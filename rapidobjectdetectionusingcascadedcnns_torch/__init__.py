"""PyTorch/CUDA port of the cascaded-CNN object detector.

A second package beside ``rapidobjectdetectionusingcascadedcnns_tpu`` (the
JAX reference, which stays as it is). Module names mirror the JAX package's
so each module's counterpart is easy to find. Plain tensor code is PyTorch;
every Pallas kernel of the JAX package on the ported path is a CUDA kernel
written for Hopper (``csrc/``), built with ``nvcc`` at first use.

The host-only modules of the JAX package import no jax and are shared, not
copied: ``config`` (one ``cf`` configures both packages), ``ops/pyramid``,
``ops/nms``, ``ops/rectangles``, ``native`` and ``data/*``. This package
never imports jax.
"""

from rapidobjectdetectionusingcascadedcnns_tpu import config  # noqa: F401

__version__ = "0.1.0"
