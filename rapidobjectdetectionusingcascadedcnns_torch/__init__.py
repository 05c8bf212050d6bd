"""PyTorch/CUDA port of the cascaded-CNN object detector.

A second package beside ``rapidobjectdetectionusingcascadedcnns_tpu`` (the
JAX reference, which stays as it is). Module names mirror the JAX package's
so each module's counterpart is easy to find. Plain tensor code is PyTorch;
every Pallas kernel of the JAX package on the ported path is a CUDA kernel
written for Hopper (``csrc/``), built with ``nvcc`` at first use.

The port imports nothing of the JAX package and never imports jax: it
keeps its own copies of the host-only modules it needs (``config``,
``ops/pyramid``, ``ops/nms``, ``ops/rectangles``, ``native``, ``utils/log``,
``utils/time_watcher``, ``utils/console``, ``utils/file_handler``,
``data/synthetic``, ``data/image_io``, ``data/file_list``, ``data/cache``,
``data/imagenet_info``, ``data/fddb``, ``data/fddb_eval``). Its ``config``
is a configuration of its own. Entry points (the apps, ``python -m
rapidobjectdetectionusingcascadedcnns_torch.run``) run on the CUDA card
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``).
"""

from . import config  # noqa: F401

__version__ = "0.1.0"
