"""Data helpers of the port: the JAX package's host-only ``data`` modules
(numpy, no jax) are shared as they are."""

from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic  # noqa: F401
