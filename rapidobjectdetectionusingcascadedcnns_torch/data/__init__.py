"""Data helpers of the port: the synthetic scene generator and host image
resizing, copied from the JAX package's ``data`` modules."""

from . import synthetic  # noqa: F401
