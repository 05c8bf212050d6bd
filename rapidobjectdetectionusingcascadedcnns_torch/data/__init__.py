"""Data helpers of the port, copied from the JAX package's ``data`` modules:
the synthetic scene generator, host image IO (``ImageInfo``), file
discovery, annotations, the disk dataset provider with its cache, the batch
prefetcher and the FDDB fold IO and scorer."""

from . import synthetic  # noqa: F401
