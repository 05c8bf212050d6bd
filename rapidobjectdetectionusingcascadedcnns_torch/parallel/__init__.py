"""Meshes (counterpart of the JAX package's ``parallel``): frame- and
window-sharded detection and data-parallel training over the devices of
one process (``mesh``, ``window_shard``), and the multi-process runs over
``torch.distributed`` (``multihost``)."""
