"""Applications of the port: inference, the FDDB benchmark and the runtime
comparison (counterparts of the JAX package's ``apps`` modules). Each runs
on the CUDA card unless given ``device="cpu"``."""
