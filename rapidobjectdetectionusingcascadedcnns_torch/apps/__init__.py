"""Applications of the port: inference (cascade, single net, the
Viola-Jones baseline), bbox visualization, training and tuning, offline
sampling, the FDDB benchmark and the runtime comparison (counterparts of
the JAX package's ``apps`` modules). Each CNN app runs on the CUDA card
unless given ``device="cpu"``."""
