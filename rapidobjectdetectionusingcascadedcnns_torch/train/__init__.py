"""Training of the port: losses, metrics, optimizers, train steps,
checkpoints, the single-net trainer and the boosted cascade trainer."""
