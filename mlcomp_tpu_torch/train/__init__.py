"""Training of the port: losses, metrics, optimizers, the TrainState and
the Trainer (the counterpart of mlcomp_tpu/train)."""
