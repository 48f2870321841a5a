"""Single-GPU training: optimizers, data, the train step and the loop."""
