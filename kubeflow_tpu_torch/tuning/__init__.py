"""The port's tuning: the suggestion algorithms (a copy of JAX's) and the
sweep CLI over the port's Experiment controller and scenarios."""
