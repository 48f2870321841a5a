"""The port's operators: the Experiment controller (tuning trials over the
port's scenarios) on a copy of the reconciler runtime it uses."""
