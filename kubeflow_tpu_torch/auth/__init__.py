"""Identity tokens for the port's gateway (``tokens.py``, a copy of
``kubeflow_tpu/auth/tokens.py``)."""
