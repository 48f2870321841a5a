"""Identity and certificates for the port's front door: ``tokens.py`` (a
copy of ``kubeflow_tpu/auth/tokens.py``, which the gateway's JWT checks
verify through) and ``pki.py`` (a copy of ``kubeflow_tpu/auth/pki.py``,
which the certificate controllers issue through)."""
