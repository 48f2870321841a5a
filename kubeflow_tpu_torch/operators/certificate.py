"""``python -m kubeflow_tpu_torch.operators.certificate``: the
cert-manager, the Issuer, Certificate and Endpoint controllers alone, as
``python -m kubeflow_tpu.operators.certificate`` is JAX's (the
``cert-manager`` Deployment runs it).

Flags are the manager's (``runtime.manager_args``): ``--apiserver``,
``--once`` (one pass, printing ``{"reconciled": n, "controllers": 3}``),
``--metrics-port`` (default 8443) and ``--leader-elect
[--leader-elect-name NAME]`` (default ``kubeflow-tpu-certificate``, the
lease JAX's ``controller_main`` derives for its cert-manager, so the two
exclude each other). Host code: the standard library and
``cryptography``; no torch, no GPU.
"""

from __future__ import annotations

from kubeflow_tpu_torch.runtime import manager_main


def make_controllers(client) -> list:
    from kubeflow_tpu_torch.operators.certificates import (
        CertificateController,
        EndpointController,
        IssuerController,
    )

    return [IssuerController(client), CertificateController(client),
            EndpointController(client)]


def main(argv=None) -> int:
    return manager_main(argv,
                        "python -m kubeflow_tpu_torch.operators.certificate",
                        __doc__, lambda client, args: make_controllers(client),
                        lease_name="kubeflow-tpu-certificate")


if __name__ == "__main__":
    raise SystemExit(main())
