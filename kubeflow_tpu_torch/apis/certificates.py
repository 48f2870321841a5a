"""The Issuer, Certificate and Endpoint CRDs of the secure entrypoint;
a copy of ``kubeflow_tpu/apis/certificates.py``, CRDs and constants
equal to JAX's.

- Issuer: the root of trust a Certificate names. A ``selfSigned`` issuer
  holds a CA the platform generates; an ``acme`` issuer (the directory URL
  of a letsencrypt-style ACME server) makes its Certificates walk the
  order states below.
- Certificate: ``dnsNames``, ``issuerRef``, ``secretName``,
  ``durationSeconds`` and ``renewBeforeSeconds``; the controller issues
  into the Secret and rotates it before expiry.
- Endpoint: a hostname -> target record, kept in the platform's zone
  ConfigMap (:data:`DNS_ZONE_CONFIGMAP`) that in-cluster resolvers read.

Standard library only.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s

CERT_API_GROUP = f"cert.{API_GROUP}"
CERTS_API_VERSION = f"{CERT_API_GROUP}/v1"
ISSUER_KIND = "Issuer"
ISSUER_PLURAL = "issuers"
CERTIFICATE_KIND = "Certificate"
CERTIFICATE_PLURAL = "certificates"
ENDPOINT_KIND = "Endpoint"
ENDPOINT_PLURAL = "endpoints"

# The DNS-zone record store the Endpoint controller maintains.
DNS_ZONE_CONFIGMAP = "kubeflow-dns-zone"

COND_READY = "Ready"

# ACME-style order states (the issuance state machine).
ORDER_PENDING = "Pending"
ORDER_VALIDATED = "Validated"
ORDER_ISSUED = "Issued"


def issuer_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "selfSigned": {
                        "type": "object",
                        "properties": {
                            "commonName": {"type": "string"},
                        },
                    },
                    "acme": {
                        "type": "object",
                        "properties": {
                            "url": {"type": "string"},
                            "email": {"type": "string"},
                        },
                    },
                },
                "x-kubernetes-preserve-unknown-fields": True,
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    return k8s.crd(
        group=CERT_API_GROUP,
        kind=ISSUER_KIND,
        plural=ISSUER_PLURAL,
        categories=["kubeflow-tpu"],
        versions=[k8s.crd_version(
            "v1", schema=schema, storage=True,
            printer_columns=[
                k8s.printer_column("Ready", ".status.ready"),
                k8s.printer_column("Age", ".metadata.creationTimestamp",
                                   "date"),
            ],
        )],
    )


def certificate_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["secretName", "dnsNames", "issuerRef"],
                "properties": {
                    "secretName": {"type": "string"},
                    "dnsNames": {
                        "type": "array",
                        "items": {"type": "string"},
                        "minItems": 1,
                    },
                    "issuerRef": {
                        "type": "object",
                        "required": ["name"],
                        "properties": {"name": {"type": "string"}},
                    },
                    "durationSeconds": {"type": "integer", "minimum": 1},
                    "renewBeforeSeconds": {"type": "integer", "minimum": 0},
                },
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    return k8s.crd(
        group=CERT_API_GROUP,
        kind=CERTIFICATE_KIND,
        plural=CERTIFICATE_PLURAL,
        short_names=["cert"],
        categories=["kubeflow-tpu"],
        versions=[k8s.crd_version(
            "v1", schema=schema, storage=True,
            printer_columns=[
                k8s.printer_column("Ready", ".status.ready"),
                k8s.printer_column("NotAfter", ".status.notAfter"),
                k8s.printer_column("Revision", ".status.revision"),
            ],
        )],
    )


def endpoint_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["hostname", "target"],
                "properties": {
                    "hostname": {"type": "string"},
                    "target": {"type": "string"},
                },
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    return k8s.crd(
        group=CERT_API_GROUP,
        kind=ENDPOINT_KIND,
        plural=ENDPOINT_PLURAL,
        categories=["kubeflow-tpu"],
        versions=[k8s.crd_version(
            "v1", schema=schema, storage=True,
            printer_columns=[
                k8s.printer_column("Hostname", ".spec.hostname"),
                k8s.printer_column("Target", ".spec.target"),
                k8s.printer_column("Ready", ".status.ready"),
            ],
        )],
    )


def all_cert_crds() -> list[dict]:
    return [issuer_crd(), certificate_crd(), endpoint_crd()]
