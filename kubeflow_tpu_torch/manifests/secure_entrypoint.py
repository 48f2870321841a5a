"""The secure entrypoint: counterparts of
``kubeflow_tpu/manifests/packages/secure_entrypoint.py``'s
``cert-manager``, ``secure-ingress`` and ``cloud-endpoints`` prototypes,
under JAX's names and parameters.

- ``cert-manager``: the Issuer, Certificate and Endpoint CRDs and a
  Deployment of ``python -m kubeflow_tpu_torch.operators.certificate``.
- ``secure-ingress``: the Issuer, Certificate and Endpoint CRs and a
  gateway (``python -m kubeflow_tpu_torch.gateway``) that terminates TLS
  with the controller's certificate (reloaded on rotation), answers
  plain HTTP with a 301 to HTTPS, serves the ACME challenge route and
  checks bearer id-tokens.
- ``cloud-endpoints``: an Endpoint CR, recorded in the DNS-zone
  ConfigMap.

Each renders JAX's objects on the port's image with the port's modules.
None of them needs a GPU, so no pod requests one.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis.certificates import (
    CERT_API_GROUP,
    CERTS_API_VERSION,
    all_cert_crds,
)
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    prototype,
)


@prototype(
    "cert-manager",
    "Certificate lifecycle: Issuer/Certificate CRDs + the issuance and "
    "rotation controller (cert-manager.jsonnet analogue)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("acme_url", "https://acme-v02.api.letsencrypt.org/directory",
                  "ACME directory for acme-type issuers "
                  "(cert-manager.jsonnet acmeUrl param)"),
        ParamSpec("acme_email", "", "registration email for acme issuers"),
    ],
)
def cert_manager(namespace: str, image: str, acme_url: str,
                 acme_email: str) -> list[dict]:
    name = "cert-manager"
    labels = {"app": name}
    return [
        *all_cert_crds(),
        k8s.service_account(name, namespace, labels),
        k8s.cluster_role(
            name,
            [
                k8s.policy_rule([CERT_API_GROUP], ["*"], ["*"]),
                k8s.policy_rule([""], ["secrets", "configmaps"], ["*"]),
            ],
            labels,
        ),
        k8s.cluster_role_binding(name, name, name, namespace),
        k8s.deployment(
            name,
            namespace,
            containers=[
                k8s.container(
                    name,
                    image,
                    command=["python", "-m",
                             "kubeflow_tpu_torch.operators.certificate"],
                    args=[f"--namespace={namespace}"],
                    env={"ACME_DIRECTORY_URL": acme_url,
                         "ACME_EMAIL": acme_email},
                )
            ],
            labels=labels,
            service_account=name,
        ),
    ]


@prototype(
    "secure-ingress",
    "Public entrypoint: gateway TLS from a controller-managed certificate "
    "(hot rotation), https-redirect, ACME challenge route, DNS record "
    "(iap-ingress + https-redirect analogue)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("hostname", "kubeflow.example.com",
                  "public hostname the certificate and DNS record cover"),
        ParamSpec("issuer", "platform-ca",
                  "Issuer the certificate references (iap-ingress "
                  "`issuer letsencrypt-prod` analogue)"),
        ParamSpec("issuer_type", "selfSigned", "selfSigned | acme"),
        ParamSpec("duration_seconds", 90 * 24 * 3600,
                  "certificate lifetime (letsencrypt-style 90d)"),
        ParamSpec("renew_before_seconds", 30 * 24 * 3600,
                  "rotate this long before expiry"),
        ParamSpec("replicas", 3),
        ParamSpec("jwt_issuer", "https://gatekeeper.kubeflow-tpu",
                  "iss claim required on bearer id-tokens (the envoy "
                  "jwt-auth filter, iap.libsonnet:589-600)"),
        ParamSpec("jwt_audience", "kubeflow-tpu",
                  "aud claim required on bearer id-tokens "
                  "({{JWT_AUDIENCE}} analogue)"),
        ParamSpec("jwks_uri", "http://gatekeeper:8085/.well-known/jwks.json",
                  "verification-key endpoint (jwks_uri analogue)"),
        ParamSpec("jwt_bypass",
                  '[{"http_method":"GET","path_exact":"/healthz"}]',
                  "JSON method+path list exempt from token checks "
                  "(bypass_jwt analogue)"),
        ParamSpec("disable_jwt_checking", False,
                  "serve without identity-token verification "
                  "(disableJwtChecking param analogue)"),
    ],
)
def secure_ingress(namespace: str, image: str, hostname: str, issuer: str,
                   issuer_type: str, duration_seconds: int,
                   renew_before_seconds: int, replicas: int,
                   jwt_issuer: str, jwt_audience: str, jwks_uri: str,
                   jwt_bypass: str, disable_jwt_checking: bool) -> list[dict]:
    name = "secure-gateway"
    labels = {"app": name, "service": "gateway"}
    cert_secret = f"{name}-tls"
    jwt_args = [] if disable_jwt_checking else [
        f"--jwt-issuer={jwt_issuer}",
        f"--jwt-audience={jwt_audience}",
        f"--jwks-uri={jwks_uri}",
        f"--jwt-bypass={jwt_bypass}",
    ]
    issuer_spec = ({"selfSigned": {"commonName": f"{issuer}.{namespace}"}}
                   if issuer_type == "selfSigned"
                   else {"acme": {}})
    return [
        {
            "apiVersion": CERTS_API_VERSION,
            "kind": "Issuer",
            "metadata": {"name": issuer, "namespace": namespace},
            "spec": issuer_spec,
        },
        {
            "apiVersion": CERTS_API_VERSION,
            "kind": "Certificate",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {
                "secretName": cert_secret,
                "dnsNames": [hostname],
                "issuerRef": {"name": issuer},
                "durationSeconds": duration_seconds,
                "renewBeforeSeconds": renew_before_seconds,
            },
        },
        {
            "apiVersion": CERTS_API_VERSION,
            "kind": "Endpoint",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"hostname": hostname,
                     "target": f"{name}.{namespace}"},
        },
        # The prototype is self-contained: its own SA with route discovery
        # (services) plus the ACME-challenge ConfigMap read the
        # --serve-acme-challenges flag needs.
        k8s.service_account(name, namespace, labels),
        k8s.cluster_role(
            name,
            [
                k8s.policy_rule([""], ["services"],
                                ["get", "list", "watch"]),
                k8s.policy_rule([""], ["configmaps"], ["get"]),
            ],
            labels,
        ),
        k8s.cluster_role_binding(name, name, name, namespace),
        k8s.service(
            name,
            namespace,
            selector=labels,
            ports=[
                {"name": "https", "port": 443, "targetPort": 8443},
                {"name": "http", "port": 80, "targetPort": 8080},
            ],
            labels=labels,
            service_type="LoadBalancer",
        ),
        k8s.deployment(
            name,
            namespace,
            containers=[
                k8s.container(
                    name,
                    image,
                    command=["python", "-m", "kubeflow_tpu_torch.gateway"],
                    args=[
                        "--port=8443",
                        "--redirect-port=8080",
                        "--admin-port=8877",
                        f"--namespace={namespace}",
                        "--tls-cert=/etc/tls/tls.crt",
                        "--tls-key=/etc/tls/tls.key",
                        "--watch-certs=5",
                        "--serve-acme-challenges",
                        *jwt_args,
                    ],
                    ports={"https": 8443, "http": 8080, "admin": 8877},
                    liveness_probe=k8s.http_probe("/healthz", 8877,
                                                  initial_delay=30),
                    readiness_probe=k8s.http_probe("/healthz", 8877),
                    volume_mounts=[
                        k8s.volume_mount("tls", "/etc/tls", read_only=True)
                    ],
                )
            ],
            replicas=replicas,
            labels=labels,
            service_account=name,
            volumes=[k8s.secret_volume("tls", cert_secret)],
        ),
    ]


@prototype(
    "cloud-endpoints",
    "DNS record for a platform hostname via the Endpoint CR "
    "(cloud-endpoints.jsonnet analogue)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("hostname", "kubeflow.example.com"),
        ParamSpec("target", "gateway.kubeflow",
                  "service (or address) the hostname resolves to"),
    ],
)
def cloud_endpoints(namespace: str, hostname: str,
                    target: str) -> list[dict]:
    return [{
        "apiVersion": CERTS_API_VERSION,
        "kind": "Endpoint",
        "metadata": {"name": hostname.split(".")[0],
                     "namespace": namespace},
        "spec": {"hostname": hostname, "target": target},
    }]
