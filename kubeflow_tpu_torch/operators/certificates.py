"""The certificate lifecycle controllers of the secure entrypoint; a copy
of ``kubeflow_tpu/operators/certificates.py`` on the port's controller
runtime (``operators/base.py``).

- :class:`IssuerController`: a ``selfSigned`` Issuer generates a CA into
  the Secret ``<name>-ca`` (its status carries the CA certificate for
  clients to trust); an ``acme`` Issuer is ready as soon as it is
  configured, its directory URL recorded, and signs with a platform CA
  of its own (the in-cluster stand-in for the directory's finalize call).
- :class:`CertificateController`: the issuance and rotation state
  machine. A Certificate of an ``acme`` issuer walks Pending -> Validated
  -> Issued through an order with an HTTP-01 challenge token, published
  in the ``acme-challenges`` ConfigMap that the gateway serves at
  ``/.well-known/acme-challenge/<token>``; a ``selfSigned`` issuer signs
  at once. Renewal re-enters the machine ``renewBeforeSeconds`` before
  expiry and bumps ``status.revision``; the gateway reloads the rotated
  Secret's files without dropping a connection
  (:mod:`kubeflow_tpu_torch.gateway`). The clock is injected.
- :class:`EndpointController`: hostname -> target records in the
  namespace's ``kubeflow-dns-zone`` ConfigMap, rebuilt from every
  Endpoint on each reconcile; zones of namespaces with no Endpoint left
  are emptied, found from the cluster, so a restart keeps the GC.

Statuses, Secrets and ConfigMaps are JAX's. The event-driven runtime's
watch lists are not copied: the port's manager polls. Host code: the
standard library and ``cryptography`` (through ``auth/pki.py``).
"""

from __future__ import annotations

import time

from kubeflow_tpu_torch.apis.certificates import (
    CERTIFICATE_KIND,
    CERTS_API_VERSION,
    DNS_ZONE_CONFIGMAP,
    ENDPOINT_KIND,
    ISSUER_KIND,
    ORDER_ISSUED,
    ORDER_PENDING,
    ORDER_VALIDATED,
)
from kubeflow_tpu_torch.auth import pki
from kubeflow_tpu_torch.k8s_client import ApiError
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.operators.base import Controller

# Challenge tokens the gateway serves at /.well-known/acme-challenge/.
ACME_CHALLENGE_CONFIGMAP = "acme-challenges"

# Zone ConfigMaps are labeled so restart-safe GC can enumerate them with
# one label-selected list instead of a cluster-wide ConfigMap scan.
ZONE_CONFIGMAP_LABELS = {"kubeflow-tpu.org/dns-zone": "true"}

_DEFAULT_DURATION = 90 * 24 * 3600       # letsencrypt-style 90 days
_DEFAULT_RENEW_BEFORE = 30 * 24 * 3600   # renew with 30 days left


def _now() -> float:
    return time.time()


class IssuerController(Controller):
    api_version = CERTS_API_VERSION
    kind = ISSUER_KIND

    def reconcile(self, issuer: dict) -> None:
        name = issuer["metadata"]["name"]
        ns = issuer["metadata"]["namespace"]
        spec = issuer.get("spec", {})
        status = dict(issuer.get("status", {}))

        if "selfSigned" in spec:
            secret_name = f"{name}-ca"
            existing = self.client.get_or_none("v1", "Secret",
                                               secret_name, ns)
            if existing is None:
                ca = pki.make_ca(
                    spec["selfSigned"].get("commonName",
                                           f"{name}.{ns}.kubeflow-tpu")
                )
                sec = k8s.secret(secret_name, ns, {
                    "tls.crt": ca.cert_pem, "tls.key": ca.key_pem,
                    "ca.crt": ca.ca_pem,
                }, secret_type="kubernetes.io/tls")
                sec["metadata"]["ownerReferences"] = [k8s.object_ref(issuer)]
                self.client.create(sec)
                ca_pem = ca.cert_pem
            else:
                data = k8s.secret_data(existing)
                ca_pem = data.get("ca.crt", data.get("tls.crt", ""))
            status.update({"ready": True, "type": "selfSigned",
                           "caSecretName": secret_name,
                           "caCertificate": ca_pem})
        elif "acme" in spec:
            # ACME directory reachability is a deploy-time concern; the
            # issuer is ready as soon as it is configured — orders carry
            # the per-certificate state machine. Signing uses a platform
            # CA secret (the in-cluster stand-in for the directory's
            # finalize call; a zero-egress deployment still gets working
            # TLS with a distributable trust root).
            secret_name = f"{name}-ca"
            if self.client.get_or_none("v1", "Secret",
                                       secret_name, ns) is None:
                ca = pki.make_ca(f"acme-{name}.{ns}.kubeflow-tpu")
                sec = k8s.secret(secret_name, ns, {
                    "tls.crt": ca.cert_pem, "tls.key": ca.key_pem,
                    "ca.crt": ca.ca_pem,
                }, secret_type="kubernetes.io/tls")
                sec["metadata"]["ownerReferences"] = [k8s.object_ref(issuer)]
                self.client.create(sec)
            status.update({"ready": True, "type": "acme",
                           "url": spec["acme"].get("url", ""),
                           "caSecretName": secret_name})
        else:
            status.update({"ready": False,
                           "reason": "spec needs selfSigned or acme"})

        if status != issuer.get("status"):
            issuer["status"] = status
            self._push_status(issuer)  # refetch-and-reapply on conflict

    def ca_for(self, name: str, ns: str) -> pki.KeyCert | None:
        """Load the Issuer's CA keypair (selfSigned and acme issuers both
        sign with a platform CA — the acme machine differs in the order
        walk, not the signer; a real ACME deployment swaps this for the
        directory's finalize call)."""
        sec = self.client.get_or_none("v1", "Secret", f"{name}-ca", ns)
        if sec is None:
            return None
        data = k8s.secret_data(sec)
        return pki.KeyCert(key_pem=data["tls.key"],
                           cert_pem=data["tls.crt"],
                           ca_pem=data.get("ca.crt", data["tls.crt"]))


class CertificateController(Controller):
    """Issuance + rotation state machine for Certificate CRs."""

    api_version = CERTS_API_VERSION
    kind = CERTIFICATE_KIND

    def __init__(self, client, *, clock=_now):
        super().__init__(client)
        self.clock = clock

    # -- state machine ------------------------------------------------------

    def reconcile(self, cert: dict) -> None:
        name = cert["metadata"]["name"]
        ns = cert["metadata"]["namespace"]
        spec = cert.get("spec", {})
        status = dict(cert.get("status", {}))
        issuer_name = spec["issuerRef"]["name"]
        issuer = self.client.get_or_none(CERTS_API_VERSION, ISSUER_KIND,
                                         issuer_name, ns)
        if issuer is None or not issuer.get("status", {}).get("ready"):
            self._set_status(cert, {**status, "ready": False,
                                    "reason": f"issuer {issuer_name} not "
                                              "ready"})
            return
        acme = issuer["status"].get("type") == "acme"

        secret = self.client.get_or_none("v1", "Secret",
                                         spec["secretName"], ns)
        if secret is not None and not self._needs_renewal(spec, status):
            return  # Issued and fresh — steady state.

        if acme:
            order = status.get("order", {})
            state = order.get("state")
            if not order or state == ORDER_ISSUED:
                # New order (first issuance or renewal): publish the
                # HTTP-01 challenge token for the gateway to serve.
                import secrets as _secrets

                token = _secrets.token_urlsafe(24)
                self._publish_challenge(ns, name, token)
                self._set_status(cert, {
                    **status, "ready": status.get("ready", False),
                    "order": {"state": ORDER_PENDING, "token": token},
                })
                return
            if state == ORDER_PENDING:
                # Self-check the challenge is published (the in-platform
                # stand-in for the ACME server's validation GET).
                if self._challenge_published(ns, name,
                                             order.get("token", "")):
                    self._set_status(cert, {
                        **status,
                        "order": {**order, "state": ORDER_VALIDATED},
                    })
                return
            if state != ORDER_VALIDATED:
                return

        self._issue(cert, issuer_name, ns, spec, status, acme=acme)

    def _issue(self, cert, issuer_name, ns, spec, status, *, acme):
        issuers = IssuerController(self.client)
        ca = issuers.ca_for(issuer_name, ns)
        if ca is None:
            self._set_status(cert, {**status, "ready": False,
                                    "reason": "issuer CA secret missing"})
            return
        duration = int(spec.get("durationSeconds", _DEFAULT_DURATION))
        leaf = pki.issue(ca, list(spec["dnsNames"]),
                         duration_seconds=duration)
        info = pki.cert_info(leaf.cert_pem)
        sec = k8s.secret(spec["secretName"], ns, {
            "tls.crt": leaf.chain_pem, "tls.key": leaf.key_pem,
            "ca.crt": leaf.ca_pem,
        }, secret_type="kubernetes.io/tls")
        sec["metadata"]["ownerReferences"] = [k8s.object_ref(cert)]
        existing = self.client.get_or_none("v1", "Secret",
                                           spec["secretName"], ns)
        if existing is None:
            self.client.create(sec)
        else:
            existing["stringData"] = sec["stringData"]
            existing["type"] = sec["type"]
            self.client.update(existing)
        new_status = {
            "ready": True,
            "serial": info["serial"],
            "notAfter": info["not_after"].isoformat(),
            "issuedAt": self.clock(),
            "revision": int(status.get("revision", 0)) + 1,
            "dnsNames": info["dns_names"],
        }
        if acme:
            new_status["order"] = {**status.get("order", {}),
                                   "state": ORDER_ISSUED}
            self._clear_challenge(ns, cert["metadata"]["name"])
        self._set_status(cert, new_status)

    def _needs_renewal(self, spec: dict, status: dict) -> bool:
        if not status.get("ready"):
            return True
        duration = int(spec.get("durationSeconds", _DEFAULT_DURATION))
        renew_before = int(spec.get("renewBeforeSeconds",
                                    min(_DEFAULT_RENEW_BEFORE,
                                        duration // 3)))
        issued_at = float(status.get("issuedAt", 0))
        return self.clock() >= issued_at + duration - renew_before

    # -- helpers ------------------------------------------------------------

    def _set_status(self, cert: dict, status: dict) -> None:
        if status != cert.get("status"):
            cert["status"] = status
            self._push_status(cert)  # refetch-and-reapply on conflict

    def _publish_challenge(self, ns: str, name: str, token: str) -> None:
        cm = self.client.get_or_none("v1", "ConfigMap",
                                     ACME_CHALLENGE_CONFIGMAP, ns)
        if cm is None:
            cm = {"apiVersion": "v1", "kind": "ConfigMap",
                  "metadata": {"name": ACME_CHALLENGE_CONFIGMAP,
                               "namespace": ns},
                  "data": {}}
            cm["data"][name] = token
            self.client.create(cm)
        else:
            cm.setdefault("data", {})[name] = token
            self.client.update(cm)

    def _challenge_published(self, ns: str, name: str, token: str) -> bool:
        cm = self.client.get_or_none("v1", "ConfigMap",
                                     ACME_CHALLENGE_CONFIGMAP, ns)
        return bool(cm and cm.get("data", {}).get(name) == token)

    def _clear_challenge(self, ns: str, name: str) -> None:
        cm = self.client.get_or_none("v1", "ConfigMap",
                                     ACME_CHALLENGE_CONFIGMAP, ns)
        if cm and name in cm.get("data", {}):
            del cm["data"][name]
            self.client.update(cm)


class EndpointController(Controller):
    """hostname → target records in the platform DNS-zone ConfigMap.

    Level-triggered zone sync: each reconcile rebuilds the namespace's
    desired record set from ALL Endpoint CRs, so deleted or renamed
    endpoints drop out of the zone instead of leaving stale records (as
    Kubeflow's cloud-endpoints keeps Cloud DNS in sync with the declared
    records). ``reconcile_all`` additionally garbage-collects
    zones whose namespace no longer has ANY endpoint (the case no live
    primary would trigger)."""

    api_version = CERTS_API_VERSION
    kind = ENDPOINT_KIND

    def __init__(self, client):
        super().__init__(client)
        self._legacy_zones_swept = False

    def _sweep_legacy_zones(self) -> bool:
        """One full ConfigMap scan: zone CMs created before the GC label
        existed get labeled so the steady-state label-selected GC sees
        them. Returns True only when every zone is labeled — a partial
        sweep (update conflicts) must run again next resync or the
        skipped zone stays invisible to GC forever."""
        ok = True
        for cm in self.client.list("v1", "ConfigMap"):
            if cm["metadata"]["name"] != DNS_ZONE_CONFIGMAP:
                continue
            labels = cm["metadata"].setdefault("labels", {})
            if all(labels.get(k) == v
                   for k, v in ZONE_CONFIGMAP_LABELS.items()):
                continue
            labels.update(ZONE_CONFIGMAP_LABELS)
            try:
                self.client.update(cm)
            except ApiError:
                ok = False  # retried on the next (still-unswept) pass
        return ok

    def reconcile_all(self) -> int:
        n = super().reconcile_all()
        if not self._legacy_zones_swept:
            try:
                self._legacy_zones_swept = self._sweep_legacy_zones()
            except ApiError:
                pass  # transient: retry next resync
        # Zone GC: a namespace whose last Endpoint was deleted has no
        # primary left to rebuild its zone — empty it here. The zone set
        # is enumerated FROM THE CLUSTER (every ConfigMap bearing the
        # zone name), not from controller memory, so a restart between
        # the deletion and this pass still cleans the orphan. Per-zone errors (lost update races, deleted
        # namespaces) must not kill the controller loop; the next resync
        # retries.
        try:
            live = {ep["metadata"]["namespace"]
                    for ep in self.client.list(CERTS_API_VERSION,
                                               ENDPOINT_KIND)}
            zones = {cm["metadata"]["namespace"]
                     for cm in self.client.list(
                         "v1", "ConfigMap",
                         label_selector=ZONE_CONFIGMAP_LABELS)
                     if cm.get("data")}
        except ApiError:
            return n
        for ns in sorted(zones - live):
            try:
                cm = self.client.get_or_none("v1", "ConfigMap",
                                             DNS_ZONE_CONFIGMAP, ns)
                if cm is not None and cm.get("data"):
                    cm["data"] = {}
                    self.client.update(cm)
            except ApiError:
                continue  # transient: retried next resync
        return n

    def reconcile(self, ep: dict) -> None:
        ns = ep["metadata"]["namespace"]
        desired: dict[str, str] = {}
        for other in self.client.list(CERTS_API_VERSION, ENDPOINT_KIND,
                                      ns):
            spec = other.get("spec", {})
            if spec.get("hostname") and spec.get("target"):
                desired[spec["hostname"]] = spec["target"]
        cm = self.client.get_or_none("v1", "ConfigMap",
                                     DNS_ZONE_CONFIGMAP, ns)
        if cm is None:
            if desired:
                self.client.create({
                    "apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": DNS_ZONE_CONFIGMAP,
                                 "namespace": ns,
                                 "labels": dict(ZONE_CONFIGMAP_LABELS)},
                    "data": desired,
                })
        elif (cm.get("data", {}) != desired
              or not all(cm["metadata"].get("labels", {}).get(k) == v
                         for k, v in ZONE_CONFIGMAP_LABELS.items())):
            # Keep the GC label present even on zones created before the
            # label existed (or hand-made ones).
            cm["metadata"].setdefault("labels", {}).update(
                ZONE_CONFIGMAP_LABELS)
            cm["data"] = desired
            self.client.update(cm)
        target = ep.get("spec", {}).get("target")
        if not target:
            return
        status = {"ready": True, "recordedTarget": target}
        if status != ep.get("status"):
            ep["status"] = status
            self._push_status(ep)  # refetch-and-reapply on conflict
