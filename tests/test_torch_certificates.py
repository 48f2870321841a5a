"""The secure entrypoint over the port against the JAX package's.

- The Issuer, Certificate and Endpoint CRDs and their constants are
  JAX's, byte for byte.
- PKI across the two packages: a leaf from either package's ``issue``
  under a CA from the other's ``make_ca`` passes a TLS handshake that
  verifies the chain and the hostname; ``cert_info`` of one PEM is equal
  from both; empty ``dnsNames`` raise ``ValueError`` in both; without
  ``cryptography`` the port's ``pki`` imports and its first call raises.
- The port's controllers and JAX's, each on its own package's fake
  apiserver, on the same CR sequence and the same injected clock, leave
  the same statuses, Secrets and ConfigMaps after every step, once the
  random fields are masked (serials, ``notAfter``, PEM bodies, ACME
  tokens): one case per scenario of ``tests/test_certificates.py``.
- The three prototypes render JAX's objects under three substitutions
  (the port's image, ``kubeflow_tpu_torch.gateway``,
  ``kubeflow_tpu_torch.operators.certificate``), request no GPU, and
  reconcile to a Ready Certificate and a zone record on the port's fake.
- The port's gateway serves and hot-rotates a certificate the port's
  controller issued: the keep-alive, the redirect and the ACME route; no
  handshake fails while it reloads a rotated pair.
- ``python -m kubeflow_tpu_torch.operators.certificate --once`` against
  the port's fake served over HTTP issues the rendered Certificate.
"""

import base64
import copy
import http.client
import json
import os
import ssl
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from kubeflow_tpu.apis import certificates as japis
from kubeflow_tpu.auth import pki as jpki
from kubeflow_tpu.k8s.fake import FakeApiServer as JFake
from kubeflow_tpu.k8s.objects import secret_data as jsecret_data
from kubeflow_tpu.manifests import images as jimages
from kubeflow_tpu.manifests.core import generate as jgenerate
from kubeflow_tpu.operators import certificates as jops
from kubeflow_tpu_torch import k8s_fake
from kubeflow_tpu_torch.apis import certificates as tapis
from kubeflow_tpu_torch.auth import pki as tpki
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TFake
from kubeflow_tpu_torch.manifests import generate as tgenerate
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests.objects import secret_data
from kubeflow_tpu_torch.operators import certificates as tops

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NS = "kubeflow"
CERTS = japis.CERTS_API_VERSION
JAX = {"api": JFake, "ops": jops, "pki": jpki, "generate": jgenerate,
       "secret_data": jsecret_data}
PORT = {"api": TFake, "ops": tops, "pki": tpki, "generate": tgenerate,
        "secret_data": secret_data}


def test_crds_and_constants_equal_jax():
    assert tapis.all_cert_crds() == japis.all_cert_crds()
    for name in dir(japis):
        if name.isupper():
            assert getattr(tapis, name) == getattr(japis, name), name
    for name in ("ACME_CHALLENGE_CONFIGMAP", "ZONE_CONFIGMAP_LABELS",
                 "_DEFAULT_DURATION", "_DEFAULT_RENEW_BEFORE"):
        assert getattr(tops, name) == getattr(jops, name), name


# ---------------------------------------------------------------------------
# PKI across the two packages
# ---------------------------------------------------------------------------


def _handshake(tmp_path, ca_pem: str, leaf, hostname: str) -> int:
    """A TLS handshake in memory: the server presents ``leaf``'s chain, the
    client trusts only ``ca_pem`` and checks ``hostname``. Returns the
    serial the client saw."""
    (tmp_path / "ca.pem").write_text(ca_pem)
    (tmp_path / "chain.pem").write_text(leaf.chain_pem)
    (tmp_path / "leaf.key").write_text(leaf.key_pem)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(tmp_path / "chain.pem", tmp_path / "leaf.key")
    client_ctx = ssl.create_default_context(cafile=str(tmp_path / "ca.pem"))
    c_in, c_out, s_in, s_out = (ssl.MemoryBIO() for _ in range(4))
    client = client_ctx.wrap_bio(c_in, c_out, server_hostname=hostname)
    server = server_ctx.wrap_bio(s_in, s_out, server_side=True)
    done = {"client": False, "server": False}
    for _ in range(10):
        for side, obj in (("client", client), ("server", server)):
            if not done[side]:
                try:
                    obj.do_handshake()
                    done[side] = True
                except ssl.SSLWantReadError:
                    pass
        s_in.write(c_out.read())
        c_in.write(s_out.read())
        if all(done.values()):
            break
    assert all(done.values())
    return int(client.getpeercert()["serialNumber"], 16)


@pytest.mark.parametrize("ca_pkg,leaf_pkg", [(jpki, tpki), (tpki, jpki)],
                         ids=["jax_ca-port_leaf", "port_ca-jax_leaf"])
def test_leaf_of_one_package_verifies_under_the_others_ca(
        tmp_path, ca_pkg, leaf_pkg):
    ca = ca_pkg.make_ca("cross root")
    leaf = leaf_pkg.issue(ca, ["svc.example.com", "alt.example.com"],
                          duration_seconds=3600)
    serial = _handshake(tmp_path, ca.cert_pem, leaf, "alt.example.com")
    assert format(serial, "x") == leaf_pkg.cert_info(leaf.cert_pem)["serial"]
    other = (tpki if ca_pkg is jpki else jpki).make_ca("cross root")
    with pytest.raises(ssl.SSLCertVerificationError):
        _handshake(tmp_path, other.cert_pem, leaf, "svc.example.com")


def test_cert_info_is_equal_from_both_packages():
    ca = jpki.make_ca("info root")
    for pem in (ca.cert_pem,
                tpki.issue(ca, ["a.example.com"], duration_seconds=60,
                           common_name="cn").cert_pem):
        assert tpki.cert_info(pem) == jpki.cert_info(pem)


@pytest.mark.parametrize("pkg", [jpki, tpki], ids=["jax", "port"])
def test_empty_dns_names_raise(pkg):
    with pytest.raises(ValueError):
        pkg.issue(pkg.make_ca("r"), [], duration_seconds=60)


def test_pki_imports_without_cryptography_and_raises_on_first_call():
    code = ("import sys\n"
            "sys.modules['cryptography'] = None\n"
            "from kubeflow_tpu_torch.auth import pki\n"
            "try:\n"
            "    pki.make_ca('r')\n"
            "except ImportError:\n"
            "    sys.exit(0)\n"
            "sys.exit(1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# The controllers beside JAX's: the scenarios of tests/test_certificates.py
# ---------------------------------------------------------------------------


def _describe(pkg: dict, text: str):
    """A PEM value with its random parts masked: a key as ``<key>``, each
    certificate of a chain as its names."""
    if "PRIVATE KEY" in text:
        return "<key>"
    if "CERTIFICATE" not in text:
        return text
    end = "-----END CERTIFICATE-----"
    out = []
    for part in text.split(end)[:-1]:
        info = pkg["pki"].cert_info(part + end + "\n")
        out.append({"dns_names": info["dns_names"],
                    "issuer": info["issuer"]})
    return out


def _mask(pkg: dict, obj: dict) -> dict:
    obj = copy.deepcopy(obj)
    meta = obj["metadata"]
    for key in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        meta.pop(key, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    status = obj.get("status", {})
    for key in ("serial", "notAfter"):
        if key in status:
            status[key] = f"<{key}>"
    if "caCertificate" in status:
        status["caCertificate"] = _describe(pkg, status["caCertificate"])
    if "token" in status.get("order", {}):
        status["order"]["token"] = "<token>"
    if obj["kind"] == "Secret":
        obj["payload"] = {k: _describe(pkg, v)
                          for k, v in pkg["secret_data"](obj).items()}
        for field in ("stringData", "data"):
            if field in obj:
                obj[field] = sorted(obj[field])
    if meta["name"] == tops.ACME_CHALLENGE_CONFIGMAP:
        obj["data"] = {k: "<token>" for k in obj.get("data", {})}
    return obj


def _snapshot(pkg: dict, api) -> dict:
    out = {}
    for av, kind in ((CERTS, "Issuer"), (CERTS, "Certificate"),
                     (CERTS, "Endpoint"), ("v1", "Secret"),
                     ("v1", "ConfigMap")):
        for o in api.list(av, kind):
            m = o["metadata"]
            out[f"{kind}/{m.get('namespace')}/{m['name']}"] = _mask(pkg, o)
    return out


def _issuer(name="ca", spec=None):
    return {"apiVersion": CERTS, "kind": "Issuer",
            "metadata": {"name": name, "namespace": NS},
            "spec": spec if spec is not None
            else {"selfSigned": {"commonName": "platform root"}}}


def _certificate(name="web", issuer="ca", **spec):
    return {"apiVersion": CERTS, "kind": "Certificate",
            "metadata": {"name": name, "namespace": NS},
            "spec": {"secretName": f"{name}-tls",
                     "dnsNames": ["web.example.com"],
                     "issuerRef": {"name": issuer}, **spec}}


def _endpoint(name, host, target, ns=NS):
    return {"apiVersion": CERTS, "kind": "Endpoint",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"hostname": host, "target": target}}


class Env:
    """One package's fake apiserver with the CRDs, its controllers on one
    injected clock, and the snapshots taken after each step."""

    def __init__(self, pkg: dict):
        self.pkg = pkg
        self.api = pkg["api"]()
        self.api.ensure_namespace(NS)
        for crd in tapis.all_cert_crds():
            self.api.apply(crd)
        self.now = [1000.0]
        self.ops = pkg["ops"]
        self.issuers = self.ops.IssuerController(self.api)
        self.certs = self.ops.CertificateController(
            self.api, clock=lambda: self.now[0])
        self.endpoints = self.ops.EndpointController(self.api)
        self.record: list = []

    def step(self, *controllers) -> dict:
        for c in controllers:
            c.reconcile_all()
        snap = _snapshot(self.pkg, self.api)
        self.record.append(snap)
        return snap

    def get(self, kind: str, name: str, ns: str = NS) -> dict:
        av = "v1" if kind in ("Secret", "ConfigMap") else CERTS
        return self.api.get(av, kind, name, ns)


def scenario_selfsigned_issuer_creates_ca(env):
    env.api.create(_issuer())
    env.step(env.issuers)
    issuer = env.get("Issuer", "ca")
    assert issuer["status"]["ready"] is True
    assert issuer["status"]["caCertificate"].startswith(
        "-----BEGIN CERTIFICATE")
    assert "BEGIN CERTIFICATE" in secret_data(
        env.get("Secret", "ca-ca"))["tls.crt"]


def scenario_issuer_reads_base64_secret(env):
    ca = env.pkg["pki"].make_ca("b64 root")
    env.api.create({
        "apiVersion": "v1", "kind": "Secret",
        "metadata": {"name": "ca-ca", "namespace": NS},
        "type": "kubernetes.io/tls",
        "data": {k: base64.b64encode(v.encode()).decode()
                 for k, v in {"tls.crt": ca.cert_pem, "tls.key": ca.key_pem,
                              "ca.crt": ca.ca_pem}.items()}})
    env.api.create(_issuer())
    env.api.create(_certificate(durationSeconds=3600))
    env.step(env.issuers)
    assert env.issuers.ca_for("ca", NS).key_pem == ca.key_pem
    env.step(env.certs)
    assert env.get("Certificate", "web")["status"]["ready"] is True


def scenario_zone_gc_sweeps_unlabeled_legacy_zones(env):
    env.api.ensure_namespace("legacy-ns")
    env.api.create({"apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": tapis.DNS_ZONE_CONFIGMAP,
                                 "namespace": "legacy-ns"},
                    "data": {"old.example.com": "gw.legacy"}})
    env.step(env.endpoints)
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP,
                   "legacy-ns")["data"] == {}


def scenario_zone_gc_survives_controller_restart(env):
    env.api.ensure_namespace("team-b")
    for ns in (NS, "team-b"):
        env.api.create(_endpoint("svc", f"svc.{ns}.example.com", f"gw.{ns}",
                                 ns))
    env.step(env.endpoints)
    env.api.delete(CERTS, "Endpoint", "svc", "team-b")
    env.step(env.ops.EndpointController(env.api))  # a restart
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP,
                   "team-b")["data"] == {}
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP, NS)["data"]


def scenario_certificate_issued_into_secret(env):
    env.api.create(_issuer())
    env.api.create(_certificate(durationSeconds=3600))
    env.step(env.issuers)
    env.step(env.certs)
    status = env.get("Certificate", "web")["status"]
    assert status["ready"] is True and status["revision"] == 1
    pem = secret_data(env.get("Secret", "web-tls"))["tls.crt"]
    assert tpki.cert_info(pem)["serial"] == status["serial"]


def scenario_certificate_waits_for_issuer(env):
    env.api.create(_certificate(issuer="missing"))
    env.step(env.certs)
    status = env.get("Certificate", "web")["status"]
    assert status["ready"] is False and "missing" in status["reason"]
    env.api.create(_issuer("missing"))
    env.step(env.issuers, env.certs)
    assert env.get("Certificate", "web")["status"]["ready"] is True


def scenario_certificate_rotates_before_expiry(env):
    env.api.create(_issuer())
    env.api.create(_certificate(durationSeconds=1000,
                                renewBeforeSeconds=200))
    env.step(env.issuers, env.certs)
    first = env.get("Certificate", "web")["status"]
    env.step(env.certs)  # fresh: no reissue
    assert env.get("Certificate", "web")["status"] == first
    serials = [first["serial"]]
    for t in (1850.0, 1900.0, 2700.0):  # in the window; fresh; again
        env.now[0] = t
        env.step(env.certs)
        serials.append(env.get("Certificate", "web")["status"]["serial"])
    status = env.get("Certificate", "web")["status"]
    assert status["revision"] == 3 and status["issuedAt"] == 2700.0
    assert serials[1] != serials[0] and serials[2] == serials[1] \
        and serials[3] != serials[2]
    pem = secret_data(env.get("Secret", "web-tls"))["tls.crt"]
    assert tpki.cert_info(pem)["serial"] == status["serial"]


def scenario_acme_order_state_machine(env):
    env.api.create(_issuer("le", {"acme": {"url": "https://acme.ex/dir"}}))
    env.api.create(_certificate(issuer="le", durationSeconds=3600))
    env.step(env.issuers)
    states = []
    for _ in range(3):
        env.step(env.certs)
        order = env.get("Certificate", "web")["status"]["order"]
        states.append(order["state"])
        if order["state"] == tapis.ORDER_PENDING:
            cm = env.get("ConfigMap", tops.ACME_CHALLENGE_CONFIGMAP)
            assert cm["data"]["web"] == order["token"]
    assert states == [tapis.ORDER_PENDING, tapis.ORDER_VALIDATED,
                      tapis.ORDER_ISSUED]
    assert "web" not in env.get("ConfigMap",
                                tops.ACME_CHALLENGE_CONFIGMAP)["data"]
    # Renewal opens a new order with a new token.
    env.now[0] = 1000.0 + 3600
    env.step(env.certs)
    status = env.get("Certificate", "web")["status"]
    assert status["order"]["state"] == tapis.ORDER_PENDING


def scenario_endpoint_records_into_zone(env):
    env.api.create(_endpoint("kf", "kf.example.com", "gateway.kubeflow"))
    env.step(env.endpoints)
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP, NS)["data"] == {
        "kf.example.com": "gateway.kubeflow"}
    assert env.get("Endpoint", "kf")["status"]["ready"] is True


def scenario_secure_entrypoint_prototypes_admitted(env):
    for obj in env.pkg["generate"]("secure-ingress",
                                   {"hostname": "kf.example.com"}):
        env.api.apply(obj)
    for obj in env.pkg["generate"]("cloud-endpoints",
                                   {"hostname": "kf.example.com",
                                    "target": "gateway.kubeflow"}):
        env.api.apply(obj)
    env.step(env.issuers, env.certs, env.endpoints)
    assert env.get("Certificate", "secure-gateway")["status"]["ready"]
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP, NS)["data"][
        "kf.example.com"] == "secure-gateway.kubeflow"


def scenario_endpoint_deletion_drops_zone_record(env):
    for i, host in enumerate(["a.example.com", "b.example.com"]):
        env.api.create(_endpoint(f"ep{i}", host, f"svc{i}.kubeflow"))
    env.step(env.endpoints)
    env.api.delete(CERTS, "Endpoint", "ep0", NS)
    env.step(env.endpoints)
    ep = env.get("Endpoint", "ep1")
    ep["spec"]["hostname"] = "c.example.com"
    env.api.update(ep)
    env.step(env.endpoints)
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP, NS)["data"] == {
        "c.example.com": "svc1.kubeflow"}
    env.api.delete(CERTS, "Endpoint", "ep1", NS)
    env.step(env.endpoints)
    assert env.get("ConfigMap", tapis.DNS_ZONE_CONFIGMAP,
                   NS)["data"] == {}


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controllers_equal_jax_on_the_same_crs_and_clock(name):
    records = {}
    for tag, pkg in (("jax", JAX), ("port", PORT)):
        env = Env(pkg)
        SCENARIOS[name](env)
        records[tag] = env.record
    assert records["port"] == records["jax"]
    assert records["port"]


# ---------------------------------------------------------------------------
# The prototypes
# ---------------------------------------------------------------------------

RENDERINGS = [
    ("cert-manager", {}),
    ("cert-manager", {"namespace": "team", "acme_email": "ops@example.com"}),
    ("secure-ingress", {}),
    ("secure-ingress", {"hostname": "localhost", "issuer": "letsencrypt",
                        "issuer_type": "acme"}),
    ("secure-ingress", {"disable_jwt_checking": True, "replicas": 1}),
    ("cloud-endpoints", {}),
    ("cloud-endpoints", {"hostname": "kf.example.com",
                         "target": "secure-gateway.kubeflow"}),
]


@pytest.mark.parametrize("proto,params", RENDERINGS,
                         ids=[f"{p}-{i}" for i, (p, _) in
                              enumerate(RENDERINGS)])
def test_prototype_renders_jax_objects_under_the_substitutions(proto,
                                                               params):
    text = json.dumps(jgenerate(proto, params))
    for jax_name, port_name in (
            (jimages.PLATFORM, images.TORCH_CUDA),
            ("kubeflow_tpu.gateway", "kubeflow_tpu_torch.gateway"),
            ("kubeflow_tpu.operators.certificate",
             "kubeflow_tpu_torch.operators.certificate")):
        text = text.replace(jax_name, port_name)
    got = tgenerate(proto, params)
    assert got == json.loads(text)
    rendered = json.dumps(got)
    assert images.GPU_RESOURCE not in rendered
    assert "kubeflow_tpu." not in rendered


@pytest.mark.parametrize("params", [{}, {"issuer_type": "acme"},
                                    {"disable_jwt_checking": True}],
                         ids=["selfSigned", "acme", "no-jwt"])
def test_prototypes_reconcile_to_ready_on_the_port(params):
    api = TFake()
    api.ensure_namespace(NS)
    for proto, p in (("cert-manager", {}),
                     ("secure-ingress", {"hostname": "localhost", **params}),
                     ("cloud-endpoints", {"hostname": "kf.example.com"})):
        for obj in tgenerate(proto, p):
            api.apply(obj)
    certs = tops.CertificateController(api)
    tops.IssuerController(api).reconcile_all()
    for _ in range(3 if params.get("issuer_type") == "acme" else 1):
        certs.reconcile_all()
    tops.EndpointController(api).reconcile_all()
    status = api.get(CERTS, "Certificate", "secure-gateway", NS)["status"]
    assert status["ready"] is True and status["dnsNames"] == ["localhost"]
    assert api.get("v1", "ConfigMap", tapis.DNS_ZONE_CONFIGMAP, NS)[
        "data"] == {"localhost": "secure-gateway.kubeflow",
                    "kf.example.com": "gateway.kubeflow"}


def test_cert_manager_lease_is_jaxs(monkeypatch):
    """``--leader-elect`` with no name elects on the lease JAX's
    ``controller_main`` derives for its cert-manager."""
    import kubeflow_tpu.operators.certificate as jcli
    import kubeflow_tpu_torch.operators.certificate as tcli

    seen = {}
    monkeypatch.setattr(jcli, "controller_main", lambda argv, make, desc:
                        seen.setdefault("jax", "-".join(desc.split()[:2])))
    monkeypatch.setattr(tcli, "manager_main", lambda *a, **kw:
                        seen.setdefault("port", kw["lease_name"]))
    jcli.main([])
    tcli.main([])
    assert seen["port"] == seen["jax"] == "kubeflow-tpu-certificate"


def test_cert_manager_cli_once_against_a_served_fake():
    """The rendered cert-manager container's command, ``--once``, against
    the port's fake served over HTTP: one pass of the three controllers
    issues the rendered Certificate and records the DNS zone."""
    api = TFake()
    api.ensure_namespace(NS)
    for proto, p in (("cert-manager", {}),
                     ("secure-ingress", {"hostname": "localhost"}),
                     ("cloud-endpoints", {})):
        for obj in tgenerate(proto, p):
            api.apply(obj)
    (dep,) = [o for o in tgenerate("cert-manager")
              if o["kind"] == "Deployment"]
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    httpd, port = k8s_fake.serve(api)
    try:
        proc = subprocess.run(
            [sys.executable, *c["command"][1:], *c["args"], "--once",
             "--metrics-port", "0"], cwd=REPO, capture_output=True,
            text=True, timeout=60,
            env={**os.environ, "KUBEFLOW_TPU_APISERVER":
                 f"http://127.0.0.1:{port}"})
    finally:
        httpd.shutdown()
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "reconciled": 4, "controllers": 3}
    status = api.get(CERTS, "Certificate", "secure-gateway", NS)["status"]
    assert status["ready"] is True and status["revision"] == 1
    pem = secret_data(api.get("v1", "Secret", "secure-gateway-tls",
                              NS))["tls.crt"]
    assert tpki.cert_info(pem)["serial"] == status["serial"]
    assert api.get("v1", "ConfigMap", tapis.DNS_ZONE_CONFIGMAP, NS)[
        "data"] == {"localhost": "secure-gateway.kubeflow",
                    "kubeflow.example.com": "gateway.kubeflow"}


# ---------------------------------------------------------------------------
# The port's gateway over the port's certificate
# ---------------------------------------------------------------------------


def _secret_files(api, name, tmp_path):
    """The TLS Secret as the files a kubelet's secret volume holds."""
    data = secret_data(api.get("v1", "Secret", name, NS))
    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
    cert.write_text(data["tls.crt"])
    key.write_text(data["tls.key"])
    return str(cert), str(key)


def test_gateway_serves_and_rotates_the_ports_certificate(tmp_path):
    from kubeflow_tpu_torch.gateway import Gateway, RouteTable

    api = TFake()
    api.ensure_namespace(NS)
    for crd in tapis.all_cert_crds():
        api.apply(crd)
    api.create(_issuer())
    api.create(_certificate("gw", durationSeconds=1000,
                            renewBeforeSeconds=200, dnsNames=["localhost"]))
    now = [0.0]
    tops.IssuerController(api).reconcile_all()
    ctrl = tops.CertificateController(api, clock=lambda: now[0])
    ctrl.reconcile_all()
    certfile, keyfile = _secret_files(api, "gw-tls", tmp_path)
    (tmp_path / "ca.pem").write_text(
        api.get(CERTS, "Issuer", "ca", NS)["status"]["caCertificate"])

    gw = Gateway(RouteTable(), port=0, admin_port=0, certfile=certfile,
                 keyfile=keyfile, cert_reload_seconds=0.1, redirect_port=0,
                 probe_interval=0,
                 challenge_lookup=lambda t: t if t == "tok123" else None)
    gw.start()
    port = gw.port
    try:
        client_ctx = ssl.create_default_context(
            cafile=str(tmp_path / "ca.pem"))

        def serial():
            with ssl.create_connection(("127.0.0.1", port)) as raw:
                with client_ctx.wrap_socket(
                        raw, server_hostname="localhost") as tls:
                    return format(int(tls.getpeercert()["serialNumber"],
                                      16), "x")

        assert serial() == api.get(CERTS, "Certificate", "gw",
                                   NS)["status"]["serial"]
        keep = http.client.HTTPSConnection("localhost", port,
                                           context=client_ctx, timeout=10)
        keep.request("GET", "/healthz")
        assert keep.getresponse().read() == b'{"status":"ok"}'

        now[0] = 900.0  # inside the renew window
        ctrl.reconcile_all()
        _secret_files(api, "gw-tls", tmp_path)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and gw.cert_reloads == 0:
            time.sleep(0.05)
        assert gw.cert_reloads >= 1
        status = api.get(CERTS, "Certificate", "gw", NS)["status"]
        assert status["revision"] == 2 and serial() == status["serial"]
        keep.request("GET", "/healthz")  # opened before the rotation
        assert keep.getresponse().read() == b'{"status":"ok"}'
        keep.close()

        plain = http.client.HTTPConnection("127.0.0.1", gw.redirect_port,
                                           timeout=10)
        plain.request("GET", "/some/path", headers={"Host": "kf.example"})
        resp = plain.getresponse()
        assert resp.status == 301
        assert resp.getheader("Location") == "https://kf.example/some/path"
        plain.close()

        chal = http.client.HTTPSConnection("localhost", port,
                                           context=client_ctx, timeout=10)
        chal.request("GET", "/.well-known/acme-challenge/tok123")
        assert chal.getresponse().read() == b"tok123"
        chal.request("GET", "/.well-known/acme-challenge/other")
        assert chal.getresponse().status == 404
        chal.close()
    finally:
        gw.stop()


def test_gateway_rotation_fails_no_handshake(tmp_path):
    """Handshakes that land while the gateway reloads a rotated pair all
    succeed: each reload loads a new context and swaps it in, where a
    reload into the live context failed about one handshake a rotation."""
    import socket
    import threading

    from kubeflow_tpu_torch.gateway import Gateway, RouteTable

    ca = tpki.make_ca("race root")
    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"

    def rotate():
        leaf = tpki.issue(ca, ["localhost"], duration_seconds=3600)
        cert.write_text(leaf.chain_pem)
        key.write_text(leaf.key_pem)
        return tpki.cert_info(leaf.cert_pem)["serial"]

    serial = rotate()
    (tmp_path / "ca.pem").write_text(ca.cert_pem)
    ctx = ssl.create_default_context(cafile=str(tmp_path / "ca.pem"))
    gw = Gateway(RouteTable(), port=0, admin_port=0, certfile=str(cert),
                 keyfile=str(key), cert_reload_seconds=0.02,
                 probe_interval=0)
    gw.start()
    seen, failures, stop = set(), [], threading.Event()

    def handshakes():
        while not stop.is_set():
            try:
                with socket.create_connection(("127.0.0.1", gw.port),
                                              timeout=10) as raw:
                    with ctx.wrap_socket(raw,
                                         server_hostname="localhost") as t:
                        seen.add(format(int(t.getpeercert()[
                            "serialNumber"], 16), "x"))
            except (ssl.SSLError, OSError) as e:
                failures.append(repr(e))

    clients = [threading.Thread(target=handshakes) for _ in range(2)]
    try:
        for c in clients:
            c.start()
        serials = [serial]
        for _ in range(5):
            time.sleep(0.15)
            serials.append(rotate())
        time.sleep(0.15)
    finally:
        stop.set()
        for c in clients:
            c.join()
        gw.stop()
    assert not failures, failures[:3]
    assert gw.cert_reloads >= 5 and serials[-1] in seen

