"""The port's API gateway (``kubeflow_tpu_torch/gateway/``) against the
JAX package's (``kubeflow_tpu/gateway/``).

Each case runs one scenario of JAX's gateway tests (``test_gateway_e2e``,
``test_jwt``, ``test_handoff``'s relay, ``test_qos``'s shedding,
``test_rollout``'s hash split) through a gateway of one package, over
real sockets, and asserts what JAX's test asserts. The ``torch`` case
also runs it through JAX's gateway (once per scenario and worker) and
holds the two records equal: on the same annotation, the same seeded
``rng`` and the same requests, the same backend sequence, statuses,
bodies, streamed chunks, headers (generated request ids aside) and admin
counter and family values.

Plain HTTP backends that a scenario does not kill are shared by both
runs (module scope), so routes over their addresses hash alike. The
servers of the relay and of the model-server case are the port's at
``lm-test-tiny``, float32, with JAX's initial weights
(``weights.params_from_numpy``); the last case puts JAX's gateway in
front of two JAX servers beside the port's in front of two port servers.
"""

import base64
import hashlib
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.gateway as jgateway  # noqa: E402
import kubeflow_tpu_torch.gateway as tgateway  # noqa: E402
from kubeflow_tpu.auth import tokens as jtokens  # noqa: E402
from kubeflow_tpu.auth.gatekeeper import (  # noqa: E402
    AuthService,
    make_server as make_auth_server,
)
from kubeflow_tpu.gateway import jwt_auth as jjwt  # noqa: E402
from kubeflow_tpu.gateway import resilience as jres  # noqa: E402
from kubeflow_tpu.gateway import routing as jrouting  # noqa: E402
from kubeflow_tpu.k8s import FakeApiServer as JaxFake  # noqa: E402
from kubeflow_tpu.manifests.core import (  # noqa: E402
    GATEWAY_ROUTE_ANNOTATION,
    gateway_route,
    generate as jgenerate,
)
from kubeflow_tpu_torch.auth import tokens as ttokens  # noqa: E402
from kubeflow_tpu_torch.gateway import jwt_auth as tjwt  # noqa: E402
from kubeflow_tpu_torch.gateway import resilience as tres  # noqa: E402
from kubeflow_tpu_torch.gateway import routing as trouting  # noqa: E402
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TorchFake  # noqa: E402,E501
from kubeflow_tpu_torch.serving.affinity import (  # noqa: E402
    prefix_affinity_key,
    rendezvous_pick,
)

ROOT = Path(__file__).resolve().parent.parent
PKGS = {
    "jax": SimpleNamespace(gw=jgateway, jwt=jjwt, tokens=jtokens, res=jres,
                           routing=jrouting, Fake=JaxFake),
    "torch": SimpleNamespace(gw=tgateway, jwt=tjwt, tokens=ttokens,
                             res=tres, routing=trouting, Fake=TorchFake),
}
FWS = ["jax", "torch"]
ISS = "https://gatekeeper.test"
AUD = "kubeflow-tpu"
_JAX_RECORDS: dict = {}


def same_as_jax(name: str, fw: str, run):
    """``run(pkg)``'s record for ``fw``; the torch record must equal the
    JAX one (computed here if this worker has not run it yet)."""
    if fw == "jax":
        _JAX_RECORDS[name] = run(PKGS["jax"])
        return _JAX_RECORDS[name]
    if name not in _JAX_RECORDS:
        _JAX_RECORDS[name] = run(PKGS["jax"])
    rec = run(PKGS["torch"])
    assert rec == _JAX_RECORDS[name]
    return rec


# ---------------------------------------------------------------------------
# Helpers: sockets, backends, the admin exposition
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(method, url, payload=None, headers=None, timeout=30):
    """(status, parsed JSON body, headers), HTTP errors included."""
    req = urllib.request.Request(
        url, method=method,
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}"), r.headers
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            body = json.loads(raw or b"{}")
        except ValueError:
            body = raw.decode(errors="replace")
        return e.code, body, e.headers


def raw_request(port: int, text: str) -> bytes:
    """Send ``text`` as-is; the response up to the server's close (or
    the head and what followed it when the connection stays open)."""
    client = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        client.sendall(text.encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = client.recv(4096)
            if not chunk:
                break
            resp += chunk
        client.settimeout(0.5)
        try:
            while True:
                chunk = client.recv(4096)
                if not chunk:
                    break
                resp += chunk
        except OSError:
            pass
        return resp
    finally:
        client.close()


def start_gateway(p, table, **kw):
    kw.setdefault("admin_port", free_port())
    gw = p.gw.Gateway(table, port=0, **kw)
    gw.start()
    return gw


def base_of(gw) -> str:
    return f"http://127.0.0.1:{gw._proxy.server_address[1]}"


def admin_values(gw) -> dict:
    """The admin exposition reduced to what must not depend on timing:
    every TYPE line, every counter and gauge value, and each histogram's
    ``_count``."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{gw.admin_port}/metrics", timeout=10) as r:
        text = r.read().decode()
    types, values = [], {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.append(line)
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            if not name.split("{")[0].endswith(("_bucket", "_sum")):
                values[name] = float(value)
    return {"types": sorted(types), "values": values}


def settled_admin(gw, timeout: float = 5.0) -> dict:
    """``admin_values`` once the mirrors still in flight have landed:
    two reads 50 ms apart agree, and every shadow counted has its
    latency observed."""
    last, deadline = admin_values(gw), time.time() + timeout
    while time.time() < deadline:
        time.sleep(0.05)
        now = admin_values(gw)
        observed = sum(v for k, v in now["values"].items() if k.startswith(
            "gateway_version_upstream_latency_seconds_count")
            and 'version="' in k)
        if now == last and observed >= gw.shadow_total:
            return now
        last = now
    return last


class IdentityBackend:
    """Answers with its own name; records each request's path and its
    X-Shadow header."""

    def __init__(self, name, port=0):
        self.name = name
        self.requests = []
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    self.rfile.read(n)
                outer.requests.append({
                    "path": self.path,
                    "shadow": self.headers.get("X-Shadow", "")})
                body = json.dumps({"variant": outer.name}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _reply

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), H)
        self.port = self.httpd.server_address[1]
        self.addr = f"127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class FailingBackend(IdentityBackend):
    """Always 500 (a broken model variant)."""

    def __init__(self):
        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self):
                body = b'{"error": "broken variant"}'
                self.send_response(500)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _reply

        self.name = "bad"
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.addr = f"127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()


class DigestBackend(IdentityBackend):
    """Reads its POST body and answers with its name, the body's length
    and sha256."""

    def __init__(self, name):
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                data = b""
                while len(data) < n:
                    chunk = self.rfile.read(n - len(data))
                    if not chunk:
                        break
                    data += chunk
                body = json.dumps({
                    "variant": outer.name, "len": len(data),
                    "sha": hashlib.sha256(data).hexdigest()}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.name = name
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.addr = f"127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()


@pytest.fixture(scope="module")
def backends():
    """The plain backends both gateways share."""
    made = {n: IdentityBackend(n) for n in ("a", "b", "c", "primary",
                                            "canary", "good")}
    made["bad"] = FailingBackend()
    made["da"], made["db"] = DigestBackend("a"), DigestBackend("b")
    yield made
    for be in made.values():
        be.close()


def fake_with(p, *objs):
    api = p.Fake()
    api.ensure_namespace("kubeflow")
    api.ensure_namespace("default")
    for obj in objs:
        api.apply(json.loads(json.dumps(obj)))
    return api


# ---------------------------------------------------------------------------
# Forward auth, TLS, the Upgrade tunnel, streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fw", FWS)
def test_forward_auth_with_gatekeeper(fw):
    def run(p):
        auth = AuthService("admin", hashlib.sha256(b"hunter2").hexdigest())
        auth_httpd = make_auth_server(auth, 0)
        threading.Thread(target=auth_httpd.serve_forever,
                         daemon=True).start()
        auth_port = auth_httpd.server_address[1]
        table = p.gw.RouteTable()
        table.set_routes([
            p.gw.Route("auth", "/login", f"127.0.0.1:{auth_port}",
                       rewrite="/login"),
            p.gw.Route("gk", "/gk/", f"127.0.0.1:{auth_port}",
                       rewrite="/")])
        gw = start_gateway(p, table,
                           auth_url=f"http://127.0.0.1:{auth_port}/auth")
        try:
            base = base_of(gw)
            no_session = call("GET", f"{base}/gk/healthz")[:2]
            from http.client import HTTPConnection

            conn = HTTPConnection("127.0.0.1", auth_port)
            conn.request("POST", "/login",
                         b"username=admin&password=hunter2",
                         {"Content-Type":
                          "application/x-www-form-urlencoded"})
            resp = conn.getresponse()
            cookie = resp.getheader("Set-Cookie").split(";")[0]
            conn.close()
            with_session = call("GET", f"{base}/gk/healthz",
                                headers={"Cookie": cookie})[:2]
            return {"no_session": no_session, "session": with_session,
                    "admin": admin_values(gw)}
        finally:
            gw.stop()
            auth_httpd.shutdown()

    rec = same_as_jax("forward_auth", fw, run)
    assert rec["no_session"][0] == 401
    assert rec["session"] == (200, {"status": "ok"})


@pytest.mark.parametrize("fw", FWS)
def test_tls_termination(fw, tmp_path):
    import ssl

    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost"], check=True, capture_output=True)

    def run(p):
        gw = start_gateway(p, p.gw.RouteTable(), certfile=str(cert),
                           keyfile=str(key))
        port = gw._proxy.server_address[1]
        try:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            with urllib.request.urlopen(f"https://127.0.0.1:{port}/healthz",
                                        context=ctx) as r:
                tls = (r.status, json.loads(r.read()))
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                       timeout=5)
                plain_refused = False
            except Exception:
                plain_refused = True
            return {"tls": tls, "plain_refused": plain_refused}
        finally:
            gw.stop()

    rec = same_as_jax("tls", fw, run)
    assert rec == {"tls": (200, {"status": "ok"}), "plain_refused": True}


def _ws_accept(key: str) -> str:
    guid = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
    return base64.b64encode(
        hashlib.sha1((key + guid).encode()).digest()).decode()


class WsEchoServer:
    """Minimal RFC6455 echo backend: a real handshake, then every masked
    text frame echoed back unmasked."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.handshake_headers = []
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._session, args=(conn,),
                             daemon=True).start()

    def _session(self, conn):
        try:
            data = b""
            while b"\r\n\r\n" not in data:
                data += conn.recv(4096)
            head = data.split(b"\r\n\r\n", 1)[0].decode()
            headers = {}
            for line in head.split("\r\n")[1:]:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            self.handshake_headers.append(headers)
            conn.sendall((
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: "
                f"{_ws_accept(headers['sec-websocket-key'])}\r\n\r\n"
            ).encode())
            while True:
                hdr = conn.recv(2)
                if len(hdr) < 2:
                    return
                ln = hdr[1] & 0x7F
                mask = conn.recv(4)
                payload = bytearray(conn.recv(ln))
                for i in range(ln):
                    payload[i] ^= mask[i % 4]
                conn.sendall(bytes([0x81, ln]) + bytes(payload))
        except OSError:
            pass

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("fw", FWS)
def test_websocket_echo_through_gateway(fw):
    key = base64.b64encode(b"0123456789abcdef").decode()
    msg = b"ping-through-gateway"
    mask = b"\x01\x02\x03\x04"

    def run(p):
        echo = WsEchoServer()
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(name="nb", prefix="/nb/",
                                     service=f"127.0.0.1:{echo.port}")])
        gw = start_gateway(p, table)
        try:
            port = gw._proxy.server_address[1]
            client = socket.create_connection(("127.0.0.1", port),
                                              timeout=10)
            client.sendall((
                f"GET /nb/kernel HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n").encode())
            resp = b""
            while b"\r\n\r\n" not in resp:
                resp += client.recv(4096)
            masked = bytes(b ^ mask[i % 4] for i, b in enumerate(msg))
            client.sendall(bytes([0x81, 0x80 | len(msg)]) + mask + masked)
            frame = b""
            while len(frame) < 2 + len(msg):
                frame += client.recv(4096)
            client.close()
            return {"status": resp.split(b"\r\n", 1)[0],
                    "accepted": _ws_accept(key).encode() in resp,
                    "frame": frame,
                    "prefix": echo.handshake_headers[0][
                        "x-forwarded-prefix"],
                    "tunnels": gw.tunnels_total}
        finally:
            gw.stop()
            echo.close()

    rec = same_as_jax("websocket", fw, run)
    assert b"101" in rec["status"] and rec["accepted"]
    assert rec["frame"][0] == 0x81 and rec["frame"][2:] == msg
    assert rec["prefix"] == "/nb/" and rec["tunnels"] == 1


@pytest.mark.parametrize("fw", FWS)
def test_streaming_chunked_response_not_buffered(fw):
    import http.client

    def run(p):
        release = threading.Event()

        class SlowChunks(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for i, wait in ((0, False), (1, True)):
                    if wait:
                        release.wait(timeout=10)
                    data = f"data: tok{i}\n\n".encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                     + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")

        backend = ThreadingHTTPServer(("127.0.0.1", 0), SlowChunks)
        threading.Thread(target=backend.serve_forever, daemon=True).start()
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="s", prefix="/stream/",
            service=f"127.0.0.1:{backend.server_address[1]}")])
        gw = start_gateway(p, table)
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", gw._proxy.server_address[1], timeout=10)
            conn.request("GET", "/stream/events")
            resp = conn.getresponse()
            # Read while the backend still holds its second chunk.
            first = resp.read1(65536)
            release.set()
            rest = b""
            while True:
                data = resp.read1(65536)
                if not data:
                    break
                rest += data
            conn.close()
            return {"status": resp.status,
                    "type": resp.getheader("Content-Type"),
                    "first": first, "rest": rest}
        finally:
            release.set()
            gw.stop()
            backend.shutdown()

    rec = same_as_jax("streaming", fw, run)
    assert rec["status"] == 200 and b"tok0" in rec["first"]
    assert b"tok1" in rec["rest"] and b"tok1" not in rec["first"]


# ---------------------------------------------------------------------------
# Traffic splitting, the bandit, shadows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fw", FWS)
def test_weighted_traffic_split_through_gateway(fw, backends):
    objs = [*jgenerate("tpu-serving", {"name": "bert", "model_path": ""}),
            jgenerate("serving-route", {
                "name": "bert", "canary_service": "bert-v2.kubeflow:8500",
                "canary_weight": 10})[0]]
    resolve = {"bert.kubeflow:8500": backends["primary"].addr,
               "bert-v2.kubeflow:8500": backends["canary"].addr}

    def run(p):
        table = p.gw.RouteTable()
        n = table.refresh(fake_with(p, *objs))
        gw = start_gateway(p, table, resolve=lambda a: resolve.get(a, a),
                           rng=random.Random(7))
        try:
            base = base_of(gw)
            hits = [call("GET", f"{base}/models/bert/v1/models")[1]
                    ["variant"] for _ in range(100)]
            return {"routes": n, "hits": hits, "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("weighted", fw, run)
    assert rec["routes"] == 2
    assert 80 <= rec["hits"].count("primary") <= 97
    assert 3 <= rec["hits"].count("canary") <= 20
    assert rec["admin"]["values"]["gateway_requests_total"] == 100
    assert rec["admin"]["values"][
        'gateway_upstream_latency_seconds_count{route="bert-route"}'] == 100


@pytest.mark.parametrize("fw", FWS)
def test_epsilon_greedy_bandit_routes_around_failures(fw, backends):
    svc = jgenerate("serving-route", {
        "name": "bert", "canary_service": "bert-v2.kubeflow:8500",
        "strategy": "epsilon-greedy", "epsilon": 0.2})[0]
    resolve = {"bert.kubeflow:8500": backends["good"].addr,
               "bert-v2.kubeflow:8500": backends["bad"].addr}

    def run(p):
        table = p.gw.RouteTable()
        table.refresh(fake_with(p, svc))
        gw = start_gateway(p, table, resolve=lambda a: resolve.get(a, a),
                           rng=random.Random(11))
        try:
            base = base_of(gw)
            statuses = [call("GET", f"{base}/models/bert/v1/models")[0]
                        for _ in range(100)]
            return {"statuses": statuses,
                    "stats": gw.bandit.snapshot("bert-route"),
                    "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("bandit", fw, run)
    assert rec["statuses"].count(500) <= 25
    assert rec["statuses"].count(200) >= 75
    stats = rec["stats"]
    assert stats["bert.kubeflow:8500"]["mean"] == 1.0
    assert stats["bert-v2.kubeflow:8500"]["mean"] == 0.0


@pytest.mark.parametrize("fw", FWS)
def test_bandit_feedback_endpoint_steers_routing(fw, backends):
    a, b = backends["a"], backends["b"]

    def run(p):
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="m", prefix="/m/", service=a.addr,
            backends=((a.addr, 1), (b.addr, 1)),
            strategy="epsilon-greedy", epsilon=0.0)])
        gw = start_gateway(p, table, rng=random.Random(3))
        try:
            admin = f"http://127.0.0.1:{gw.admin_port}"
            fb = [call("POST", f"{admin}/routes/m/feedback",
                       {"service": a.addr, "reward": 0.2})[:2],
                  call("POST", f"{admin}/routes/m/feedback",
                       {"service": b.addr, "reward": 1.0})[:2]]
            hits = [call("GET", f"{base_of(gw)}/m/x")[1]["variant"]
                    for _ in range(20)]
            routes = call("GET", f"{admin}/routes")[1]
            bad = [call("POST", f"{admin}/routes/{path}/feedback",
                        payload)[:2]
                   for path, payload in (
                       ("m", {"service": a.addr, "reward": 2.0}),
                       ("m", {"service": "typo:8500", "reward": 0.5}),
                       ("ghost", {"service": a.addr, "reward": 0.5}))]
            return {"feedback": fb, "hits": hits, "routes": routes,
                    "bad": bad, "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("feedback", fw, run)
    assert all(code == 200 and out["ok"] for code, out in rec["feedback"])
    assert rec["hits"] == ["b"] * 20
    (m,) = [r for r in rec["routes"] if r["name"] == "m"]
    assert m["bandit"][b.addr]["trials"] >= 20
    assert [code for code, _ in rec["bad"]] == [400, 400, 404]


@pytest.mark.parametrize("fw", FWS)
def test_shadow_mirror_through_gateway(fw):
    def run(p):
        primary, shadow = IdentityBackend("primary"), IdentityBackend("sh")
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(name="m", prefix="/m/",
                                     service=primary.addr,
                                     shadow=shadow.addr)])
        gw = start_gateway(p, table)
        try:
            base = base_of(gw)
            first = call("POST", f"{base}/m/predict", {"x": 1})[1]
            for _ in range(100):  # the mirror is asynchronous
                if shadow.requests:
                    break
                time.sleep(0.02)
            mirrored = list(shadow.requests)
            shadow.close()
            second = call("POST", f"{base}/m/predict", {"x": 2})[1]
            return {"answers": [first, second], "mirrored": mirrored,
                    "primary": primary.requests, "shadows": gw.shadow_total}
        finally:
            gw.stop()
            primary.close()

    rec = same_as_jax("shadow", fw, run)
    assert rec["answers"] == [{"variant": "primary"}] * 2
    assert rec["mirrored"][0]["shadow"] == "true"
    assert rec["primary"][0]["shadow"] == ""


# ---------------------------------------------------------------------------
# Health, outliers, malformed lengths, request ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fw", FWS)
def test_upstream_health_eject_halfopen_recover(fw):
    def run(p):
        now = [0.0]
        h = p.gw.UpstreamHealth(failure_threshold=3, ejection_seconds=10,
                                clock=lambda: now[0])
        svc, seen = "m.kubeflow:8500", []

        def at(t=None):
            if t is not None:
                now[0] = t
            seen.append(h.admits(svc))

        at()
        for _ in range(3):
            h.record_failure(svc)
        at()
        seen.append(h.filter_healthy([svc, "other"]))
        seen.append(h.filter_healthy([svc]))
        at(11)
        h.begin_trial(svc)
        at()
        h.record_failure(svc)
        at()
        at(22)
        at(32)
        h.begin_trial(svc)
        h.record_success(svc)
        at()
        seen.append(h.snapshot()[svc])
        for _ in range(3):
            h.record_failure(svc)
        now[0] = 60
        h.begin_trial(svc)
        at()
        at(95)
        h.set_warming(svc, True)
        at()
        h.set_warming(svc, False)
        at()
        return seen

    seen = same_as_jax("health_machine", fw, run)
    assert seen[:2] == [True, False]
    assert seen[2:4] == [["other"], ["m.kubeflow:8500"]]
    assert seen[4:9] == [True, False, False, False, True]
    assert seen[9] is True and seen[10]["ejections"] == 0
    assert seen[11:] == [False, True, False, True]


@pytest.mark.parametrize("fw", FWS)
def test_traffic_shifts_on_upstream_death_and_returns(fw):
    def run(p):
        a, b = IdentityBackend("a"), IdentityBackend("b")
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="m", prefix="/m/", service=a.addr,
            backends=((a.addr, 1), (b.addr, 1)))])
        gw = start_gateway(p, table, probe_interval=0.2,
                           rng=random.Random(5))
        try:
            base = base_of(gw)

            def hit():
                code, out, _ = call("GET", f"{base}/m/x")
                return code, out.get("variant")

            before = [hit()[1] for _ in range(20)]
            b_port, b_addr = b.port, b.addr
            b.close()
            deadline = time.time() + 5
            while time.time() < deadline and gw.health.snapshot().get(
                    b_addr, {}).get("healthy", True):
                time.sleep(0.05)
            ejected = not gw.health.snapshot()[b_addr]["healthy"]
            after = [hit() for _ in range(20)]
            upstream = call("GET", f"http://127.0.0.1:{gw.admin_port}"
                                   "/upstreams")[1][b_addr]["healthy"]
            b2 = IdentityBackend("b", port=b_port)
            try:
                deadline, seen = time.time() + 10, set()
                while time.time() < deadline and "b" not in seen:
                    seen.add(hit()[1])
                    time.sleep(0.05)
            finally:
                b2.close()
            return {"before": before, "ejected": ejected, "after": after,
                    "upstream_healthy": upstream, "recovered": seen}
        finally:
            gw.stop()
            a.close()

    rec = same_as_jax("death_and_return", fw, run)
    assert set(rec["before"]) == {"a", "b"} and rec["ejected"]
    assert rec["after"] == [(200, "a")] * 20
    assert rec["upstream_healthy"] is False
    assert rec["recovered"] == {"a", "b"}


@pytest.mark.parametrize("fw", FWS)
def test_outlier_route_flags_injected_anomalies(fw, backends):
    svc = jgenerate("serving-route", {
        "name": "bert", "outlier_threshold": 3.0, "outlier_window": 50})[0]
    addr = backends["c"].addr

    def run(p):
        table = p.gw.RouteTable()
        table.refresh(fake_with(p, svc))
        gw = start_gateway(p, table, probe_interval=0,
                           resolve=lambda a: addr, rng=random.Random(3))
        try:
            base = base_of(gw)

            def predict(values):
                code, _out, headers = call(
                    "POST", f"{base}/models/bert/v1/models/bert:predict",
                    {"instances": [values]})
                return code, headers["X-Outlier"], headers["X-Outlier-Score"]

            rng = random.Random(0)
            tags = [predict([1.0 + rng.uniform(-0.1, 0.1)
                             for _ in range(8)]) for _ in range(30)]
            tags.append(predict([400.0] * 8))
            tags.append(predict([1.0] * 8))
            return {"tags": tags,
                    "stats": gw.outliers.snapshot("bert-route"),
                    "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("outliers", fw, run)
    assert all(t[:2] == (200, "false") for t in rec["tags"][:30])
    assert rec["tags"][30][1] == "true" and float(rec["tags"][30][2]) > 3
    assert rec["tags"][31][1] == "false"
    assert rec["stats"]["outliers"] == 1 and rec["stats"]["scored"] == 32


@pytest.mark.parametrize("fw", FWS)
def test_malformed_client_content_length_is_400(fw, backends):
    addr = backends["c"].addr

    def run(p):
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(name="m", prefix="/m/", service=addr)])
        gw = start_gateway(p, table)
        try:
            port = gw._proxy.server_address[1]
            resp = raw_request(port, (
                f"POST /m/x HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                "Content-Length: abc\r\n\r\n"))
            after = call("POST", f"http://127.0.0.1:{port}/m/x",
                         {"a": 1})[:2]
            return {"status": resp.split(b"\r\n", 1)[0],
                    "body": resp.split(b"\r\n\r\n", 1)[1],
                    "after": after, "errors": gw.errors_total}
        finally:
            gw.stop()

    rec = same_as_jax("malformed_client", fw, run)
    assert b" 400 " in rec["status"] + b" "
    assert b"malformed Content-Length" in rec["body"]
    assert rec["after"] == (200, {"variant": "c"}) and rec["errors"] >= 1


@pytest.mark.parametrize("fw", FWS)
def test_malformed_upstream_content_length_is_502(fw):
    def run(p):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.listen(8)

        def serve():
            while True:
                try:
                    conn, _ = sock.accept()
                except OSError:
                    return
                try:
                    data = b""
                    while b"\r\n\r\n" not in data:
                        chunk = conn.recv(4096)
                        if not chunk:
                            break
                        data += chunk
                    conn.sendall(b"HTTP/1.1 200 OK\r\n"
                                 b"Content-Length: banana\r\n\r\nhello")
                    conn.close()
                except OSError:
                    pass

        threading.Thread(target=serve, daemon=True).start()
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="u", prefix="/u/",
            service=f"127.0.0.1:{sock.getsockname()[1]}")])
        gw = start_gateway(p, table)
        try:
            code, body, _ = call(
                "GET", f"http://127.0.0.1:{gw._proxy.server_address[1]}"
                       "/u/x")
            return {"code": code, "body": body, "errors": gw.errors_total}
        finally:
            gw.stop()
            sock.close()

    rec = same_as_jax("malformed_upstream", fw, run)
    assert rec["code"] == 502 and "malformed upstream" in rec["body"]["error"]
    assert rec["errors"] >= 1


@pytest.mark.parametrize("fw", FWS)
def test_request_id_generated_preserved_echoed_forwarded(fw):
    def run(p):
        seen_ids = []

        class Capture(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                seen_ids.append(self.headers.get("X-Request-ID"))
                body = b'{"ok": true}'
                self.send_response(200)
                self.send_header("X-Request-ID",
                                 self.headers.get("X-Request-ID", ""))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        backend = ThreadingHTTPServer(("127.0.0.1", 0), Capture)
        threading.Thread(target=backend.serve_forever, daemon=True).start()
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="m", prefix="/m/",
            service=f"127.0.0.1:{backend.server_address[1]}")])
        gw = start_gateway(p, table)

        def rids(path, extra=""):
            port = gw._proxy.server_address[1]
            resp = raw_request(port, (
                f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                f"{extra}Connection: close\r\n\r\n"))
            head = resp.split(b"\r\n\r\n", 1)[0].decode()
            return [ln.split(":", 1)[1].strip()
                    for ln in head.split("\r\n")
                    if ln.lower().startswith("x-request-id:")]

        try:
            generated = rids("/m/x")
            out = {"generated_once": len(generated) == 1 and
                   bool(generated[0]),
                   "generated_forwarded": seen_ids == generated,
                   "preserved": rids("/m/x",
                                     "X-Request-ID: client-chosen-42\r\n"),
                   "forwarded": seen_ids[-1],
                   "health": rids("/healthz", "X-Request-ID: health-7\r\n")}
            out["traced"] = [r["status"] for r in
                             gw.trace.find("client-chosen-42")]
            return out
        finally:
            gw.stop()
            backend.shutdown()

    rec = same_as_jax("request_ids", fw, run)
    assert rec["generated_once"] and rec["generated_forwarded"]
    assert rec["preserved"] == ["client-chosen-42"]
    assert rec["forwarded"] == "client-chosen-42"
    assert rec["health"] == ["health-7"]
    assert rec["traced"] and "open" not in rec["traced"]


# ---------------------------------------------------------------------------
# KV fill, prefix-affine placement, long and oversized bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fw", FWS)
def test_kv_fill_cache_staleness_and_no_signal(fw):
    def run(p):
        clock, fills = {"t": 0.0}, {"b1": 0.9}
        cache = p.res.KvFillCache(ttl=5.0, fetch=lambda a: fills.get(a),
                                  clock=lambda: clock["t"])

        def settle(service):
            t0 = time.monotonic()
            while time.monotonic() - t0 < 5:
                with cache._lock:
                    if not cache._cells[service]["refreshing"]:
                        return
                time.sleep(0.01)
            raise AssertionError("refresh never settled")

        seen = [cache.fill("b1")]
        settle("b1")
        seen += [cache.fill("b1"), cache.scrapes]
        clock["t"] += 2
        seen += [cache.fill("b1"), cache.scrapes]
        clock["t"] += 10
        fills["b1"] = 0.2
        seen.append(cache.fill("b1"))
        settle("b1")
        seen.append(cache.fill("b1"))
        fills.pop("b1")
        clock["t"] += 10
        seen.append(cache.fill("b1"))
        settle("b1")
        clock["t"] += 11
        cache.fill("b1")
        settle("b1")
        seen += [cache.fill("b1"), cache.fill("b2")]
        settle("b2")
        seen += [cache.fill("b2"), cache.snapshot()]
        return seen

    seen = same_as_jax("kv_fill", fw, run)
    assert seen[:9] == [None, 0.9, 1, 0.9, 1, 0.9, 0.2, 0.2, None]
    assert seen[9:11] == [None, None]


def _pool_service(**route_kw):
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": "pool", "namespace": "kubeflow",
                         "annotations": gateway_route(
                             "pool", "/models/m/", "m-r0.kubeflow:8500",
                             backends=[
                                 {"service": "m-r0.kubeflow:8500",
                                  "weight": 1},
                                 {"service": "m-r1.kubeflow:8500",
                                  "weight": 1}],
                             strategy="prefix-affine", affinity_tokens=4,
                             **route_kw)}}


@pytest.mark.parametrize("fw", FWS)
def test_affine_kv_pressure_spills_to_less_full_backend(fw, backends):
    svc = _pool_service(pressure=0, kv_pressure=0.8)
    resolve = {"m-r0.kubeflow:8500": backends["a"].addr,
               "m-r1.kubeflow:8500": backends["b"].addr}

    def run(p):
        table = p.gw.RouteTable()
        table.refresh(fake_with(p, svc))
        gw = p.gw.Gateway(table, port=0, admin_port=free_port(),
                          probe_interval=0,
                          resolve=lambda a: resolve.get(a, a))
        fills: dict = {}

        class StubFill:
            scrapes = 0
            scrape_failures = 0

            def fill(self, service, resolve=None):
                return fills.get(service)

            def snapshot(self):
                return dict(fills)

        gw.kv_fill = StubFill()
        gw.start()
        try:
            def predict(tokens):
                return call("POST", f"{base_of(gw)}/models/m/v1/models/"
                            "m:predict",
                            {"instances": [{"tokens": tokens}]})[1][
                                "variant"]

            toks = [1, 2, 3, 4]
            home = predict(toks)
            home_svc, other_svc = (
                ("m-r0.kubeflow:8500", "m-r1.kubeflow:8500")
                if home == "a" else
                ("m-r1.kubeflow:8500", "m-r0.kubeflow:8500"))
            seq = [home, predict(toks), gw.affine_spills]
            fills.update({home_svc: 0.95, other_svc: 0.3})
            seq += [predict(toks), gw.affine_spills]
            fills[other_svc] = 0.97
            seq.append(predict(toks))
            fills.update({home_svc: 0.2, other_svc: 0.3})
            seq.append(predict(toks))
            metricsz = call("GET", f"http://127.0.0.1:{gw.admin_port}"
                                   "/metricsz")[1]
            return {"seq": seq, "metricsz": metricsz,
                    "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("kv_pressure", fw, run)
    home, again, spills0, spilled, spills1, full, back = rec["seq"]
    assert again == home and spills0 == 0
    assert spilled != home and spills1 == 1
    assert full == home and back == home


@pytest.mark.parametrize("fw", FWS)
def test_prefix_affine_routing_through_gateway(fw):
    svc = _pool_service(pressure=0)

    def run(p):
        a, b = IdentityBackend("a"), IdentityBackend("b")
        resolve = {"m-r0.kubeflow:8500": a.addr,
                   "m-r1.kubeflow:8500": b.addr}
        table = p.gw.RouteTable()
        table.refresh(fake_with(p, svc))
        gw = start_gateway(p, table, probe_interval=0,
                           resolve=lambda x: resolve.get(x, x),
                           health=p.gw.UpstreamHealth(
                               failure_threshold=1, ejection_seconds=30.0))
        try:
            def predict(tokens):
                code, out, _ = call(
                    "POST", f"{base_of(gw)}/models/m/v1/models/m:predict",
                    {"instances": [{"tokens": tokens}]})
                return out.get("variant") if code == 200 else code

            group1 = [predict([1, 2, 3, 4, 9 + i]) for i in range(6)]
            spread = [predict([s, s + 1, 5, 6]) for s in range(16)]
            home1 = group1[0]
            other = next([s, s + 1, 5, 6] for s in range(16)
                         if spread[s] != home1)
            (a if home1 == "a" else b).close()
            after = [predict([1, 2, 3, 4, 99]),
                     predict([1, 2, 3, 4, 100]),
                     *[predict(other) for _ in range(3)]]
            return {"group1": group1, "spread": spread, "after": after,
                    "metricsz": call("GET", f"http://127.0.0.1:"
                                     f"{gw.admin_port}/metricsz")[1]}
        finally:
            gw.stop()
            for be in (a, b):
                try:
                    be.close()
                except Exception:
                    pass

    rec = same_as_jax("prefix_affine", fw, run)
    assert len(set(rec["group1"])) == 1
    assert set(rec["spread"]) == {"a", "b"}
    survivor = "b" if rec["group1"][0] == "a" else "a"
    assert rec["after"] == [502] + [survivor] * 4
    # The spill-free placement is the rendezvous pick of the prompt's
    # leading tokens over the route's backends.
    members = ["m-r0.kubeflow:8500", "m-r1.kubeflow:8500"]
    for s, got in enumerate(rec["spread"]):
        want = rendezvous_pick(prefix_affinity_key([s, s + 1, 5, 6], 4),
                               members)
        assert got == ("a" if want == members[0] else "b")


@pytest.mark.parametrize("fw", FWS)
def test_long_body_spills_past_affinity_head(fw, backends):
    da, db = backends["da"], backends["db"]
    toks = [7, 11, 13, 17, 19, 23]
    long_body = (b'{"instances": [{"tokens": ' + json.dumps(toks).encode()
                 + b', "pad": "' + b"x" * (1 << 20) + b'"}]}')
    junk = b"\x00\x01" * (1 << 19)

    def run(p):
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="long", prefix="/long/", service=da.addr,
            backends=((da.addr, 1), (db.addr, 1)),
            strategy="prefix-affine")])
        gw = start_gateway(p, table, probe_interval=0)
        try:
            url = f"{base_of(gw)}/long/x:predict"
            short = call("POST", url, {"instances": [{"tokens": toks}]})[1]
            replies = []
            for data in (long_body, junk, junk):
                req = urllib.request.Request(url, data=data, method="POST")
                with urllib.request.urlopen(req, timeout=30) as resp:
                    replies.append(json.loads(resp.read()))
            return {"short": short, "replies": replies}
        finally:
            gw.stop()

    rec = same_as_jax("long_body", fw, run)
    long_reply, junk1, junk2 = rec["replies"]
    assert long_reply["len"] == len(long_body)
    assert long_reply["sha"] == hashlib.sha256(long_body).hexdigest()
    assert long_reply["variant"] == rec["short"]["variant"]
    assert junk1["variant"] == junk2["variant"]


@pytest.mark.parametrize("fw", FWS)
def test_max_body_bytes_rejects_oversized_declared_body(fw, backends):
    addr = backends["da"].addr

    def run(p):
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(name="cap", prefix="/cap/",
                                     service=addr)])
        gw = start_gateway(p, table, probe_interval=0,
                           max_body_bytes=1 << 20)
        try:
            port = gw._proxy.server_address[1]
            resp = raw_request(port, (
                f"POST /cap/x HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                f"Content-Length: {64 << 20}\r\n\r\n"))
            within = call("POST", f"http://127.0.0.1:{port}/cap/x",
                          {"a": 1})[:2]
            return {"status": resp.split(b"\r\n", 1)[0],
                    "body": resp.split(b"\r\n\r\n", 1)[1],
                    "rejected": gw.body_rejected_total, "within": within,
                    "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("max_body", fw, run)
    assert b" 413 " in rec["status"] + b" "
    assert b"max_body_bytes" in rec["body"] and rec["rejected"] == 1
    assert rec["within"][0] == 200 and rec["within"][1]["len"] > 0


# ---------------------------------------------------------------------------
# QoS shedding and the version hash split
# ---------------------------------------------------------------------------


def _raw_post(port, path, payload, headers=None):
    body = json.dumps(payload).encode()
    head = (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: "
            f"application/json\r\nContent-Length: {len(body)}\r\n"
            "Connection: close\r\n")
    for k, v in (headers or {}).items():
        head += f"{k}: {v}\r\n"
    resp = raw_request(port, head + "\r\n" + body.decode())
    blob, _, rest = resp.partition(b"\r\n\r\n")
    lines = blob.decode().split("\r\n")
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split(" ")[1]), hdrs.get("retry-after"), rest


@pytest.mark.parametrize("fw", FWS)
def test_gateway_sheds_429_with_retry_after(fw, backends):
    be = backends["c"]

    def run(p):
        before = len(be.requests)
        table = p.gw.RouteTable()
        table.set_routes([p.gw.Route(
            name="m", prefix="/models/m/", service=be.addr,
            backends=((be.addr, 1.0),),
            qos_tenants=(("capped", 1.0, 1.0),))])
        gw = start_gateway(p, table, probe_interval=0)
        try:
            port = gw.port
            out = [_raw_post(port, "/models/m/x", {"a": 1},
                             {"X-Tenant": "capped"}),
                   _raw_post(port, "/models/m/x", {"a": 1},
                             {"X-Tenant": "capped"}),
                   _raw_post(port, "/models/m/x", {"a": 1},
                             {"X-Tenant": "other"})]
            reached = len(be.requests) - before
            table.set_routes([p.gw.Route(
                name="m", prefix="/models/m/", service=be.addr,
                backends=((be.addr, 1.0),), pressure=1,
                qos_default_rate=1000.0, qos_default_burst=1000.0)])
            gw.load.acquire(be.addr)
            try:
                out.append(_raw_post(port, "/models/m/x", {"a": 1}))
            finally:
                gw.load.release(be.addr)
            out.append(_raw_post(port, "/models/m/x", {"a": 1}))
            return {"out": out, "reached": reached,
                    "shed": gw.qos_shed_total, "admin": admin_values(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("qos_shed", fw, run)
    codes = [o[0] for o in rec["out"]]
    assert codes == [200, 429, 200, 429, 200]
    assert int(rec["out"][1][1]) >= 1 and b"over admission rate" in \
        rec["out"][1][2]
    assert rec["out"][3][1] == "1" and b"saturated" in rec["out"][3][2]
    assert rec["reached"] == 2 and rec["shed"] == 2


def _split_route(p, **kw):
    return p.gw.Route(
        name="r", prefix="/models/m/", service="a:1", strategy="hash-split",
        backends=(("a:1", 1.0), ("b:1", 1.0), ("c:1", 1.0)),
        splits=(("v1", kw.get("w_v1", 90.0), ("a:1", "b:1")),
                ("v2", kw.get("w_v2", 10.0), ("c:1",))),
        shadow="c:1", shadow_fraction=kw.get("shadow_fraction", 1.0))


@pytest.mark.parametrize("fw", FWS)
def test_hash_split_route_mechanics(fw):
    keys = [f"prefix-{i}".encode() for i in range(2000)]

    def run(p):
        r = _split_route(p)
        return {"splits": [r.pick_split(k)[0] for k in keys],
                "zero": {_split_route(p, w_v1=100.0, w_v2=0.0)
                         .pick_split(k)[0] for k in keys},
                "mirror": [_split_route(p, shadow_fraction=0.25)
                           .mirror_sample(k) for k in keys],
                "versions": [r.version_of(s) for s in ("a:1", "c:1", "x")],
                "hash": [p.routing.stable_hash01(k, b"s:")
                         for k in keys[:50]]}

    rec = same_as_jax("split_mechanics", fw, run)
    assert 0.06 < rec["splits"].count("v2") / len(keys) < 0.14
    assert rec["zero"] == {"v1"}
    assert 0.19 < sum(rec["mirror"]) / len(keys) < 0.31
    assert rec["versions"] == ["v1", "v2", ""]


@pytest.mark.parametrize("fw", FWS)
def test_version_hash_split_through_gateway(fw, backends):
    """The progressive-delivery route as the rollout controller renders
    it: each prompt lands on one version group by the stable hash of its
    affinity key, the version families count it, the sampled shadow
    mirrors it."""
    import yaml

    spec = {"name": "llm", "prefix": "/models/llm/",
            "service": "llm-r0.kubeflow:8500", "strategy": "hash-split",
            "affinity_tokens": 4,
            "backends": [{"service": f"llm-r{i}.kubeflow:8500"}
                         for i in range(3)],
            "splits": [{"version": "v1", "weight": 70,
                        "backends": ["llm-r0.kubeflow:8500",
                                     "llm-r1.kubeflow:8500"]},
                       {"version": "v2", "weight": 30,
                        "backends": ["llm-r2.kubeflow:8500"]}],
            "shadow": "llm-r2.kubeflow:8500", "shadow_fraction": 0.5}
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "llm-router", "namespace": "kubeflow",
                        "annotations": {GATEWAY_ROUTE_ANNOTATION:
                                        yaml.safe_dump(spec)}}}
    resolve = {f"llm-r{i}.kubeflow:8500": backends[n].addr
               for i, n in enumerate("abc")}

    def run(p):
        table = p.gw.RouteTable()
        table.refresh(fake_with(p, svc))
        gw = start_gateway(p, table, probe_interval=0,
                           resolve=lambda a: resolve.get(a, a))
        try:
            url = f"{base_of(gw)}/models/llm/v1/models/llm:predict"
            served = [call("POST", url,
                           {"instances": [{"tokens": [s, 2, 3, 4, 5]}]})[1]
                      ["variant"] for s in range(40)]
            return {"served": served, "admin": settled_admin(gw)}
        finally:
            gw.stop()

    rec = same_as_jax("version_split", fw, run)
    vals = rec["admin"]["values"]
    v1 = vals['gateway_version_requests_total{route="llm",version="v1"}']
    v2 = vals['gateway_version_requests_total{route="llm",version="v2"}']
    assert v1 + v2 == 40 and v1 == sum(s in "ab" for s in rec["served"])
    assert 0 < vals["gateway_shadow_requests_total"] < 40


@pytest.mark.parametrize("fw", FWS)
def test_route_annotation_validation(fw):
    import yaml

    base = {"name": "r", "prefix": "/m/", "service": "a:1",
            "backends": [{"service": "a:1"}, {"service": "b:1"}]}
    cases = [
        {**base, "splits": [{"version": "v1", "weight": 1,
                             "backends": ["a:1"]}]},
        {**base, "strategy": "hash-split"},
        {**base, "shadow_fraction": 1.5},
        {**base, "strategy": "hash-split", "shadow_fraction": 0.5,
         "splits": [{"version": "v1", "weight": 90, "backends": ["a:1"]},
                    {"version": "v2", "weight": 10, "backends": ["b:1"]}]},
        {**base, "strategy": "prefix-affine", "pressure": 2,
         "kv_pressure": 0.7, "prefill_backends": [{"service": "p:1"}],
         "qos": {"tenants": {"gold": {"rate": 8, "burst": 2}},
                 "default": {"rate": 1}}},
        {**base, "strategy": "nope"},
        {**base, "jwt": "required", "outlier": {"threshold": 2.5,
                                                "window": 10}},
    ]

    def run(p):
        out = []
        for spec in cases:
            for text in (yaml.safe_dump(spec), json.dumps(spec)):
                routes = p.routing.routes_from_service({"metadata": {
                    "name": "s",
                    "annotations": {GATEWAY_ROUTE_ANNOTATION: text}}})
                out.append([dict(vars(r)) for r in routes])
        return out

    rec = same_as_jax("annotation_validation", fw, run)
    assert [len(r) for r in rec[::2]] == [0, 0, 0, 1, 1, 0, 1]
    assert rec[6][0]["splits"] == (("v1", 90.0, ("a:1",)),
                                   ("v2", 10.0, ("b:1",)))


def test_routes_without_pyyaml(monkeypatch):
    """Where PyYAML is absent (the card's machine), a JSON annotation, as
    the port's renderer writes it there, gives JAX's routes; a block-YAML
    one raises an error that names PyYAML, never "no routes"."""
    import yaml

    spec = {"name": "pool", "prefix": "/models/m/",
            "service": "m-r0.kubeflow:8500", "strategy": "prefix-affine",
            "backends": [{"service": "m-r0.kubeflow:8500", "weight": 1},
                         {"service": "m-r1.kubeflow:8500", "weight": 1}]}
    want = jrouting.routes_from_service({"metadata": {
        "name": "s",
        "annotations": {GATEWAY_ROUTE_ANNOTATION: yaml.safe_dump(spec)}}})
    monkeypatch.setitem(sys.modules, "yaml", None)
    from kubeflow_tpu_torch.manifests.core import gateway_route as tgr

    ann = tgr("pool", "/models/m/", "m-r0.kubeflow:8500",
              backends=spec["backends"], strategy="prefix-affine")
    assert json.loads(ann[GATEWAY_ROUTE_ANNOTATION])["name"] == "pool"
    got = trouting.routes_from_service({"metadata": {
        "name": "s", "annotations": ann}})
    assert [vars(r) for r in got] == [vars(r) for r in want]
    block = {"metadata": {"name": "s", "annotations": {
        GATEWAY_ROUTE_ANNOTATION:
            "name: pool\nprefix: /models/m/\nservice: m-r0.kubeflow:8500\n"}}}
    with pytest.raises(ImportError, match="PyYAML"):
        trouting.routes_from_service(block)
    table = trouting.RouteTable()
    api = TorchFake()
    api.ensure_namespace("kubeflow")
    api.create({"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": "s", "namespace": "kubeflow",
                             **block["metadata"]}})
    with pytest.raises(ImportError, match="PyYAML"):
        table.refresh(api)


# ---------------------------------------------------------------------------
# Identity tokens and the JWT filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("issuer,verifier",
                         [(i, v) for i in FWS for v in FWS])
def test_tokens_verify_across_packages(issuer, verifier):
    """``auth/tokens.py``: a token one package's key ring issues is
    verified (or refused for the same reason) by the other's ``verify``."""
    ti, tv = PKGS[issuer].tokens, PKGS[verifier].tokens
    ring = ti.SigningKeyRing(ISS)
    tok = ring.issue("alice", AUD, ttl_seconds=60,
                     claims={"email": "alice@example.com"})
    claims = tv.verify(tok, ring.jwks(), issuer=ISS, audience=AUD)
    assert (claims["sub"], claims["email"], claims["iss"]) == (
        "alice", "alice@example.com", ISS)

    def reason(token, jwks=None, **kw):
        kw = {"issuer": ISS, "audience": AUD, **kw}
        with pytest.raises(tv.TokenError) as e:
            tv.verify(token, jwks or ring.jwks(), **kw)
        return str(e.value)

    assert "bad-audience" in reason(tok, audience="other")
    assert "bad-issuer" in reason(tok, issuer="https://evil")
    now = [1000.0]
    timed = ti.SigningKeyRing(ISS, clock=lambda: now[0])
    old = timed.issue("a", AUD, ttl_seconds=100)
    tv.verify(old, timed.jwks(), issuer=ISS, audience=AUD, now=1130,
              skew_seconds=60)
    assert "expired" in reason(old, timed.jwks(), now=1161,
                               skew_seconds=60)
    header = {"alg": "none", "typ": "JWT", "kid": ring.active_kid}
    h = base64.urlsafe_b64encode(
        json.dumps(header).encode()).rstrip(b"=").decode()
    assert "bad-alg" in reason(h + "." + tok.split(".")[1] + ".")
    hh, pp, ss = tok.split(".")
    payload = json.loads(base64.urlsafe_b64decode(pp + "=="))
    payload["sub"] = "admin"
    p2 = base64.urlsafe_b64encode(
        json.dumps(payload).encode()).rstrip(b"=").decode()
    assert "bad-signature" in reason(f"{hh}.{p2}.{ss}")
    assert "bad-signature" in reason(f"{hh}.{pp}.a")
    assert "unknown-kid" in reason(
        ti.SigningKeyRing(ISS).issue("a", AUD, ttl_seconds=60))
    for bad in ("", "abc", "a.b", "a.b.c.d", "!!.??.!!"):
        reason(bad)
    listed = ring.issue("a", ["other", AUD], ttl_seconds=60)
    assert AUD in tv.verify(listed, ring.jwks(), issuer=ISS,
                            audience=AUD)["aud"]
    # Rotation: the retired key stays published until pruned.
    old_kid = timed.active_kid
    long_lived = timed.issue("a", AUD, ttl_seconds=3600)
    new_kid = timed.rotate()
    assert {k["kid"] for k in timed.jwks()["keys"]} == {old_kid, new_kid}
    tv.verify(long_lived, timed.jwks(), issuer=ISS, audience=AUD,
              now=now[0])
    assert timed.prune() == []
    now[0] += tv.MAX_TTL_SECONDS + 1
    assert timed.prune() == [old_kid]
    assert "unknown-kid" in reason(long_lived, timed.jwks(), now=1500.0)


@pytest.mark.parametrize("fw", FWS)
def test_jwt_verifier_policy(fw):
    """``JwtVerifier`` and ``JwksCache``: bypass rules (query strings
    ignored), the single refetch on an unknown kid and the remembered
    miss, the assertion header, the failure backoff, the miss budget and
    stale keys served through fetch errors."""
    def run(p):
        j = p.jwt
        rec = {}
        rules = j.bypass_from_specs(
            '[{"http_method":"GET","path_exact":"/healthz"},'
            ' {"http_method":"GET","path_prefix":"/public/"}]')
        v = j.JwtVerifier(lambda: {"keys": []}, issuer=ISS, audience=AUD,
                          bypass=rules)
        rec["bypass"] = [v.bypassed(m, path) for m, path in (
            ("GET", "/healthz"), ("POST", "/healthz"),
            ("GET", "/public/doc"), ("GET", "/private"),
            ("GET", "/healthz?verbose=1"), ("GET", "/healthzX?x=/healthz"))]
        rec["bypass_check"] = v.check("GET", "/healthz", {})

        ring = p.tokens.SigningKeyRing(ISS)
        now = [0.0]
        cache = j.JwksCache(ring.jwks, min_refresh_seconds=1.0,
                            clock=lambda: now[0])
        v = j.JwtVerifier(cache, issuer=ISS, audience=AUD)
        now[0] = 10.0
        seq = [v.check("GET", "/x", {"Authorization": "Bearer " +
                                     ring.issue("a", AUD, ttl_seconds=60)}
                       )[0]["sub"]]
        fetches = cache.fetches
        ring.rotate()
        now[0] = 20.0
        seq.append(v.check("GET", "/x", {"Authorization": "Bearer " +
                                         ring.issue("b", AUD,
                                                    ttl_seconds=60)})[0]
                   ["sub"])
        seq.append(cache.fetches - fetches)
        bad = p.tokens.SigningKeyRing(ISS).issue("x", AUD, ttl_seconds=60)
        before = cache.fetches
        seq.append(v.check("GET", "/x",
                           {"Authorization": f"Bearer {bad}"}))
        seq.append(cache.fetches - before)
        v.check("GET", "/x", {"Authorization": f"Bearer {bad}"})
        seq.append(cache.fetches - before)
        now[0] += 5.0
        v.check("GET", "/x", {"Authorization": f"Bearer {bad}"})
        seq.append(cache.fetches - before)
        rec["refetch"] = seq

        v = j.JwtVerifier(ring.jwks, issuer=ISS, audience=AUD)
        rec["assertion"] = [
            v.check("GET", "/x", {}),
            v.check("GET", "/x", {j.ASSERTION_HEADER: ring.issue(
                "svc", AUD, ttl_seconds=60)})[0]["sub"],
            v.verified_total, v.rejected_total]

        calls = [0]

        def down():
            calls[0] += 1
            raise OSError("issuer down")

        now2 = [100.0]
        dead = j.JwksCache(down, refresh_seconds=10.0,
                           min_refresh_seconds=1.0, clock=lambda: now2[0])
        for _ in range(3):
            dead.jwks()
        backoff = [calls[0]]
        now2[0] = 102.0
        dead.jwks()
        rec["backoff"] = backoff + [calls[0]]

        now3 = [10.0]
        flood = j.JwksCache(ring.jwks, min_refresh_seconds=1.0,
                            clock=lambda: now3[0])
        v = j.JwtVerifier(flood, issuer=ISS, audience=AUD)
        baseline = None
        for i in range(20):
            t = p.tokens.SigningKeyRing(ISS).issue(f"x{i}", AUD,
                                                   ttl_seconds=60)
            v.check("GET", "/x", {"Authorization": f"Bearer {t}"})
            baseline = flood.fetches if baseline is None else baseline
        rec["flood"] = flood.fetches - baseline < j.JwksCache.MISS_FETCH_BUDGET
        now3[0] = 12.0
        ring.rotate()
        rec["flood_rotation"] = v.check("GET", "/x", {
            "Authorization": "Bearer " + ring.issue(
                "a", AUD, ttl_seconds=60)})[0] is not None

        fail = [False]

        def flaky():
            if fail[0]:
                raise OSError("issuer down")
            return ring.jwks()

        now4 = [0.0]
        stale = j.JwksCache(flaky, refresh_seconds=5.0,
                            clock=lambda: now4[0])
        v = j.JwtVerifier(stale, issuer=ISS, audience=AUD)
        tok = ring.issue("a", AUD, ttl_seconds=60)
        ok = [v.check("GET", "/x", {j.ASSERTION_HEADER: tok})[0]
              is not None]
        fail[0] = True
        now4[0] = 100.0
        ok.append(v.check("GET", "/x", {j.ASSERTION_HEADER: tok})[0]
                  is not None)
        rec["stale"] = ok + [stale.fetch_errors >= 1]
        return rec

    rec = same_as_jax("jwt_policy", fw, run)
    assert rec["bypass"] == [True, False, True, False, True, False]
    assert rec["bypass_check"] == ({}, "")
    assert rec["refetch"] == ["a", "b", 1, (None, "unknown-kid"), 1, 1, 2]
    assert rec["assertion"] == [(None, "missing-token"), "svc", 1, 1]
    assert rec["backoff"] == [1, 2]
    assert rec["flood"] and rec["flood_rotation"]
    assert rec["stale"] == [True, True, True]


@pytest.fixture(scope="module")
def gatekeeper():
    """JAX's gatekeeper as the identity provider both gateways trust."""
    auth = AuthService("admin", hashlib.sha256(b"hunter2").hexdigest(),
                       service_accounts={"prober": "sa-key-123"})
    ring = jtokens.SigningKeyRing(ISS)
    httpd = make_auth_server(auth, 0, ring=ring, audience=AUD)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", ring
    httpd.shutdown()


@pytest.mark.parametrize("fw", FWS)
def test_jwt_enforced_through_gateway(fw, gatekeeper):
    """The secured gateway of ``test_jwt``: 401 without a token, the
    asserted identity replacing a spoofed one, a wrong audience refused,
    the bypass path and a ``jwt: off`` route open, a rotation without a
    401 window, and a ``required`` route failing closed without a
    verifier."""
    gk_base, ring = gatekeeper
    basic = {"Authorization": "Basic " +
             base64.b64encode(b"admin:hunter2").decode()}

    class Echo(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = json.dumps({
                "path": self.path,
                "identity": self.headers.get("X-Auth-Identity", "")}
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def grant():
        return call("POST", f"{gk_base}/token", {}, basic)[1]["id_token"]

    def run(p):
        backend = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
        threading.Thread(target=backend.serve_forever, daemon=True).start()
        bport = backend.server_address[1]
        table = p.gw.RouteTable()
        table.set_routes([
            p.gw.Route(name="app", prefix="/app/", service="app.kubeflow:80"),
            p.gw.Route(name="open", prefix="/open/",
                       service="app.kubeflow:80", jwt="off"),
            p.gw.Route(name="locked", prefix="/locked/",
                       service="app.kubeflow:80", jwt="required")])
        verifier = p.jwt.JwtVerifier(
            f"{gk_base}/.well-known/jwks.json", issuer=ISS, audience=AUD,
            bypass=(p.jwt.BypassRule(http_method="GET",
                                     path_exact="/app/status"),))
        gw = start_gateway(p, table, probe_interval=0,
                           resolve=lambda addr: f"127.0.0.1:{bport}",
                           jwt_verifier=verifier)
        bare = start_gateway(p, table, probe_interval=0,
                             resolve=lambda addr: f"127.0.0.1:{bport}")
        try:
            base = base_of(gw)
            rec = {}
            code, _b, h = call("GET", f"{base}/app/data")
            rec["no_token"] = (code, h.get("WWW-Authenticate"))
            rec["identity"] = call("GET", f"{base}/app/data", headers={
                "Authorization": f"Bearer {grant()}",
                "X-Auth-Identity": "spoofed"})[:2]
            wrong = ring.issue("a", "other-audience", ttl_seconds=60)
            code, _b, h = call("GET", f"{base}/app/data", headers={
                "Authorization": f"Bearer {wrong}"})
            rec["wrong_aud"] = (code, h.get("WWW-Authenticate"))
            rec["open"] = [call("GET", f"{base}/app/status")[0],
                           call("GET", f"{base}/open/anything")[0]]
            old = grant()
            call("POST", f"{gk_base}/rotate", {}, basic)
            rec["rotation"] = [call("GET", f"{base}/app/data", headers={
                "Authorization": f"Bearer {t}"})[0] for t in (old, grant())]
            rec["fail_closed"] = call("GET", f"{base_of(bare)}/locked/x")[0]
            rec["admin"] = admin_values(gw)
            return rec
        finally:
            gw.stop()
            bare.stop()
            backend.shutdown()

    rec = same_as_jax("jwt_gateway", fw, run)
    assert rec["no_token"][0] == 401 and "missing-token" in \
        rec["no_token"][1]
    assert rec["identity"] == (200, {"path": "/data", "identity": "admin"})
    assert rec["wrong_aud"][0] == 401 and "bad-audience" in \
        rec["wrong_aud"][1]
    assert rec["open"] == [200, 200] and rec["rotation"] == [200, 200]
    assert rec["fail_closed"] == 503


# ---------------------------------------------------------------------------
# The port's servers behind the gateway
# ---------------------------------------------------------------------------

PROMPT = list(range(3, 3 + 20))


@pytest.fixture(scope="module")
def weights():
    from kubeflow_tpu.models.registry import get_model

    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        spec.init(jax.random.PRNGKey(0), spec.config))


def _server_cfg(**kw):
    return dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                prefix_cache_slots=8, prefix_cache_min_len=8,
                dtype="float32", **kw)


@pytest.fixture(scope="module")
def colocated(weights):
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.server import ModelServer

    ref = ModelServer(EngineConfig(**_server_cfg(device="cpu")), port=0,
                      params=weights, batch_timeout_ms=2)
    ref.start()
    yield ref
    ref.stop()


@pytest.mark.parametrize("fw", FWS)
def test_two_hop_relay_to_port_servers(fw, weights, colocated):
    """``test_handoff``'s relay with the port's prefill and decode
    servers behind each gateway: the predict rides ``:prefill`` with
    ``handoff_to``, the server-to-server push and the relayed
    ``:predict``, and answers a colocated server's tokens; a dead
    prefill pool degrades and is counted."""
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.server import ModelServer

    want = colocated.handle_predict("lm-test-tiny", {"instances": [
        {"tokens": PROMPT, "max_new_tokens": 6}]})["predictions"][0][
            "tokens"]

    def run(p):
        pre, dec = (ModelServer(EngineConfig(**_server_cfg(
            serving_role=role, device="cpu")), port=0, params=weights,
            batch_timeout_ms=2) for role in ("prefill", "decode"))
        for s in (pre, dec):
            s.start()
        pre_addr, dec_addr = f"127.0.0.1:{pre.port}", f"127.0.0.1:{dec.port}"
        ann = gateway_route(
            "llm-pool", "/models/llm/", dec_addr,
            backends=[{"service": dec_addr, "weight": 1}],
            strategy="prefix-affine", affinity_tokens=16, pressure=0,
            prefill_backends=[{"service": pre_addr, "weight": 1}])
        table = p.gw.RouteTable()
        table.set_routes(p.gw.routes_from_service(
            {"metadata": {"name": "llm", "annotations": ann}}))
        gw = start_gateway(p, table, probe_interval=0)
        try:
            url = f"{base_of(gw)}/models/llm/v1/models/lm-test-tiny:predict"
            out = call("POST", url, {"instances": [
                {"tokens": PROMPT, "max_new_tokens": 6}]}, timeout=120)[1]
            rec = {"tokens": out["predictions"][0]["tokens"],
                   "handoffs": gw.handoffs_total,
                   "failures": gw.handoff_failures,
                   "dec": {k: dec.decoder.metrics()[k] for k in (
                       "kv_handoff_imports", "kv_handoff_tokens",
                       "prefix_hits")},
                   "exports": pre.decoder.metrics()["kv_handoff_exports"]}
            pre.stop()
            out2 = call("POST", url, {"instances": [
                {"tokens": [9] + PROMPT, "max_new_tokens": 4}]},
                timeout=120)[1]
            rec["degraded"] = len(out2["predictions"][0]["tokens"])
            rec["failures_after"] = gw.handoff_failures
            return rec
        finally:
            gw.stop()
            dec.stop()

    rec = same_as_jax("relay", fw, run)
    assert rec["tokens"] == want
    assert (rec["handoffs"], rec["failures"]) == (1, 0)
    assert rec["dec"] == {"kv_handoff_imports": 1,
                          "kv_handoff_tokens": len(PROMPT) - 1,
                          "prefix_hits": 1}
    assert rec["exports"] == 1
    assert rec["degraded"] == 4 and rec["failures_after"] == 1


def test_gateway_fronts_port_servers_as_jax_fronts_jax(weights):
    """The InferenceService router's prefix-affine route over two
    replicas: the port's gateway before two port servers and JAX's before
    two JAX servers place every prompt on the same replica (the
    rendezvous pick of its leading tokens, read back from the replica's
    ``/debug/requests`` by the gateway's request id) and answer the same
    greedy tokens."""
    from kubeflow_tpu.serving.engine import EngineConfig as JaxEngineConfig
    from kubeflow_tpu.serving.server import ModelServer as JaxServer
    from kubeflow_tpu_torch.observability.lint import lint
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.server import ModelServer

    members = ["lm-r0.kubeflow:8500", "lm-r1.kubeflow:8500"]
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "lm-router", "namespace": "kubeflow",
                        "annotations": gateway_route(
                            "lm-router", "/models/lm/", members[0],
                            backends=[{"service": m, "weight": 1}
                                      for m in members],
                            strategy="prefix-affine", affinity_tokens=8,
                            pressure=4)}}
    prompts = [[s, s + 1, s + 2, 7, 8, 9, 10, 11, 12] for s in range(8)]
    servers = {
        "jax": [JaxServer(JaxEngineConfig(**_server_cfg()), port=0,
                          grpc_port=None, batch_timeout_ms=2)
                for _ in members],
        "torch": [ModelServer(EngineConfig(**_server_cfg(device="cpu")),
                              port=0, params=weights, batch_timeout_ms=2)
                  for _ in members]}
    results = {}
    try:
        for fw, pair in servers.items():
            for s in pair:
                s.start()
            p = PKGS[fw]
            ports = {m: f"127.0.0.1:{s.port}" for m, s in zip(members, pair)}
            table = p.gw.RouteTable()
            assert table.refresh(fake_with(p, svc), "kubeflow") == 1
            gw = start_gateway(p, table, probe_interval=0,
                               resolve=lambda a: ports.get(a, a))
            try:
                placed, tokens = [], []
                for i, prompt in enumerate(prompts):
                    rid = f"{fw}-{i}"
                    code, out, headers = call(
                        "POST", f"{base_of(gw)}/models/lm/v1/models/"
                                "lm-test-tiny:predict",
                        {"instances": [{"tokens": prompt,
                                        "max_new_tokens": 8}]},
                        headers={"X-Request-ID": rid}, timeout=120)
                    assert code == 200 and headers["X-Request-ID"] == rid
                    tokens.append(out["predictions"][0]["tokens"])
                    # A replica that has not decoded yet answers no
                    # "requests" key (JAX builds its decoder lazily).
                    where = [m for m, s in zip(members, pair) if call(
                        "GET", f"http://127.0.0.1:{s.port}/debug/requests"
                               f"?id={rid}")[1].get("requests")]
                    placed.append(where)
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{gw.admin_port}/metrics") as r:
                    exposition = r.read().decode()
                results[fw] = {"placed": placed, "tokens": tokens,
                               "lint": lint(exposition),
                               "admin": admin_values(gw)}
            finally:
                gw.stop()
    finally:
        for pair in servers.values():
            for s in pair:
                s.stop()
    assert results["torch"] == results["jax"]
    rec = results["torch"]
    assert rec["lint"] == []
    for prompt, where, toks in zip(prompts, rec["placed"], rec["tokens"]):
        assert where == [rendezvous_pick(prefix_affinity_key(prompt, 8),
                                         members)]
        assert len(toks) == 8
    assert {w[0] for w in rec["placed"]} == set(members)
    assert rec["admin"]["values"][
        'gateway_upstream_latency_seconds_count{route="lm-router"}'] == 8


def test_gateway_cli_serves_routes_from_the_apiserver():
    """``python -m kubeflow_tpu_torch.gateway`` with JAX's flags against
    an apiserver over HTTP: it lists the Services' route annotations and
    proxies to the backend; its admin port answers ``/healthz``."""
    from kubeflow_tpu.k8s.httpfake import serve

    be = IdentityBackend("cli")
    fake = JaxFake()
    fake.ensure_namespace("kubeflow")
    fake.create({"apiVersion": "v1", "kind": "Service",
                 "metadata": {"name": "cli", "namespace": "kubeflow",
                              "annotations": gateway_route(
                                  "cli", "/cli/", be.addr)}})
    httpd, api_port = serve(fake)
    port, admin = free_port(), free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "http_proxy": "",
           "HTTP_PROXY": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.gateway",
         f"--apiserver=http://127.0.0.1:{api_port}", f"--port={port}",
         f"--admin-port={admin}", "--namespace=kubeflow",
         "--refresh-seconds=0.2", "--alsologtostderr", "-v=1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline, got = time.time() + 30, None
        while time.time() < deadline:
            try:
                got = call("GET", f"http://127.0.0.1:{port}/cli/x",
                           timeout=2)[:2]
                if got[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert got == (200, {"variant": "cli"}), got
        assert call("GET", f"http://127.0.0.1:{admin}/healthz")[:2] == (
            200, {"status": "ok"})
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
        httpd.shutdown()
        be.close()
