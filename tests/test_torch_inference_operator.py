"""The port's InferenceService controller beside the JAX package's.

Both controllers run on the same CR sequence, each against its own fake
apiserver (JAX's ``FakeApiServer`` and the port's ``k8s_fake``), with one
injected ``fetch_metrics`` and one clock. After every round the two
sides must agree on the replica count of each pool, the router
annotation (parsed), the whole status and the addresses scraped; the
rendered replica Deployments and Services are JAX's under the mapping of
``test_torch_manifests.py`` (the port's image, ``python -m
kubeflow_tpu_torch.serving``, ``nvidia.com/gpu``, ``--device=cpu`` for a
pod without a GPU). The cases are those of
``tests/test_inference_operator.py`` plus QoS, model-parallel replica
sizing and the image override; a ``warmup.compileCacheDir`` CR raises the
port's refusal naming ``compile_cache_dir`` and is backed off.

The scrape: ``scrape_signals`` over the port server's exposition equals
JAX's function on the same text, and the HTTP fetch reads a live port
server. End to end: the controller scales ``lm-test-tiny`` servers
started from the rendered containers' own commands (``--device=cpu``)
from 1 to 2 on their scraped HTTP signals; r1 boots its weights from r0
over ``:pull`` and answers with r0's tokens.
"""

import copy
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from kubeflow_tpu.apis.inference import inference_service as jservice  # noqa: E402
from kubeflow_tpu.apis.inference import inference_service_crd as jcrd  # noqa: E402
from kubeflow_tpu.k8s.fake import FakeApiServer as JFakeApiServer  # noqa: E402
from kubeflow_tpu.k8s.httpfake import serve  # noqa: E402
from kubeflow_tpu.manifests.core import GATEWAY_ROUTE_ANNOTATION  # noqa: E402
from kubeflow_tpu.operators import inference as jinf  # noqa: E402
from kubeflow_tpu_torch.apis.inference import (  # noqa: E402
    inference_service,
    inference_service_crd,
)
from kubeflow_tpu_torch.k8s_fake import FakeApiServer  # noqa: E402
from kubeflow_tpu_torch.manifests import images  # noqa: E402
from kubeflow_tpu_torch.observability.metrics import MetricRegistry  # noqa: E402
from kubeflow_tpu_torch.operators import base as tbase  # noqa: E402
from kubeflow_tpu_torch.operators import inference as tinf  # noqa: E402
from kubeflow_tpu_torch.parallel.launch import free_port  # noqa: E402
from test_torch_manifests import to_gpu  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NS = "kubeflow"
API = "kubeflow-tpu.org/v1"

CALM = {"queue_wait_p99_s": 0.05, "ttft_p99_s": 0.1,
        "kv_utilization": 0.2, "queued": 0.0}
BREACH = {"queue_wait_p99_s": 2.0, "ttft_p99_s": 0.1,
          "kv_utilization": 0.2, "queued": 12.0}
LOW = {"queue_wait_p99_s": 0.01, "ttft_p99_s": 0.01,
       "kv_utilization": 0.05, "queued": 0.0}
MID = {"queue_wait_p99_s": 0.35, "ttft_p99_s": 0.5,
       "kv_utilization": 0.5, "queued": 2.0}
KV_FULL = {"queue_wait_p99_s": 0.01, "ttft_p99_s": 0.01,
           "inter_token_p99_s": 0.01, "kv_utilization": 0.95,
           "queued": 0.0}
SLOW_TOKENS = {"queue_wait_p99_s": 0.01, "ttft_p99_s": 0.01,
               "inter_token_p99_s": 2.0, "kv_utilization": 0.1,
               "queued": 0.0}
ROLES = {"prefill": {"replicas": 2, "maxReplicas": 4},
         "decode": {"replicas": 2, "maxReplicas": 4,
                    "engine": {"kv_dtype": "int8"}}}
# Fields the apiserver assigns (each fake its own uids and clock).
SERVER_FIELDS = ("uid", "resourceVersion", "creationTimestamp",
                 "generation")


def _strip(obj: dict) -> dict:
    obj = copy.deepcopy(obj)
    for key in SERVER_FIELDS:
        obj["metadata"].pop(key, None)
    for ref in obj["metadata"].get("ownerReferences", []):
        ref.pop("uid", None)
    obj.pop("status", None)
    return obj


class Twins:
    """The two controllers on one clock and one signal source."""

    def __init__(self):
        self.t = 0.0
        self.signals = dict(CALM)
        self.unscrapeable: set[str] = set()  # address fragments
        self.scraped = {"jax": [], "torch": []}
        self.apis = {"jax": JFakeApiServer(), "torch": FakeApiServer()}
        self.apis["jax"].apply(jcrd())
        self.apis["torch"].apply(inference_service_crd())
        self.ctrls = {}
        for side, mod in (("jax", jinf), ("torch", tinf)):
            self.apis[side].ensure_namespace(NS)
            self.ctrls[side] = mod.InferenceServiceController(
                self.apis[side], fetch_metrics=self._fetch(side),
                clock=lambda: self.t)

    def _fetch(self, side):
        def fetch(addr):
            self.scraped[side].append(addr)
            if any(frag in addr for frag in self.unscrapeable):
                return None
            return dict(self.signals)
        return fetch

    def create(self, name="llm", **kw):
        jcr, tcr = jservice(name, NS, "lm-test-tiny", **kw), \
            inference_service(name, NS, "lm-test-tiny", **kw)
        assert tcr == jcr  # the port's CRD builder is JAX's
        for side, cr in (("jax", jcr), ("torch", tcr)):
            self.apis[side].create(cr)

    def status(self, side="torch", name="llm"):
        cr = self.apis[side].get_or_none(API, "InferenceService", name, NS)
        return (cr or {}).get("status", {})

    def route(self, side="torch", name="llm"):
        svc = self.apis[side].get("v1", "Service", name, NS)
        return yaml.safe_load(
            svc["metadata"]["annotations"][GATEWAY_ROUTE_ANNOTATION])

    def children(self, side):
        return {(o["kind"], o["metadata"]["name"]): _strip(o)
                for kind, av in (("Deployment", "apps/v1"),
                                 ("Service", "v1"))
                for o in self.apis[side].list(av, kind, NS)}

    def reconcile(self, dt: float = 0.0) -> dict:
        """One round on both sides; asserts they agree; the port's
        status."""
        self.t += dt
        for side in ("jax", "torch"):
            assert self.ctrls[side].reconcile_all() >= 1
        self.check()
        return self.status()

    def check(self):
        jst, tst = self.status("jax"), self.status("torch")
        assert tst == jst
        assert self.scraped["torch"] == self.scraped["jax"]
        if self.apis["jax"].get_or_none("v1", "Service", "llm", NS):
            assert self.route("torch") == self.route("jax")
        jkids, tkids = self.children("jax"), self.children("torch")
        assert sorted(tkids) == sorted(jkids)
        for key, jobj in jkids.items():
            assert tkids[key] == to_gpu("serving", [jobj])[0], key

    def delete(self, name="llm"):
        for side in ("jax", "torch"):
            obj = self.apis[side].get(API, "InferenceService", name, NS)
            self.apis[side].delete(API, "InferenceService", name, NS)
            self.ctrls[side].reconcile_deleted(obj)


def _cr(**kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("autoscale", {"cooldownSeconds": 30,
                                "scrapePeriodSeconds": 5})
    return kw


def _role_cr(**kw):
    kw.setdefault("roles", {r: copy.deepcopy(v) for r, v in ROLES.items()})
    kw.setdefault("kv_pressure", 0.85)
    return _cr(**kw)


def _pools(st: dict) -> dict:
    return {r: v["replicas"] for r, v in st["roles"].items()} \
        if "roles" in st else {"": st["replicas"]}


# (CR keywords, [(signals, seconds before the round, unscrapeable address
# fragments, the port's replicas per pool after it)]).
CASES = {
    "materialize": (_cr(), [(CALM, 0, (), {"": 2})]),
    "engine_knobs": (_cr(engine={"kv_layout": "paged", "kv_dtype": "int8",
                                 "speculative_k": 4}),
                     [(CALM, 0, (), {"": 2})]),
    "breach_scales_up_in_one_period": (
        _cr(), [(CALM, 0, (), {"": 2}), (BREACH, 5, (), {"": 3})]),
    "scale_down_waits_for_cooldown": (
        _cr(), [(CALM, 0, (), {"": 2}), (BREACH, 5, (), {"": 3}),
                (LOW, 5, (), {"": 3}), (LOW, 5, (), {"": 3}),
                (LOW, 5, (), {"": 3}), (LOW, 30, (), {"": 2}),
                (LOW, 5, (), {"": 2}), (LOW, 30, (), {"": 1})]),
    "mid_band_holds": (_cr(), [(CALM, 0, (), {"": 2})]
                       + [(MID, 60, (), {"": 2})] * 6),
    "max_replicas_caps": (_cr(replicas=4), [(CALM, 0, (), {"": 4})]
                          + [(BREACH, 5, (), {"": 4})] * 3),
    "unscrapeable_holds": (_cr(), [(CALM, 0, ("-r",), {"": 2}),
                                   (LOW, 120, ("-r",), {"": 2})]),
    "kv_pressure_breach": (_cr(), [(CALM, 0, (), {"": 2}),
                                   (KV_FULL, 5, (), {"": 3})]),
    "prune_highest_first": (_cr(replicas=3), [(CALM, 0, (), {"": 3}),
                                              (LOW, 60, (), {"": 2})]),
    "role_pools": (_role_cr(), [(CALM, 0, (), {"prefill": 2,
                                               "decode": 2})]),
    "prefill_breach": (_role_cr(), [
        (CALM, 0, (), {"prefill": 2, "decode": 2}),
        (BREACH, 5, (), {"prefill": 3, "decode": 2})]),
    "decode_kv_breach": (_role_cr(), [
        (CALM, 0, (), {"prefill": 2, "decode": 2}),
        (KV_FULL, 5, (), {"prefill": 2, "decode": 3})]),
    "decode_inter_token_breach": (_role_cr(), [
        (CALM, 0, (), {"prefill": 2, "decode": 2}),
        (SLOW_TOKENS, 5, (), {"prefill": 2, "decode": 3})]),
    "role_cooldown_per_pool": (_role_cr(), [
        (CALM, 0, (), {"prefill": 2, "decode": 2}),
        (BREACH, 5, (), {"prefill": 3, "decode": 2}),
        (LOW, 5, (), {"prefill": 3, "decode": 2}),
        (LOW, 5, (), {"prefill": 3, "decode": 2}),
        (LOW, 5, (), {"prefill": 3, "decode": 2}),
        (LOW, 30, (), {"prefill": 2, "decode": 1})]),
    "predictive_scale_up": (
        _cr(autoscale={"cooldownSeconds": 30, "scrapePeriodSeconds": 5,
                       "predictive": True, "horizonSeconds": 30,
                       "maxStepUp": 4}),
        [({**CALM, "queue_wait_p99_s": 0.2}, 0, (), {"": 2}),
         ({**CALM, "queue_wait_p99_s": 0.3}, 5, (), {"": 2}),
         ({**CALM, "queue_wait_p99_s": 0.4}, 5, (), {"": 4})]),
    "reactive_only": (
        _cr(), [({**CALM, "queue_wait_p99_s": w}, dt, (), {"": 2})
                for w, dt in ((0.2, 0), (0.3, 5), (0.4, 5))]),
    "newborn_ramp_guard": (
        _cr(warmup={"rampSeconds": 60}),
        [(CALM, 0, ("-r2.",), {"": 2}), (BREACH, 5, ("-r2.",), {"": 3}),
         (LOW, 35, ("-r2.",), {"": 3}), (LOW, 30, (), {"": 2})]),
    "peer_weights_chain": (_cr(replicas=3, warmup={"peerWeights": True}),
                           [(CALM, 0, (), {"": 3})]),
    "qos_tenants": (
        _cr(qos={"tenants": {"gold": {"weight": 8, "rate": 50,
                                      "burst": 10, "priority": 5},
                             "free": {"weight": 1, "rate": 5}},
                 "default": {"weight": 1, "rate": 1, "burst": 2},
                 "agingSeconds": 10},
            kv_pressure=0.9, affinity_tokens=16, pressure=4),
        [(CALM, 0, (), {"": 2}), (BREACH, 5, (), {"": 3})]),
    "model_parallel_replicas": (
        _cr(replicas=1, engine={"tpShards": 2, "cpShards": 2,
                                "kv_layout": "paged"}),
        [(CALM, 0, (), {"": 1})]),
    "pinned_chips_and_image": (
        _cr(replicas=1, tpu_chips_per_replica=2, image="reg/llm:7",
            model_path="/models/llm", engine={"tpShards": 4}),
        [(CALM, 0, (), {"": 1}), (BREACH, 5, (), {"": 2})]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_controller_equals_jax(case):
    kw, rounds = CASES[case]
    twins = Twins()
    twins.create(**kw)
    for signals, dt, dark, pools in rounds:
        twins.signals = dict(signals)
        twins.unscrapeable = set(dark)
        st = twins.reconcile(dt)
        assert _pools(st) == pools
    # Every replica is the port's server on the port's image, asking for
    # its GPUs (tp x cp x pp unless the CR pins the count).
    gpus = kw.get("tpu_chips_per_replica") or (
        (kw.get("engine") or {}).get("tpShards", 1)
        * (kw.get("engine") or {}).get("cpShards", 1))
    for dep in twins.apis["torch"].list("apps/v1", "Deployment", NS):
        (c,) = dep["spec"]["template"]["spec"]["containers"]
        assert c["command"] == ["python", "-m", "kubeflow_tpu_torch.serving"]
        assert c["image"] == (kw.get("image") or images.TORCH_CUDA)
        assert c["resources"]["limits"] == {images.GPU_RESOURCE: gpus}
        assert dep["metadata"]["labels"]["service"] == "gpu-serving"


def test_reconcile_materializes_replicas_and_router():
    twins = Twins()
    twins.create(**_cr())
    st = twins.reconcile()
    assert st["replicas"] == st["scrapedReplicas"] == 2
    route = twins.route()
    assert route["strategy"] == "prefix-affine"
    assert [b["service"] for b in route["backends"]] == \
        ["llm-r0.kubeflow:8500", "llm-r1.kubeflow:8500"]
    dep = twins.apis["torch"].get("apps/v1", "Deployment", "llm-r1", NS)
    assert dep["metadata"]["labels"][tinf.SERVICE_LABEL] == "llm"
    assert dep["metadata"]["labels"][tinf.REPLICA_LABEL] == "1"
    assert dep["metadata"]["ownerReferences"][0]["kind"] == \
        "InferenceService"


@pytest.mark.parametrize("roles", [False, True], ids=["colocated", "roles"])
def test_deleted_service_cascades_and_clears_state(roles):
    twins = Twins()
    twins.create(**(_role_cr() if roles else _cr()))
    twins.reconcile()
    assert any(k[1] == "llm" for k in twins.ctrls["torch"]._scale_state)
    twins.delete()
    twins.check()
    assert twins.apis["torch"].list("apps/v1", "Deployment", NS) == []
    for side in ("jax", "torch"):
        assert not any(k[1] == "llm" for k in twins.ctrls[side]._scale_state)


def test_polling_pass_releases_a_deleted_service():
    """No watch delivers the DELETED event: the next pass finds the CR
    gone and calls ``reconcile_deleted`` itself."""
    twins = Twins()
    twins.create(**_cr())
    twins.reconcile()
    ctrl = twins.ctrls["torch"]
    assert ctrl.requeue_after == 5.0  # the scrape period
    twins.apis["torch"].delete(API, "InferenceService", "llm", NS)
    assert ctrl.reconcile_all() == 0
    assert ctrl._scale_state == {} and ctrl.requeue_after is None


def test_compile_cache_dir_is_refused_and_backed_off():
    """JAX renders ``warmup.compileCacheDir`` as a cache volume and
    ``--compile-cache-dir``; the port's ``gpu-serving`` refuses the
    parameter by name, the refusal leaves the reconcile, and the polling
    runtime counts it and backs the object off."""
    twins = Twins()
    twins.create(**_cr(warmup={"compileCacheDir": "/var/cache/compile",
                               "peerWeights": True}))
    assert twins.ctrls["jax"].reconcile_all() == 1
    jdep = twins.apis["jax"].get("apps/v1", "Deployment", "llm-r0", NS)
    assert any(a.startswith("--compile-cache-dir")
               for a in jdep["spec"]["template"]["spec"]["containers"][0][
                   "args"])
    ctrl = twins.ctrls["torch"]
    cr = twins.apis["torch"].get(API, "InferenceService", "llm", NS)
    with pytest.raises(ValueError, match="compile_cache_dir"):
        ctrl.reconcile(cr)
    retries = tbase._M_RETRIES.labels("InferenceService")
    before = retries.value
    assert ctrl.reconcile_all() == 1
    assert retries.value == before + 1
    assert 0 < ctrl.requeue_after < 2 * ctrl.backoff_base_seconds
    ctrl.reconcile_all()
    assert ctrl.requeue_after >= ctrl.backoff_base_seconds  # doubled
    assert twins.apis["torch"].list("apps/v1", "Deployment", NS) == []


# ---------------------------------------------------------------------------
# The scrape
# ---------------------------------------------------------------------------


def _histogram_page():
    reg = MetricRegistry()
    h = reg.histogram("serving_queue_wait_seconds", "t")
    for v in (0.001, 0.002, 0.01, 0.05, 0.05, 0.2, 0.7, 1.5, 3.0, 9.0):
        h.observe(v)
    return reg.render() + "\n".join([
        'serving_ttft_seconds_bucket{le="0.5"} 100',
        'serving_ttft_seconds_bucket{le="+Inf"} 100',
        'serving_inter_token_seconds_bucket{le="0.25"} 90',
        'serving_inter_token_seconds_bucket{le="1.0"} 99',
        'serving_inter_token_seconds_bucket{le="+Inf"} 100',
        "serving_kv_bytes_in_use 750", "serving_kv_bytes_total 1000",
        "serving_queued 4", "serving_requests_total 40",
        "serving_errors_total 2"]), h


@pytest.mark.parametrize("page", ["histograms", "empty", "garbage"])
def test_scrape_signals_equals_jax(page):
    text, h = _histogram_page()
    text = {"histograms": text, "empty": "",
            "garbage": "not a metric line\nfoo{bar} nope\n"}[page]
    got = tinf.scrape_signals(text)
    assert got == jinf.scrape_signals(text)
    assert tinf._parse_exposition(text) == jinf._parse_exposition(text)
    if page == "histograms":
        assert got["queue_wait_p99_s"] == pytest.approx(h.quantile(0.99),
                                                       rel=1e-6)
        assert (got["kv_utilization"], got["error_rate"]) == (0.75, 0.05)


def test_signal_cache_equals_jax():
    results = [{"ttft_p99_s": 1.0}, None, None, {"ttft_p99_s": 2.0}, None,
               None]
    seq = {}
    for side, mod in (("jax", jinf), ("torch", tinf)):
        feed, now = iter(results), [0.0]
        cache = mod.SignalCache(lambda addr: next(feed), lambda: now[0])
        out = []
        for dt in (0, 5, 20, 1, 25, 31):
            now[0] += dt
            out.append(cache.scrape("r0:8500", 30))
        cache.forget("r0:8500")
        seq[side] = out
    assert seq["torch"] == seq["jax"]
    assert seq["torch"][4] == ({"ttft_p99_s": 2.0}, False)
    assert seq["torch"][5] == (None, False)


def test_http_scrape_of_a_port_server_equals_jax():
    """The default fetch over HTTP against the port's ``ModelServer``:
    finite signals, and JAX's reduction of the same page agrees."""
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer(
        EngineConfig(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                     max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                     device="cpu"), port=0, batch_timeout_ms=2)
    server.start()
    try:
        server.handle_predict("lm-test-tiny", {"instances": [
            {"tokens": [1, 2, 3], "max_new_tokens": 4}]})
        addr = f"127.0.0.1:{server.port}"
        sig = tinf._http_fetch_signals(addr)
        with urllib.request.urlopen(
                f"http://{addr}/monitoring/prometheus/metrics") as resp:
            page = resp.read().decode()
    finally:
        server.stop()
    assert sig is not None and sig["ttft_p99_s"] > 0
    assert 0 <= sig["kv_utilization"] <= 1
    assert tinf.scrape_signals(page) == jinf.scrape_signals(page)
    assert tinf._http_fetch_signals("127.0.0.1:1") is None  # dead replica


# ---------------------------------------------------------------------------
# End to end: rendered CLI servers scaled on scraped signals
# ---------------------------------------------------------------------------


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read().decode()


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm-test-tiny:predict",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _start(dep: dict, ports: dict, addrs: dict, log):
    """The rendered container's own command, ``python`` as this
    interpreter; the pod's ports and the peer addresses it names are
    mapped onto this host."""
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    args = []
    for a in c["args"]:
        flag, _, value = a.partition("=")
        if flag in ports:
            a = f"{flag}={ports[flag]}"
        elif flag == "--weight-peers":
            a = f"{flag}={','.join(addrs[p] for p in value.split(','))}"
        args.append(a)
    assert "--device=cpu" in args
    cmd = [sys.executable if x == "python" else x for x in c["command"]]
    # One thread a server: the suite's workers share the host's cores.
    return subprocess.Popen(cmd + args, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def _wait_ready(proc, port: int, timeout: float = 90.0) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        assert proc.poll() is None, "the server exited"
        try:
            if json.loads(_get(port, "/readyz"))["ready"]:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("the server was not ready")


def test_scales_rendered_cli_servers_on_scraped_signals(tmp_path):
    api = FakeApiServer()
    api.ensure_namespace(NS)
    api.apply(inference_service_crd())
    cr = inference_service(
        "llm", NS, "lm-test-tiny", replicas=1, min_replicas=1,
        max_replicas=2, engine={"kv_layout": "paged", "batch_size": 4},
        warmup={"peerWeights": True},
        autoscale={"ttftP99Ms": 1e-3, "scrapePeriodSeconds": 5,
                   "cooldownSeconds": 30})
    cr["spec"]["tpuChipsPerReplica"] = 0  # CPU pods: --device=cpu
    api.create(cr)
    addrs, procs = {}, []
    ctrl = tinf.InferenceServiceController(
        api, fetch_metrics=lambda a: tinf._http_fetch_signals(addrs[a])
        if a in addrs else None)
    prompt = {"instances": [{"tokens": [5, 6, 7, 8], "max_new_tokens": 6}]}
    try:
        def start(i):
            port = free_port()
            dep = api.get("apps/v1", "Deployment", f"llm-r{i}", NS)
            log = open(tmp_path / f"r{i}.log", "w")
            proc = _start(dep, {"--rest-port": port, "--grpc-port": -1},
                          addrs, log)
            procs.append((proc, log))
            _wait_ready(proc, port)
            addrs[f"llm-r{i}.{NS}:8500"] = f"127.0.0.1:{port}"
            return port

        ctrl.reconcile_all()
        assert api.get(API, "InferenceService", "llm", NS)["status"][
            "replicas"] == 1
        r0 = start(0)
        want = _post(r0, prompt)["predictions"][0]["tokens"]
        ctrl.reconcile_all()  # r0's TTFT p99 is over 1 microsecond
        st = api.get(API, "InferenceService", "llm", NS)["status"]
        assert st["replicas"] == 2 and "ttft_p99" in st["lastScaleReason"]
        r1_dep = api.get("apps/v1", "Deployment", "llm-r1", NS)
        assert "--weight-peers=llm-r0.kubeflow:8500" in \
            r1_dep["spec"]["template"]["spec"]["containers"][0]["args"]
        r1 = start(1)
        page = _get(r1, "/monitoring/prometheus/metrics")
        assert 'serving_weight_pulls_total{source="peer"} 1' in page
        assert _post(r1, prompt)["predictions"][0]["tokens"] == want
        svc = api.get("v1", "Service", "llm", NS)
        route = yaml.safe_load(
            svc["metadata"]["annotations"][GATEWAY_ROUTE_ANNOTATION])
        assert [b["service"] for b in route["backends"]] == \
            [f"llm-r{i}.{NS}:8500" for i in range(2)]
    finally:
        for proc, log in procs:
            proc.terminate()
            proc.wait(timeout=30)
            log.close()


def test_manager_once_runs_the_three_controllers_over_http():
    """``python -m kubeflow_tpu_torch.operators --once`` against JAX's
    fake apiserver over HTTP: the InferenceService renders its replica
    from ``gpu-serving`` and the pass counts it among the manager's
    twelve controllers (the three of the serving and tuning planes, the
    six job controllers, the scheduler, the RLJob and the Notebook
    controller; the kinds whose CRDs this fake lacks count 0).
    The replica's scrape goes to a proxy that refuses it (no name is
    looked up), so the pool holds."""
    fake = JFakeApiServer()
    fake.ensure_namespace(NS)
    fake.create(jcrd())
    fake.create(jservice("llm", NS, "lm-test-tiny", replicas=1))
    httpd, port = serve(fake)
    env = {**os.environ, "http_proxy": "http://127.0.0.1:1",
           "no_proxy": "127.0.0.1", "OMP_NUM_THREADS": "1"}
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.operators", "--once",
             "--device", "cpu", "--apiserver", f"http://127.0.0.1:{port}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    finally:
        httpd.shutdown()
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        {"reconciled": 2, "controllers": 12}
    st = fake.get(API, "InferenceService", "llm", NS)["status"]
    assert (st["replicas"], st["scrapedReplicas"]) == (1, 0)
    (c,) = fake.get("apps/v1", "Deployment", "llm-r0", NS)["spec"][
        "template"]["spec"]["containers"]
    assert c["resources"]["limits"] == {images.GPU_RESOURCE: 1}
