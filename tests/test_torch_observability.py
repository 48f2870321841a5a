"""The port's observability against the JAX package's: the copied metric
and tracing modules on the JAX package's own cases, the decoder's
instruments and timelines, request ids over HTTP, and the
``/monitoring/prometheus/metrics`` exposition held against the JAX
server's for the same requests.

The servers get the same weights (the JAX init at ``dtype=float32``,
handed across as numpy arrays) and the same requests, sent one at a time
so both schedule alike: every metric family and ``# TYPE`` line must be
equal, every counter equal, and every histogram's ``_count``.
"""

import ast
import http.client
import json
import math
import random
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.observability.lint import lint  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402,E501
from kubeflow_tpu.serving.server import ModelServer as JaxServer  # noqa: E402,E501
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.observability.metrics import (  # noqa: E402
    DEFAULT_LATENCY_BUCKETS,
    Histogram,
    MetricRegistry,
    render_prometheus,
    type_line,
)
from kubeflow_tpu_torch.observability.tracing import (  # noqa: E402
    TraceStore,
    gen_request_id,
)
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def weights():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu"), \
        tree


# ---------------------------------------------------------------------------
# The copies, on the JAX package's cases (tests/test_observability.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["metrics", "tracing"])
def test_copies_match_the_jax_modules(name):
    """The copies differ from their JAX originals in the module docstring
    only."""
    def body(path):
        tree = ast.parse(path.read_text())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    rel = Path("observability") / f"{name}.py"
    assert body(ROOT / "kubeflow_tpu_torch" / rel) == \
        body(ROOT / "kubeflow_tpu" / rel)


def test_histogram_concurrent_observes_match_serial_reference():
    h = Histogram()
    rngs = [random.Random(seed) for seed in range(8)]
    values = [[rng.uniform(0, 2.0) for _ in range(500)] for rng in rngs]

    def work(vals):
        for v in vals:
            h.observe(v)

    threads = [threading.Thread(target=work, args=(vals,))
               for vals in values]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ref = Histogram()
    for v in (v for vals in values for v in vals):
        ref.observe(v)
    cum, total_sum, count = h.snapshot()
    ref_cum, ref_sum, ref_count = ref.snapshot()
    assert count == ref_count == 4000
    assert cum == ref_cum
    assert math.isclose(total_sum, ref_sum, rel_tol=1e-9)
    assert all(b >= a for a, b in zip(cum, cum[1:]))
    assert cum[-1] == count


def test_histogram_quantile_interpolation():
    h = Histogram(buckets=[1, 2, 4, 8])
    for v in [0.5, 1.5, 3.0, 3.5, 6.0]:
        h.observe(v)
    assert 2.0 < h.quantile(0.5) <= 4.0
    assert h.quantile(1.0) <= 8.0
    h.observe(100.0)
    assert h.quantile(1.0) == 8.0
    assert Histogram().quantile(0.99) == 0.0


def test_registry_render_and_label_escaping_survive_lint():
    reg = MetricRegistry()
    reg.counter("demo_requests_total", "say \"hi\"", labels=("route",)) \
        .labels('we"ird\\ro\nute').inc(3)
    reg.gauge("demo_depth", "queue depth").set(7)
    reg.histogram("demo_latency_seconds", labels=("kind",)) \
        .labels("admit").observe(0.25)
    text = reg.render()
    assert type_line("demo_requests_total", "counter") in text
    assert 'route="we\\"ird\\\\ro\\nute"' in text
    assert lint(text) == []
    assert "demo_depth 7\n" in text
    assert 'demo_latency_seconds_bucket{kind="admit",le="+Inf"} 1' in text


def test_registry_rejects_kind_and_label_conflicts():
    reg = MetricRegistry()
    reg.counter("x_total")
    assert reg.counter("x_total") is not None
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", labels=("a",))
    with pytest.raises(ValueError):
        reg.counter("y_total").inc(-1)


def test_gauge_set_function_and_render_prometheus_lint():
    reg = MetricRegistry()
    depth = [3]
    reg.gauge("live_depth").set_function(lambda: depth[0])
    assert "live_depth 3\n" in reg.render()
    depth[0] = 9
    assert "live_depth 9\n" in reg.render()
    assert lint(render_prometheus({"a_total": 1, "b": 2.5})) == []
    b = DEFAULT_LATENCY_BUCKETS
    assert b[0] == pytest.approx(1e-4) and b[-1] == pytest.approx(1e2)


def test_timeline_span_sum_equals_duration_and_ring_is_bounded():
    store = TraceStore(capacity=4)
    for i in range(6):
        tl = store.start(f"req-{i}")
        tl.event("submit")
        tl.event("admitted", slot=i)
        tl.event("first_token")
        tl.close("length")
    assert store.open_count == 0
    snap = store.snapshot()
    assert len(snap["finished"]) == 4
    rec = snap["finished"][-1]
    assert rec["request_id"] == "req-5" and rec["status"] == "length"
    assert sum(s["duration_ms"] for s in rec["spans"]) == pytest.approx(
        rec["duration_ms"], abs=0.05)
    chrome = store.chrome_trace()
    assert len([e for e in chrome["traceEvents"] if e["ph"] == "X"]) == 12
    json.dumps(chrome)


def test_timeline_close_is_idempotent_and_caps_events():
    store = TraceStore(capacity=2, max_events=4)
    tl = store.start()
    assert len(tl.request_id) == 16
    for _ in range(10):
        tl.event("dispatch", tokens=1)
    tl.close("eos")
    tl.close(error=RuntimeError("late"))
    rec = tl.to_dict()
    assert rec["status"] == "eos" and rec["error"] is None
    assert len(rec["events"]) == 5
    assert rec["events"][-1]["name"] == "finish"
    assert rec["dropped_events"] == 6


def test_timeline_to_dict_consistent_with_concurrent_close():
    for i in range(50):
        store = TraceStore()
        tl = store.start(f"rid{i:03d}")
        tl.event("submit")
        out: list[dict] = []
        t = threading.Thread(target=lambda: out.append(tl.to_dict()))
        t.start()
        tl.close(error=RuntimeError("boom"))
        t.join(timeout=10)
        d = out[0]
        if d["status"] == "error":
            assert d["error"] == "boom"
        else:
            assert d["status"] == "open" and d["error"] is None
    assert tl.open is False


# ---------------------------------------------------------------------------
# The decoder's instruments and timelines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decoder_timelines_close_on_finish_and_on_loop_death(weights,
                                                             layout):
    *_, tcfg, tparams, _ = weights
    d = ContinuousDecoder(tparams, tcfg, slots=2, prefill_len=16,
                          max_new_tokens=8, kv_layout=layout,
                          kv_block_size=8)
    try:
        rid = gen_request_id()
        res = d.submit([1, 2, 3], 4, request_id=rid).result(timeout=60)
        assert len(res["tokens"]) == 4
        (rec,) = d.trace.find(rid)
        assert rec["status"] == "length"
        names = [e["name"] for e in rec["events"]]
        for expected in ("submit", "queued", "admitted", "prefill",
                         "first_token", "finish"):
            assert expected in names, (expected, names)
        assert names.index("first_token") < names.index("finish")
        assert sum(s["duration_ms"] for s in rec["spans"]) == \
            pytest.approx(rec["duration_ms"], abs=0.05)
        h2 = d.submit([4, 5], 6, request_id="dying")
        d._fail_all(RuntimeError("chaos: loop died"))
        with pytest.raises(RuntimeError):
            h2.result(timeout=10)
        assert d.trace.open_count == 0
        dead = d.trace.find("dying")[0]
        assert dead["status"] == "error" and "chaos" in dead["error"]
    finally:
        d.stop()
    assert d.trace.open_count == 0


def test_chunked_timeline_records_the_chain(weights):
    *_, tcfg, tparams, _ = weights
    d = ContinuousDecoder(tparams, tcfg, slots=2, prefill_len=16,
                          max_new_tokens=8, kv_layout="paged",
                          kv_block_size=8, prefill_chunk_tokens=8,
                          max_prompt_len=40)
    try:
        d.generate(list(range(1, 30)), 2, timeout=60, request_id="long")
    finally:
        d.stop()
    names = [e["name"] for e in d.trace.find("long")[0]["events"]]
    assert "chunked_admission" in names
    assert names.count("prefill_chunk") == 3  # 29 tokens: 8+8+8, final 5
    assert names.index("prefill_chunk") < names.index("prefill")


@pytest.fixture(scope="module")
def jax_decoder_metrics(weights):
    jcfg, jparams, *_ = weights
    d = JaxDecoder(jparams, jcfg, slots=2, prefill_len=16, max_new_tokens=8,
                   kv_layout="paged", kv_block_size=8)
    try:
        for _ in range(3):
            d.generate([1, 2, 3], 4, timeout=60)
        return d.metrics()
    finally:
        d.stop()


def test_decoder_metrics_keys_and_counts_match_jax(weights,
                                                   jax_decoder_metrics):
    """Every key of the JAX decoder's metrics(), with equal values for
    everything that is not a time, and lint-clean histograms."""
    *_, tcfg, tparams, _ = weights
    d = ContinuousDecoder(tparams, tcfg, slots=2, prefill_len=16,
                          max_new_tokens=8, kv_layout="paged",
                          kv_block_size=8)
    try:
        for _ in range(3):
            d.generate([1, 2, 3], 4, timeout=60)
        m = d.metrics()
        text = d.registry.render()
    finally:
        d.stop()
    want = jax_decoder_metrics
    assert set(want) <= set(m), sorted(set(want) - set(m))
    timed = {k for k in want if k.endswith("_s") or "seconds" in k}
    for key in set(want) - timed:
        assert m[key] == want[key], key
    assert 0 < m["ttft_p50_s"] <= m["ttft_p99_s"]
    assert lint(text) == []
    assert type_line("serving_ttft_seconds", "histogram") in text
    assert 'serving_dispatch_seconds_count{kind="admit"}' in text


# ---------------------------------------------------------------------------
# The exposition against the JAX server's, and request ids over HTTP
# ---------------------------------------------------------------------------

PREFIX_CFG = dict(kv_layout="paged", kv_block_size=8, prefix_cache_slots=4,
                  prefix_cache_min_len=8)
CHUNK_CFG = dict(kv_layout="paged", kv_block_size=8, prefill_chunk_tokens=8,
                 max_prompt_len=48)
# A pool of 6 blocks under 4 trie entries and a host tier: the third
# request evicts (demotes) SYSTEM's entry, the fourth promotes it back
# and demotes the others to make room; QoS is on.
TIER_QOS_CFG = dict(kv_layout="paged", kv_block_size=8, kv_pool_blocks=6,
                    prefix_cache_slots=4, prefix_cache_min_len=8,
                    host_kv_bytes=1 << 20,
                    qos_tenants="gold=8:0:0:10,free=1")
SYSTEM = list(range(2, 22))
TRAFFIC = {
    "dense": [{"tokens": [1, 2, 3], "max_new_tokens": 4},
              {"tokens": [7, 5], "max_new_tokens": 8},
              {"tokens": [9, 9, 2]}],
    "paged_prefix": [{"tokens": SYSTEM, "max_new_tokens": 4},
                     {"tokens": SYSTEM + [50, 51], "max_new_tokens": 6},
                     {"tokens": SYSTEM[:16] + [3], "max_new_tokens": 3}],
    "chunked": [{"tokens": list(range(1, 41)), "max_new_tokens": 4},
                {"tokens": [4, 5, 6], "max_new_tokens": 5}],
    "host_tier_qos": [{"tokens": SYSTEM, "max_new_tokens": 4},
                      {"tokens": list(range(30, 50)), "max_new_tokens": 4},
                      {"tokens": list(range(60, 80)), "max_new_tokens": 4},
                      {"tokens": SYSTEM + [50, 51], "max_new_tokens": 6}],
}
CASES = {"dense": {}, "paged_prefix": PREFIX_CFG, "chunked": CHUNK_CFG,
         "host_tier_qos": TIER_QOS_CFG}


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


PREDICT = "/v1/models/lm-test-tiny:predict"
METRICS = "/monitoring/prometheus/metrics"
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)$")


def _exposition(text):
    """(the # TYPE lines in order, {sample: value})."""
    types = [line for line in text.splitlines() if line.startswith("# TYPE")]
    samples = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m:
            samples[m.group(1)] = float(m.group(2))
    return types, samples


def _settled_scrape(port, family, want, deadline_s=10.0):
    """The exposition once ``family`` reads ``want``. Both servers count
    a request in the handler's ``finally``, after the response is
    written, so a scrape sent right after a response can land before
    that count; polling (bounded) reads every server in the state the
    comparison means."""
    end = time.monotonic() + deadline_s
    while True:
        status, _, text = _request(port, "GET", METRICS)
        assert status == 200
        if _exposition(text)[1].get(family) == want:
            return text
        if time.monotonic() > end:
            raise AssertionError(f"{family} never read {want} in "
                                 f"{deadline_s} s")
        time.sleep(0.02)


def _scrape_after(server, traffic, port):
    for body in traffic:
        status, _, text = _request(port, "POST", PREDICT,
                                   {"instances": [body]})
        assert status == 200, text
    return _settled_scrape(port, "serving_requests_total", len(traffic))


@pytest.mark.parametrize("case", list(CASES))
def test_exposition_matches_the_jax_server(weights, case):
    kw = dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
              max_new_tokens=8, dtype="float32", **CASES[case])
    jserver = JaxServer(JaxEngineConfig(**kw), port=0, grpc_port=None,
                        batch_timeout_ms=2)
    jserver.start()
    try:
        want = _scrape_after(jserver, TRAFFIC[case], jserver.port)
    finally:
        jserver.stop()
    server = ModelServer(EngineConfig(**kw, device="cpu"), port=0,
                         params=weights[4], batch_timeout_ms=2)
    server.start()
    try:
        got = _scrape_after(server, TRAFFIC[case], server.port)
    finally:
        server.stop()
    (jtypes, jsamples), (types, samples) = _exposition(want), \
        _exposition(got)
    assert types == jtypes
    assert lint(got) == []
    counters = {line.split()[2] for line in types
                if line.split()[3] == "counter"}
    compared = 0
    for name, value in jsamples.items():
        family = name.split("{")[0]
        if family in counters or family.endswith("_count"):
            assert samples.get(name) == value, name
            compared += 1
    assert compared > 40
    assert samples["serving_requests_total"] == len(TRAFFIC[case])
    if case == "paged_prefix":
        assert samples["serving_prefix_hits_total"] >= 1
        assert samples["serving_kv_shared_blocks_total"] >= 1
        assert samples["serving_kv_cow_copies_total"] >= 1
    if case == "chunked":
        assert samples["serving_prefill_chunks_total"] >= 1
    if case == "host_tier_qos":
        assert samples["serving_kv_host_demotions_total"] >= 2
        assert samples["serving_kv_host_promotions_total"] >= 1
        assert samples["serving_qos_enabled"] == 1


def test_request_ids_round_trip_over_http(weights):
    server = ModelServer(
        EngineConfig(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                     max_new_tokens=8, dtype="float32", device="cpu",
                     **PREFIX_CFG),
        port=0, params=weights[4], batch_timeout_ms=2)
    server.start()
    try:
        port = server.port
        body = {"instances": [{"tokens": [1, 2, 3], "max_new_tokens": 3}]}
        status, headers, _ = _request(port, "POST", PREDICT, body,
                                      {"X-Request-ID": "rid-abc"})
        assert status == 200 and headers["X-Request-ID"] == "rid-abc"
        status, headers, _ = _request(port, "POST", PREDICT, body)
        minted = headers["X-Request-ID"]
        assert status == 200 and re.fullmatch(r"[0-9a-f]{16}", minted)
        status, headers, text = _request(
            port, "POST", PREDICT, {"stream": True, **body},
            {"X-Request-ID": "rid-stream"})
        assert status == 200 and headers["X-Request-ID"] == "rid-stream"
        two = {"instances": [{"tokens": [4, 5], "max_new_tokens": 2}] * 2}
        assert _request(port, "POST", PREDICT, two,
                        {"X-Request-ID": "rid-two"})[0] == 200
        for rid in ("rid-abc", minted, "rid-stream", "rid-two", "rid-two-1"):
            status, headers, text = _request(
                port, "GET", f"/debug/requests?id={rid}")
            assert status == 200
            (rec,) = json.loads(text)["requests"]
            assert rec["request_id"] == rid and rec["status"] == "length"
            assert [e["name"] for e in rec["events"]][-1] == "finish"
        status, headers, text = _request(
            port, "GET", "/debug/requests?format=chrome",
            headers={"X-Request-ID": "rid-get"})
        assert headers["X-Request-ID"] == "rid-get"
        assert any(e["ph"] == "X" for e in json.loads(text)["traceEvents"])
        status, _, text = _request(port, "GET", "/debug/requests")
        assert json.loads(text)["open"] == []
        # An error response echoes the id too.
        status, headers, _ = _request(port, "POST", PREDICT, {"instances": [
            {"tokens": list(range(40)), "max_new_tokens": 1}]},
            {"X-Request-ID": "rid-413"})
        assert status == 413 and headers["X-Request-ID"] == "rid-413"
        text = _settled_scrape(port, "serving_errors_total", 1)
        assert "serving_errors_total 1\n" in text
    finally:
        server.stop()
