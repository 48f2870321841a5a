"""The port's QoS and suspension against the JAX package's: the copied
primitives (token bucket, tenant parsing, bounded labels, the fair-share
and aging order), the decoder's token bucket at submit, deadline
shedding, priority order, per-tenant accounting, the suspension of a
low-priority stream to the host tier and its byte-exact resume on fp and
int8 pools, the crash drain of parked streams, and the model server's
QoS headers and 429.

Both packages get the same weights (the JAX init, handed across as numpy
arrays) at ``dtype=float32`` on the CPU; greedy streams and counters are
compared with JAX's.
"""

import http.client
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.scheduler.queue as jqueue  # noqa: E402
import kubeflow_tpu.serving.qos as jqos  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving import qos as tqos  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.qos import (  # noqa: E402
    DeadlineExceeded,
    QosPolicy,
    QosRejected,
    TenantSpec,
)
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

VICTIM = [5, 6, 7, 8, 9, 10, 11, 12]


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return (spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu"),
            tree)


def _kw(slots=4, pool=10, max_new=32, watermark=0, **over):
    kw = dict(slots=slots, prefill_len=32, max_new_tokens=max_new,
              kv_layout="paged", kv_block_size=8, kv_pool_blocks=pool,
              prefix_cache_slots=4, prefix_cache_min_len=8,
              kv_low_watermark=watermark, stream_timeout_s=120.0)
    kw.update(over)
    return kw


def _port(models, **over):
    _jc, _jp, tcfg, tparams, _t = models
    return ContinuousDecoder(tparams, tcfg, **_kw(**over))


def _jax(models, **over):
    jcfg, jparams, *_ = models
    return JaxDecoder(jparams, jcfg, **_kw(**over))


def _two_tier(mod):
    return mod.QosPolicy(
        {"gold": mod.TenantSpec("gold", weight=8, priority=10),
         "free": mod.TenantSpec("free", weight=1, priority=0)},
        aging_seconds=30.0)


# ---------------------------------------------------------------------------
# qos.py (the copy) against JAX's
# ---------------------------------------------------------------------------


def test_token_bucket_refill_and_retry_after():
    for mod in (tqos, jqos):
        b = mod.TokenBucket(rate=2.0, burst=2.0, now=0.0)
        seen = [b.try_take(t) for t in (0.0, 0.0, 0.0, 0.25, 0.5)]
        assert seen[:2] == [(True, 0.0)] * 2
        assert not seen[2][0] and seen[2][1] == pytest.approx(0.5)
        assert not seen[3][0] and seen[3][1] == pytest.approx(0.25)
        assert seen[4] == (True, 0.0)
        free = mod.TokenBucket(rate=0.0, burst=0.0)
        assert all(free.try_take(0.0)[0] for _ in range(100))


def test_parse_render_and_labels_match_jax():
    spec = "free=1,gold=8:100:200:10,mid=2:5"
    t, j = tqos.parse_tenants(spec), jqos.parse_tenants(spec)
    assert {n: vars(s) for n, s in t.items()} == \
        {n: vars(s) for n, s in j.items()}
    structured = {n: {"weight": s.weight, "rate": s.rate, "burst": s.burst,
                      "priority": s.priority} for n, s in t.items()}
    assert tqos.render_tenants(structured) == \
        jqos.render_tenants(structured)
    for bad in ("noequals", "x=1:2:3:4:5", "y=abc"):
        with pytest.raises(ValueError):
            tqos.parse_tenants(bad)
    with pytest.raises(ValueError):
        TenantSpec("z", weight=0)
    names = [f"tenant-{i}" for i in range(500)] + ["", "default", "alice"]
    assert [tqos.tenant_bucket(n) for n in names] == \
        [jqos.tenant_bucket(n) for n in names]
    assert {tqos.tenant_bucket(n) for n in names} <= \
        {f"t{i:02d}" for i in range(16)}


def test_order_primitives_match_the_scheduler_queue():
    rng = np.random.default_rng(0)
    for _ in range(200):
        prio, waited, aging = (float(rng.integers(-5, 20)),
                               float(rng.uniform(0, 300)),
                               float(rng.choice([0.0, 10.0, 30.0])))
        served, weight = float(rng.uniform(0, 1e4)), float(rng.uniform(0.1, 9))
        assert tqos.aged_priority(prio, waited, aging) == \
            jqueue.aged_priority(prio, waited, aging)
        assert tqos.fairness_ratio(served, weight) == \
            jqueue.fairness_ratio(served, weight)
        kw = dict(served=served, weight=weight, priority=prio,
                  waited_seconds=waited, aging_seconds=aging,
                  submit_t=float(rng.uniform(0, 9)))
        assert tqos.order_key(**kw) == jqos.order_key(**kw)


def test_fair_share_and_aging():
    """Under full backlog, serving the lowest order_key converges each
    tenant's share to its weight; a starved low priority overtakes a
    fresh high one once its wait crosses the aging window times the
    gap."""
    weights = {"a": 1, "b": 2, "c": 8}
    served = {t: 0.0 for t in weights}
    for step in range(4000):
        pick = min(weights, key=lambda t: tqos.order_key(
            served=served[t], weight=weights[t], priority=0,
            waited_seconds=0.0, aging_seconds=0.0, submit_t=float(step)))
        served[pick] += 1.0
    for t, w in weights.items():
        assert served[t] / 4000 == pytest.approx(w / 11, abs=0.02)

    def key(prio, waited):
        return tqos.order_key(served=0.0, weight=1.0, priority=prio,
                              waited_seconds=waited, aging_seconds=10.0,
                              submit_t=0.0)

    assert key(10, 0.0) < key(0, 50.0)
    assert key(0, 150.0) < key(10, 0.0)


def test_qos_policy_admission_and_priority_defaults():
    qos = QosPolicy("gold=8:2:2:10,free=1", aging_seconds=30)
    assert qos.base_priority("gold", None) == 10
    assert qos.base_priority("gold", 3) == 3
    assert qos.base_priority("unknown", None) == 0
    qos.admit("gold", 0.0)
    qos.admit("gold", 0.0)
    with pytest.raises(QosRejected) as err:
        qos.admit("gold", 0.0)
    assert err.value.retry_after_s > 0
    for _ in range(50):
        qos.admit("free", 0.0)


# ---------------------------------------------------------------------------
# The decoder's QoS
# ---------------------------------------------------------------------------


def test_submit_rejects_over_rate_tenant(models):
    for mod, make in ((tqos, _port), (jqos, _jax)):
        d = make(models, qos=mod.QosPolicy(
            {"capped": mod.TenantSpec("capped", rate=0.01, burst=1)}))
        try:
            d.generate([1, 2, 3], 2, tenant="capped")
            with pytest.raises(mod.QosRejected):
                d.submit([1, 2, 3], 2, tenant="capped")
        finally:
            d.stop()


def test_deadline_shedding(models):
    """A request whose deadline passes while queued is shed with
    DeadlineExceeded, never served; the blocker is undisturbed and its
    tokens equal JAX's."""
    got = []
    for mod, make in ((tqos, _port), (jqos, _jax)):
        d = make(models, slots=1, qos=mod.QosPolicy({}))
        try:
            blocker = d.submit([5, 6, 7], 32)
            next(blocker.tokens(timeout=60))
            doomed = d.submit([1, 2, 3], 4, deadline_ms=1.0)
            with pytest.raises(mod.DeadlineExceeded):
                doomed.result(timeout=60)
            assert doomed._req.out == []
            got.append((blocker.result(timeout=60)["tokens"],
                        d.metrics()["qos_deadline_shed"]))
        finally:
            d.stop()
    assert got[0] == got[1] and got[0][1] == 1
    assert issubclass(DeadlineExceeded, TimeoutError)


def test_priority_orders_the_queue(models):
    """One slot: a high-priority late arrival is served before the queued
    low-priority backlog."""
    d = _port(models, slots=1, qos=_two_tier(tqos))
    try:
        first = d.submit([5, 6, 7], 8, tenant="free")
        lows = [d.submit([5, 6, 7, i], 4, tenant="free") for i in range(3)]
        gold = d.submit([9, 9, 9], 2, tenant="gold")
        gold.result(timeout=120)
        assert any(not h._req.done.is_set() for h in lows)
        for h in [first] + lows:
            h.result(timeout=120)
    finally:
        d.stop()


def test_tenant_served_accounting_and_labels_match_jax(models):
    got = []
    for mod, make in ((tqos, _port), (jqos, _jax)):
        d = make(models, qos=_two_tier(mod))
        try:
            toks = [d.generate([1, 2, 3], 4, tenant="gold")["tokens"],
                    d.generate([4, 5, 6], 2, tenant="free")["tokens"]]
            m = d.metrics()
            text = d.registry.render()
        finally:
            d.stop()
        labels = sorted(line.split("{")[1].split("}")[0]
                        for line in text.splitlines()
                        if line.startswith(
                            "serving_tenant_queue_wait_seconds_count{"))
        got.append((toks, m["tenant_served"], m["qos_enabled"], labels))
    assert got[0] == got[1]
    assert got[0][1] == {"gold": 4.0, "free": 2.0}


# ---------------------------------------------------------------------------
# Suspension and resume
# ---------------------------------------------------------------------------


def _force_suspension(d, want, min_emitted=1):
    """A low-priority victim, then high-priority golds that cannot fit
    beside it: the pop loop suspends the victim."""
    h = d.submit(VICTIM, want, tenant="free")
    deadline = time.perf_counter() + 30
    while len(h._req.out) < min_emitted and time.perf_counter() < deadline:
        time.sleep(0.002)
    assert len(h._req.out) >= min_emitted, "victim never started"
    return h, [d.submit([9] * 20 + [i], 4, tenant="gold") for i in range(3)]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_suspend_resume_byte_identity(models, kv_dtype):
    """A suspended, parked and resumed stream emits exactly the tokens of
    the same stream never suspended, and of JAX's; the golds equal
    JAX's; the pinned payload drains and no block leaks."""
    kw = dict(qos=_two_tier(tqos), host_kv_bytes=1 << 20, watermark=2,
              kv_dtype=kv_dtype)
    ref = _port(models, **kw)
    try:
        want = ref.generate(VICTIM, 32, timeout=120)["tokens"]
        gold_want = [ref.generate([9] * 20 + [i], 4, timeout=120)["tokens"]
                     for i in range(3)]
    finally:
        ref.stop()
    jref = _jax(models, **{**kw, "qos": _two_tier(jqos)})
    try:
        assert jref.generate(VICTIM, 32, timeout=120)["tokens"] == want
        jgolds = [jref.generate([9] * 20 + [i], 4, timeout=120)["tokens"]
                  for i in range(3)]
    finally:
        jref.stop()
    assert jgolds == gold_want
    d = _port(models, **kw)
    try:
        h, golds = _force_suspension(d, 32)
        assert [g.result(timeout=120)["tokens"] for g in golds] == gold_want
        out = h.result(timeout=120)["tokens"]
        m = d.metrics()
        with d._prefix_lock:
            while d.prefix_cache.evict_lru():
                pass
        in_use = d.metrics()["kv_blocks_in_use"]
    finally:
        d.stop()
    assert out == want
    assert m["kv_suspends"] >= 1 and m["kv_resumes"] == m["kv_suspends"]
    assert m["kv_host_tier_pinned_bytes"] == 0
    assert m["kv_host_hits"] >= 1
    assert in_use == 0


def test_fail_all_drains_parked_streams(models):
    """A crash with a SUSPENDED stream parked: the parked request fails
    fast (the queued sweep catches it), its pinned payload drains, and
    the pool returns to zero after a full trie evict."""
    d = _port(models, qos=_two_tier(tqos), host_kv_bytes=1 << 20,
              watermark=2)
    try:
        h = d.submit(VICTIM, 32, tenant="free")
        while len(h._req.out) < 2:
            time.sleep(0.002)
        gold = d.submit([9] * 20, 32, tenant="gold")
        deadline = time.perf_counter() + 30
        while (d.metrics()["kv_suspends"] < 1
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        assert d.metrics()["kv_suspends"] >= 1
        assert h._req.host_key is not None  # parked, payload pinned
        with d._state_lock:
            d._state = None  # the next dispatch raises
        t0 = time.perf_counter()
        with pytest.raises(Exception):
            h.result(timeout=60)
        with pytest.raises(Exception):
            gold.result(timeout=60)
        assert time.perf_counter() - t0 < 10, "parked stream hung"
        with d._prefix_lock:
            while d.prefix_cache.evict_lru():
                pass
        m = d.metrics()
        assert m["kv_host_tier_pinned_bytes"] == 0
        assert m["kv_blocks_in_use"] == 0
    finally:
        d.stop()


def test_no_victim_without_the_host_tier(models):
    """QoS without a host tier never suspends: the gold waits for the
    pool, as a deferral."""
    d = _port(models, qos=_two_tier(tqos), watermark=2)
    try:
        h, golds = _force_suspension(d, 32)
        for g in golds:
            g.result(timeout=120)
        h.result(timeout=120)
        m = d.metrics()
        assert m["kv_suspends"] == 0 and m["kv_defer_admissions"] >= 1
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# HTTP: the QoS headers and 429
# ---------------------------------------------------------------------------


def _post(port, body, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/models/lm-test-tiny:predict",
                     body=json.dumps(body), headers=headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture()
def qos_server(models):
    server = ModelServer(
        EngineConfig(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                     max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                     host_kv_bytes=1 << 20, dtype="float32", device="cpu",
                     qos_tenants="gold=8:0:0:10,capped=1:1:1"),
        port=0, params=models[4], batch_timeout_ms=2)
    server.start()
    yield server
    server.stop()


def test_server_threads_qos_headers(qos_server):
    status, _h, body = _post(
        qos_server.port,
        {"instances": [{"tokens": [1, 2, 3], "max_new_tokens": 4}]},
        {"X-Tenant": "gold", "X-Priority": "5", "X-Deadline-Ms": "60000"})
    assert status == 200, body
    assert qos_server.decoder.metrics()["tenant_served"].get("gold") == 4
    # The stream path reads the same headers.
    status, _h, body = _post(
        qos_server.port, {"stream": True, "instances": [
            {"tokens": [1, 2, 3], "max_new_tokens": 2}]},
        {"X-Tenant": "gold"})
    assert status == 200, body
    assert qos_server.decoder.metrics()["tenant_served"]["gold"] == 6


def test_server_429_with_retry_after(qos_server):
    payload = {"instances": [{"tokens": [1, 2, 3], "max_new_tokens": 2}]}
    assert _post(qos_server.port, payload, {"X-Tenant": "capped"})[0] == 200
    status, headers, body = _post(qos_server.port, payload,
                                  {"X-Tenant": "capped"})
    assert status == 429, body
    assert int(headers["Retry-After"]) >= 1
    assert headers["X-Request-ID"]
    for bad in ({"X-Priority": "high"}, {"X-Deadline-Ms": "soon"}):
        assert _post(qos_server.port, payload, bad)[0] == 400
