"""The port's decoder fleet against the JAX package's: rendezvous keys and
orders, placement (affine, spilled under pressure, off dead replicas,
warming newborns), the replica-death chaos (streams fail fast with the
502-coded error, only the dead replica's keys remap, survivors leak no
block), the disaggregated prefill->decode relay, and fleet weight
broadcasts (subset pushes, lag exclusion, claimed epochs).

Placement runs on stub replicas of JAX's shape (pure host logic, the same
stub under both fleets); the chaos, the relay and the broadcasts drive
real decoders of both packages with the same weights (the JAX init,
handed across as numpy arrays) at ``dtype=float32`` on the CPU, where
greedy streams must be identical.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving import affinity as jaffinity  # noqa: E402
from kubeflow_tpu.serving import fleet as jfleet  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving import affinity as taffinity  # noqa: E402
from kubeflow_tpu_torch.serving import fleet as tfleet  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

SPEC = get_model("lm-test-tiny", dtype=jnp.float32)
J1 = SPEC.init(jax.random.PRNGKey(0), SPEC.config)
J2 = SPEC.init(jax.random.PRNGKey(1), SPEC.config)
P1 = jax.tree.map(np.asarray, J1)
P2 = jax.tree.map(np.asarray, J2)
TCFG = ttransformer.config("lm-test-tiny", dtype=torch.float32)
T1 = params_from_numpy(P1, TCFG, "cpu")


def _prompts(n: int, seed: int = 0) -> list[list[int]]:
    rng = random.Random(seed)
    return [[rng.randrange(256) for _ in range(rng.randrange(1, 48))]
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Rendezvous hashing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 4, 32])
def test_affinity_keys_and_orders_equal_jax(width):
    """Keys and rendezvous orders are JAX's bit for bit: the gateway, the
    JAX fleet and the port's place a prompt on the same replica."""
    members = [f"r{i}" for i in range(7)] + ["m:8500", "m:8501"]
    for toks in _prompts(300, seed=width):
        key = taffinity.prefix_affinity_key(toks, width)
        assert key == jaffinity.prefix_affinity_key(toks, width)
        assert taffinity.rendezvous_order(key, members) == \
            jaffinity.rendezvous_order(key, members)
        assert taffinity.rendezvous_pick(key, members[:3]) == \
            jaffinity.rendezvous_pick(key, members[:3])
    assert taffinity.DEFAULT_AFFINITY_TOKENS == \
        jaffinity.DEFAULT_AFFINITY_TOKENS
    assert taffinity.rendezvous_pick("k", []) is None


def test_rendezvous_churn_moves_only_the_changed_members_keys():
    keys = [taffinity.prefix_affinity_key([i, i + 1, i * 3])
            for i in range(800)]
    four = [f"r{i}" for i in range(4)]
    a4 = {k: taffinity.rendezvous_pick(k, four) for k in keys}
    a5 = {k: taffinity.rendezvous_pick(k, four + ["r4"]) for k in keys}
    moved = [k for k in keys if a4[k] != a5[k]]
    assert all(a5[k] == "r4" for k in moved)
    assert 0.10 < len(moved) / len(keys) < 0.33
    three = [m for m in four if m != "r2"]
    for k in keys:
        got = taffinity.rendezvous_pick(k, three)
        assert got == a4[k] if a4[k] != "r2" else got != "r2"


# ---------------------------------------------------------------------------
# Placement on stub replicas, the same stubs under both fleets
# ---------------------------------------------------------------------------


class _Alloc:
    def __init__(self, in_use: int, total: int = 8):
        self.blocks_in_use, self.num_blocks = in_use, total


class _StubReplica:
    """JAX's stub shape: submit/metrics/stop, a settable queue depth, a
    KV fill, a role and a weights epoch."""

    def __init__(self, depth: int = 0, fill: int = 0, role: str = ""):
        self._active_count = depth
        self._pending: list = []
        self._alloc = _Alloc(fill)
        self.role = role
        self.submitted: list = []
        self.dead = False
        self.weights_version = 0
        self.pushes: list = []

    def submit(self, tokens, want, temperature=0.0, *, request_id=None):
        if self.dead:
            raise RuntimeError("decoder is stopped")
        self.submitted.append(list(tokens))
        return object()

    def update_weights(self, params, *, version=None, draft_params=None):
        if self.dead:
            raise RuntimeError("decoder stopped")
        self.pushes.append(version)
        self.weights_version = version
        return version

    def metrics(self):
        return {"prefix_hits": 0, "prefix_misses": len(self.submitted),
                "tokens_emitted": 3 * len(self.submitted)}

    def stop(self):
        pass


_ROUTE_CASES = {
    "affine": dict(n=4),
    "pressure": dict(n=4, pressure=3, depths=[3, 2, 0, 5]),
    "kv_pressure": dict(n=4, kv_pressure=0.5, fills=[6, 1, 4, 0],
                        depths=[2, 1, 0, 1]),
    "dead": dict(n=5, dead=["r1", "r3"]),
    "dead_and_pressure": dict(n=5, dead=["r0"], pressure=2,
                              depths=[0, 4, 1, 2, 3]),
    "warming": dict(n=4, warming=["r2"], pressure=1, depths=[1, 0, 0, 1]),
    "random": dict(n=4, router="random", seed=3),
    "disaggregated": dict(n=4, roles=["prefill", "prefill", "", "decode"],
                          fills=[0, 0, 3, 2]),
}


def _stub_fleet(fleet_mod, case: dict):
    n = case["n"]
    depths = case.get("depths", [0] * n)
    fills = case.get("fills", [0] * n)
    roles = case.get("roles", [""] * n)
    reps = {f"r{i}": _StubReplica(depths[i], fills[i], roles[i])
            for i in range(n)}
    fleet = fleet_mod.DecoderFleet(
        reps, affinity_tokens=8, pressure=case.get("pressure", 0),
        kv_pressure=case.get("kv_pressure", 0.0),
        router=case.get("router", "affine"), seed=case.get("seed", 0))
    for name in case.get("dead", ()):
        fleet.mark_dead(name)
    for name in case.get("warming", ()):
        reps[name].warming = True
    return fleet


@pytest.mark.parametrize("case", list(_ROUTE_CASES))
def test_route_equals_jax_fleet(case):
    """The same keys, loads, dead sets and roles: every route, the decode
    leg's placement and the routing counters equal JAX's fleet's."""
    spec = _ROUTE_CASES[case]
    fleets = [_stub_fleet(m, spec) for m in (tfleet, jfleet)]
    for toks in _prompts(200, seed=len(case)):
        picks = [f.route(toks) for f in fleets]
        assert picks[0] == picks[1], toks
    if fleets[0].disaggregated:
        assert fleets[0].route_decode() == fleets[1].route_decode()
    for attr in ("routed", "spilled"):
        assert getattr(fleets[0], attr) == getattr(fleets[1], attr)
    assert fleets[0].live_members() == fleets[1].live_members()


def test_submit_remaps_and_all_dead_raises_as_jax():
    picks = []
    for mod in (tfleet, jfleet):
        reps = {f"r{i}": _StubReplica() for i in range(3)}
        fleet = mod.DecoderFleet(reps, affinity_tokens=4)
        toks = [9, 8, 7]
        home = fleet.route(toks)
        reps[home].dead = True
        handle = fleet.submit(toks, 4)
        assert handle.replica != home and fleet.remapped == 1
        assert home not in fleet.live_members()
        picks.append((home, handle.replica))
        for r in reps.values():
            r.dead = True
        with pytest.raises(mod.ReplicaUnavailableError) as e:
            fleet.submit([1, 2], 4)
        assert e.value.code == 502
    assert picks[0] == picks[1]


def test_newborn_warming_donor_and_metrics_as_jax():
    """add_replica joins a warming newborn (spill only), mark_warm gives
    it its affine share, donor_for skips it while it warms; the fleet's
    metrics aggregate the live replicas, as JAX's do."""
    outs = []
    for mod in (tfleet, jfleet):
        reps = {f"r{i}": _StubReplica() for i in range(3)}
        fleet = mod.DecoderFleet(reps, affinity_tokens=4)
        newborn = _StubReplica()
        newborn.weights_version = 2
        fleet.add_replica("r3", newborn)
        prompts = _prompts(100, seed=7)
        warm_picks = [fleet.route(p) for p in prompts]
        donor = fleet.donor_for("r3")
        fleet.mark_warm("r3")
        picks = [fleet.route(p) for p in prompts]
        fleet.submit(prompts[0], 4)
        fleet.mark_dead("r0")
        m = fleet.metrics()
        outs.append((warm_picks, donor, picks, m["live"], m["dead"],
                     m["routed"], m["tokens_emitted"],
                     m["replicas_added"], fleet.weights_versions()))
        with pytest.raises(ValueError):
            fleet.add_replica("r3", _StubReplica())
    assert outs[0] == outs[1]
    assert "r3" not in outs[0][0] and "r3" in outs[0][2]


def test_stub_broadcasts_equal_jax():
    """Subset pushes, lagging members, unknown names, a dead replica's
    failure and revival, and weights_max_lag's routing exclusion: the
    results equal JAX's fleet's on the same sequence."""
    outs = []
    for mod in (tfleet, jfleet):
        reps = {f"r{i}": _StubReplica() for i in range(3)}
        fleet = mod.DecoderFleet(reps, affinity_tokens=4, weights_max_lag=1)
        seq = [fleet.broadcast_weights(None)]
        seq.append(fleet.broadcast_weights(None, members=["r0", "zz"]))
        seq.append(fleet.broadcast_weights(None, members=["r0"]))
        routes = {fleet.route(p) for p in _prompts(50)}
        reps["r1"].dead = True
        seq.append(fleet.broadcast_weights(None, version=7))
        reps["r1"].dead = False
        seq.append(fleet.broadcast_weights(None))
        outs.append((seq, routes, fleet.weights_versions(),
                     fleet.live_members(),
                     {n: r.pushes for n, r in reps.items()}))
    assert outs[0] == outs[1]
    assert outs[0][1] == {"r0"}  # r1 and r2 lag by 2 > max_lag 1


def test_concurrent_broadcasts_claim_distinct_epochs():
    reps = {f"r{i}": _StubReplica() for i in range(4)}
    fleet = tfleet.DecoderFleet(reps)
    out: list = []
    threads = [threading.Thread(
        target=lambda: out.append(fleet.broadcast_weights(None)["version"]))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(out) == list(range(1, 9))
    assert fleet.weights_versions()["latest"] == 8


def test_metrics_snapshot_consistent_under_concurrent_mark_dead():
    """metrics() snapshots the dead set under the fleet lock while
    mark_dead runs on other threads: live and dead always partition the
    membership."""
    reps = {f"r{i:02d}": _StubReplica() for i in range(24)}
    fleet = tfleet.DecoderFleet(reps, affinity_tokens=4)
    errors: list[Exception] = []
    stop = threading.Event()

    def hammer():
        try:
            while not stop.is_set():
                m = fleet.metrics()
                live, dead = set(m["live"]), set(m["dead"])
                assert live | dead == set(reps)
                assert not live & dead
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        for name in sorted(reps)[:-1]:
            fleet.mark_dead(name)
            time.sleep(0.002)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors, errors


# ---------------------------------------------------------------------------
# Real decoders: chaos, the relay, broadcasts
# ---------------------------------------------------------------------------


def _kw(**kw):
    base = dict(slots=4, prefill_len=16, max_new_tokens=64,
                kv_layout="paged", kv_block_size=8, stream_timeout_s=60.0)
    base.update(kw)
    return base


def _port(params=None, **kw):
    return ContinuousDecoder(T1 if params is None else params, TCFG,
                             **_kw(**kw))


def _jax(**kw):
    return JaxDecoder(J1, SPEC.config, **_kw(**kw))


def test_replica_kill_mid_stream_fails_fast_and_remaps():
    """One replica's scheduler dies mid-stream (its device state poisoned
    under the state lock): its streams fail fast with the 502-coded
    error, it leaves the fleet, only its keys remap (to the next replica
    of their rendezvous order), survivors finish their streams and leak
    no block."""
    reps = {f"r{i}": _port() for i in range(3)}
    fleet = tfleet.DecoderFleet(reps, affinity_tokens=8)
    try:
        home_of = {}
        probe = 0
        while set(home_of) != set(reps) and probe < 200:
            toks = [3 + probe % 11, 5, 7, probe % 13 + 2]
            home_of.setdefault(fleet.route(toks), toks)
            probe += 1
        assert set(home_of) == set(reps)
        victim, survivors = "r1", ["r0", "r2"]
        handles = {nm: fleet.submit(toks, 64)
                   for nm, toks in home_of.items()}
        assert all(h.replica == nm for nm, h in handles.items())
        stream = handles[victim].tokens(timeout=60)
        next(stream)
        with reps[victim]._state_lock:
            reps[victim]._state = None
        t0 = time.perf_counter()
        with pytest.raises(tfleet.ReplicaUnavailableError) as err:
            for _ in stream:
                pass
        assert err.value.code == 502
        assert time.perf_counter() - t0 < 10
        assert victim not in fleet.live_members()
        for nm in survivors:
            assert len(handles[nm].result(timeout=60)["tokens"]) == 64
        h2 = fleet.submit(home_of[victim], 4)
        order = taffinity.rendezvous_order(
            taffinity.prefix_affinity_key(home_of[victim], 8),
            ["r0", "r1", "r2"])
        assert h2.replica == [m for m in order if m != victim][0]
        assert len(h2.result(timeout=60)["tokens"]) == 4
        for nm in survivors:
            h = fleet.submit(home_of[nm], 4)
            assert h.replica == nm
            h.result(timeout=60)
        m = fleet.metrics()
        assert m["kv_blocks_in_use"] == 0 and m["dead"] == [victim]
        assert m["remapped"] == 0  # the death surfaced on a stream
        for nm in survivors:
            assert all(not b for b in reps[nm]._slot_blocks)
    finally:
        fleet.stop()


def _relay_fleet(make):
    econ = dict(prefix_cache_slots=8, prefix_cache_min_len=8)
    reps = {"p0": make(role="prefill", **econ),
            "d0": make(role="decode", **econ),
            "d1": make(role="decode", **econ)}
    return reps, (jfleet if make is _jax else tfleet).DecoderFleet(
        reps, affinity_tokens=8)


RELAY_PROMPTS = [[3, 5, 7, 2] + [11] * 8, [4, 5, 7, 9] + [12] * 9,
                 [1, 2], [6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 1]]


def test_relay_streams_and_counters_equal_jax():
    """The two-hop relay (export on the prefill replica, import on the
    least-loaded decode replica, the decode submit's prefix hit): streams
    equal JAX's fleet's and a plain decoder's; handoffs, skips and
    placements equal JAX's."""
    outs = []
    for make in (_port, _jax):
        reps, fleet = _relay_fleet(make)
        try:
            got = []
            for p in RELAY_PROMPTS:
                h = fleet.submit(p, 8)
                got.append((h.replica, h.result(timeout=120)["tokens"]))
            m = fleet.metrics()
            outs.append((got, m["handoffs"], m["handoff_fallbacks"],
                         m["handoff_skipped"],
                         m["replicas"]["p0"]["kv_handoff_exports"],
                         sorted(m["decode_pool"])))
        finally:
            fleet.stop()
    assert outs[0] == outs[1]
    assert outs[0][1] == 3 and outs[0][3] == 1
    plain = _port()
    try:
        assert [t for _, t in outs[0][0]] == [
            plain.generate(p, 8, timeout=120)["tokens"]
            for p in RELAY_PROMPTS]
    finally:
        plain.stop()


def test_prefill_replica_kill_mid_handoff_fails_fast():
    """A prefill replica dying under a handoff fails that submit fast
    with the 502-coded error; with the prefill pool gone, the fleet
    degrades to colocated submits on the decode pool, whose streams are
    untouched."""
    reps, fleet = _relay_fleet(_port)
    try:
        live = fleet.submit(RELAY_PROMPTS[0][:-1] + [50], 48)
        with reps["p0"]._state_lock:
            reps["p0"]._state = None
        t0 = time.perf_counter()
        with pytest.raises(tfleet.ReplicaUnavailableError) as err:
            fleet.submit(RELAY_PROMPTS[1], 4)
        assert err.value.code == 502 and time.perf_counter() - t0 < 10
        assert len(live.result(timeout=120)["tokens"]) == 48
        out = fleet.submit(RELAY_PROMPTS[1], 4)
        assert out.replica in ("d0", "d1")
        assert len(out.result(timeout=120)["tokens"]) == 4
        m = fleet.metrics()
        assert m["prefill_pool"] == [] and m["dead"] == ["p0"]
        assert m["handoff_fallbacks"] == 1
        for name in ("d0", "d1"):
            rep = reps[name]
            assert all(not b for b in rep._slot_blocks)
            with rep._prefix_lock:
                while rep.prefix_cache.evict_lru():
                    pass
            assert rep._alloc.blocks_in_use == 0, name
    finally:
        fleet.stop()


BROADCAST_PROMPT = [3 + (j % 23) for j in range(12)]


def test_broadcast_subset_leaves_other_replicas_unchanged():
    """Replicas built from one tree share its tensors; a push to one
    (``members``) swaps only its reference: it then streams as a decoder
    cold-started on the new weights, the others as before, and the
    fleet's epochs, installs and lagging list equal JAX's fleet's."""
    outs = []
    for mod, make, new in ((tfleet, _port, P2), (jfleet, _jax, J2)):
        reps = {f"r{i}": make() for i in range(3)}
        fleet = mod.DecoderFleet(reps, weights_max_lag=1)
        try:
            before = {n: r.generate(BROADCAST_PROMPT, 8,
                                    timeout=120)["tokens"]
                      for n, r in reps.items()}
            res = fleet.broadcast_weights(new, members=["r1"])
            after = {n: r.generate(BROADCAST_PROMPT, 8,
                                   timeout=120)["tokens"]
                     for n, r in reps.items()}
            outs.append((before, after, res, fleet.weights_versions()))
        finally:
            fleet.stop()
    assert outs[0] == outs[1]
    before, after, res, _ = outs[0]
    assert res["installed"] == {"r1": 1} and res["lagging"] == ["r0", "r2"]
    assert after["r0"] == after["r2"] == before["r0"]
    cold = _port(params_from_numpy(P2, TCFG, "cpu"))
    try:
        assert after["r1"] == cold.generate(BROADCAST_PROMPT, 8,
                                            timeout=120)["tokens"]
    finally:
        cold.stop()
