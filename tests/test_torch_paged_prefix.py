"""The port's paged prefix path against the JAX package's: the span
attention walk, the span forward, the paged admission primitives, and the
continuous decoder's refcount sharing, copy-on-write, publishing, priming
and reclaim.

Both packages get the same weights (the JAX init, handed across as numpy
arrays) at ``dtype=float32`` on the CPU. Span attention and the span
forward agree within 1e-5; block copies are exact; greedy streams are
identical, warm or cold, fused or gathered.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.models.decode as jdecode  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.ops.attention import (  # noqa: E402
    paged_span_attention as jax_span,
)
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402
from kubeflow_tpu_torch.serving import continuous as tcont  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _quantize_np(x):
    """The abs-max int8 quantization both packages use, in numpy."""
    scale = np.abs(x).max(-1) / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(x / safe[..., None]), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def _pools(rng, shape, kv):
    """Random K and V pools as numpy: fp arrays or int8 dicts."""
    out = []
    for _ in range(2):
        x = rng.standard_normal(shape).astype(np.float32)
        out.append(_quantize_np(x) if kv == "int8" else x)
    return out


def _to_jax(pool):
    if isinstance(pool, dict):
        return {k: jnp.asarray(v) for k, v in pool.items()}
    return jnp.asarray(pool)


def _to_torch(pool):
    if isinstance(pool, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in pool.items()}
    return torch.from_numpy(np.array(pool))


def _np(pool):
    if isinstance(pool, dict):
        return {k: np.asarray(v) for k, v in pool.items()}
    return np.asarray(pool)


def _assert_pools_equal(a, b, atol=0.0):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        np.testing.assert_array_equal(a["q"], b["q"])
        np.testing.assert_allclose(a["scale"], b["scale"], rtol=1e-6,
                                   atol=1e-7)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# paged_span_attention
# ---------------------------------------------------------------------------

N, BS, HKV, HD = 10, 4, 2, 16


def _span_case(kv, seed=0):
    """Three rows over a [N, Bs, Hkv, hd] pool, MB 4: row 0 a span that
    crosses a block edge with a sentinel tail, row 1 parked at the row's
    end (every position visible, a sentinel inside), row 2 with no
    admitted key (pos < -S)."""
    rng = np.random.default_rng(seed)
    b, s_w, hq = 3, 5, 4
    q = rng.standard_normal((b, s_w, hq, HD)).astype(np.float32)
    kp, vp = _pools(rng, (N, BS, HKV, HD), kv)
    table = np.array([[3, 0, N, N], [1, N, 7, 5], [2, 4, 6, 8]], np.int32)
    pos = np.array([6, 16, -6], np.int32)
    return q, kp, vp, table, pos


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("group", [4, 8, 256], ids=["1blk", "2blk", "all"])
def test_paged_span_attention_matches_jax(kv, group, monkeypatch):
    q, kp, vp, table, pos = _span_case(kv)
    want = np.asarray(jax_span(jnp.asarray(q), _to_jax(kp), _to_jax(vp),
                               jnp.asarray(table), jnp.asarray(pos),
                               n_kv_heads=HKV))
    monkeypatch.setattr(tattn, "SPAN_GROUP_POSITIONS", group)
    args = (torch.from_numpy(q), _to_torch(kp), _to_torch(vp),
            torch.from_numpy(table), torch.from_numpy(pos))
    got = tattn.paged_span_attention(*args, n_kv_heads=HKV).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert not got[2].any()  # no admitted key: exact zeros
    qg = args[0].reshape(3, 5, HKV, 2, HD)
    plain = tattn._paged_span_plain(qg, *args[1:], HD ** -0.5)
    np.testing.assert_allclose(plain.reshape(got.shape).numpy(), want,
                               rtol=TOL, atol=TOL)


def test_paged_span_attention_rejects_a_mesh():
    """A mesh runs the twin (tests/test_torch_tp_serving.py); one whose
    shards do not divide the heads is rejected."""
    q, kp, vp, table, pos = _span_case("fp")
    with pytest.raises(ValueError, match="not divisible"):
        tattn.paged_span_attention(
            torch.from_numpy(q), _to_torch(kp), _to_torch(vp),
            torch.from_numpy(table), torch.from_numpy(pos), n_kv_heads=HKV,
            mesh=["cpu"] * 3)


# ---------------------------------------------------------------------------
# The span forward and the paged admission primitives
# ---------------------------------------------------------------------------

SLOTS, NB, BSZ, MB = 3, 12, 8, 4   # rows of 32 positions


def _state_pair(jcfg, tcfg, kv, table, seed=1):
    """A JAX and a port paged state over the same random pools and
    table."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, NB, BSZ, jcfg.n_kv_heads, jcfg.head_dim)
    kp, vp = _pools(rng, shape, kv)
    js = jdecode.init_paged_state(jcfg, SLOTS, NB, BSZ, MB, kv_dtype=kv)
    js["pool"] = {"k": _to_jax(kp), "v": _to_jax(vp)}
    js["block_table"] = jnp.asarray(table)
    ts = tdecode.init_paged_state(tcfg, SLOTS, NB, BSZ, MB, kv_dtype=kv,
                                  device="cpu")
    ts["pool"] = {"k": _to_torch(kp), "v": _to_torch(vp)}
    ts["block_table"].copy_(torch.from_numpy(table))
    return js, ts


TABLE = np.array([[3, 0, 7, 5], [1, 9, NB, NB], [2, 4, 6, 8]], np.int32)


@pytest.mark.parametrize("fused", [False, True], ids=["gathered", "fused"])
@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_block_forward_matches_jax_including_a_spill(models, fused, kv):
    """Row 0 spans positions 29..34 of a 32-position row: the last three
    columns spill past the row and are dropped (JAX's scatter drops
    them; the port's write index filters them). Row 1's span runs into
    sentinel entries; row 2 starts at 0."""
    jcfg, jparams, tcfg, tparams = models
    js, ts = _state_pair(jcfg, tcfg, kv, TABLE)
    toks = np.array([[5, 9, 2, 7, 1, 3], [3, 3, 8, 1, 2, 2],
                     [8, 1, 4, 4, 2, 6]], np.int32)
    pos = np.array([29, 14, 0], np.int32)
    jl, jk, jv = jdecode._block_forward(
        jparams, jcfg, js["pool"]["k"], js["pool"]["v"], jnp.asarray(toks),
        jnp.asarray(pos), jnp.ones(toks.shape, bool),
        table=jnp.asarray(TABLE), fused=fused)
    tl = tdecode._block_forward(
        tparams, tcfg, ts["pool"]["k"], ts["pool"]["v"],
        torch.from_numpy(toks), torch.from_numpy(pos),
        ts["block_table"], fused)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _assert_pools_equal(ts["pool"]["k"], jk, atol=TOL)
    _assert_pools_equal(ts["pool"]["v"], jv, atol=TOL)


def test_block_forward_rejects_unported_reads(models):
    """The context-parallel span read is ported: ``ring`` (each stage's
    shards' ring devices) folds every layer's gathered read over two
    shards, and the logits equal the gathered read's."""
    _, _, tcfg, tparams = models
    out = []
    for ring in (None, [[["cpu", "cpu"]]]):
        ts = tdecode.init_paged_state(tcfg, SLOTS, NB, BSZ, MB,
                                      device="cpu")
        ts["block_table"][0] = torch.from_numpy(TABLE[0].copy())
        toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=torch.int32)
        pos = torch.zeros(1, dtype=torch.int32)
        out.append(tdecode._block_forward(
            tparams, tcfg, ts["pool"]["k"], ts["pool"]["v"], toks, pos,
            ts["block_table"][:1], ring=ring))
    torch.testing.assert_close(out[1], out[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["gathered", "fused"])
@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_admit_prefix_and_step_matches_jax(models, fused, kv):
    """Slot 2 reuses 13 prefix positions (one and a half blocks) and
    prefills a 3-token suffix padded to 8, then one decode step runs for
    every row (slot 0 active at 20 positions)."""
    jcfg, jparams, tcfg, tparams = models
    js, ts = _state_pair(jcfg, tcfg, kv, TABLE)
    for st, xp in ((js, jnp), (ts, None)):
        if xp is None:
            tdecode._set_rows(st, 0, 20, 5, 0.0, torch.zeros(256))
        else:
            st["length"] = st["length"].at[0].set(20)
            st["remaining"] = st["remaining"].at[0].set(5)
            st["active"] = st["active"].at[0].set(True)
    suffix = np.array([[7, 1, 9, 0, 0, 0, 0, 0]], np.int32)
    js, jlast, jtok, jemit = jdecode.paged_admit_prefix_and_step(
        js, jparams, jcfg, jnp.int32(2), jnp.int32(13), jnp.asarray(suffix),
        jnp.int32(16), jnp.int32(4), jnp.float32(0.0), kv_fused=fused)
    ts, tlast, ttok, temit = tdecode.paged_admit_prefix_and_step(
        ts, tparams, tcfg, 2, 13, torch.from_numpy(suffix), 16, 4, 0.0,
        kv_fused=fused)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    for key in ("length", "remaining", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    np.testing.assert_allclose(ts["last_logits"].numpy(),
                               np.asarray(js["last_logits"]), rtol=TOL,
                               atol=TOL)
    _assert_pools_equal(ts["pool"]["k"], js["pool"]["k"], atol=TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["gathered", "fused"])
def test_paged_prefill_chunk_parks_the_row_and_draws_nothing(models, fused):
    jcfg, jparams, tcfg, tparams = models
    js, ts = _state_pair(jcfg, tcfg, "fp", TABLE)
    chunk = np.array([[4, 8, 15, 16, 23, 42, 0, 0]], np.int32)
    js = jdecode.paged_prefill_chunk(js, jparams, jcfg, jnp.int32(2),
                                     jnp.int32(8), jnp.asarray(chunk),
                                     jnp.int32(6), kv_fused=fused)
    rng_before = ts["generator"].get_state().clone()
    ts = tdecode.paged_prefill_chunk(ts, tparams, tcfg, 2, 8,
                                     torch.from_numpy(chunk), 6,
                                     kv_fused=fused)
    assert torch.equal(ts["generator"].get_state(), rng_before)
    assert int(ts["length"][2]) == MB * BSZ and not bool(ts["active"][2])
    for key in ("length", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    _assert_pools_equal(ts["pool"]["k"], js["pool"]["k"], atol=TOL)
    _assert_pools_equal(ts["pool"]["v"], js["pool"]["v"], atol=TOL)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_store_blocks_matches_jax(models, kv):
    """The paged prime: a batch-1 prefill of 13 tokens scattered into two
    blocks, and a sentinel id that is dropped."""
    jcfg, jparams, tcfg, tparams = models
    js, ts = _state_pair(jcfg, tcfg, kv, TABLE)
    toks = np.array([[(7 * i) % 97 + 1 for i in range(13)] + [0, 0, 0]],
                    np.int32)
    ids = np.array([6, 10, NB], np.int32)
    jcache, _ = jdecode.prefill(jparams, jnp.asarray(toks),
                                jnp.asarray([13], np.int32), jcfg,
                                total_len=24)
    tcache, _ = tdecode.prefill(tparams, torch.from_numpy(toks),
                                torch.tensor([13]), tcfg, total_len=24)
    jpool = jdecode.store_blocks(js["pool"], jnp.asarray(ids), jcache)
    tpool = tdecode.store_blocks(ts["pool"], ids, tcache)
    _assert_pools_equal(tpool["k"], jpool["k"], atol=TOL)
    _assert_pools_equal(tpool["v"], jpool["v"], atol=TOL)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_copy_block_matches_jax_exactly(models, kv):
    jcfg, _, tcfg, _ = models
    js, ts = _state_pair(jcfg, tcfg, kv, TABLE)
    jpool = jdecode.copy_block(js["pool"], jnp.int32(11), jnp.int32(4))
    tpool = tdecode.copy_block(ts["pool"], 11, 4)
    for side in ("k", "v"):
        a, b = _np(tpool[side]), _np(jpool[side])
        for x, y in ((a, b),) if not isinstance(a, dict) else (
                (a["q"], b["q"]), (a["scale"], b["scale"])):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(IndexError):
        tdecode.copy_block(ts["pool"], NB, 4)


# ---------------------------------------------------------------------------
# The continuous decoder's paged prefix path (tests/test_paged_kv.py)
# ---------------------------------------------------------------------------

BASE = dict(slots=4, prefill_len=32, max_new_tokens=8, kv_layout="paged",
            kv_block_size=8)
PREFIX = dict(prefix_cache_slots=4, prefix_cache_min_len=8)


def _port(models, **kw):
    _, _, tcfg, tparams = models
    return ContinuousDecoder(tparams, tcfg, **{**BASE, **kw})


def _jax(models, **kw):
    jcfg, jparams, _, _ = models
    return JaxDecoder(jparams, jcfg, **{**BASE, **kw})


def _run(decoder, prompts, want=6, **gen):
    try:
        return ([decoder.generate(p, want, timeout=120, **gen)["tokens"]
                 for p in prompts], decoder.metrics())
    finally:
        decoder.stop()


def _pool_blocks(decoder, blocks):
    """A copy of ``blocks``' K and V payloads on every layer."""
    pool = decoder._state["pool"]
    ids = torch.tensor(list(blocks))
    return [tdecode._kv_arr(pool[s])[:, ids].clone() for s in ("k", "v")]


def test_warm_hit_block_aligned_shares_with_zero_copies(models):
    donor = list(range(2, 26))            # 24 tokens = 3 full 8-blocks
    warm = donor + [100, 101, 102, 103]
    want, jm = _run(_jax(models, **PREFIX), [donor, warm])
    got, m = _run(_port(models, **PREFIX), [donor, warm])
    assert got == want
    assert m["prefix_hits"] == jm["prefix_hits"] == 1
    assert m["kv_shared_blocks"] == jm["kv_shared_blocks"] == 3
    assert m["kv_cow_copies"] == jm["kv_cow_copies"] == 0
    assert m["prefix_tokens_reused"] == 24


def test_cow_tail_never_mutates_donor_blocks(models):
    """A hit mid-block copies that one block; the donor's blocks are
    byte for byte unchanged after the divergent stream, and the donor's
    prompt replays identically."""
    donor = list(range(2, 22))        # 20 tokens: 2 full blocks + 4 tail
    divergent = donor + [50, 51]
    want, jm = _run(_jax(models, **PREFIX), [donor, divergent, donor])
    d = _port(models, **PREFIX)
    try:
        cold = d.generate(donor, 6, timeout=120)["tokens"]
        with d._prefix_lock:
            (entry,) = d.prefix_cache.entries()
            blocks = entry.blocks
        before = _pool_blocks(d, blocks)
        div = d.generate(divergent, 6, timeout=120)["tokens"]
        after = _pool_blocks(d, blocks)
        for a, b in zip(before, after):
            assert torch.equal(a, b)
        m = d.metrics()
        assert m["kv_cow_copies"] == 1 and m["kv_shared_blocks"] == 2
        again = d.generate(donor, 6, timeout=120)["tokens"]
    finally:
        d.stop()
    assert [cold, div, again] == want
    assert jm["kv_cow_copies"] == 2  # the replay hits and copies again


def test_shared_blocks_visible_in_both_slots_with_refcounts(models,
                                                            monkeypatch):
    """Two in-flight requests over a primed prefix hold the SAME physical
    blocks (trie + one reference per slot) while their owned blocks stay
    disjoint. Decode steps are slowed so the rows are inspected live."""
    real_step = tcont.decode_step

    def slow_step(*a, **kw):
        time.sleep(0.1)
        return real_step(*a, **kw)

    monkeypatch.setattr(tcont, "decode_step", slow_step)
    system = list(range(5, 29))  # 24 tokens = 3 blocks, aligned
    d = _port(models, slots=2, **PREFIX)
    try:
        assert d.prime_prefix(system)
        h1 = d.submit(system + [100], 8)
        h2 = d.submit(system + [101], 8)
        it1, it2 = h1.tokens(timeout=120), h2.tokens(timeout=120)
        next(it1), next(it2)  # both admitted and mid-decode
        b0, b1 = d._slot_blocks[0], d._slot_blocks[1]
        shared = set(b0) & set(b1)
        assert len(shared) == 3
        for b in shared:
            assert d._alloc.ref_count(b) == 3
        owned0, owned1 = set(b0) - shared, set(b1) - shared
        assert owned0 and owned1 and not (owned0 & owned1)
        for b in owned0 | owned1:
            assert d._alloc.ref_count(b) == 1
        for it in (it1, it2):
            for _ in it:
                pass
        # The primed entry keeps its 3 blocks; each finished prompt's
        # publish kept its own tail block beyond the shared ones.
        assert d.metrics()["kv_blocks_in_use"] == 5
    finally:
        d.stop()


def test_paged_prime_keeps_streams(models):
    """prime_prefix writes blocks owned by the trie entry without
    touching the decode state or its generator: greedy streams equal
    JAX's primed decoder, and a sampled stream equals an unprimed dense
    decoder's with the same seed."""
    system = list(range(3, 23))
    prompt = system + [200, 17, 11]

    def primed(make, **kw):
        d = make(models, **PREFIX, **kw)
        assert d.prime_prefix(system)
        return d

    want, jm = _run(primed(_jax), [prompt])
    got, m = _run(primed(_port), [prompt])
    assert got == want and m["prefix_hits"] == jm["prefix_hits"] == 1
    sampled, _ = _run(primed(_port, seed=11), [prompt], temperature=1.0)
    dense, _ = _run(_port(models, kv_layout="dense", seed=11), [prompt],
                    temperature=1.0)
    assert sampled == dense


def test_admission_pressure_reclaims_cached_prefix_blocks(models):
    """Cache-held blocks are reclaimable: with a pool of one worst-case
    sequence, the next admission evicts the published entry instead of
    deferring forever."""
    kw = dict(slots=2, prefill_len=16, kv_pool_blocks=3, **PREFIX)
    d = _port(models, **kw)
    try:
        first = d.generate([9] * 10, 8, timeout=120)
        assert d.metrics()["kv_blocks_in_use"] > 0
        second = d.generate([7] * 10, 8, timeout=120)
        m = d.metrics()
    finally:
        d.stop()
    want, jm = _run(_jax(models, **kw), [[9] * 10, [7] * 10], want=8)
    assert [first["tokens"], second["tokens"]] == want
    assert m["prefix_evictions"] >= 1
    assert m["prefix_evictions"] == jm["prefix_evictions"]


def test_concurrent_same_round_prefix_hits_stay_exact(models):
    """Three followers hitting one donor in one burst (slots freshly
    recycled): a slot's table row stays sentinel until its own
    admission, so no earlier same-round decode step writes junk into the
    shared prefix blocks."""
    prefix = [(7 * j) % 97 + 3 for j in range(24)]
    followers = [prefix + [200, 150 + r, 11 + r, 7] for r in (1, 2, 3)]
    ref, _ = _run(_port(models, slots=8), followers, want=8)
    want, _ = _run(_jax(models, slots=8), followers, want=8)
    assert ref == want
    d = _port(models, slots=8, prefix_cache_slots=8,
              prefix_cache_min_len=16, prefill_len_buckets=2,
              kv_pool_blocks=40, stream_timeout_s=120.0)
    try:
        d.generate(prefix + [200, 150, 11, 7], 8, timeout=120)
        with ThreadPoolExecutor(3) as pool:
            out = list(pool.map(
                lambda t: d.generate(t, 8, timeout=120)["tokens"],
                followers))
        m = d.metrics()
    finally:
        d.stop()
    assert m["prefix_hits"] == 3
    assert out == ref


@pytest.fixture(scope="module")
def jax_prefix_streams(models):
    return _run(_jax(models, **PREFIX, kv_fused=True), PREFIX_PROMPTS)


SYSTEM = [(5 * j) % 89 + 2 for j in range(18)]
PREFIX_PROMPTS = [SYSTEM + [40, 41], SYSTEM + [50], SYSTEM[:9] + [3, 4, 5],
                  SYSTEM + [40, 41, 42, 43, 44], SYSTEM + [50]]


@pytest.mark.parametrize("fused", [False, True], ids=["gathered", "fused"])
def test_prefix_streams_warm_and_cold_match_jax(models, jax_prefix_streams,
                                                fused):
    """Warm (cache on), cold (cache off), fused and gathered: the same
    greedy tokens as JAX's fused prefix decoder, and the same prefix
    counters."""
    want, jm = jax_prefix_streams
    warm, m = _run(_port(models, **PREFIX, kv_fused=fused), PREFIX_PROMPTS)
    cold, _ = _run(_port(models, kv_fused=fused), PREFIX_PROMPTS)
    assert warm == cold == want
    for key in ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
                "kv_shared_blocks", "kv_cow_copies", "prefix_inserts"):
        assert m[key] == jm[key], key
    assert m["prefix_hits"] >= 3


def test_blocks_freed_after_loop_crash_with_prefix_entries(models,
                                                           monkeypatch):
    """A decode-loop death frees every slot's block references; the
    blocks still in use are exactly the trie entries'."""
    d = _port(models, slots=1, **PREFIX)
    try:
        d.generate(list(range(2, 22)), 2, timeout=60)
        inflight = d.submit(list(range(2, 22)) + [9], 8)
        next(inflight.tokens(timeout=60))
        crashed = threading.Event()

        def boom(*a, **k):
            crashed.set()
            raise RuntimeError("injected decode failure")

        monkeypatch.setattr(tcont, "decode_step", boom)
        with pytest.raises(RuntimeError, match="injected decode failure"):
            inflight.result(timeout=10)
        assert crashed.is_set()
        d._thread.join(timeout=10)
        assert not any(d._slot_blocks)
        with d._prefix_lock:
            held = {b for e in d.prefix_cache.entries() for b in e.blocks}
        assert held and d.metrics()["kv_blocks_in_use"] == len(held)
        assert d.trace.open_count == 0
    finally:
        d.stop()
