"""The port's host KV tier against the JAX package's: the block export
and import (``export_blocks``/``import_blocks``), the ``HostKvTier``
copy, and the continuous decoder's demotion on eviction and
second-chance promotion on a miss, on fp and int8 pools.

Both packages get the same weights (the JAX init, handed across as numpy
arrays) at ``dtype=float32`` on the CPU. Exported and imported blocks
are exact; greedy streams and every tier counter equal JAX's, and a
host-tier hit equals a cold admission.
"""

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
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.kv_tier import HostKvTier as JaxTier  # noqa: E402
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.kv_tier import (  # noqa: E402
    HostKvTier,
    payload_nbytes,
)
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

PFX = list(range(1, 17))
TIER_COUNTERS = ("kv_host_hits", "kv_host_promotions", "kv_host_demotions",
                 "kv_host_evictions", "kv_host_tier_entries",
                 "kv_host_tier_bytes", "kv_host_tier_pinned_bytes",
                 "prefix_hits", "prefix_misses", "prefix_inserts",
                 "prefix_evictions", "prefill_tokens", "kv_blocks_in_use",
                 "tokens_emitted", "weights_stale_refused")


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _kw(**over):
    kw = dict(slots=4, prefill_len=32, max_new_tokens=32, kv_layout="paged",
              kv_block_size=8, kv_pool_blocks=10, prefix_cache_slots=4,
              prefix_cache_min_len=8, stream_timeout_s=120.0)
    kw.update(over)
    return kw


def _both(models, **over):
    jcfg, jparams, tcfg, tparams = models
    return (JaxDecoder(jparams, jcfg, **_kw(**over)),
            ContinuousDecoder(tparams, tcfg, **_kw(**over)))


def _evict_all(d):
    with d._prefix_lock:
        while d.prefix_cache.evict_lru():
            pass


# ---------------------------------------------------------------------------
# export_blocks / import_blocks
# ---------------------------------------------------------------------------


def _quantize_np(x):
    scale = np.abs(x).max(-1) / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(x / safe[..., None]), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def _pool_np(kv, seed=0, shape=(2, 6, 4, 2, 8)):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("k", "v"):
        x = rng.standard_normal(shape).astype(np.float32)
        out[side] = _quantize_np(x) if kv == "int8" else x
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_export_and_import_match_jax_exactly(kv):
    pool = _pool_np(kv)
    ids = [4, 1, 1, 3]
    jout = jdecode.export_blocks(_map(pool, jnp.asarray),
                                 jnp.asarray(ids, np.int32))
    tpool = _map(pool, lambda a: torch.from_numpy(np.array(a)))
    tout = tdecode.export_blocks(tpool, ids)
    _assert_same(_map(tout, lambda t: t.numpy()), _map(jout, np.asarray))
    # Import another pool's blocks into blocks [0, 5]: both packages land
    # the same values, codes and scales as they came.
    src = _map(_pool_np(kv, seed=1), lambda a: a[:, :2])
    jpool = jdecode.import_blocks(_map(pool, jnp.asarray),
                                  jnp.asarray([0, 5], np.int32),
                                  _map(src, jnp.asarray))
    tdecode.import_blocks(tpool, torch.tensor([0, 5]),
                          _map(src, lambda a: torch.from_numpy(np.array(a))))
    _assert_same(_map(tpool, lambda t: t.numpy()), _map(jpool, np.asarray))
    # The round trip is exact: export of the imported blocks = the source.
    back = tdecode.export_blocks(tpool, [0, 5])
    _assert_same(_map(back, lambda t: t.numpy()), src)


@pytest.mark.parametrize("bad", [[6], [-1], [0, 9]])
def test_block_ids_out_of_range_raise(bad):
    """JAX drops (scatter) or clamps (gather) an id out of range; the port
    never reads or writes out of bounds: it raises."""
    tpool = _map(_pool_np("fp"), lambda a: torch.from_numpy(np.array(a)))
    with pytest.raises(IndexError):
        tdecode.export_blocks(tpool, bad)
    payload = _map(_pool_np("fp"), lambda a: torch.from_numpy(
        np.array(a[:, :len(bad)])))
    with pytest.raises(IndexError):
        tdecode.import_blocks(tpool, bad, payload)


def test_import_refuses_a_mismatched_payload():
    tpool = _map(_pool_np("fp"), lambda a: torch.from_numpy(np.array(a)))
    q8 = _map(_pool_np("int8"), lambda a: torch.from_numpy(
        np.array(a[:, :1])))
    with pytest.raises(ValueError, match="layout"):
        tdecode.import_blocks(tpool, [0], q8)
    half = _map(_pool_np("fp"), lambda a: torch.from_numpy(
        np.array(a[:, :1])).to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        tdecode.import_blocks(tpool, [0], half)
    with pytest.raises(ValueError, match="shape"):
        tdecode.import_blocks(tpool, [0, 1], _map(
            _pool_np("fp"), lambda a: torch.from_numpy(np.array(a[:, :1]))))


# ---------------------------------------------------------------------------
# HostKvTier (the copy) against JAX's, operation for operation
# ---------------------------------------------------------------------------


def _payload(tokens_worth, torch_side):
    arr = np.zeros((1, 1, tokens_worth, 4), dtype=np.float16)
    if torch_side:
        return {"k": torch.from_numpy(arr), "v": torch.from_numpy(arr.copy())}
    return {"k": arr, "v": arr.copy()}


def _tier_script(cls, torch_side):
    """The JAX tests' LRU, pin and interior-match sequence; returns every
    observable it produced."""
    per = payload_nbytes(_payload(8, torch_side))
    out = [per]
    tier = cls(capacity_bytes=3 * per)
    for key in ((1,), (2,), (3,)):
        out.append(tier.put(key, _payload(8, torch_side), 1))
    tier.get((1,))
    out += [tier.put((4,), _payload(8, torch_side), 1), tier.has((2,)),
            tier.has((1,)), tier.evictions, tier.bytes_in_use]
    tier2 = cls(capacity_bytes=2 * per)
    out += [tier2.put((1,), _payload(8, torch_side), 1, pinned=True),
            tier2.put((2,), _payload(8, torch_side), 1, pinned=True),
            tier2.pinned_bytes,
            tier2.put((3,), _payload(8, torch_side), 1),
            tier2.can_fit(per)]
    tier2.unpin((1,))
    out += [tier2.put((3,), _payload(8, torch_side), 1), tier2.has((1,))]
    tier2.discard((2,))
    out += [tier2.pinned_bytes, tier2.high_water_bytes,
            cls(per - 1).put((9,), _payload(8, torch_side), 1)]
    tier3 = cls(1 << 20)
    tier3.put((1, 2, 3, 4, 5), _payload(8, torch_side), 5, version=2)
    for toks, version in (([1, 2, 3, 4, 5], None), ([1, 2, 3, 4, 5, 6], 2),
                          ([1, 2, 3, 9, 9], None), ([8, 8], None),
                          ([1, 2, 3, 4, 5, 6], 1)):
        m = tier3.match(toks, version)
        out.append(None if m is None else (m[0].key, m[1]))
    return out


def test_host_tier_copy_matches_jax():
    assert _tier_script(HostKvTier, True) == _tier_script(JaxTier, False)
    payload = _payload(8, True)
    assert payload_nbytes(payload) == 2 * 8 * 4 * 2


# ---------------------------------------------------------------------------
# The decoder: demotion, second-chance promotion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_demote_then_second_chance_promotion_matches_jax(models, kv_dtype):
    """An evicted prefix demotes to the host tier and a re-arrival
    promotes it back and pays a suffix-only prefill: tokens and every
    tier counter equal JAX's, and the promoted hit equals the cold
    admission."""
    runs = []
    for d in _both(models, host_kv_bytes=1 << 20, kv_dtype=kv_dtype):
        try:
            out1 = d.generate(PFX + [99], 4, timeout=120)["tokens"]
            _evict_all(d)
            before = d.metrics()
            out2 = d.generate(PFX + [99], 4, timeout=120)["tokens"]
            # An interior match: a prompt sharing the demoted run.
            _evict_all(d)
            out3 = d.generate(PFX[:12] + [7, 7], 4, timeout=120)["tokens"]
            m = d.metrics()
        finally:
            d.stop()
        assert out2 == out1
        assert m["kv_host_hits"] >= 1 and m["kv_host_promotions"] >= 1
        assert m["kv_host_demotions"] >= 1
        assert m["prefill_tokens"] - before["prefill_tokens"] < 17 + 14
        runs.append((out1, out3, {k: m[k] for k in TIER_COUNTERS}))
    assert runs[1] == runs[0]
    # Host-tier hit = cold admission (no tier, no cache).
    jcfg, jparams, tcfg, tparams = models
    cold = ContinuousDecoder(tparams, tcfg, **_kw(
        kv_dtype=kv_dtype, prefix_cache_slots=0))
    try:
        assert cold.generate(PFX + [99], 4, timeout=120)["tokens"] == \
            runs[1][0]
        if kv_dtype == "fp":
            assert cold.generate(PFX[:12] + [7, 7], 4,
                                 timeout=120)["tokens"] == runs[1][1]
    finally:
        cold.stop()


def test_no_tier_eviction_still_frees(models):
    """host_kv_bytes=0: eviction frees outright, no tier counters."""
    _j, _p, tcfg, tparams = models
    d = ContinuousDecoder(tparams, tcfg, **_kw())
    try:
        d.generate(PFX, 4, timeout=120)
        _evict_all(d)
        m = d.metrics()
        assert m["kv_host_demotions"] == 0
        assert m["kv_blocks_in_use"] == 0
        assert m["kv_host_tier_bytes_total"] == 0
    finally:
        d.stop()


def test_tier_bounded_by_its_budget(models):
    """A budget of one prefix's payload (17 tokens: 3 blocks of 8): a
    second demotion evicts the first, and the evicted prefix's re-arrival
    prefills cold."""
    _j, _p, tcfg, tparams = models
    per = 2 * tcfg.n_layers * 24 * tcfg.n_kv_heads * tcfg.head_dim * 4
    d = ContinuousDecoder(tparams, tcfg, **_kw(host_kv_bytes=per))
    try:
        a, b = PFX + [1], [5] * 16 + [2]
        for p in (a, b):
            d.generate(p, 2, timeout=120)
            _evict_all(d)
        m = d.metrics()
        assert m["kv_host_demotions"] == 2 and m["kv_host_evictions"] == 1
        assert m["kv_host_tier_bytes"] <= per
        d.generate(a, 2, timeout=120)
        assert d.metrics()["kv_host_hits"] == 0
        d.generate(b, 2, timeout=120)
        assert d.metrics()["kv_host_hits"] == 1
        assert 'serving_kv_host_eviction_age_seconds_count 1' in \
            d.registry.render()
    finally:
        d.stop()


def test_sampled_stream_through_the_tier_is_exact(models):
    """A sampled continuation from a prefix promoted out of the host tier
    equals the continuation from the same prefix kept on the device, with
    the same seed and schedule: the export, host copy and import change
    no byte of the K/V."""
    _j, _p, tcfg, tparams = models
    prompt, cut, rest = [5, 6, 7, 8, 9, 10, 11, 12], 6, 18

    def run(through_tier):
        d = ContinuousDecoder(tparams, tcfg, **_kw(host_kv_bytes=1 << 20,
                                                   seed=3))
        try:
            head = d.generate(prompt, cut, temperature=1.0,
                              timeout=120)["tokens"]
            if through_tier:
                _evict_all(d)
            tail = d.generate(prompt + head, rest, temperature=1.0,
                              timeout=120)["tokens"]
            return head, tail, d.metrics()["kv_host_hits"]
        finally:
            d.stop()

    head_a, tail_a, hits_a = run(False)
    head_b, tail_b, hits_b = run(True)
    assert head_a == head_b
    assert (hits_a, hits_b) == (0, 1)
    assert tail_b == tail_a
