"""The port's tensor-parallel serving against the JAX package's, case by
case after ``tests/test_tp_serving.py``: the ContinuousDecoder over
``tp_shards`` shards driven by one process (here every shard on the
host, ``tp_devices=["cpu"] * tp``).

The invariant everywhere: a tensor-sharded replica is the same engine
spread over more shards. Greedy, sampled, speculative, prefix-hit, CoW,
dense and int8 token streams are identical across mesh shapes (f32: the
only sums across shards are the row-parallel projections', whose ~1e-6
reorder flips no argmax on these margins) and equal JAX's decoder at tp
1 and 2 on the same weights; the host side (allocator, trie, block ids,
handoff envelopes) never sees the split; the byte gauges price the pool
per shard, as JAX's do. The mesh twins of the paged reads equal the
unsharded calls bit for bit. The operator and manifest cases of the JAX
suite cover the control plane, which has no port.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving import handoff as jhandoff  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.kv_allocator import (  # noqa: E402
    kv_bytes_per_token as jkv_bytes_per_token,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    TensorShards,
    serving_mesh,
)
from kubeflow_tpu_torch.serving import handoff as thandoff  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.kv_allocator import kv_bytes_per_token  # noqa: E402,E501
from kubeflow_tpu_torch.weights import (  # noqa: E402
    params_from_numpy,
    tensor_shards,
)

# 12 shared tokens = one full 8-token block (refcount-shared on a hit)
# plus a 4-token partial tail (one CoW per follower).
SHARED = [5, 11, 7, 3, 13, 2, 17, 9, 4, 6, 19, 8]
PROBES = ([SHARED + [23 + i, 29] for i in range(3)]
          + [[1, 2, 3], [9] * 9, list(range(4, 20))])


@pytest.fixture(scope="module")
def tiny_tp():
    # 4 kv heads so the tp=4 leg shards evenly; f32 so greedy is
    # identical across mesh shapes.
    spec = get_model("lm-test-tiny", n_kv_heads=4, dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tcfg = ttransformer.config("lm-test-tiny", n_kv_heads=4,
                               dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return spec, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _kw(kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prefill_len", 32)
    kw.setdefault("max_new_tokens", 16)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("stream_timeout_s", 120.0)
    return kw


def _decoder(tiny_tp, tp=1, **kw):
    _spec, _jparams, tcfg, params = tiny_tp
    return ContinuousDecoder(params, tcfg, tp_shards=tp,
                             tp_devices=["cpu"] * tp, **_kw(kw))


def _jax_decoder(tiny_tp, tp=1, **kw):
    spec, jparams, _tcfg, _params = tiny_tp
    return JaxDecoder(jparams, spec.config, tp_shards=tp, **_kw(kw))


def _probe(d, want=6, temperature=0.0):
    return [d.generate(p, want, temperature=temperature,
                       timeout=120)["tokens"] for p in PROBES]


@pytest.fixture(scope="module")
def greedy_by_tp(tiny_tp):
    """Greedy probe streams (prefix cache on: the shared-prefix probes hit
    the trie, share a full block and CoW the tail), the metrics and the
    exposition, per mesh shape, the port's at tp 1, 2 and 4 and JAX's at
    tp 1 and 2."""
    out = {}
    for name, make, tp in (("port", _decoder, 1), ("port", _decoder, 2),
                           ("port", _decoder, 4), ("jax", _jax_decoder, 1),
                           ("jax", _jax_decoder, 2)):
        d = make(tiny_tp, tp, prefix_cache_slots=4, prefix_cache_min_len=4)
        try:
            toks = _probe(d)
            out[name, tp] = (toks, d.metrics(), d.registry.render())
        finally:
            d.stop()
    return out


# ---------------------------------------------------------------------------
# Identity across mesh shapes
# ---------------------------------------------------------------------------


def test_greedy_streams_equal_across_meshes_and_jax(greedy_by_tp):
    ref = greedy_by_tp["jax", 1][0]
    assert greedy_by_tp["jax", 2][0] == ref
    for tp in (1, 2, 4):
        assert greedy_by_tp["port", tp][0] == ref, f"port tp={tp}"


def test_prefix_sharing_and_cow_exercised_under_tp(greedy_by_tp):
    """The identity above covers the sharing machinery: the shared-prefix
    probes hit the trie on every mesh shape, map the full block by
    refcount and CoW the partial tail, with JAX's counts."""
    keys = ("prefix_hits", "kv_shared_blocks", "kv_cow_copies")
    want = tuple(greedy_by_tp["jax", 1][1][k] for k in keys)
    assert want[0] >= 2 and want[1] >= 2 and want[2] >= 2
    for (_name, _tp), (_toks, m, _text) in greedy_by_tp.items():
        assert tuple(m[k] for k in keys) == want


def test_sampled_streams_equal_across_meshes(tiny_tp):
    """Temperature > 0: the generator lives once (shard 0) and sees the
    whole row of logits, so sampled streams pin too."""
    outs = {}
    for tp in (1, 2):
        d = _decoder(tiny_tp, tp, seed=7)
        try:
            outs[tp] = _probe(d, temperature=0.8)
        finally:
            d.stop()
    assert outs[1] == outs[2]


def test_speculative_streams_equal_under_tp(tiny_tp):
    """Verify rounds ride the same sharded state: greedy tokens at tp 2
    with speculation equal the plain tp=1 stream."""
    plain = _decoder(tiny_tp, 1)
    try:
        ref = _probe(plain)
    finally:
        plain.stop()
    spec2 = _decoder(tiny_tp, 2, speculative_k=3)
    try:
        got = _probe(spec2)
        m = spec2.metrics()
    finally:
        spec2.stop()
    assert got == ref
    assert m["spec_verify_dispatches"] > 0  # speculation actually ran


def test_dense_layout_streams_equal_under_tp(tiny_tp):
    """tp also serves the dense layout (rows split by KV head)."""
    outs = {}
    for tp in (1, 2):
        d = _decoder(tiny_tp, tp, kv_layout="dense")
        try:
            outs[tp] = _probe(d)
        finally:
            d.stop()
    assert outs[1] == outs[2]


def test_int8_scales_ride_the_sharded_pool(tiny_tp):
    """Codes and abs-max scales split by the same KV heads: int8 tp=2
    streams equal int8 tp=1."""
    outs = {}
    for tp in (1, 2):
        d = _decoder(tiny_tp, tp, kv_dtype="int8")
        try:
            outs[tp] = _probe(d)
        finally:
            d.stop()
    assert outs[1] == outs[2]


def test_fused_read_matches_gather_under_tp(tiny_tp):
    """kv_fused under tp reads each shard's pool through the paged decode
    read on its heads; at f32 its tokens match the gathered read's."""
    outs = {}
    for fused in (False, True):
        d = _decoder(tiny_tp, 2, kv_fused=fused)
        try:
            outs[fused] = _probe(d)
        finally:
            d.stop()
    assert outs[True] == outs[False]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_primed_prefix_under_tp(tiny_tp, layout):
    """A primed system prompt lands in every shard's blocks (paged) or
    prefix-pool rows (dense), and the hits on it decode at tp=2 as at
    tp=1."""
    system = list(range(3, 23))
    outs = {}
    for tp in (1, 2):
        d = _decoder(tiny_tp, tp, kv_layout=layout, prefix_cache_slots=4,
                     prefix_cache_min_len=4)
        try:
            assert d.prime_prefix(system)
            toks = [d.generate(system + [30 + i], 6, timeout=120)["tokens"]
                    for i in range(3)]
            outs[tp] = (toks, d.metrics()["prefix_hits"])
        finally:
            d.stop()
    assert outs[1] == outs[2] and outs[2][1] == 3


def test_host_tier_and_chunked_prefill_under_tp(tiny_tp):
    """The host tier demotes and promotes whole-head payloads and the
    chunked admission walks each shard's pool: a one-entry trie over a
    24-block pool demotes on every publish and promotes on a return, a
    36-token prompt runs in chunks of 8, and tp=2 equals tp=1 stream for
    stream and counter for counter."""
    seq = PROBES + [PROBES[0], list(range(4, 40)), PROBES[1]]
    keys = ("kv_host_demotions", "kv_host_promotions", "kv_host_hits",
            "prefix_hits", "prefill_chunks", "kv_cow_copies")
    outs = {}
    for tp in (1, 2):
        d = _decoder(tiny_tp, tp, prefix_cache_slots=1,
                     prefix_cache_min_len=4, host_kv_bytes=1 << 22,
                     prefill_chunk_tokens=8, max_prompt_len=48,
                     kv_pool_blocks=24)
        try:
            toks = [d.generate(p, 6, timeout=120)["tokens"] for p in seq]
            m = d.metrics()
        finally:
            d.stop()
        outs[tp] = (toks, tuple(m[k] for k in keys))
    assert outs[1] == outs[2]
    demotions, promotions, _hits, _prefix, chunks, _cow = outs[2][1]
    assert demotions > 0 and promotions > 0 and chunks > 0


def test_weight_push_cuts_the_tree_by_the_rules(tiny_tp):
    """A live push of a whole tree (JAX's numpy layout) into a tp=2
    replica is cut into its shards as the boot tree was: streams after
    the push equal a tp=1 replica cold-started on the new weights, and
    a tree of the wrong shape is refused whole."""
    spec, _jparams, tcfg, _params = tiny_tp
    new = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(1),
                                             spec.config))
    cold = ContinuousDecoder(params_from_numpy(new, tcfg, "cpu"), tcfg,
                             **_kw({}))
    try:
        ref = _probe(cold)
    finally:
        cold.stop()
    d = _decoder(tiny_tp, 2)
    try:
        assert d.update_weights(new) == 1
        assert _probe(d) == ref
        whole, version = d.weights_snapshot()
        assert version == 1
        np.testing.assert_array_equal(
            whole["layers"]["attn"]["wo"].numpy(),
            new["layers"]["attn"]["wo"])
        bad = jax.tree.map(lambda a: a, new)
        bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :8]
        with pytest.raises(ValueError, match="shape"):
            d.update_weights(bad)
    finally:
        d.stop()
    shards = tensor_shards(new, tcfg, 2)
    wq = new["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(shards[1]["layers"]["attn"]["wq"].numpy(),
                                  wq[..., wq.shape[-1] // 2:])


# ---------------------------------------------------------------------------
# Op-level mesh twins (bitwise: per-head math is shard-local)
# ---------------------------------------------------------------------------


def _mk_pool(gen, n, bs, hkv, hd, quant=False):
    vals = torch.randn((n, bs, hkv, hd), generator=gen)
    if not quant:
        return vals
    scale = vals.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(vals / safe[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def _split_pool(pool, tp):
    """One contiguous pool a shard, as a replica holds them."""
    def cut(arr):
        return [p.contiguous() for p in torch.chunk(arr, tp, dim=2)]

    if isinstance(pool, dict):
        return TensorShards({"q": a, "scale": b} for a, b in
                            zip(cut(pool["q"]), cut(pool["scale"])))
    return TensorShards(cut(pool))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_decode_attention_mesh_twin_bitwise(quant):
    """The twin's online softmax is per head, so its output equals the
    unsharded walk's bit for bit (fp and quantized pools; the pools whole
    or already one a shard)."""
    b, hkv, g, hd, n, bs = 3, 4, 2, 16, 12, 8
    gen = torch.Generator().manual_seed(3)
    kp = _mk_pool(gen, n, bs, hkv, hd, quant)
    vp = _mk_pool(gen, n, bs, hkv, hd, quant)
    q = torch.randn((b, hkv * g, hd), generator=gen)
    table = torch.tensor([[0, 1, 2, 12], [3, 4, 12, 12], [5, 6, 7, 8]],
                         dtype=torch.int32)
    pos = torch.tensor([17, 9, 25], dtype=torch.int32)
    ref = tattn.paged_decode_attention(q, kp, vp, table, pos,
                                       n_kv_heads=hkv)
    mesh = serving_mesh(2, devices=["cpu", "cpu"])
    for k, v in ((kp, vp), (_split_pool(kp, 2), _split_pool(vp, 2))):
        got = tattn.paged_decode_attention(q, k, v, table, pos,
                                           n_kv_heads=hkv, mesh=mesh)
        assert torch.equal(got, ref)


def test_paged_span_attention_mesh_twin_bitwise():
    b, s, hkv, g, hd, n, bs = 2, 3, 4, 2, 16, 10, 8
    gen = torch.Generator().manual_seed(5)
    kp = _mk_pool(gen, n, bs, hkv, hd)
    vp = _mk_pool(gen, n, bs, hkv, hd)
    q = torch.randn((b, s, hkv * g, hd), generator=gen)
    table = torch.tensor([[0, 1, 2], [3, 10, 10]], dtype=torch.int32)
    pos = torch.tensor([9, 4], dtype=torch.int32)
    ref = tattn.paged_span_attention(q, kp, vp, table, pos, n_kv_heads=hkv)
    got = tattn.paged_span_attention(q, kp, vp, table, pos, n_kv_heads=hkv,
                                     mesh=serving_mesh(4, devices=["cpu"] * 4))
    assert torch.equal(got, ref)


def test_mesh_twin_rejects_undivisible_heads():
    mesh = serving_mesh(4, devices=["cpu"] * 4)
    q = torch.zeros((1, 6, 8))
    kp = torch.zeros((4, 8, 6, 8))
    table = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        tattn.paged_decode_attention(q, kp, kp, table, pos, n_kv_heads=6,
                                     mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        tattn.paged_span_attention(q[:, None], kp, kp, table, pos,
                                   n_kv_heads=6, mesh=mesh)


# ---------------------------------------------------------------------------
# Per-shard KV accounting
# ---------------------------------------------------------------------------


def test_kv_bytes_per_token_prices_per_shard():
    base = kv_bytes_per_token(2, 4, 16, 4)
    assert kv_bytes_per_token(2, 4, 16, 4, tp_shards=2) == base // 2
    assert kv_bytes_per_token(2, 4, 16, 4, tp_shards=4) == base // 4
    i8 = kv_bytes_per_token(2, 4, 16, 4, "int8")
    assert kv_bytes_per_token(2, 4, 16, 4, "int8", tp_shards=2) == i8 // 2
    for args in ((2, 4, 16, 4, "fp", 2), (2, 4, 16, 4, "int8", 4)):
        assert kv_bytes_per_token(*args) == jkv_bytes_per_token(*args)
    with pytest.raises(ValueError, match="not divisible"):
        kv_bytes_per_token(2, 4, 16, 4, tp_shards=3)
    with pytest.raises(ValueError, match="tp_shards"):
        kv_bytes_per_token(2, 4, 16, 4, tp_shards=0)


def _gauge(text, name):
    line = next(ln for ln in text.splitlines() if ln.startswith(name + " "))
    return float(line.split()[1])


def test_metrics_and_exposition_report_per_shard_bytes(greedy_by_tp):
    """The pool-fill signals price per-shard memory: a tp=2 pool reports
    half the unsharded bytes per token (same block count), and the
    metrics and gauges read what JAX's decoder's read at the same
    mesh."""
    m1, m2 = greedy_by_tp["port", 1][1], greedy_by_tp["port", 2][1]
    assert m1["kv_blocks_total"] == m2["kv_blocks_total"]
    assert m2["kv_bytes_per_token"] * 2 == m1["kv_bytes_per_token"]
    assert m2["kv_bytes_total"] * 2 == m1["kv_bytes_total"]
    assert m2["tp_shards"] == 2
    for tp in (1, 2):
        _toks, tm, ttext = greedy_by_tp["port", tp]
        _toks, jm, jtext = greedy_by_tp["jax", tp]
        for key in ("tp_shards", "kv_bytes_per_token", "kv_bytes_total",
                    "kv_blocks_total", "kv_blocks_peak"):
            assert tm[key] == jm[key], (tp, key)
        assert _gauge(ttext, "serving_tp_shards") == \
            _gauge(jtext, "serving_tp_shards") == tp


def test_tp_validation_errors(tiny_tp):
    """JAX's messages, each before any device work."""
    _spec, _jparams, _tcfg, params = tiny_tp
    with pytest.raises(ValueError, match="n_kv_heads"):
        _decoder(tiny_tp, 3)
    with pytest.raises(ValueError, match="devices"):
        serving_mesh(max(1, torch.cuda.device_count()) * 2)
    with pytest.raises(ValueError, match="devices"):
        serving_mesh(2, devices=["cpu"])
    # kv heads divide (4 % 4 == 0) but query heads don't (6 % 4 != 0).
    bad = ttransformer.config("lm-test-tiny", n_kv_heads=4, n_heads=6,
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="n_heads"):
        ContinuousDecoder(params, bad, slots=2, prefill_len=16,
                          max_new_tokens=8, tp_shards=4,
                          tp_devices=["cpu"] * 4)
    # A mixture of experts shards its d_ff too (tp=2 serves it:
    # tests/test_torch_moe_parallel.py).
    moe = ttransformer.config("moe-test-tiny", n_kv_heads=4, d_ff=126,
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="d_ff"):
        ContinuousDecoder(params, moe, slots=2, prefill_len=16,
                          max_new_tokens=8, tp_shards=4,
                          tp_devices=["cpu"] * 4)


# ---------------------------------------------------------------------------
# Handoff across mesh shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp_export,tp_import", [(2, 1), (1, 2)])
def test_handoff_across_mesh_shapes(tiny_tp, greedy_by_tp, tp_export,
                                    tp_import):
    """A sharded export holds every head, so a differently sharded
    importer takes its own heads of it: decode after the handoff equals
    a colocated replica's, and the envelope is byte for byte the one
    JAX's packer writes for the same export."""
    prompt = SHARED + [23, 29, 31]
    kw = dict(prefix_cache_slots=4, prefix_cache_min_len=4)
    colo = _decoder(tiny_tp, tp_import, **kw)
    try:
        ref = colo.generate(prompt, 6, timeout=120)["tokens"]
    finally:
        colo.stop()
    exp = _decoder(tiny_tp, tp_export, **kw)
    imp = _decoder(tiny_tp, tp_import, **kw)
    try:
        handoff = exp.export_prompt(prompt)
        assert handoff["tp_shards"] == tp_export
        env = thandoff.pack(handoff)
        jenv = jhandoff.pack({**handoff, "payload": {
            side: handoff["payload"][side].numpy()
            for side in ("k", "v")}})
        assert json.dumps(env, sort_keys=True) == json.dumps(
            jenv, sort_keys=True)
        env = json.loads(json.dumps(env))
        assert env["version"] == thandoff.HANDOFF_VERSION
        assert env["mesh"] == {"tpShards": tp_export, "cpShards": 1,
                               "ppStages": 1}
        unpacked = thandoff.unpack(env)
        assert unpacked["tp_shards"] == tp_export
        assert imp.import_prompt(unpacked)
        got = imp.generate(prompt, 6, timeout=120)["tokens"]
        m = imp.metrics()
    finally:
        exp.stop()
        imp.stop()
    assert got == ref
    assert m["kv_handoff_imports"] == 1
    assert m["prefix_hits"] >= 1  # the submit rode the imported prefix


# ---------------------------------------------------------------------------
# Failure: a sharded replica dies mid-stream
# ---------------------------------------------------------------------------


def test_killed_sharded_replica_leaks_no_block(tiny_tp):
    """A tp=2 replica whose device state dies mid-stream fails its
    streams fast and frees every block: bookkeeping is host-side, so a
    sharded replica's crash sweep frees exactly as an unsharded one's."""
    d = _decoder(tiny_tp, 2, max_new_tokens=64)
    try:
        live = d.submit([3, 5, 7, 2], 60)
        other = d.submit([4, 6, 8], 60)
        stream = live.tokens(timeout=60)
        next(stream)  # live mid-stream
        assert d.metrics()["kv_blocks_in_use"] > 0
        with d._state_lock:
            d._state = None
        with pytest.raises(Exception):
            for _ in stream:
                pass
        with pytest.raises(Exception):
            other.result(timeout=10)
        assert all(not b for b in d._slot_blocks)
        assert d.metrics()["kv_blocks_in_use"] == 0
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# Configuration and the CLI
# ---------------------------------------------------------------------------


def test_engine_config_and_cli_flag(monkeypatch):
    """EngineConfig and --tp-shards as JAX's: 1 by default, < 1 and a
    lockstep server exit 2; ``--device cpu --tp-shards 2`` serves, every
    shard on the host, and its exposition reads 2 shards."""
    import http.client

    from kubeflow_tpu_torch.serving import __main__ as cli
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.server import ModelServer

    assert EngineConfig().tp_shards == 1
    for extra in (["--tp-shards", "0"],
                  ["--tp-shards", "2", "--decode-mode", "lockstep"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["--model-name", "lm-test-tiny", "--grpc-port", "-1",
                      *extra])
        assert e.value.code == 2
    if not torch.cuda.is_available():  # the card default names devices
        with pytest.raises(SystemExit) as e:
            cli.main(["--model-name", "lm-test-tiny", "--grpc-port", "-1",
                      "--tp-shards", "2"])
        assert e.value.code == 2

    seen = {}

    def serve_once(self):
        self.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=60)
            conn.request("POST", "/v1/models/lm-test-tiny:predict",
                         body=json.dumps({"instances": [
                             {"tokens": [1, 2, 3], "max_new_tokens": 4}]}))
            seen["predict"] = json.loads(conn.getresponse().read())
            conn.request("GET", "/monitoring/prometheus/metrics")
            seen["metrics"] = conn.getresponse().read().decode()
            conn.close()
            seen["devices"] = self.decoder.tp_devices
        finally:
            self.stop()

    monkeypatch.setattr(ModelServer, "serve_forever", serve_once)
    assert cli.main(["--model-name", "lm-test-tiny", "--device", "cpu",
                     "--grpc-port", "-1", "--rest-port", "0",
                     "--max-seq-len", "16", "--kv-layout", "paged",
                     "--kv-block-size", "8", "--tp-shards", "2"]) == 0
    assert len(seen["predict"]["predictions"][0]["tokens"]) == 4
    assert _gauge(seen["metrics"], "serving_tp_shards") == 2
    assert seen["devices"] == [torch.device("cpu")] * 2
