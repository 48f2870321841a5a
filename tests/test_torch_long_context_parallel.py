"""The context-parallel ring and pipeline stages in the port's continuous
decoder, against the JAX package's.

One process drives every shard of a replica on the host. On
``lm-test-tiny`` at f32 (4 KV heads, so tensor shards of 2 split them),
chunked prefill at 16 tokens a chunk over a 112-token prompt ceiling, the
greedy tokens of four probes (an 80-token prompt, which the chunk chain
admits, 40 tokens, 12 and 3) must be identical to JAX's
``ContinuousDecoder`` at the same settings:

- cp 2 and cp 4 against JAX's cp 2 and cp 4; cp 2 x tp 2 against JAX's
  cp 2 (JAX's CPU backend cannot partition tp x cp, so its own tests run
  the ring at tp 1; its cp streams equal its cp 1 streams);
- pp 2 against JAX's pp 2 on the paged layout and the dense one; pp 2 x
  tp 2 against JAX's pp 2.

Then the gauges and ``metrics()`` entries read the replica's cp and pp,
as JAX's do; a pipeline replica's pool holds each stage's layers (and
each shard's heads of them), its weights join back whole, and a handoff
crosses mesh shapes (cp 2 x tp 2 -> pp 2 x tp 2 -> tp 1) with the
envelope's ``mesh`` carrying the exporter's shape, byte for byte JAX's;
the option checks raise JAX's messages.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving import handoff as jhandoff  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    PipelineStages,
    TensorShards,
    serving_mesh,
)
from kubeflow_tpu_torch.serving import handoff as thandoff  # noqa: E402
from kubeflow_tpu_torch.serving.__main__ import main as cli_main  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.weights import (  # noqa: E402
    flatten,
    params_from_numpy,
)

# 80 tokens: 2.5x the 32-token window, a chain of five 16-token chunks.
LONG = [(j * 7 + 3) % 97 + 1 for j in range(80)]
SHORT = [5, 11, 7, 3, 13, 2, 17, 9, 4, 6, 19, 8]
PROBES = [LONG, LONG[:40], SHORT, [1, 2, 3]]


@pytest.fixture(scope="module")
def tiny():
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
    if kw["kv_layout"] == "paged":
        kw.setdefault("prefill_chunk_tokens", 16)
        kw.setdefault("max_prompt_len", 112)
    return kw


def _decoder(tiny, tp=1, cp=1, pp=1, **kw):
    _spec, _jparams, tcfg, params = tiny
    return ContinuousDecoder(params, tcfg, tp_shards=tp, cp_shards=cp,
                             pp_stages=pp, tp_devices=["cpu"] * (tp * cp * pp),
                             **_kw(kw))


def _jax_decoder(tiny, cp=1, pp=1, **kw):
    spec, jparams, _tcfg, _params = tiny
    return JaxDecoder(jparams, spec.config, cp_shards=cp, pp_stages=pp,
                      **_kw(kw))


def _run(d, probes=PROBES):
    try:
        toks = [d.generate(p, 6, timeout=120)["tokens"] for p in probes]
        return toks, d.metrics(), d.registry.render()
    finally:
        d.stop()


# (port settings, JAX settings): the port's replica and the JAX decoder it
# must equal.
PORT = {
    "cp2": (dict(cp=2), "cp2"),
    "cp4": (dict(cp=4), "cp4"),
    "cp2xtp2": (dict(cp=2, tp=2), "cp2"),
    "pp2": (dict(pp=2), "pp2"),
    "pp2-dense": (dict(pp=2, kv_layout="dense", prefill_len=128),
                  "pp2-dense"),
    "pp2xtp2": (dict(pp=2, tp=2), "pp2"),
}
JAX = {"cp2": dict(cp=2), "cp4": dict(cp=4), "pp2": dict(pp=2),
       "pp2-dense": dict(pp=2, kv_layout="dense", prefill_len=128)}


@pytest.fixture(scope="module")
def streams(tiny):
    """Every setting's probe tokens, metrics and exposition, the port's
    and JAX's."""
    out = {("jax", k): _run(_jax_decoder(tiny, **kw))
           for k, kw in JAX.items()}
    for k, (kw, _ref) in PORT.items():
        out["port", k] = _run(_decoder(tiny, **kw))
    return out


@pytest.mark.parametrize("setting", list(PORT))
def test_greedy_streams_match_jax(streams, setting):
    ref = PORT[setting][1]
    assert streams["port", setting][0] == streams["jax", ref][0]


def _gauge(text: str, name: str) -> float:
    return float(re.search(rf"^{name} (\S+)$", text, re.M).group(1))


@pytest.mark.parametrize("setting", ["cp2", "cp4", "pp2", "pp2-dense"])
def test_metrics_and_exposition_carry_the_mesh(streams, setting):
    """``metrics()`` and the gauges read the replica's cp and pp, and the
    pool's block and byte entries JAX's (priced per tensor shard, as
    JAX's allocator prices them)."""
    _t, tm, ttext = streams["port", setting]
    _t, jm, jtext = streams["jax", setting]
    for key in ("cp_shards", "pp_stages", "tp_shards", "kv_bytes_per_token",
                "kv_bytes_total", "kv_blocks_total", "prefill_chunks"):
        assert tm[key] == jm[key], key
    for gauge in ("serving_cp_shards", "serving_pp_stages"):
        assert _gauge(ttext, gauge) == _gauge(jtext, gauge)
    assert (tm["cp_shards"], tm["pp_stages"]) == (
        JAX[setting].get("cp", 1), JAX[setting].get("pp", 1))


def test_staged_replica_holds_each_stages_layers(tiny):
    """pp 2 x tp 2: each stage's pool holds its layer of the two, each
    shard half the KV heads; the weights join back to the tree served."""
    _spec, _jparams, tcfg, params = tiny
    d = _decoder(tiny, tp=2, pp=2)
    try:
        pool = d._state["pool"]["k"]
        assert isinstance(pool, PipelineStages) and len(pool) == 2
        for stage in pool:
            assert isinstance(stage, TensorShards)
            assert [tuple(s.shape[:1]) + tuple(s.shape[3:]) for s in stage] \
                == [(1, 2, 16)] * 2
        assert isinstance(d.params, PipelineStages)
        assert d.params[1][0]["layers"]["attn"]["wq"].shape == (1, 64, 32)
        whole, _version = d.weights_snapshot()
        for path, leaf in flatten(params).items():
            torch.testing.assert_close(flatten(whole)[path], leaf,
                                       rtol=0, atol=0)
    finally:
        d.stop()


@pytest.mark.parametrize("exporter,importer", [
    (dict(cp=2, tp=2), dict(pp=2, tp=2)),
    (dict(pp=2, tp=2), dict()),
], ids=["cp2xtp2-to-pp2xtp2", "pp2xtp2-to-tp1"])
def test_handoff_across_mesh_shapes(tiny, exporter, importer):
    """An export holds every layer and head, so any mesh imports it:
    decode after the handoff equals a colocated replica's, and the
    envelope (its ``mesh`` the exporter's shape) is byte for byte JAX's
    packer's."""
    prompt = SHORT + [23, 29, 31]
    kw = dict(prefix_cache_slots=4, prefix_cache_min_len=4)
    colo = _decoder(tiny, **importer, **kw)
    try:
        ref = colo.generate(prompt, 6, timeout=120)["tokens"]
    finally:
        colo.stop()
    exp = _decoder(tiny, **exporter, **kw)
    imp = _decoder(tiny, **importer, **kw)
    try:
        handoff = exp.export_prompt(prompt)
        env = thandoff.pack(handoff)
        jenv = jhandoff.pack({**handoff, "payload": {
            side: handoff["payload"][side].numpy() for side in ("k", "v")}})
        assert json.dumps(env, sort_keys=True) == json.dumps(
            jenv, sort_keys=True)
        env = json.loads(json.dumps(env))
        assert env["mesh"] == {"tpShards": exporter.get("tp", 1),
                               "cpShards": exporter.get("cp", 1),
                               "ppStages": exporter.get("pp", 1)}
        unpacked = thandoff.unpack(env)
        assert (unpacked["cp_shards"], unpacked["pp_stages"]) == (
            exporter.get("cp", 1), exporter.get("pp", 1))
        assert imp.import_prompt(unpacked)
        got = imp.generate(prompt, 6, timeout=120)["tokens"]
    finally:
        exp.stop()
        imp.stop()
    assert got == ref


@pytest.mark.parametrize("kw,match", [
    (dict(cp=3), "must be a power of two"),
    (dict(cp=2, prefill_chunk_tokens=0, max_prompt_len=0),
     "set prefill_chunk_tokens > 0"),
    (dict(cp=2, kv_fused=True), "does not compose with kv_fused"),
    (dict(cp=2, kv_layout="dense"), "requires kv_layout='paged'"),
    (dict(cp=8, prefill_len_buckets=3),
     "must divide the suffix bucket floor 4"),
    (dict(pp=3), "n_layers 2 not divisible by pp_stages 3"),
    (dict(pp=2, kv_fused=True), "pp_stages > 1 does not compose with "
     "kv_fused"),
], ids=["cp3", "cp-unchunked", "cp-fused", "cp-dense", "cp-floor", "pp3",
        "pp-fused"])
def test_validation_errors_are_jax_messages(tiny, kw, match):
    jkw = {k: v for k, v in kw.items()}
    with pytest.raises(ValueError, match=match) as jerr:
        _jax_decoder(tiny, **jkw)
    with pytest.raises(ValueError) as terr:
        _decoder(tiny, **kw)
    assert str(terr.value) == str(jerr.value)


def test_serving_mesh_orders_the_replica_devices():
    assert serving_mesh(2, cp=2, pp=2, devices=["cpu"] * 8) == \
        [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="tp=2 cp=2 pp=2 needs 8 devices"):
        serving_mesh(2, cp=2, pp=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="cp must be >= 1"):
        serving_mesh(1, cp=0)


def test_engine_config_and_cli_flags(capsys):
    """EngineConfig and the CLI as JAX's: 1 by default; the ring wants
    chunked prefill and the gathered read, stages the continuous
    decoder; a CUDA replica wider than the visible cards exits 2 naming
    the devices."""
    cfg = EngineConfig()
    assert cfg.cp_shards == 1 and cfg.pp_stages == 1
    base = ["--model-name", "lm-test-tiny", "--grpc-port", "-1"]
    cases = [
        (["--kv-layout", "paged", "--cp-shards", "2"],
         "--cp-shards requires --prefill-chunk-tokens"),
        (["--kv-layout", "paged", "--prefill-chunk-tokens", "8",
          "--cp-shards", "2", "--kv-fused-attention"],
         "--cp-shards uses the gathered ring read"),
        (["--pp-stages", "2", "--decode-mode", "lockstep"],
         "--pp-stages requires --decode-mode=continuous"),
        (["--cp-shards", "0"], "--cp-shards must be >= 1"),
        (["--pp-stages", "0"], "--pp-stages must be >= 1"),
        (["--pp-stages", str(max(1, torch.cuda.device_count()) * 2)],
         "devices"),
    ]
    for flags, match in cases:
        with pytest.raises(SystemExit) as e:
            cli_main(base + flags)
        assert e.value.code == 2
        assert match in capsys.readouterr().err


def test_only_chunk_dispatches_read_through_the_ring(tiny, monkeypatch):
    """cp 2: the 80-token prompt's five chunk dispatches (four interior,
    the final admission) fold every layer's span read through the ring;
    the decode steps after it and a short prompt's monolithic admission
    never do."""
    from kubeflow_tpu_torch.models import decode as tdecode

    calls = []
    real = tdecode.ring_span_attention

    def counted(*args, **kwargs):
        calls.append(len(kwargs["devices"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tdecode, "ring_span_attention", counted)
    d = _decoder(tiny, cp=2)
    try:
        d.generate(LONG, 6, timeout=120)
        assert calls == [2] * (5 * 2)  # 5 dispatches x 2 layers
        d.generate(SHORT, 6, timeout=120)
        assert len(calls) == 10
    finally:
        d.stop()


def test_weight_push_into_a_staged_replica(tiny):
    """A live push of a whole tree (JAX's numpy layout) into a pp 2 x tp 2
    replica is cut into its stages and shards as the boot tree was:
    streams after the push equal a cold replica on the new weights, and
    the snapshot joins back to the pushed tree."""
    spec, _jparams, tcfg, _params = tiny
    new = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(1),
                                             spec.config))
    cold = ContinuousDecoder(params_from_numpy(new, tcfg, "cpu"), tcfg,
                             **_kw({}))
    ref = _run(cold)[0]
    d = _decoder(tiny, tp=2, pp=2)
    try:
        assert d.update_weights(new) == 1
        got = [d.generate(p, 6, timeout=120)["tokens"] for p in PROBES]
        whole, version = d.weights_snapshot()
    finally:
        d.stop()
    assert got == ref and version == 1
    np.testing.assert_array_equal(whole["layers"]["mlp"]["down"].numpy(),
                                  new["layers"]["mlp"]["down"])
