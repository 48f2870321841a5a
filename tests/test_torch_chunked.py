"""The port's chunked prefill against the JAX package's.

A chunked admission is the same admission dispatched in bounded pieces:
greedy streams must equal JAX's chunked decoder and a monolithic decoder
whose prefill window covers the whole prompt (with and without a prefix
hit; int8 pools equal JAX's, chunked and monolithic); a sampled stream
must equal the port's monolithic
one with the same seed (interior chunks draw nothing); prompts past
``max_prompt_len`` are ``PromptTooLong`` (HTTP 413). lm-test-tiny at
``dtype=float32`` on the CPU, weights carried across as numpy arrays.
"""

import http.client
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
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving.continuous import (  # noqa: E402
    ContinuousDecoder,
    PromptTooLong,
)
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

# 80 tokens: 2.5x the 32-token prefill window, mid-block tail at block 8.
LONG = [(j * 7 + 3) % 97 + 1 for j in range(80)]
SHORT = [5, 11, 7, 3, 13, 2, 17, 9, 4, 6, 19, 8]
PROBES = [LONG, LONG[:40], SHORT, [1, 2, 3]]
BASE = dict(slots=4, prefill_len=32, max_new_tokens=16, kv_layout="paged",
            kv_block_size=8, stream_timeout_s=120.0)


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return (spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu"),
            tree)


def _port(models, **kw):
    _, _, tcfg, tparams, _ = models
    return ContinuousDecoder(tparams, tcfg, **{**BASE, **kw})


def _chunked(models, chunk=8, **kw):
    kw.setdefault("max_prompt_len", 112)
    return _port(models, prefill_chunk_tokens=chunk, **kw)


def _wide(models, **kw):
    """Monolithic reference: one prefill window covering max_prompt_len."""
    return _port(models, prefill_len=112, **kw)


def _probe(decoder, prompts=PROBES, want=6, **gen):
    try:
        return ([decoder.generate(p, want, timeout=120, **gen)["tokens"]
                 for p in prompts], decoder.metrics())
    finally:
        decoder.stop()


@pytest.fixture(scope="module")
def jax_chunked(models):
    jcfg, jparams, *_ = models
    return _probe(JaxDecoder(jparams, jcfg, prefill_chunk_tokens=8,
                             max_prompt_len=112, **BASE))


@pytest.mark.parametrize("fused", [False, True], ids=["gathered", "fused"])
def test_chunked_equals_jax_and_monolithic(models, jax_chunked, fused):
    want, jm = jax_chunked
    got, m = _probe(_chunked(models, kv_fused=fused))
    wide, _ = _probe(_wide(models, kv_fused=fused))
    assert got == want == wide
    for key in ("prefill_chunks", "prefill_dispatches", "prefill_tokens",
                "requests_admitted", "tokens_emitted"):
        assert m[key] == jm[key], key
    assert m["prefill_chunks"] > 0 and m["kv_blocks_in_use"] == 0


@pytest.mark.parametrize("plen", [63, 64, 65])
def test_chunk_boundary_lengths(models, plen):
    """Prompt lengths straddling a chunk multiple: the final chunk is
    full-width, one token, or chunk-1; all equal the monolithic
    admission."""
    prompt = LONG[:plen]
    want, _ = _probe(_wide(models), [prompt])
    got, _ = _probe(_chunked(models, chunk=8), [prompt])
    assert got == want


def test_sampled_chunked_equals_monolithic(models):
    """Interior chunks draw nothing from the generator, so a sampled
    chunked stream is the monolithic one with the same seed."""
    want, _ = _probe(_wide(models, seed=7), temperature=0.8)
    got, _ = _probe(_chunked(models, seed=7), temperature=0.8)
    assert got == want


def test_prefix_hit_then_chunking_matches_jax(models):
    """A chunked re-admission over a cached prefix starts its chain at
    the pinned prefix length."""
    jcfg, jparams, *_ = models
    kw = dict(prefix_cache_slots=4, prefix_cache_min_len=8)
    probes = [LONG, LONG + [23, 29], LONG + [31, 37]]
    want, jm = _probe(JaxDecoder(jparams, jcfg, prefill_chunk_tokens=8,
                                 max_prompt_len=112, **BASE, **kw), probes)
    wide, _ = _probe(_wide(models, **kw), probes)
    got, m = _probe(_chunked(models, **kw), probes)
    assert got == want == wide
    assert m["prefix_hits"] == jm["prefix_hits"] >= 2
    assert m["kv_shared_blocks"] == jm["kv_shared_blocks"]
    assert m["kv_cow_copies"] == jm["kv_cow_copies"]
    assert m["prefill_chunks"] == jm["prefill_chunks"] > 0


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "monolithic"])
def test_int8_matches_jax(models, chunked):
    """int8 pools: a chunk attends over the earlier chunks' quantized K/V
    where a monolithic prefill attends over its own float K/V, so the
    two may differ (on this model LONG[:40] does, in JAX as here). Each
    must equal JAX's."""
    jcfg, jparams, *_ = models
    kw = (dict(prefill_chunk_tokens=8, max_prompt_len=112) if chunked
          else dict(prefill_len=112))
    want, jm = _probe(JaxDecoder(jparams, jcfg, **{**BASE, **kw},
                                 kv_dtype="int8"))
    got, m = _probe(_port(models, **kw, kv_dtype="int8"))
    assert got == want
    assert m["prefill_chunks"] == jm["prefill_chunks"]
    assert (m["prefill_chunks"] > 0) == chunked


def test_a_chunk_chain_starting_on_a_prefix_hit_copies_the_tail(models):
    """The chain's first chunk copies the plan's partly shared tail
    block, as a one-call prefix hit does: LONG[:20] is published, then a
    long prompt over it chunks from position 20 (two full blocks shared,
    one copied)."""
    kw = dict(prefix_cache_slots=4, prefix_cache_min_len=8)
    prompts = [LONG[:20], LONG]
    want, _ = _probe(_wide(models, **kw), prompts)
    got, m = _probe(_chunked(models, **kw), prompts)
    assert got == want
    assert m["kv_cow_copies"] == 1 and m["kv_shared_blocks"] == 2


def test_no_leaked_blocks_after_chunked_drain(models):
    d = _chunked(models, prefix_cache_slots=4, prefix_cache_min_len=8)
    try:
        for p in PROBES:
            assert len(d.generate(p, 6, timeout=120)["tokens"]) == 6
        with d._prefix_lock:
            while d.prefix_cache.evict_lru():
                pass
        assert d.metrics()["kv_blocks_in_use"] == 0
    finally:
        d.stop()


def test_long_admission_interleaves_with_a_live_stream(models):
    """A long prompt submitted while a short stream decodes: the chain
    runs one chunk a round, so the short stream keeps emitting between
    chunks, and both streams equal their monolithic runs."""
    want, _ = _probe(_wide(models), [SHORT, LONG], want=16)
    d = _chunked(models)
    try:
        short = d.submit(SHORT, 16)
        it = short.tokens(timeout=120)
        first = next(it)
        long_h = d.submit(LONG, 16)
        got_short = [first] + list(it)
        got_long = long_h.result(timeout=120)["tokens"]
        m = d.metrics()
    finally:
        d.stop()
    assert [got_short, got_long] == want
    # LONG: 9 interior chunks of 8 and a final 8; SHORT (12 tokens): one
    # interior chunk and a final 4.
    assert m["prefill_chunks"] == 10


def test_prompt_too_long_boundary(models):
    d = _chunked(models, chunk=16, max_prompt_len=112)
    try:
        edge = [(i % 90) + 1 for i in range(112)]
        assert len(d.generate(edge, 4, timeout=120)["tokens"]) == 4
        with pytest.raises(PromptTooLong):
            d.generate(edge + [1], 4, timeout=120)
        m = d.metrics()
    finally:
        d.stop()
    assert m["prompt_rejected_too_long"] == 1
    assert m["max_prompt_len"] == 112


def test_unchunked_prompt_beyond_window_still_rejects(models):
    d = _port(models)
    try:
        with pytest.raises(PromptTooLong):
            d.generate(LONG, 4, timeout=120)
    finally:
        d.stop()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/models/lm-test-tiny:predict",
                     body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_server_maps_prompt_too_long_to_413(models):
    server = ModelServer(
        EngineConfig(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                     max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                     prefill_chunk_tokens=8, max_prompt_len=48,
                     dtype="float32", device="cpu"),
        port=0, params=models[4], batch_timeout_ms=2)
    server.start()
    try:
        status, body = _post(server.port, {
            "instances": [{"tokens": [1] * 48, "max_new_tokens": 2}]})
        assert status == 200, body
        status, body = _post(server.port, {
            "instances": [{"tokens": [1] * 49, "max_new_tokens": 2}]})
        assert status == 413, body
        assert b"prompt" in body.lower()
        status, _ = _post(server.port, {
            "instances": [{"tokens": [1, 2, 3], "max_new_tokens": 2}]})
        assert status == 200
    finally:
        server.stop()


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk_tokens=8, kv_layout="dense"),
     "requires kv_layout='paged'"),
    (dict(prefill_chunk_tokens=64), "must be <= prefill_len"),
    (dict(max_prompt_len=112), "requires prefill_chunk_tokens"),
    (dict(max_prompt_len=16), "must be >= prefill_len"),
], ids=["dense", "wider_than_window", "no_chunks", "below_window"])
def test_chunk_knob_validation(models, kw, match):
    with pytest.raises(ValueError, match=match):
        _port(models, **kw)
