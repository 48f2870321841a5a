"""The port's default LM server against the JAX package's: the dense
continuous decoder, the dense prefix cache, the plain predict, lockstep
generation and the CLI's defaults; and the port's copies of the host-side
``PrefixCache`` and ``DynamicBatcher`` on the JAX package's own cases.

Both packages get the same weights (the JAX init, handed across as numpy
arrays) at ``dtype=float32`` on the CPU. Greedy streams must be
identical, plain-predict logits within 1e-5.
"""

import ast
import http.client
import json
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

from kubeflow_tpu.models.decode import generate as jax_generate  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.engine import _predict_impl  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving.batcher import DynamicBatcher  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 9, 2], list(range(4, 20))]
# A token the f32 lm-test-tiny streams of PROMPTS emit mid-stream, so the
# EOS stop really happens.
EOS = 219
DECODER_KW = dict(slots=4, prefill_len=32, max_new_tokens=8, eos_id=EOS)


@pytest.fixture(scope="module")
def weights():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec, jparams, tree, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _streams(decoder, prompts=PROMPTS, want=8, with_logits=None):
    try:
        return [decoder.submit(p, want).result(120, with_logits=with_logits)
                for p in prompts]
    finally:
        decoder.stop()


@pytest.fixture(scope="module")
def jax_dense_streams(weights):
    spec, jparams, *_ = weights
    return {chunk: _streams(JaxDecoder(jparams, spec.config,
                                       chunk_size=chunk, **DECODER_KW))
            for chunk in (1, 4)}


# ---------------------------------------------------------------------------
# The dense continuous decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 4])
def test_dense_decoder_greedy_streams_match_jax(weights, jax_dense_streams,
                                                chunk):
    *_, tcfg, tparams = weights
    decoder = ContinuousDecoder(tparams, tcfg, chunk_size=chunk,
                                **DECODER_KW)
    got = _streams(decoder)
    want = jax_dense_streams[chunk]
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert ([r["finish_reason"] for r in got]
            == [r["finish_reason"] for r in want])
    assert "eos" in [r["finish_reason"] for r in got]
    m = decoder.metrics()
    assert m["kv_layout"] == "dense" and m["kv_blocks_total"] == 0


def test_dense_equals_paged_bitwise(weights):
    """The layouts change where K/V lives, never what is computed: at fp
    the greedy streams and the prefill logits are bitwise equal."""
    *_, tcfg, tparams = weights
    runs = {}
    for layout in ("dense", "paged"):
        runs[layout] = _streams(
            ContinuousDecoder(tparams, tcfg, kv_layout=layout,
                              kv_block_size=8, **DECODER_KW),
            with_logits=True)
    for d, p in zip(runs["dense"], runs["paged"]):
        assert d["tokens"] == p["tokens"]
        np.testing.assert_array_equal(d["prefill_logits"],
                                      p["prefill_logits"])


@pytest.mark.parametrize("option,match", [
    (dict(kv_dtype="int8"), "requires kv_layout='paged'"),
    (dict(kv_fused=True), "requires kv_layout='paged'")],
    ids=["kv_dtype", "kv_fused"])
def test_dense_rejects_paged_only_options(weights, option, match):
    *_, tcfg, tparams = weights
    with pytest.raises(ValueError, match=match):
        ContinuousDecoder(tparams, tcfg, **DECODER_KW, **option)


# ---------------------------------------------------------------------------
# The dense prefix cache
# ---------------------------------------------------------------------------


def _prefix_decoder(weights, **kw):
    *_, tcfg, tparams = weights
    kw.setdefault("prefix_cache_slots", 4)
    return ContinuousDecoder(tparams, tcfg, slots=4, prefill_len=32,
                             max_new_tokens=8, prefix_cache_min_len=8,
                             prefill_len_buckets=2, **kw)


def test_prefix_cold_vs_warm_byte_identical(weights):
    """Same prompt, cache cold then warm (published on finish): the same
    stream, the warm pass prefilling one token; equal to a cache-off
    decoder and to the JAX decoder's stream."""
    spec, jparams, *_ = weights
    prompt = list(range(2, 26))
    d = _prefix_decoder(weights)
    try:
        cold = d.generate(prompt, 6, timeout=120)
        warm = d.generate(prompt, 6, timeout=120)
        m = d.metrics()
    finally:
        d.stop()
    assert warm["tokens"] == cold["tokens"]
    assert (m["prefix_hits"], m["prefix_misses"]) == (1, 1)
    assert m["prefix_tokens_reused"] == len(prompt) - 1
    assert m["prefix_suffix_tokens"] == 1
    assert m["prefill_tokens"] == len(prompt) + 1
    assert m["prefix_inserts"] == 1 and m["prefix_entries"] == 1
    off = _streams(_prefix_decoder(weights, prefix_cache_slots=0),
                   [prompt], 6)[0]
    assert off["tokens"] == cold["tokens"]
    ref = _streams(JaxDecoder(jparams, spec.config, slots=4, prefill_len=32,
                              max_new_tokens=8, prefix_cache_slots=4,
                              prefix_cache_min_len=8,
                              prefill_len_buckets=2), [prompt, prompt], 6)
    assert [r["tokens"] for r in ref] == [cold["tokens"], warm["tokens"]]


def test_primed_prefix_keeps_the_sampling_stream(weights):
    """prime_prefix must not touch the decode generator: a primed decoder
    samples exactly as a cache-off one with the same seed."""
    system = list(range(3, 23))
    prompt = system + [200, 17, 11]

    def run(cache_on):
        d = _prefix_decoder(weights, seed=11,
                            prefix_cache_slots=4 if cache_on else 0)
        try:
            if cache_on:
                assert d.prime_prefix(system)
                assert d.prime_prefix(system)  # already pooled
            toks = d.generate(prompt, 6, temperature=1.0,
                              timeout=120)["tokens"]
            return toks, d.metrics()
        finally:
            d.stop()

    off, _ = run(False)
    on, m = run(True)
    assert on == off
    assert m["prefix_hits"] == 1
    assert m["prefix_tokens_reused"] == len(system)


def test_store_during_a_pinned_admission_leaves_it_unchanged(weights):
    """The pool is written in place, so the pin is the guard. The
    scheduler is held right after the admission that read the sole pool
    row: a store of another prefix then is refused (every row pinned),
    and the request's tokens equal the cold stream. Once it finishes, the
    row is free again."""
    system = list(range(3, 23))
    prompt = system + [5, 6, 7]
    other = list(range(40, 60))
    cold = _streams(_prefix_decoder(weights, prefix_cache_slots=0),
                    [prompt])[0]["tokens"]
    d = _prefix_decoder(weights, prefix_cache_slots=1)
    reached, gate = threading.Event(), threading.Event()
    dispatch = d._dispatch

    def held(toks, emitted):
        if not reached.is_set():
            reached.set()
            gate.wait(60)
        dispatch(toks, emitted)

    d._dispatch = held
    try:
        assert d.prime_prefix(system)
        handle = d.submit(prompt, 8)
        assert reached.wait(60)  # admitted, its entry pinned
        assert not d.prime_prefix(other)
        gate.set()
        assert handle.result(timeout=120)["tokens"] == cold
        assert d.metrics()["prefix_hits"] == 1
        assert d.prime_prefix(other)  # unpinned now: evicts and stores
        assert d.metrics()["prefix_evictions"] == 1
    finally:
        gate.set()
        d.stop()


# ---------------------------------------------------------------------------
# The server: plain predict, lockstep, CLI defaults
# ---------------------------------------------------------------------------


def _engine_cfg(**kw):
    base = dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                max_new_tokens=8, dtype="float32", device="cpu")
    return EngineConfig(**{**base, **kw})


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/models/lm-test-tiny:predict",
                     body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _padded(prompts, b=4, t=32):
    toks = np.zeros((b, t), np.int32)
    lengths = np.ones((b,), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
        lengths[i] = len(p)
    return toks, lengths


def test_http_plain_predict_matches_jax_predict(weights):
    """Three plain instances coalesce into one padded batch of four: the
    last-position logits within 1e-5 of JAX's ``_predict_impl`` on the
    same weights, and their argmax."""
    spec, jparams, tree, *_ = weights
    prompts = PROMPTS[:3]
    toks, lengths = _padded(prompts)
    ref = _predict_impl(spec, jparams, {
        "tokens": jnp.asarray(toks),
        "last_index": jnp.asarray(lengths - 1)})
    server = ModelServer(_engine_cfg(), port=0, params=tree)
    server.start()
    try:
        assert server.engine.ready and server.decoder is not None
        status, body = _post(server.port, {"instances": [
            {"tokens": p} for p in prompts]})
    finally:
        server.stop()
    assert status == 200
    preds = body["predictions"]
    got = np.asarray([p["logits"] for p in preds], np.float32)
    np.testing.assert_allclose(got, np.asarray(ref["logits"])[:3],
                               rtol=1e-5, atol=1e-5)
    assert [p["next_token"] for p in preds] == \
        np.asarray(ref["next_token"])[:3].tolist()


def test_lockstep_predictions_match_jax_generate(weights):
    spec, jparams, tree, *_ = weights
    wants = [8, 3, 5, 0]
    toks, lengths = _padded(PROMPTS)
    ref, last = jax_generate(
        jparams, jnp.asarray(toks), jnp.asarray(lengths), spec.config,
        max_new_tokens=8, key=jax.random.PRNGKey(1),
        temperature=jnp.zeros((4,)))
    ref, last = np.asarray(ref), np.asarray(last)
    server = ModelServer(_engine_cfg(decode_mode="lockstep"), port=0,
                         params=tree)
    server.start()
    try:
        assert server.decoder is None
        status, body = _post(server.port, {"instances": [
            {"tokens": p, "max_new_tokens": w}
            for p, w in zip(PROMPTS, wants)]})
        with pytest.raises(ValueError, match="continuous"):
            server.handle_predict_stream("lm-test-tiny", {"instances": [
                {"tokens": [1], "max_new_tokens": 1}]})
    finally:
        server.stop()
    assert status == 200
    preds = body["predictions"]
    for i, (pred, want) in enumerate(zip(preds, wants)):
        assert pred["tokens"] == ref[i, :want].tolist()
        assert pred["next_token"] == (int(ref[i, 0]) if want
                                      else int(np.argmax(last[i])))
    np.testing.assert_allclose(preds[3]["logits"], last[3], rtol=1e-5,
                               atol=1e-5)


def test_cli_with_no_layout_flag_serves_dense(weights, monkeypatch):
    """The JAX CLI's defaults: the continuous decoder on the dense layout,
    answering a generation predict and a plain predict."""
    from kubeflow_tpu_torch.serving.__main__ import main

    built = []

    def fake_serve_forever(self):
        built.append(self)

    monkeypatch.setattr(ModelServer, "serve_forever", fake_serve_forever)
    assert main(["--model-name", "lm-test-tiny", "--device", "cpu",
                 "--rest-port", "0", "--max-seq-len", "16"]) == 0
    server = built[0]
    try:
        assert server.decoder.metrics()["kv_layout"] == "dense"
        assert server.decoder.prefix_cache is None
        preds = server.handle_predict("lm-test-tiny", {"instances": [
            {"tokens": [1, 2, 3], "max_new_tokens": 4},
            {"tokens": [1, 2, 3]}]})["predictions"]
        assert len(preds[0]["tokens"]) == 4
        assert preds[1]["next_token"] == preds[0]["tokens"][0]
    finally:
        server.stop()


@pytest.mark.parametrize("extra", [
    ["--decode-mode", "lockstep", "--eos-id", "3"],
    ["--decode-mode", "lockstep", "--prefix-cache-slots", "2"],
    ["--kv-dtype", "int8"], ["--kv-fused-attention"]],
    ids=["eos_lockstep", "prefix_lockstep", "int8_dense", "fused_dense"])
def test_cli_rejects_what_the_jax_cli_rejects(extra):
    from kubeflow_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--model-name", "lm-test-tiny", "--device", "cpu", *extra])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# The copies: the JAX package's own cases on the port's PrefixCache and
# DynamicBatcher (tests/test_prefix_cache.py, tests/test_batcher.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["prefix_cache", "batcher"])
def test_copies_match_the_jax_modules(name):
    """The copies differ from their JAX originals in the module docstring
    only."""
    def body(path):
        tree = ast.parse(path.read_text())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(ROOT / "kubeflow_tpu_torch" / "serving" / f"{name}.py") == \
        body(ROOT / "kubeflow_tpu" / "serving" / f"{name}.py")


def test_trie_match_through_interior_nodes():
    c = PrefixCache(4, min_len=4)
    shared = list(range(10, 30))
    assert c.reserve(tuple(shared + [1, 2])) is not None
    m = c.match(shared + [3, 4])
    assert m is not None
    entry, depth = m
    assert depth == len(shared)
    assert entry.key[:depth] == tuple(shared)


def test_trie_match_caps_and_min_len():
    c = PrefixCache(4, min_len=4)
    assert c.reserve((1, 2, 3, 4, 5, 6)) is not None
    _entry, depth = c.match([1, 2, 3, 4, 5, 6])
    assert depth == 5
    assert c.match([1, 2, 3, 4]) is None
    assert c.match([9, 9, 9, 9, 9]) is None
    assert c.reserve((1, 2, 3, 4, 5, 6)) is None
    assert len(c) == 1


def test_trie_lru_eviction_order():
    c = PrefixCache(2, min_len=1)
    e1 = c.reserve((1,) * 8)
    e2 = c.reserve((2,) * 8)
    assert {e1.slot, e2.slot} == {0, 1}
    c.touch((1,) * 8)
    e3 = c.reserve((3,) * 8)
    assert c.evictions == 1
    assert e3.slot == e2.slot
    assert c.match(list((2,) * 8) + [0]) is None
    assert c.match(list((1,) * 8) + [0]) is not None


def test_trie_pinned_entries_never_evicted():
    c = PrefixCache(1, min_len=1)
    c.reserve((1, 2, 3, 4))
    entry, _depth = c.match([1, 2, 3, 4, 5])
    assert c.reserve((7, 8, 9)) is None
    assert c.evictions == 0
    c.release(entry)
    assert c.reserve((7, 8, 9)) is not None
    assert c.evictions == 1
    assert c.match([1, 2, 3, 4, 5]) is None


class _Recorder:
    """predict_batch stand-in recording each batch's contents."""

    def __init__(self, delay: float = 0.0):
        self.batches: list[list[dict]] = []
        self.delay = delay
        self.lock = threading.Lock()

    def __call__(self, instances):
        if self.delay:
            time.sleep(self.delay)
        with self.lock:
            self.batches.append(list(instances))
        return [{"echo": inst["i"]} for inst in instances]


def test_batcher_full_batch_flushes_without_waiting_for_timeout():
    rec = _Recorder()
    b = DynamicBatcher(rec, batch_size=4, batch_timeout_ms=30_000)
    try:
        t0 = time.monotonic()
        pending = [b.submit_async({"i": i}) for i in range(4)]
        results = [DynamicBatcher.collect(p, timeout=10) for p in pending]
        assert time.monotonic() - t0 < 5
        assert [r["echo"] for r in results] == [0, 1, 2, 3]
        assert [len(batch) for batch in rec.batches] == [4]
    finally:
        b.stop()


def test_batcher_timeout_flushes_partial_batch():
    rec = _Recorder()
    b = DynamicBatcher(rec, batch_size=8, batch_timeout_ms=50)
    try:
        pending = [b.submit_async({"i": i}) for i in range(3)]
        results = [DynamicBatcher.collect(p, timeout=10) for p in pending]
        assert [r["echo"] for r in results] == [0, 1, 2]
        assert [len(batch) for batch in rec.batches] == [3]
    finally:
        b.stop()


def test_batcher_deadline_runs_from_submit_not_dequeue():
    rec = _Recorder(delay=0.3)
    b = DynamicBatcher(rec, batch_size=8, batch_timeout_ms=50)
    try:
        first = b.submit_async({"i": 0})
        time.sleep(0.15)  # batch 1 ([0]) is mid-predict
        late = [b.submit_async({"i": i}) for i in (1, 2)]
        t0 = time.monotonic()
        for p in late:
            DynamicBatcher.collect(p, timeout=10)
        waited = time.monotonic() - t0
        DynamicBatcher.collect(first, timeout=10)
        assert [len(batch) for batch in rec.batches] == [1, 2]
        assert waited < 0.58, waited
    finally:
        b.stop()


def test_batcher_stop_drains_queued_work():
    rec = _Recorder(delay=0.2)
    b = DynamicBatcher(rec, batch_size=1, batch_timeout_ms=5)
    pending = [b.submit_async({"i": i}) for i in range(3)]
    b.stop()
    for p in pending:
        t0 = time.monotonic()
        try:
            r = DynamicBatcher.collect(p, timeout=1)
            assert "echo" in r
        except RuntimeError as e:
            assert "batcher stopped" in str(e)
        assert time.monotonic() - t0 < 0.5


def test_batcher_submit_after_stop_raises():
    b = DynamicBatcher(_Recorder(), batch_size=2, batch_timeout_ms=5)
    b.stop()
    with pytest.raises(RuntimeError, match="batcher stopped"):
        b.submit_async({"i": 0})
