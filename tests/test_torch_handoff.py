"""The port's prefill/decode handoff against the JAX package's: the
envelope (``serving/handoff.py``: byte for byte JAX's, bf16 carried as
its 16-bit pattern), ``export_prompt``/``import_prompt`` on fp and int8
pools, handoffs that cross frameworks in both directions, the
bookkeeping (nothing leaks, shared blocks stay refcounted, mismatched
pools are refused), the ``role`` gauge, and the server's ``:prefill`` and
``:import`` routes.

Both packages get the same weights (the JAX init, handed across as numpy
arrays) at ``dtype=float32`` on the CPU; greedy streams equal a
colocated replica's and JAX's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving import handoff as jhandoff  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving import handoff as thandoff  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

PROMPT = list(range(3, 3 + 20))
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return (spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu"),
            tree)


def _kw(**over):
    kw = dict(slots=4, prefill_len=32, max_new_tokens=16, kv_layout="paged",
              kv_block_size=8, prefix_cache_slots=8, prefix_cache_min_len=8,
              prefill_len_buckets=2, stream_timeout_s=120.0)
    kw.update(over)
    return kw


def _port(models, **over):
    return ContinuousDecoder(models[3], models[2], **_kw(**over))


def _jax(models, **over):
    return JaxDecoder(models[1], models[0], **_kw(**over))


def _np(node):
    if isinstance(node, dict):
        return {k: _np(v) for k, v in node.items()}
    return node.numpy() if isinstance(node, torch.Tensor) else \
        np.asarray(node)


def _same_payload(a, b):
    a, b = _np(a), _np(b)
    for side in ("k", "v"):
        if isinstance(a[side], dict):
            for k in ("q", "scale"):
                assert a[side][k].tobytes() == b[side][k].tobytes()
                assert a[side][k].dtype == b[side][k].dtype
        else:
            assert a[side].tobytes() == b[side].tobytes()
            assert a[side].dtype == b[side].dtype


# ---------------------------------------------------------------------------
# The envelope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_export_and_envelope_match_jax(models, kv_dtype):
    """The same prompt exported by both packages: the same prefix, the
    same payload within f32 rounding, and, for one payload, the same JSON
    envelope from either packer; each side unpacks the other's bit for
    bit."""
    hs = []
    for make in (_port, _jax):
        d = make(models, role="prefill", kv_dtype=kv_dtype)
        try:
            hs.append(d.export_prompt(PROMPT, timeout=120))
            assert d.metrics()["kv_handoff_exports"] == 1
        finally:
            d.stop()
    th, jh = hs
    assert th["prefix_len"] == jh["prefix_len"] == len(PROMPT) - 1
    assert th["tokens"] == jh["tokens"]
    # The two prefills agree within f32 rounding (TOL), not bit for bit.
    for side in ("k", "v"):
        t, j = _np(th["payload"][side]), _np(jh["payload"][side])
        if kv_dtype == "fp":
            assert t.dtype == j.dtype and t.shape == j.shape
            np.testing.assert_allclose(t, j, rtol=0, atol=TOL)
        else:  # a code may differ by one where a value sits on an edge
            assert t["q"].dtype == j["q"].dtype == np.int8
            assert np.abs(t["q"].astype(int) - j["q"]).max() <= 1
            np.testing.assert_allclose(t["scale"], j["scale"], rtol=TOL)
    tenv, jenv = thandoff.pack(th), jhandoff.pack(jh)
    assert json.dumps(thandoff.pack(jh), sort_keys=True) == \
        json.dumps(jenv, sort_keys=True)
    assert set(tenv) == set(jenv) and tenv["mesh"] == jenv["mesh"]
    back = thandoff.unpack(json.loads(json.dumps(jenv)))
    _same_payload(back["payload"], jh["payload"])
    jback = jhandoff.unpack(json.loads(json.dumps(tenv)))
    _same_payload(jback["payload"], th["payload"])
    assert thandoff.unpack(tenv)["prefix_len"] == th["prefix_len"]


def test_bf16_round_trips_bit_for_bit_both_ways():
    """A bf16 payload: the port packs its 16-bit pattern under the name
    "bfloat16"; JAX (through ml_dtypes) reads the same values, and the
    port reads JAX's envelope back bit for bit."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((2, 3, 4, 2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    t[0, 0, 0, 0, :3] = torch.tensor([float("inf"), float("-inf"), -0.0])
    h = {"tokens": [1, 2, 3], "prefix_len": 2, "block_size": 4,
         "kv_dtype": "fp", "payload": {"k": t, "v": t.clone()}}
    env = json.loads(json.dumps(thandoff.pack(h)))
    assert env["payload"]["k"]["dtype"] == "bfloat16"
    back = thandoff.unpack(env)["payload"]["k"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    jk = jhandoff.unpack(env)["payload"]["k"]
    assert jk.dtype == ml_dtypes.bfloat16
    assert np.array_equal(jk.view(np.int16), t.view(torch.int16).numpy())
    jenv = json.loads(json.dumps(jhandoff.pack({**h, "payload": {
        "k": jk, "v": jk}})))
    assert jenv["payload"]["k"] == env["payload"]["k"]
    assert torch.equal(thandoff.unpack(jenv)["payload"]["v"].view(
        torch.int16), t.view(torch.int16))


def test_unpack_rejects_garbage():
    with pytest.raises(ValueError):
        thandoff.unpack({"version": 99, "payload": {}})
    with pytest.raises(ValueError):
        thandoff.unpack({"version": 1, "tokens": [1, 2], "prefix_len": 1,
                         "block_size": 8, "payload": {"k": "nope"}})
    with pytest.raises(ValueError):
        thandoff.unpack("not even a dict")
    with pytest.raises(ValueError):
        thandoff.unpack({"version": 2, "tokens": [1], "prefix_len": 1,
                         "block_size": 8, "mesh": 5,
                         "payload": {"k": {}, "v": {}}})


# ---------------------------------------------------------------------------
# Byte identity across the handoff, within and across frameworks
# ---------------------------------------------------------------------------


def test_fp_handoff_equals_colocated_and_jax(models):
    ref = _port(models)
    try:
        want = ref.generate(PROMPT, 8, timeout=120)["tokens"]
    finally:
        ref.stop()
    jref = _jax(models)
    try:
        assert jref.generate(PROMPT, 8, timeout=120)["tokens"] == want
    finally:
        jref.stop()
    a, b = _port(models, role="prefill"), _port(models, role="decode")
    try:
        h = a.export_prompt(PROMPT, timeout=120)
        assert b.import_prompt(h)
        assert b.generate(PROMPT, 8, timeout=120)["tokens"] == want
        mb = b.metrics()
        assert mb["prefix_hits"] == 1 and mb["kv_handoff_imports"] == 1
        assert mb["kv_handoff_tokens"] == len(PROMPT) - 1
        assert a.metrics()["kv_handoff_exports"] == 1
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_handoff_across_frameworks(models, kv_dtype):
    """A handoff JAX exports and packs imports into the port and decodes
    the tokens JAX's decode replica does; the port's export imports into
    JAX the same way."""
    def run(exporter, importer, via_json):
        a, b = exporter(models, role="prefill", kv_dtype=kv_dtype), \
            importer(models, role="decode", kv_dtype=kv_dtype)
        try:
            h = a.export_prompt(PROMPT, timeout=120)
            if via_json:
                env = json.loads(json.dumps(
                    (jhandoff if exporter is _jax else thandoff).pack(h)))
                h = (thandoff if importer is _port else jhandoff).unpack(env)
            assert b.import_prompt(h)
            return b.generate(PROMPT, 8, timeout=120)["tokens"]
        finally:
            a.stop()
            b.stop()

    jj = run(_jax, _jax, False)
    assert run(_jax, _port, True) == jj     # JAX envelope into the port
    assert run(_jax, _port, False) == jj    # JAX numpy payload, in process
    assert run(_port, _jax, True) == jj     # the port's envelope into JAX
    assert run(_port, _port, True) == jj


def test_int8_handoff_scales_ride(models):
    """Quantized handoff: codes and scales travel together, so the decode
    replica reads what a colocated replica admitting through the same
    dequantized prefix reads."""
    ref = _port(models, kv_dtype="int8")
    try:
        assert ref.prime_prefix(PROMPT[:-1])
        want = ref.generate(PROMPT, 8, timeout=120)["tokens"]
    finally:
        ref.stop()
    a = _port(models, role="prefill", kv_dtype="int8")
    b = _port(models, role="decode", kv_dtype="int8")
    try:
        h = a.export_prompt(PROMPT, timeout=120)
        k = h["payload"]["k"]
        assert isinstance(k, dict) and k["q"].dtype == torch.int8
        assert k["scale"].shape[:2] == k["q"].shape[:2]
        h = thandoff.unpack(json.loads(json.dumps(thandoff.pack(h))))
        assert b.import_prompt(h)
        assert b.generate(PROMPT, 8, timeout=120)["tokens"] == want
    finally:
        a.stop()
        b.stop()


def test_prefix_hit_prompt_shares_blocks_and_donor_survives(models):
    shared = list(range(5, 5 + 16))
    p1, p2 = shared + [201, 17, 11, 3], shared + [202, 19, 13, 7]
    ref = _port(models)
    try:
        w1 = ref.generate(p1, 8, timeout=120)["tokens"]
        w2 = ref.generate(p2, 8, timeout=120)["tokens"]
    finally:
        ref.stop()
    a, b = _port(models, role="prefill"), _port(models, role="decode")
    try:
        h1 = a.export_prompt(p1, timeout=120)
        assert b.import_prompt(h1)
        entry = b.prefix_cache._by_key[tuple(p1[:h1["prefix_len"]])]
        donor = entry.blocks
        refs = [b._alloc.ref_count(blk) for blk in donor]
        assert b.generate(p1, 8, timeout=120)["tokens"] == w1
        assert b.generate(p2, 8, timeout=120)["tokens"] == w2
        assert b.metrics()["kv_shared_blocks"] > 0
        assert entry.blocks == donor
        assert all(b._alloc.ref_count(blk) >= r
                   for blk, r in zip(donor, refs))
        assert all(not blks for blks in b._slot_blocks)
        with b._prefix_lock:
            while b.prefix_cache.evict_lru():
                pass
        assert b._alloc.blocks_in_use == 0
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------


def test_cold_export_leaks_nothing(models):
    a = _port(models, role="prefill", prefix_cache_slots=0)
    try:
        h = a.export_prompt(PROMPT, timeout=120)
        assert h["prefix_len"] == len(PROMPT) - 1
        assert a.metrics()["kv_blocks_in_use"] == 0
    finally:
        a.stop()


def test_import_rejects_mismatched_pool_and_refuses_without_a_cache(
        models):
    a = _port(models, role="prefill")
    b4 = _port(models, role="decode", kv_block_size=4)
    b8 = _port(models, role="decode", kv_dtype="int8")
    bare = _port(models, role="decode", prefix_cache_slots=0)
    try:
        h = a.export_prompt(PROMPT, timeout=120)
        with pytest.raises(ValueError):
            b4.import_prompt(h)
        with pytest.raises(ValueError):
            b8.import_prompt(h)
        with pytest.raises(ValueError):
            bare.import_prompt({**h, "prefix_len": 40})
        assert bare.import_prompt(h) is False
        # Degraded, never wrong: a plain submit prefills it itself.
        assert len(bare.generate(PROMPT, 4, timeout=120)["tokens"]) == 4
    finally:
        for d in (a, b4, b8, bare):
            d.stop()


def test_export_requires_paged_and_enough_tokens(models):
    dense = _port(models, kv_layout="dense", kv_block_size=16)
    paged = _port(models)
    try:
        with pytest.raises(ValueError):
            dense.export_prompt(PROMPT)
        with pytest.raises(ValueError):
            paged.export_prompt([7])
        with pytest.raises(ValueError, match="role"):
            _port(models, role="router")
        with pytest.raises(ValueError, match="paged"):
            _port(models, role="decode", kv_layout="dense")
    finally:
        dense.stop()
        paged.stop()


def test_serving_role_rides_the_exposition(models):
    ds = [_port(models, role="decode"), _port(models, role="prefill"),
          _port(models)]
    try:
        for d, role in zip(ds, ("decode", "prefill", "colocated")):
            assert f'serving_role{{role="{role}"}} 1' in d.registry.render()
        assert ds[0].metrics()["role"] == "decode"
    finally:
        for d in ds:
            d.stop()


# ---------------------------------------------------------------------------
# HTTP: :prefill, :import
# ---------------------------------------------------------------------------


def test_http_handoff_endpoints_round_trip(models):
    common = dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                  max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                  prefix_cache_slots=8, prefix_cache_min_len=8,
                  dtype="float32", device="cpu")
    servers = [ModelServer(EngineConfig(serving_role=role, **common),
                           port=0, params=models[4], batch_timeout_ms=2)
               for role in ("prefill", "decode", "")]
    pre, dec, ref = servers
    for s in servers:
        s.start()
    try:
        body = {"instances": [{"tokens": PROMPT, "max_new_tokens": 6}]}
        want = ref.handle_predict("lm-test-tiny", body)
        out = pre.handle_prefill("lm-test-tiny",
                                 {"instances": [{"tokens": PROMPT}]})
        assert out["handoff"] is False and "envelope" in out
        env = json.loads(json.dumps(out["envelope"]))
        assert dec.handle_import("lm-test-tiny", env)["imported"]
        got = dec.handle_predict("lm-test-tiny", body)
        assert got["predictions"][0]["tokens"] == \
            want["predictions"][0]["tokens"]
        # handoff_to pushes server to server, over HTTP.
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", pre.port, timeout=60)
        try:
            conn.request("POST", "/v1/models/lm-test-tiny:prefill",
                         body=json.dumps({
                             "instances": [{"tokens": [9] + PROMPT}],
                             "handoff_to": f"127.0.0.1:{dec.port}"}))
            resp = conn.getresponse()
            out2 = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 200 and out2["handoff"] is True
        assert dec.decoder.metrics()["kv_handoff_imports"] == 2
        # A dead destination degrades to False, never an error.
        assert pre.handle_prefill("lm-test-tiny", {
            "instances": [{"tokens": [8] + PROMPT}],
            "handoff_to": "127.0.0.1:1"})["handoff"] is False
        with pytest.raises(ValueError):
            dec.handle_import("lm-test-tiny", {"version": 7})
        with pytest.raises(KeyError):
            dec.handle_import("other", env)
    finally:
        for s in servers:
            s.stop()
