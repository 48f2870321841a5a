"""The port's fleet KV economy against the JAX package's: the
prefix->holder directory, the content-addressed cold store (its content
key, blobs that unpack in either package), ``export_prefix`` and its
envelope, and the decoder's fleet miss path (trie -> host -> peer -> cold
-> prefill) with its churn contracts:

- a holder dying mid-import falls through to the cold tier or a plain
  prefill, counted, never a hang, never wrong bytes;
- a weight push landing mid-pull makes the envelope stale, and it is
  refused (``kv_import_stale_refused``), never installed;
- the crossover skips pulls that would not save enough prefill;
- host-tier evictions demote into the cold store, and every tier drains
  with no leaked block.

Each scenario runs on decoders of both packages with the same weights
(the JAX init, handed across as numpy arrays) at ``dtype=float32`` on the
CPU: streams equal a plain decoder's, and the economy's counters equal
JAX's. The ``:kv`` route pulls across frameworks in both directions.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving import cold_store as jcold  # noqa: E402
from kubeflow_tpu.serving import fleet as jfleet  # noqa: E402
from kubeflow_tpu.serving import handoff as jhandoff  # noqa: E402
from kubeflow_tpu.serving import kv_directory as jdir  # noqa: E402
from kubeflow_tpu.serving import remote_fleet as jremote  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402,E501
from kubeflow_tpu.serving.server import ModelServer as JaxServer  # noqa: E402,E501
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving import cold_store as tcold  # noqa: E402
from kubeflow_tpu_torch.serving import fleet as tfleet  # noqa: E402
from kubeflow_tpu_torch.serving import handoff as thandoff  # noqa: E402
from kubeflow_tpu_torch.serving import kv_directory as tdir  # noqa: E402
from kubeflow_tpu_torch.serving import remote_fleet as tremote  # noqa: E402
from kubeflow_tpu_torch.serving.affinity import prefix_affinity_key  # noqa: E402,E501
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

SPEC = get_model("lm-test-tiny", dtype=jnp.float32)
J1 = SPEC.init(jax.random.PRNGKey(0), SPEC.config)
P1 = jax.tree.map(np.asarray, J1)
TCFG = ttransformer.config("lm-test-tiny", dtype=torch.float32)
T1 = params_from_numpy(P1, TCFG, "cpu")

AFFINITY = 16
# A prompt family sharing the affinity window (the first 16 token ids).
BASE = [(3 * j) % 89 + 2 for j in range(20)]
P_1 = BASE + [40]
P_2 = BASE + [51, 52, 53]
OTHER = [[(7 * j + k) % 97 + 100 for j in range(21)] for k in (1, 2)]
TOL = 1e-5

FW = {
    "torch": SimpleNamespace(
        Decoder=ContinuousDecoder, params=T1, cfg=TCFG, Directory=tdir,
        Cold=tcold, Fleet=tfleet, new_params=lambda: T1),
    "jax": SimpleNamespace(
        Decoder=JaxDecoder, params=J1, cfg=SPEC.config, Directory=jdir,
        Cold=jcold, Fleet=jfleet, new_params=lambda: J1),
}
ECON = ("kv_peer_hits", "kv_peer_misses", "kv_peer_import_bytes",
        "kv_peer_fetch_failures", "kv_cold_hits", "kv_cold_demotions",
        "kv_cold_import_bytes", "kv_import_stale_refused",
        "kv_import_skipped_crossover", "kv_directory_publishes",
        "prefill_tokens", "prefix_hits", "kv_handoff_exports",
        "kv_host_demotions", "kv_host_evictions", "kv_blocks_in_use")


def _kw(**kw):
    base = dict(slots=4, prefill_len=32, max_new_tokens=8,
                kv_layout="paged", kv_block_size=8, prefix_cache_slots=4,
                prefix_cache_min_len=4, stream_timeout_s=120.0)
    base.update(kw)
    return base


def _economy(fw, name, directory, cold=None, fetch=None, **kw):
    return fw.Decoder(fw.params, fw.cfg, kv_directory=directory,
                      cold_store=cold, peer_fetch=fetch,
                      kv_affinity_tokens=AFFINITY, replica_name=name,
                      **_kw(**kw))


def _plain_tokens(prompt, want=6):
    d = ContinuousDecoder(T1, TCFG, **_kw())
    try:
        return d.generate(prompt, want, timeout=120)["tokens"]
    finally:
        d.stop()


def _econ(d) -> dict:
    m = d.metrics()
    return {k: m[k] for k in ECON}


# ---------------------------------------------------------------------------
# The directory and the cold store against JAX's classes
# ---------------------------------------------------------------------------


def _directory_script(mod):
    d = mod.KvDirectory(capacity=3)
    out = []
    d.publish("k", "a", prefix_len=8, version=1, tier="hbm")
    d.publish("k", "a", prefix_len=4, version=1, tier="host")
    out.append(d.lookup("k"))
    d.publish("k", "a", prefix_len=2, version=2, tier="hbm")
    out += [d.lookup("k"), d.lookup("k", version=1)]
    d.publish("k", "b", prefix_len=16, version=2)
    d.publish("k", mod.COLD_HOLDER, prefix_len=24, version=2, tier="cold")
    out += [d.lookup("k"), d.lookup("k", exclude=("b", mod.COLD_HOLDER)),
            d.holders("k"), d.holders("k", warm_only=False)]
    d.withdraw("k", "b")
    d.withdraw("k", "zz")
    d.publish("k2", "a", prefix_len=4, version=1)
    d.drop_holder("a")
    out += [d.holders("k"), d.holders("k2"), len(d)]
    for i in range(5):
        d.publish(f"e{i}", "c", prefix_len=i, version=1)
    d.lookup("e2")
    d.publish("e9", "c", prefix_len=1, version=1)
    out += [len(d), d.lookup("e2"), d.lookup("e3"), d.stats()]
    d.publish("e9", "", prefix_len=1, version=1)
    out.append(d.stats())
    with pytest.raises(ValueError):
        mod.KvDirectory(capacity=0)
    return [[(h.holder, h.prefix_len, h.version, h.tier) for h in o]
            if isinstance(o, list) and o and not isinstance(o[0], str)
            else o for o in out]


def test_directory_contracts_equal_jax():
    """Same-epoch publishes deepen, an epoch change replaces, lookups go
    deepest first with filters, withdraw, drop_holder and the key LRU:
    every answer and stat equals JAX's directory's on the same script."""
    assert tdir.COLD_HOLDER == jdir.COLD_HOLDER
    assert _directory_script(tdir) == _directory_script(jdir)


def _fake_handoff(tokens, *, fill=0.0):
    shape = (2, 1, 8, 2, 4)
    return {"tokens": list(tokens), "prefix_len": len(tokens),
            "block_size": 8, "kv_dtype": "fp", "tp_shards": 1,
            "cp_shards": 1, "pp_stages": 1,
            "payload": {"k": np.full(shape, fill, np.float32),
                        "v": np.full(shape, fill + 1, np.float32)}}


@pytest.mark.parametrize("version", [0, 1, 7, -3])
def test_content_key_equals_jax(version):
    for toks in ([], [1], list(range(40)), [255, 0, 2 ** 40]):
        assert tcold.content_key(toks, version) == \
            jcold.content_key(toks, version)


def _cold_script(mod, capacity):
    s = mod.ColdKvStore(capacity)
    out = [s.put(_fake_handoff([1, 2, 3]), version=7),
           s.put(_fake_handoff([1, 2, 3]), version=7),
           s.put(_fake_handoff([4, 5, 6], fill=2), version=7),
           s.put(_fake_handoff([7, 8, 9, 10], fill=3), version=7),
           s.put(_fake_handoff(list(range(1, 9))), version=1)]
    out += [s.peek_depth([1, 2, 3, 4, 5], 1), s.peek_depth([1, 2, 3, 0], 7),
            s.peek_depth([7, 8, 9, 10, 11], 2)]
    for probe, ver in (([1, 2, 3, 0], 7), ([7, 8, 9, 10, 11], 7),
                       (list(range(1, 12)), 1), ([1, 2], 2)):
        got = s.match(probe, ver)
        out.append(None if got is None else
                   (got[1], got[0]["tokens"], got[0]["prefix_len"],
                    np.asarray(got[0]["payload"]["v"]).tolist()))
    out += [len(s), s.stats()]
    return out


@pytest.mark.parametrize("capacity", [1 << 20, 3000, 2000, 100])
def test_cold_store_contracts_equal_jax(capacity):
    """Dedup by content, byte-bounded LRU, interior matches capped one
    token short, epochs kept apart, refusals: the keys, matches and stats
    equal JAX's store's on the same puts (the blobs are the same bytes)."""
    assert _cold_script(tcold, capacity) == _cold_script(jcold, capacity)


def test_cold_blobs_unpack_across_frameworks():
    """A blob either store holds is the other's: the port's unpacks in
    JAX and JAX's in the port, bf16 bit for bit."""
    h = _fake_handoff([5, 6, 7])
    h["payload"] = {"k": torch.randn(2, 1, 8, 2, 4).to(torch.bfloat16),
                    "v": torch.randn(2, 1, 8, 2, 4).to(torch.bfloat16)}
    ts, js = tcold.ColdKvStore(1 << 20), jcold.ColdKvStore(1 << 20)
    key = ts.put(h, version=3)
    jh = jhandoff.unpack(json.loads(ts._blobs[key].blob))
    assert js.put(jh, version=3) == key
    assert js._blobs[key].blob == ts._blobs[key].blob
    back, depth = ts.match([5, 6, 7, 8], 3)
    assert depth == 3
    for side in ("k", "v"):
        assert torch.equal(back["payload"][side].view(torch.int16),
                           h["payload"][side].view(torch.int16))
        assert np.asarray(jh["payload"][side]).view(np.int16).tobytes() \
            == h["payload"][side].view(torch.int16).numpy().tobytes()


def test_cold_store_ref_registry():
    a = tcold.cold_store_from_ref("mem://t-torch-econ-reg?bytes=4096")
    b = tcold.cold_store_from_ref("mem://t-torch-econ-reg?bytes=9999")
    assert a is b and a.capacity_bytes == 4096
    assert tcold.cold_store_from_ref("") is None
    assert tcold.cold_store_from_ref("mem://t-torch-econ-dflt") \
        .capacity_bytes == 64 << 20
    for bad in ("s3://bucket/kv", "mem://"):
        with pytest.raises(ValueError):
            tcold.cold_store_from_ref(bad)
    # The port's registry is its own: JAX's name space is untouched.
    assert jcold.cold_store_from_ref("mem://t-torch-econ-reg") is not a


# ---------------------------------------------------------------------------
# export_prefix and its envelope
# ---------------------------------------------------------------------------


def test_export_prefix_envelope_matches_jax():
    """The same cached prompt exported by both packages: the same tokens,
    depth and epoch, payloads within f32 rounding; for one payload both
    packers write the same envelope, and each side unpacks the other's
    bit for bit. A miss is a KeyError on both."""
    hs = []
    for fw in (FW["torch"], FW["jax"]):
        d = _economy(fw, "a", fw.Directory.KvDirectory())
        try:
            with pytest.raises(KeyError):
                d.export_prefix(P_2)
            d.generate(P_1, 4, timeout=120)
            hs.append(d.export_prefix(P_2))
            assert d.metrics()["kv_handoff_exports"] == 1
        finally:
            d.stop()
    th, jh = hs
    for k in ("tokens", "prefix_len", "weights_version", "block_size",
              "kv_dtype"):
        assert th[k] == jh[k], k
    assert th["prefix_len"] == len(BASE)
    for side in ("k", "v"):
        np.testing.assert_allclose(th["payload"][side].numpy(),
                                   np.asarray(jh["payload"][side]),
                                   rtol=0, atol=TOL)
    th.pop("weights_version")
    env = thandoff.pack(th)
    jenv = jhandoff.pack({**th, "payload": {
        s: th["payload"][s].numpy() for s in ("k", "v")}})
    assert json.dumps(env) == json.dumps(jenv)
    back = thandoff.unpack(json.loads(json.dumps(jenv)))
    jback = jhandoff.unpack(json.loads(json.dumps(env)))
    for side in ("k", "v"):
        assert back["payload"][side].numpy().tobytes() == \
            np.asarray(jback["payload"][side]).tobytes()


# ---------------------------------------------------------------------------
# The fleet miss path, both packages, the same call sequence
# ---------------------------------------------------------------------------


def _peer_hit(fw):
    directory = fw.Directory.KvDirectory()
    a = _economy(fw, "a", directory)
    b = _economy(fw, "b", directory)
    fleet = fw.Fleet.DecoderFleet({"a": a, "b": b}, affinity_tokens=AFFINITY)
    try:
        a.generate(P_1, 6, timeout=120)
        assert directory.holders(prefix_affinity_key(P_1, AFFINITY))
        got = b.generate(P_2, 6, timeout=120)["tokens"]
        held = b.metrics()["kv_blocks_in_use"]
        again = b.generate(P_2, 6, timeout=120)["tokens"]
        assert b.metrics()["kv_blocks_in_use"] == held
        return [got, again], _econ(a), _econ(b), directory.stats()
    finally:
        fleet.stop()


def _dying_holder(fw):
    directory = fw.Directory.KvDirectory()
    a = _economy(fw, "a", directory)
    b = _economy(fw, "b", directory)
    fleet = fw.Fleet.DecoderFleet({"a": a, "b": b}, affinity_tokens=AFFINITY)
    inner = fleet._peer_fetch

    def dying_fetch(holder, tokens, version):
        fleet.mark_dead(holder)  # the death lands mid-import
        return inner(holder, tokens, version)

    b._peer_fetch = dying_fetch
    try:
        a.generate(P_1, 6, timeout=120)
        got = b.generate(P_2, 6, timeout=120)["tokens"]
        assert "a" not in directory.holders(
            prefix_affinity_key(P_2, AFFINITY))
        return [got], _econ(b), directory.stats()
    finally:
        fleet.stop()


def _cold_fallback(fw):
    """The peer is gone, but its prefix was parked in the cold store: the
    miss falls past the dead peer into the cold tier."""
    directory = fw.Directory.KvDirectory()
    cold = fw.Cold.ColdKvStore(8 << 20)
    a = _economy(fw, "a", directory, cold=cold)
    b = _economy(fw, "b", directory, cold=cold,
                 fetch=lambda *_args: None)
    try:
        a.generate(P_1, 6, timeout=120)
        h = a.export_prefix(P_2)
        ver = h.pop("weights_version")
        assert cold.put(h, version=ver) is not None
        got = b.generate(P_2, 6, timeout=120)["tokens"]
        return [got], _econ(b), cold.stats()
    finally:
        a.stop()
        b.stop()


def _stale_epoch(fw):
    directory = fw.Directory.KvDirectory()
    a = _economy(fw, "a", directory)
    b = _economy(fw, "b", directory)
    fleet = fw.Fleet.DecoderFleet({"a": a, "b": b}, affinity_tokens=AFFINITY)
    inner = fleet._peer_fetch

    def racing_fetch(holder, tokens, version):
        got = inner(holder, tokens, version)
        # The push lands after the fetch and before the install: the same
        # weights under a new epoch, so streams stay comparable while the
        # envelope's stamp goes stale.
        b.update_weights(fw.new_params())
        return got

    b._peer_fetch = racing_fetch
    try:
        a.generate(P_1, 6, timeout=120)
        got = b.generate(P_2, 6, timeout=120)["tokens"]
        return [got], _econ(b)
    finally:
        fleet.stop()


def _crossover(fw):
    directory = fw.Directory.KvDirectory()
    calls = []
    a = _economy(fw, "a", directory, prefill_len=64)
    b = _economy(fw, "b", directory, kv_import_crossover_tokens=30,
                 fetch=lambda *args: calls.append(args), prefill_len=64)
    try:
        a.generate(P_1, 6, timeout=120)
        b.generate(P_2 + list(range(200, 212)), 6, timeout=120)
        assert calls == []
        return _econ(b)
    finally:
        a.stop()
        b.stop()


def _demotion_chain(fw):
    """HBM -> host -> COLD: a one-entry trie demotes each evicted prefix
    to a host tier that holds one payload, whose eviction packs the older
    one into the cold store; a second replica then misses its peer (the
    holder evicted it) and imports from cold."""
    directory = fw.Directory.KvDirectory()
    cold = fw.Cold.ColdKvStore(8 << 20)
    a = _economy(fw, "a", directory, cold=cold, prefix_cache_slots=1,
                 host_kv_bytes=16000)
    b = _economy(fw, "b", directory, cold=cold)
    fleet = fw.Fleet.DecoderFleet({"a": a, "b": b}, affinity_tokens=AFFINITY)
    try:
        for p in [P_1] + OTHER:
            a.generate(p, 4, timeout=120)
        got = b.generate(P_2, 6, timeout=120)["tokens"]
        for d in (a, b):
            with d._prefix_lock:
                while d.prefix_cache.evict_lru():
                    pass
        return [got], _econ(a), _econ(b), cold.stats()
    finally:
        fleet.stop()


SCENARIOS = {"peer_hit": _peer_hit, "holder_dies_mid_import": _dying_holder,
             "cold_fallback": _cold_fallback, "stale_epoch": _stale_epoch,
             "crossover": _crossover, "demotion_chain": _demotion_chain}


@pytest.fixture(scope="module")
def plain_p2():
    return _plain_tokens(P_2)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_miss_path_equals_jax(name, plain_p2):
    """The same call sequence on both packages' decoders: the economy's
    counters (and the directory's or cold store's stats) equal JAX's, and
    every stream equals a plain decoder's."""
    got = SCENARIOS[name](FW["torch"])
    ref = SCENARIOS[name](FW["jax"])
    assert got == ref
    if isinstance(got, tuple) and isinstance(got[0], list):
        assert all(s == plain_p2 for s in got[0])
    if name == "peer_hit":
        assert got[2]["kv_peer_hits"] == 1
        assert got[2]["prefill_tokens"] < len(P_2)  # the tail only
        assert got[1]["kv_handoff_exports"] == 1
    elif name == "holder_dies_mid_import":
        assert got[1]["kv_peer_fetch_failures"] == 1
        assert got[1]["kv_peer_hits"] == 0
    elif name == "cold_fallback":
        assert got[1]["kv_cold_hits"] == 1
        assert got[1]["kv_peer_fetch_failures"] == 1
    elif name == "stale_epoch":
        assert got[1]["kv_import_stale_refused"] == 1
        assert got[1]["kv_peer_hits"] == 0
    elif name == "crossover":
        assert got["kv_import_skipped_crossover"] == 1
    else:
        a, b = got[1], got[2]
        assert a["kv_cold_demotions"] >= 1 and b["kv_cold_hits"] == 1
        assert a["kv_blocks_in_use"] == b["kv_blocks_in_use"] == 0


def test_economy_refusals_and_metrics_surface():
    """The dense layout refuses the economy, as JAX's decoder does; with
    a directory and a cold store the metrics carry every key JAX's do,
    the economy's counters and the shared tiers' gauges live."""
    keys = []
    for fw in (FW["torch"], FW["jax"]):
        directory = fw.Directory.KvDirectory()
        with pytest.raises(ValueError, match="paged"):
            fw.Decoder(fw.params, fw.cfg, slots=2, prefill_len=32,
                       max_new_tokens=8, kv_directory=directory,
                       replica_name="a")
        a = _economy(fw, "a", directory, cold=fw.Cold.ColdKvStore(1 << 20))
        try:
            a.generate(P_1, 4, timeout=120)
            m = a.metrics()
            keys.append(set(m))
            assert m["kv_directory_publishes"] == 1
            assert m["kv_directory_keys"] == 1 and m["warming"] is False
            assert m["kv_cold_store_bytes_total"] == 1 << 20
        finally:
            a.stop()
    assert keys[1] <= keys[0]


# ---------------------------------------------------------------------------
# The :kv route across frameworks
# ---------------------------------------------------------------------------


def _server_cfg(**kw):
    return dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                prefix_cache_slots=4, prefix_cache_min_len=4,
                kv_directory_size=64, dtype="float32", **kw)


def _pull_into(fw, remote_mod, target: str):
    """A decoder of ``fw`` whose peer transport is ``remote_mod``'s
    ``fetch_kv``, with a hint naming ``target`` as P_1's holder."""
    directory = fw.Directory.KvDirectory()
    directory.publish(prefix_affinity_key(P_1, AFFINITY), target,
                      prefix_len=len(P_1), version=0)
    remote = remote_mod.RemoteActorFleet([target], "lm-test-tiny",
                                         timeout=30.0)
    d = _economy(fw, "requester", directory, fetch=remote.fetch_kv)
    try:
        got = d.generate(P_2, 6, timeout=120)["tokens"]
        return got, _econ(d)
    finally:
        d.stop()


def test_kv_route_pulls_across_frameworks(plain_p2):
    """Port server <- JAX fetcher and JAX server <- port fetcher: the
    peer hit imports over ``:kv`` and the stream equals a plain decoder's;
    a prefix the server does not hold answers 404 (the fetch returns
    None). The port server names itself ``<model>:<port>``."""
    port = ModelServer(EngineConfig(**_server_cfg(device="cpu")), port=0,
                       params=P1, batch_timeout_ms=2)
    jserver = JaxServer(JaxEngineConfig(**_server_cfg()), port=0,
                        grpc_port=None, batch_timeout_ms=2)
    port.start()
    jserver.start()
    try:
        assert port.decoder.replica_name == f"lm-test-tiny:{port.port}"
        for server in (port, jserver):
            server.handle_predict("lm-test-tiny", {"instances": [
                {"tokens": P_1, "max_new_tokens": 4}]})
        tp, jp = f"127.0.0.1:{port.port}", f"127.0.0.1:{jserver.port}"
        assert tremote.RemoteActorFleet([tp], "lm-test-tiny").fetch_kv(
            tp, OTHER[0]) is None
        got_j, econ_j = _pull_into(FW["jax"], jremote, tp)
        got_t, econ_t = _pull_into(FW["torch"], tremote, jp)
        assert got_j == got_t == plain_p2
        assert econ_j == econ_t and econ_t["kv_peer_hits"] == 1
        assert port.decoder.metrics()["kv_handoff_exports"] == 1
        with pytest.raises(KeyError):
            port.handle_kv("other", {"tokens": P_1})
        with pytest.raises(ValueError):
            port.handle_kv("lm-test-tiny", {"tokens": []})
    finally:
        port.stop()
        jserver.stop()


@pytest.mark.parametrize("extra", [
    ["--kv-directory-size", "8"], ["--cold-store-ref", "mem://x"],
    ["--kv-layout", "paged", "--cold-store-ref", "s3://bucket/kv"],
    ["--kv-layout", "paged", "--kv-directory-size", "-1"],
    ["--kv-layout", "paged", "--kv-import-crossover-tokens", "-2"]],
    ids=["dense_directory", "dense_cold", "bad_ref", "neg_size",
         "neg_crossover"])
def test_cli_economy_flags_refused_as_jax(extra, capsys):
    """The economy's flags are ported: they exit 2 where JAX's CLI does
    (the dense layout, a bad store ref, negative sizes) and name the
    flag."""
    from kubeflow_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--model-name", "lm-test-tiny", "--grpc-port", "-1", *extra])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" not in err and extra[-2] in err
