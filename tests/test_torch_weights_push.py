"""The port's live weight pushes against the JAX package's: the decoder's
swap (``update_weights``: a new epoch, stale K/V flushed or refused,
streams straddling the boundary, the draft model swapped with the
target), the chunked envelope (``serving/weights.py``, byte for byte
JAX's), pushes that cross frameworks in both directions over HTTP, the
``:pull`` route with a replica booting from its peers, and a replica
booting from a checkpoint the port's trainer wrote.

Both packages get the same weights (JAX inits of seeds 0 and 1, handed
across as numpy arrays) at ``dtype=float32`` on the CPU; greedy streams
equal a decoder cold-started on the pushed weights and JAX's.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving import weights as jweights  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402,E501
from kubeflow_tpu.serving.server import ModelServer as JaxServer  # noqa: E402,E501
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving import weights as tweights  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import flatten, params_from_numpy  # noqa: E402,E501

SPEC = get_model("lm-test-tiny", dtype=jnp.float32)
J1 = SPEC.init(jax.random.PRNGKey(0), SPEC.config)
J2 = SPEC.init(jax.random.PRNGKey(1), SPEC.config)
P1 = jax.tree.map(np.asarray, J1)
P2 = jax.tree.map(np.asarray, J2)
TCFG = ttransformer.config("lm-test-tiny", dtype=torch.float32)
GEN = 12
PROMPT = [3 + (j % 23) for j in range(12)]


def _kw(**kw):
    base = dict(slots=4, prefill_len=32, max_new_tokens=GEN,
                prefix_cache_slots=4, prefix_cache_min_len=6,
                kv_layout="paged", kv_block_size=4, stream_timeout_s=120.0)
    base.update(kw)
    return base


def mk(tree, **kw):
    return ContinuousDecoder(params_from_numpy(tree, TCFG, "cpu"), TCFG,
                             **_kw(**kw))


def gen_tokens(d, prompt=PROMPT, want=GEN):
    return d.generate(list(prompt), want, timeout=120)["tokens"]


def cold_tokens(tree, prompt=PROMPT, want=GEN, **kw):
    d = mk(tree, **kw)
    try:
        return gen_tokens(d, prompt, want)
    finally:
        d.stop()


def _jax_swap(**kw):
    """JAX's tokens before and after the same push (P1 -> P2)."""
    d = JaxDecoder(J1, SPEC.config, **_kw(**kw))
    try:
        pre = gen_tokens(d)
        assert d.update_weights(J2) == 1
        return pre, gen_tokens(d), d.metrics()
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# The swap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_swap_matches_jax_and_a_cold_start(kv_dtype):
    d = mk(P1, kv_dtype=kv_dtype)
    try:
        pre = gen_tokens(d)
        assert d.metrics()["weights_version"] == 0
        assert d.update_weights(P2) == 1
        m = d.metrics()
        post = gen_tokens(d)
        m2 = d.metrics()
    finally:
        d.stop()
    assert m["weights_version"] == 1 and m["weight_pushes"] == 1
    assert m["weight_swap_seconds_last"] >= 0
    assert post == cold_tokens(P2, kv_dtype=kv_dtype)
    assert pre != post
    jpre, jpost, jm = _jax_swap(kv_dtype=kv_dtype)
    assert (pre, post) == (jpre, jpost)
    for key in ("weights_version", "weight_pushes", "weights_stale_refused",
                "prefix_hits", "prefix_entries", "prefix_inserts"):
        assert m2[key] == jm[key], key
    assert 'serving_weight_pushes_total 1' in d.registry.render()
    assert 'serving_weights_version 1' in d.registry.render()


def test_stale_version_push_is_noop():
    d = mk(P1)
    try:
        assert d.update_weights(P2, version=5) == 5
        assert d.update_weights(P1, version=5) == 5
        assert d.update_weights(P1, version=3) == 5
        assert d.metrics()["weight_pushes"] == 1
        assert gen_tokens(d) == cold_tokens(P2)
    finally:
        d.stop()


def test_update_weights_validation():
    d = mk(P1)
    try:
        bad = jax.tree.map(lambda a: np.zeros((2, 2), np.float32), P1)
        with pytest.raises(ValueError):
            d.update_weights(bad)
        with pytest.raises(ValueError):
            d.update_weights({"not": "a matching tree"})
        assert d.metrics()["weights_version"] == 0
        assert gen_tokens(d) == cold_tokens(P1)
    finally:
        d.stop()


def test_stale_prefix_flushed_and_pinned_entry_refused():
    d = mk(P1)
    try:
        gen_tokens(d)  # publishes PROMPT under epoch 0
        with d._prefix_lock:
            entry = d.prefix_cache.entries()[0]
            entry.refs += 1  # an admission in flight pins it
        d.update_weights(P2)
        assert d.metrics()["prefix_entries"] == 1  # pinned: survived
        with d._prefix_lock:
            entry.refs -= 1
        before = d.metrics()
        post = gen_tokens(d)
        m = d.metrics()
        assert post == cold_tokens(P2)
        assert m["weights_stale_refused"] >= 1
        assert m["prefix_hits"] == before["prefix_hits"]
        assert all(e.version == 1 for e in d.prefix_cache.entries())
        # Unpinned stale entries go at the swap itself.
        d.update_weights(P1)
        assert d.metrics()["prefix_entries"] == 0
    finally:
        d.stop()


def test_host_tier_stale_never_promoted():
    d = mk(P1, host_kv_bytes=32 << 20)
    try:
        gen_tokens(d)
        with d._prefix_lock:
            while d.prefix_cache.evict_lru():
                pass
        assert d.metrics()["kv_host_tier_entries"] >= 1
        d.update_weights(P2)
        assert d.metrics()["kv_host_tier_entries"] == 0  # flushed
        assert gen_tokens(d) == cold_tokens(P2)
        assert d.metrics()["kv_host_hits"] == 0
    finally:
        d.stop()


def test_streams_straddle_swap_without_disruption():
    """A push of the same weights mid-decode: every straddling stream
    equals an undisturbed run."""
    d = mk(P1, max_new_tokens=24)
    results: dict[int, list] = {}

    def prompt(i):
        return PROMPT + [7 + i] * 3

    def one(i):
        results[i] = list(d.submit(prompt(i), 24).tokens(timeout=120))

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        deadline = time.perf_counter() + 10
        while (d.metrics()["in_flight"] < 1
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        d.update_weights(P1)
        for th in threads:
            th.join(timeout=120)
    finally:
        d.stop()
    assert sorted(results) == [0, 1, 2]
    for i in range(3):
        assert results[i] == cold_tokens(P1, prompt(i), 24,
                                         max_new_tokens=24), i


def test_straddling_stream_single_boundary_and_no_publish():
    d = mk(P1, slots=2, max_new_tokens=24)
    ref = cold_tokens(P1, PROMPT, 24, max_new_tokens=24)
    out: list[int] = []
    try:
        it = d.submit(list(PROMPT), 24).tokens(timeout=120)
        for _ in range(4):
            out.append(next(it))
        d.update_weights(P2)
        out += list(it)
    finally:
        d.stop()
    assert len(out) == 24 and out[:4] == ref[:4]
    assert all(e.version == 1 for e in d.prefix_cache.entries())


def test_chunked_chain_restarts_on_a_push():
    """A push landing mid-chain restarts the chunked admission under the
    new epoch: the stream equals a cold start on the new weights. (The
    push runs on the scheduler thread right after the chain's first
    interior chunk, so it lands mid-chain every time.)"""
    long = [5 + (j % 31) for j in range(40)]
    kw = dict(prefix_cache_slots=0, prefill_chunk_tokens=8,
              max_prompt_len=48, max_new_tokens=8)
    d = mk(P1, **kw)
    advance, pushed = d._advance_chunked, []

    def advance_then_push():
        advance()
        if not pushed and d._chunk_jobs and \
                d._chunk_jobs[0][0].chunk_pos >= 8:
            pushed.append(d.update_weights(P2))

    d._advance_chunked = advance_then_push
    try:
        h = d.submit(long, 8)
        out = h.result(timeout=120)["tokens"]
        events = [name for name, _t, _a in h._req.timeline.events()]
    finally:
        d.stop()
    assert pushed == [1]
    assert events.count("chunk_restart") == 1
    assert out == cold_tokens(P2, long, 8, **kw)


def test_draft_pairing_keeps_acceptance_high():
    d = mk(P1, slots=2, speculative_k=4, draft_mode="model:lm-test-tiny",
           max_new_tokens=24)
    try:
        assert d.update_weights(P2, draft_params=P2) == 1
        toks = gen_tokens(d, PROMPT, 24)
        m = d.metrics()
        assert toks == cold_tokens(P2, PROMPT, 24, max_new_tokens=24)
        assert m["spec_drafted_tokens"] > 0
        assert m["spec_acceptance_rate"] > 0.8, m["spec_acceptance_rate"]
    finally:
        d.stop()


def test_draft_params_without_proposer_rejected():
    d = mk(P1)
    try:
        with pytest.raises(ValueError):
            d.update_weights(P2, draft_params=P2)
        assert d.metrics()["weights_version"] == 0
    finally:
        d.stop()


def test_weights_snapshot_is_consistent():
    d = mk(P1)
    try:
        params, version = d.weights_snapshot()
        assert version == 0 and params is d.params
        d.update_weights(P2)
        params, version = d.weights_snapshot()
        assert version == 1
        np.testing.assert_array_equal(
            params["embed"]["kernel"].numpy(), P2["embed"]["kernel"])
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# The envelope
# ---------------------------------------------------------------------------


def test_envelope_matches_jax_and_round_trips():
    tchunks = tweights.pack_weights(P1, 3, chunk_bytes=1024)
    jchunks = jweights.pack_weights(J1, 3, chunk_bytes=1024)
    assert len(tchunks) > 1
    assert json.dumps(tchunks, sort_keys=True) == \
        json.dumps(jchunks, sort_keys=True)
    asm = tweights.WeightChunkAssembler()
    order = list(reversed(tchunks))
    done = None
    for env in [order[0]] + order:
        res = asm.add(tweights.unpack_chunk(json.loads(json.dumps(env))))
        if res is not None:
            assert done is None
            done = res
    leaves, has_draft = done
    assert not has_draft
    model_leaves, draft_leaves = tweights.split_namespaces(leaves)
    assert not draft_leaves
    rebuilt = tweights.unflatten_params(model_leaves, P1)
    for path, arr in flatten(P1).items():
        np.testing.assert_array_equal(flatten(rebuilt)[path].numpy(), arr)


def test_assembler_and_unflatten_refusals():
    asm = tweights.WeightChunkAssembler()
    old = tweights.pack_weights(P1, 1, chunk_bytes=1024)
    new = tweights.pack_weights(P2, 2, chunk_bytes=1024)
    assert asm.add(tweights.unpack_chunk(old[0])) is None
    for env in new:
        res = asm.add(tweights.unpack_chunk(env))
    assert res is not None
    asm.add(tweights.unpack_chunk(
        tweights.pack_weights(P2, 5, chunk_bytes=1024)[0]))
    with pytest.raises(ValueError):
        asm.add(tweights.unpack_chunk(old[0]))
    leaves = tweights.flatten_params(P1)
    with pytest.raises(ValueError):
        tweights.unflatten_params(dict(list(leaves.items())[:-1]), P1)
    with pytest.raises(ValueError):
        tweights.unflatten_params({**leaves, "bogus/leaf": leaves[
            "final_norm"]}, P1)
    for bad in ({"version": 99},
                {"version": 1, "weights_version": 1, "seq": 2, "chunks": 2,
                 "leaves": {}},
                {"version": 1, "weights_version": 1, "seq": 0, "chunks": 1,
                 "leaves": "nope"}):
        with pytest.raises(ValueError):
            tweights.unpack_chunk(bad)


def test_bf16_leaves_round_trip_without_ml_dtypes():
    """In a process that imports neither JAX nor ml_dtypes: bf16 leaves
    pack as their 16-bit pattern under "bfloat16" and unpack bit for
    bit."""
    code = (
        "import json, sys, torch\n"
        "from kubeflow_tpu_torch.serving import weights as w\n"
        "g = torch.Generator().manual_seed(0)\n"
        "t = torch.randn(5, 7, generator=g).to(torch.bfloat16)\n"
        "t[0, :3] = torch.tensor([float('inf'), float('-inf'), -0.0])\n"
        "env = json.loads(json.dumps(w.pack_weights({'a': {'b': t}}, 1)[0]))\n"
        "leaf = w.unpack_chunk(env)['leaves']['m/a/b']\n"
        "assert env['leaves']['m/a/b']['dtype'] == 'bfloat16'\n"
        "assert leaf.dtype == torch.bfloat16\n"
        "assert torch.equal(leaf.view(torch.int16), t.view(torch.int16))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('ml_dtypes', 'jax', 'kubeflow_tpu')]\n"
        "assert not bad, bad\n")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# HTTP: pushes across frameworks, :pull, the boot chain
# ---------------------------------------------------------------------------


def _cfg(**kw):
    return dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                max_new_tokens=GEN, kv_layout="paged", kv_block_size=4,
                dtype="float32", **kw)


def _port_server(**kw):
    server = ModelServer(EngineConfig(**_cfg(device="cpu", **kw)), port=0,
                         params=None if "weight_peers" in kw
                         or "checkpoint_dir" in kw else P1,
                         batch_timeout_ms=2)
    server.start()
    return server


def _predict(server):
    return server.handle_predict("lm-test-tiny", {"instances": [
        {"tokens": PROMPT, "max_new_tokens": GEN}]})["predictions"][0][
        "tokens"]


def test_http_push_both_directions():
    """A push JAX packs installs into a port server, which then answers
    as the JAX server does after the same push; a push the port packs
    installs into a JAX server the same way. Stale re-pushes install
    nothing; garbage is a 400."""
    port = _port_server()
    jserver = JaxServer(JaxEngineConfig(**_cfg()), port=0, grpc_port=None,
                        batch_timeout_ms=2)
    jserver.start()
    try:
        assert _predict(port) == _predict(jserver) == cold_tokens(P1)
        out = jweights.push_weights(f"127.0.0.1:{port.port}",
                                    "lm-test-tiny", J2, 1, chunk_bytes=4096)
        assert out == {"installed": True, "weights_version": 1}
        out = tweights.push_weights(f"127.0.0.1:{jserver.port}",
                                    "lm-test-tiny", P2, 1, chunk_bytes=4096)
        assert out == {"installed": True, "weights_version": 1}
        assert _predict(port) == _predict(jserver) == cold_tokens(P2)
        # The port's own push, its own server: a stale epoch is a no-op.
        out = tweights.push_weights(f"127.0.0.1:{port.port}",
                                    "lm-test-tiny", port.decoder.params, 1,
                                    chunk_bytes=4096)
        assert out["weights_version"] == 1
        assert port.decoder.metrics()["weight_pushes"] == 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{port.port}/v1/models/lm-test-tiny:weights",
            data=json.dumps({"version": 42}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400
    finally:
        port.stop()
        jserver.stop()


def test_peer_boot_pulls_the_donors_epoch():
    """A replica booting with weight_peers pulls a live donor's weights
    over :pull, at the donor's epoch; a dead donor first in the list is
    skipped. JAX boots from the port's donor the same way."""
    donor = _port_server()
    try:
        tweights.push_weights(f"127.0.0.1:{donor.port}", "lm-test-tiny",
                              P2, 4, chunk_bytes=4096)
        newborn = _port_server(
            weight_peers=f"127.0.0.1:1,127.0.0.1:{donor.port}",
            weight_pull_timeout_s=5.0)
        try:
            assert newborn.engine.weight_pull_source == "peer"
            assert newborn.engine.boot_weights_version == 4
            assert newborn.decoder.metrics()["weights_version"] == 4
            assert _predict(newborn) == cold_tokens(P2)
            assert 'serving_weight_pulls_total{source="peer"} 1' in \
                newborn.render_metrics()
        finally:
            newborn.stop()
        jnew = JaxServer(JaxEngineConfig(**_cfg(
            weight_peers=f"127.0.0.1:{donor.port}")), port=0,
            grpc_port=None, batch_timeout_ms=2)
        jnew.start()
        try:
            assert jnew.engine.weight_pull_source == "peer"
            assert _predict(jnew) == cold_tokens(P2)
        finally:
            jnew.stop()
        with pytest.raises(KeyError):
            donor.handle_weights_pull("lm-test-tiny", {"seq": 99})
    finally:
        donor.stop()


def test_checkpoint_boot_from_the_ports_trainer(tmp_path):
    """A replica booting from --model-path: the newest step the port's
    trainer wrote gives its weights, and it answers as a server given
    those parameters."""
    from kubeflow_tpu_torch.train.loop import RunConfig, run

    ckpt = str(tmp_path / "ckpt")
    run(RunConfig(model="lm-test-tiny", batch_size=2, seq_len=16, steps=2,
                  device="cpu", checkpoint_dir=ckpt), log=lambda *a: None)
    step_dir = Path(ckpt) / "2"
    assert step_dir.is_dir()
    tree = {}
    for path in flatten(P1):
        tree[path] = np.load(step_dir / "params" / (path + ".npy"))
    server = _port_server(checkpoint_dir=ckpt)
    try:
        assert server.engine.weight_pull_source == "checkpoint"
        for path, leaf in flatten(server.engine.params).items():
            np.testing.assert_array_equal(leaf.numpy(), tree[path])
        restored = _predict(server)
    finally:
        server.stop()
    nested: dict = {}
    for path, arr in tree.items():
        node = nested
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr
    assert restored == cold_tokens(nested)
    assert os.listdir(ckpt)
