"""The port's BERT encoder against the JAX package's, on the CPU.

``apply`` (sequence output and pooled), ``mlm_logits``, the MLM loss and
its gradients, remat, a train step, the synthetic batches, the leaves'
stored dtypes, padding isolation and the served plain predict (REST and
the CLI), on ``bert-test-tiny`` with the same weights (the JAX init handed
across as numpy arrays).

Tolerances: float32 on both sides with sums in another order. Forward
outputs within 1e-5 of their largest magnitude; losses 1e-5 relative;
gradients 1e-4 of each leaf's largest JAX element (leaves whose JAX
gradient is zero, or zero up to rounding, against the largest of all);
parameters after a step 1e-4 relative and 1e-6 absolute. Synthetic
batches are equal bit for bit.
"""

import http.client
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

from kubeflow_tpu.models import bert as jbert  # noqa: E402
from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.serving.engine import _predict_impl  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import bert as tbert  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import loop as tloop  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train import trainer as ttrainer  # noqa: E402

NAME = "bert-test-tiny"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    jm = jregistry.get_model(NAME, dtype=jnp.float32)
    tm = tregistry.get_model(NAME, dtype=torch.float32)
    jparams = jm.init(jax.random.PRNGKey(0), jm.config)
    tree = jax.tree.map(np.asarray, jparams)
    return jm, tm, jparams, tree, weights.params_from_numpy(tree, tm, "cpu")


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= rel * np.abs(ref).max()


def _inputs():
    """Three rows of 20: one whole, one padded after 12, one all pad."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.float32)
    mask[1, 12:] = 0
    mask[2] = 0
    return tokens, mask


def test_apply_pooled_and_mlm_logits_match_jax(models):
    jm, tm, jparams, _, params = models
    tokens, mask = _inputs()
    jseq, jpooled = jbert.apply(jparams, jnp.asarray(tokens), jm.config,
                                pad_mask=jnp.asarray(mask))
    with torch.no_grad():
        seq, pooled = tbert.apply(params, torch.from_numpy(tokens),
                                  tm.config, pad_mask=torch.from_numpy(mask))
        logits = tbert.mlm_logits(params, seq, tm.config)
    assert seq.dtype == torch.float32 and pooled.shape == (3, 64)
    _close(seq.numpy(), jseq)
    _close(pooled.numpy(), jpooled)
    _close(logits.numpy(), jbert.mlm_logits(jparams, jseq, jm.config))
    # Without a mask JAX attends every key, and so does the port.
    jseq, _ = jbert.apply(jparams, jnp.asarray(tokens), jm.config)
    with torch.no_grad():
        seq, _ = tbert.apply(params, torch.from_numpy(tokens), tm.config)
    _close(seq.numpy(), jseq)


def test_padding_cannot_change_a_real_row(models):
    """A row's real positions give the same output whatever padding
    follows them (pad keys are masked; pad queries attend real keys)."""
    _, tm, _, _, params = models
    tokens, _ = _inputs()
    short = torch.from_numpy(tokens[:1, :12])
    padded = torch.from_numpy(np.concatenate(
        [tokens[:1, :12], np.full((1, 20), 7, np.int32)], axis=1))
    mask = torch.zeros(1, 32)
    mask[0, :12] = 1
    with torch.no_grad():
        a, pa = tbert.apply(params, short, tm.config)
        b, pb = tbert.apply(params, padded, tm.config, pad_mask=mask)
    torch.testing.assert_close(b[:, :12], a, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pb, pa, rtol=1e-5, atol=1e-5)


def _grads(tm, params, batch):
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in weights.flatten(params).items()}
    loss, met = tm.loss_fn(weights._unflatten(leaves),
                           tdata.place_batch(batch, CPU), tm.config)
    loss.backward()
    return loss, met, {k: p.grad for k, p in leaves.items()}


def test_loss_and_grads_match_jax(models):
    """The MLM loss; the pooler and NSP head get no gradient from it (JAX
    gives them zeros)."""
    jm, tm, jparams, tree, _ = models
    params = weights.params_from_numpy(tree, tm, "cpu", dtype=torch.float32)
    batch = tdata.synthetic_batch(tm, 2, 16, seed=1)
    batch["pad_mask"] = np.ones((2, 16), np.float32)
    batch["pad_mask"][1, 10:] = 0
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                             jm.config), has_aux=True)(jparams)
    loss, met, grads = _grads(tm, params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["tokens"].item(), float(jmet["tokens"]))
    jflat = weights.flatten(jax.tree.map(np.asarray, jgrads))
    largest = max(np.abs(g).max() for g in jflat.values())
    for path, ref in jflat.items():
        got = grads[path]
        if path.startswith(("pooler", "nsp")):
            assert got is None and not ref.any(), path
            continue
        # bk's gradient is zero up to rounding: softmax is blind to a
        # shift of every key by q·bk.
        scale = max(np.abs(ref).max(), 1e-3 * largest)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * scale, path


def test_remat_equals_no_remat(models):
    _, tm, _, tree, _ = models
    params = weights.params_from_numpy(tree, tm, "cpu", dtype=torch.float32)
    batch = tdata.synthetic_batch(tm, 2, 16, seed=2)
    ref = _grads(tm, params, batch)
    remat = tregistry.get_model(NAME, dtype=torch.float32, remat=True)
    got = _grads(remat, params, batch)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)
    for path, g in ref[2].items():
        if g is not None:
            torch.testing.assert_close(got[2][path], g, rtol=1e-5, atol=1e-7)


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def test_train_step_matches_jax(models):
    """Two sgd steps from the same state: every parameter, the untouched
    heads included (zero gradients). sgd, because an optimizer that
    normalises the update (adam, adafactor) turns bk's gradient, zero up
    to rounding, into a step of the learning rate's size whose sign is the
    rounding's."""
    jm, tm, *_ = models
    kw = dict(name="sgd", learning_rate=1e-1, warmup_steps=1,
              total_steps=10)
    jcfg, tcfg = joptim.OptimizerConfig(**kw), toptim.OptimizerConfig(**kw)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg)
    tstate = weights.state_from_numpy(_jax_flat(jstate), tcfg, device="cpu")
    step_j = jtrainer.build_train_step(jm, jcfg)
    step_t = ttrainer.build_train_step(tm, tcfg)
    for seed in (3, 4):  # warmup: the first update has learning rate 0
        batch = tdata.synthetic_batch(tm, 2, 16, seed=seed)
        jstate, jmet = step_j(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = step_t(tstate, tdata.place_batch(batch, CPU))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    got = weights.flatten(weights.params_to_numpy(tstate.params))
    for path, ref in weights.flatten(jax.tree.map(
            np.asarray, jstate.params)).items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_synthetic_batches_equal_jax_bitwise(models):
    jm, tm, *_ = models
    for seed in (0, 5):
        want = jdata.synthetic_batch(jm, 3, 24, seed=seed)
        got = tdata.synthetic_batch(tm, 3, 24, seed=seed)
        assert set(got) == set(want) == {"tokens", "mlm_labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_leaf_dtypes_follow_jax_reads(models):
    """bf16 serving: the layers' projections and biases in bf16 (cast at
    use), the embeddings, norms, pooler and heads in float32 (read so);
    the forward from stored bf16 equals the forward from f32 masters."""
    *_, tree, _ = models
    spec = tregistry.get_model(NAME)
    params = weights.params_from_numpy(tree, spec, "cpu")
    for path, leaf in weights.flatten(params).items():
        want = (torch.bfloat16 if path.startswith(("layers/attn/",
                                                   "layers/mlp/"))
                else torch.float32)
        assert leaf.dtype == want, path
    init = spec.init(spec.config, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    assert {p: v.dtype for p, v in weights.flatten(init).items()} == \
        {p: v.dtype for p, v in weights.flatten(params).items()}
    masters = weights.params_from_numpy(tree, spec, "cpu",
                                        dtype=torch.float32)
    tokens = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        a, pa = tbert.apply(masters, tokens, spec.config)
        b, pb = tbert.apply(params, tokens, spec.config)
    assert a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(pa, pb, rtol=0, atol=0)


def test_sequence_past_the_position_table_raises(models):
    _, tm, _, _, params = models
    with pytest.raises(ValueError, match="position table"):
        tbert.apply(params, torch.zeros(1, 129, dtype=torch.int32),
                    tm.config)
    sequence_mesh = SimpleNamespace(  # a DeviceMesh's fields, sequence=2
        mesh_dim_names=("data", "pipeline", "fsdp", "expert", "sequence",
                        "tensor"), mesh=torch.zeros(1, 1, 1, 1, 2, 1))
    # sequence=2 is a replica axis for BERT (JAX's rules and batch spec
    # name no other than data, fsdp and tensor): the same forward.
    tokens = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        plain = tbert.apply(params, tokens, tm.config)
        over = tbert.apply(params, tokens, tm.config, mesh=sequence_mesh)
    for a, b in zip(plain, over):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tensor3 = SimpleNamespace(  # tensor=3 does not divide 4 heads
        mesh_dim_names=sequence_mesh.mesh_dim_names,
        mesh=torch.zeros(1, 1, 1, 1, 1, 3))
    with pytest.raises(ValueError, match="must divide n_heads"):
        tbert.apply(params, torch.zeros(1, 4, dtype=torch.int32), tm.config,
                    mesh=tensor3)


# ---------------------------------------------------------------------------
# Serving and the loop
# ---------------------------------------------------------------------------


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", f"/v1/models/{NAME}:predict",
                     body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_rest_predict_pooled_matches_jax(models):
    """Three instances of mixed lengths padded into a batch of four under
    a ``pad_mask``: ``pooled`` within 1e-5 of JAX's ``_predict_impl`` on
    the same padded inputs, and a gRPC Predict of them returns the REST
    body. No decoder; pushes are refused."""
    grpc = pytest.importorskip("grpc")
    from kubeflow_tpu_torch.serving.grpc_server import client_stubs

    jm, _, jparams, tree, _ = models
    prompts = [[1, 2, 3], list(range(5, 25)), [9] * 7]
    toks = np.zeros((4, 32), np.int32)
    mask = np.zeros((4, 32), np.float32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        mask[i, :len(p)] = 1
    ref = _predict_impl(jm, jparams, {"tokens": jnp.asarray(toks),
                                      "pad_mask": jnp.asarray(mask)})
    server = ModelServer(EngineConfig(
        model=NAME, batch_size=4, max_seq_len=32, dtype="float32",
        device="cpu"), port=0, grpc_port=0, params=tree)
    server.start()
    try:
        assert server.decoder is None
        status, body = _post(server.port, {"instances": [
            {"tokens": p} for p in prompts]})
        with grpc.insecure_channel(
                f"127.0.0.1:{server.grpc_port}") as channel:
            predict, _ = client_stubs(channel)
            assert predict(NAME, [{"tokens": p} for p in prompts],
                           timeout=60) == body
        bad, _ = _post(server.port, {"instances": [{"tokens": [256]}]})
        with pytest.raises(ValueError, match="does not support"):
            server.handle_weights(NAME, {})
    finally:
        server.stop()
    assert status == 200 and bad == 400
    got = np.asarray([p["pooled"] for p in body["predictions"]], np.float32)
    _close(got, np.asarray(ref["pooled"])[:3])


def test_cli_serves_bert(monkeypatch):
    from kubeflow_tpu_torch.serving.__main__ import main

    built = []
    monkeypatch.setattr(ModelServer, "serve_forever",
                        lambda self: built.append(self))
    assert main(["--model-name", NAME, "--device", "cpu", "--rest-port",
                 "0", "--grpc-port", "-1", "--max-seq-len", "16"]) == 0
    server = built[0]
    try:
        assert server.decoder is None
        preds = server.handle_predict(NAME, {"instances": [
            {"tokens": [1, 2, 3]}]})["predictions"]
        assert len(preds[0]["pooled"]) == 64
    finally:
        server.stop()


def test_loop_trains_bert():
    lines = []
    result = tloop.run(tloop.RunConfig(
        model=NAME, device="cpu", batch_size=2, seq_len=16, steps=2,
        log_every=1), log=lines.append)
    assert result["step"] == 2 and np.isfinite(result["loss"])
    assert result["samples_per_sec"] > 0
    with pytest.raises(ValueError, match="synthetic"):
        tloop.run(tloop.RunConfig(model=NAME, device="cpu", steps=1,
                                  data_path="tokens.bin"), log=lines.append)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = tregistry.get_model(NAME)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.init(spec.config, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelServer(EngineConfig(model=NAME), port=0)
