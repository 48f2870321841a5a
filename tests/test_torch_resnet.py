"""The port's ResNet classifier against the JAX package's, on the CPU.

Eval and train logits, the batch-norm running statistics a train forward
records (``_state_updates``), the loss and its gradients, trainer steps
(parameters and statistics, also under gradient accumulation), the
synthetic batches, ``list_models``, the weight tree's list paths and leaf
dtypes, a checkpoint and a train state carried across frameworks, and the
served plain predict, on ``resnet-test-tiny`` (batch 2 of 32×32 images)
with the same weights (the JAX init handed across as numpy arrays).

Tolerances: float32 on both sides with sums in another order. Logits and
statistics within 1e-5 of their largest magnitude; gradients 1e-4 of each
leaf's largest JAX element; parameters after a step 1e-4 relative and
1e-5 absolute. Synthetic batches, checkpoint files and carried states
are equal bit for bit.
"""

import http.client
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.models import resnet as jresnet  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.serving.engine import _predict_impl  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.models import resnet as tresnet  # noqa: E402
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import loop as tloop  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train import trainer as ttrainer  # noqa: E402

NAME = "resnet-test-tiny"
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


def _images(seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


def test_same_padding_is_xla_s():
    """XLA pads total // 2 before and the rest after: the 7×7/2 stem at
    224 pads 2 and 3, a 3×3/2 conv at 56 pads 0 and 1, the 3×3/2 pool at
    112 pads 0 and 1; stride 1 pads evenly."""
    assert tresnet._same_pads(224, 7, 2) == (2, 3)
    assert tresnet._same_pads(56, 3, 2) == (0, 1)
    assert tresnet._same_pads(112, 3, 2) == (0, 1)
    assert tresnet._same_pads(56, 3, 1) == (1, 1)
    assert tresnet._same_pads(56, 1, 2) == (0, 0)


def test_eval_and_train_forward_match_jax(models):
    """Eval logits (stored statistics), train logits (batch statistics)
    and the merged running statistics of every batch norm."""
    jm, tm, jparams, _, params = models
    x = _images()
    _close(tresnet.apply(params, torch.from_numpy(x), tm.config).numpy(),
           jresnet.apply(jparams, jnp.asarray(x), jm.config))
    jlogits, jstats = jresnet.apply(jparams, jnp.asarray(x), jm.config,
                                    train=True)
    with torch.no_grad():
        logits, stats = tresnet.apply(params, torch.from_numpy(x), tm.config,
                                      train=True)
    _close(logits.numpy(), jlogits)
    assert list(stats) == list(jstats)
    assert "stages/1/0/bn_proj" in stats
    for path, value in jstats.items():
        for key in ("mean", "var"):
            _close(stats[path][key].numpy(), value[key])


def test_loss_grads_and_state_updates_match_jax(models):
    jm, tm, jparams, tree, _ = models
    params = weights.params_from_numpy(tree, tm, "cpu", dtype=torch.float32)
    batch = tdata.synthetic_batch(tm, 2, seed=4)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, batch), jm.config),
        has_aux=True)(jparams)
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in weights.flatten(params).items()}
    loss, met = tm.loss_fn(weights._unflatten(leaves),
                           tdata.place_batch(batch, CPU), tm.config)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    updates = met["_state_updates"]
    # JAX's pytree flattening sorts the dict's keys.
    assert sorted(updates) == sorted(jmet["_state_updates"])
    for path, value in jmet["_state_updates"].items():
        _close(updates[path]["mean"].numpy(), value["mean"])
    for path, ref in weights.flatten(jax.tree.map(np.asarray,
                                                  jgrads)).items():
        got = leaves[path].grad
        if path.endswith(("/mean", "/var")):  # statistics: no gradient
            assert got is None and not ref.any(), path
            continue
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), \
            path


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _assert_params_close(tstate, jstate):
    got = weights.flatten(weights.params_to_numpy(tstate.params))
    for path, ref in weights.flatten(jax.tree.map(
            np.asarray, jstate.params)).items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("opt_name,accum", [
    ("adafactor", 1), ("sgd", 1), ("sgd", 2)],
    ids=["adafactor", "sgd", "sgd-accum2"])
def test_trainer_steps_match_jax(models, opt_name, accum):
    """Trainer steps from one state: parameters and the running
    statistics, which the state channel writes over the optimizer's
    update of those leaves (adafactor decays them). Under accumulation
    the last microbatch's statistics win, as in JAX. Not adam: a channel
    that the ReLU kills has a batch-norm gradient of rounding size, and
    adam's update of it (g / (|g| + 1e-8)) is then the rounding's."""
    jm, tm, *_ = models
    kw = dict(name=opt_name, learning_rate=1e-2, warmup_steps=1,
              total_steps=10)
    jcfg, tcfg = joptim.OptimizerConfig(**kw), toptim.OptimizerConfig(**kw)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg)
    tstate = weights.state_from_numpy(_jax_flat(jstate), tcfg, device="cpu")
    step_j = jtrainer.build_train_step(jm, jcfg, accum_steps=accum)
    step_t = ttrainer.build_train_step(tm, tcfg, accum_steps=accum)
    stream = tdata.synthetic_stream(tm, 2, seed=5)
    if accum > 1:
        stream = tdata.stack_microbatches(stream, accum)
    for _ in range(2):
        batch = next(stream)
        jstate, jmet = step_j(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = step_t(tstate, tdata.place_batch(batch, CPU))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-5, err_msg=key)
        _assert_params_close(tstate, jstate)
    assert "_state_updates" not in tmet
    # The statistics moved off their init (mean 0, var 1).
    bn = tstate.params["stages"][0][0]["bn1"]
    assert bn["mean"].abs().max() > 0 and (bn["var"] != 1).any()


def test_synthetic_batches_and_list_models_equal_jax(models):
    jm, tm, *_ = models
    for seed in (0, 7):
        want = jdata.synthetic_batch(jm, 3, seed=seed)
        got = tdata.synthetic_batch(tm, 3, seed=seed)
        assert set(got) == set(want) == {"images", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert tregistry.list_models() == jregistry.list_models()
    for name in jregistry.list_models():
        assert tregistry.get_model(name).family == \
            jregistry.get_model(name).family
    assert tregistry.get_model("resnet50").update_state is not None


def test_weight_tree_lists_and_leaf_dtypes(models):
    """``stages`` stays a list of lists through flatten/unflatten, paths
    take JAX's index keys, conv kernels stay HWIO in cfg.dtype and the
    batch norms and head float32; the tree converts back exactly."""
    *_, tree, _ = models
    spec = tregistry.get_model(NAME)  # bf16
    params = weights.params_from_numpy(tree, spec, "cpu")
    assert isinstance(params["stages"], list)
    assert isinstance(params["stages"][1], list)
    flat = weights.flatten(params)
    assert list(flat) == list(weights.flatten(tree))
    assert flat["stages/1/0/conv2"].shape == tree["stages"][1][0][
        "conv2"].shape  # HWIO
    for path, leaf in flat.items():
        conv = path.rsplit("/", 1)[-1] in ("conv", "conv1", "conv2", "conv3",
                                           "proj")
        assert leaf.dtype == (torch.bfloat16 if conv else torch.float32), path
    init = spec.init(spec.config, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    assert {p: (v.dtype, tuple(v.shape))
            for p, v in weights.flatten(init).items()} == \
        {p: (v.dtype, tuple(v.shape)) for p, v in flat.items()}
    masters = weights.params_from_numpy(tree, spec, "cpu",
                                        dtype=torch.float32)
    back = weights.params_to_numpy(masters)
    assert isinstance(back["stages"][0], list)
    for path, leaf in weights.flatten(back).items():
        np.testing.assert_array_equal(leaf, weights.flatten(tree)[path])


def test_checkpoint_and_train_state_cross_frameworks(models, tmp_path):
    """A JAX train state (after a step) goes through the port's checkpoint
    files and back to the JAX layout bit for bit: HWIO kernels at JAX's
    paths, the statistics as leaves, every optimizer slot. Then the
    restored state and JAX's continue equal for a step."""
    jm, tm, *_ = models
    opt = dict(name="adafactor", learning_rate=1e-2, warmup_steps=1,
               total_steps=10)
    jcfg, tcfg = joptim.OptimizerConfig(**opt), toptim.OptimizerConfig(**opt)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg)
    step_j = jtrainer.build_train_step(jm, jcfg)
    stream = tdata.synthetic_stream(tm, 2, seed=6)
    jstate, _ = step_j(jstate, jax.tree.map(jnp.asarray, next(stream)))
    jflat = _jax_flat(jstate)
    tstate = weights.state_from_numpy(jflat, tcfg, device="cpu")
    tckpt.save(str(tmp_path), 1, tstate, tcfg)
    kernel = np.load(tmp_path / "1" / "params" / "stages" / "1" / "0" /
                     "conv2.npy")
    assert kernel.shape == jflat["params/stages/1/0/conv2"].shape
    assert os.path.isfile(tmp_path / "1" / "params" / "stem" / "bn" /
                          "mean.npy")
    like = ttrainer.init_state(torch.Generator().manual_seed(1), tm, tcfg,
                               device="cpu")
    restored, step = tckpt.restore_latest(str(tmp_path), like, tcfg)
    assert step == 1
    flat = weights.state_to_numpy(restored, tcfg)
    assert set(flat) == set(jflat)
    for path, ref in jflat.items():
        np.testing.assert_array_equal(flat[path], ref, err_msg=path)
    batch = next(stream)
    jstate, _ = step_j(jstate, jax.tree.map(jnp.asarray, batch))
    restored, _ = ttrainer.build_train_step(tm, tcfg)(
        restored, tdata.place_batch(batch, CPU))
    _assert_params_close(restored, jstate)


def test_rest_predict_matches_jax(models):
    """Two images in a batch of four: probabilities within 1e-5 and the
    classes of JAX's ``_predict_impl``; a wrongly shaped image is a 400."""
    jm, _, jparams, tree, _ = models
    x = _images(8)
    padded = np.zeros((4, 32, 32, 3), np.float32)
    padded[:2] = x
    ref = _predict_impl(jm, jparams, {"images": jnp.asarray(padded)})
    server = ModelServer(EngineConfig(
        model=NAME, batch_size=4, dtype="float32", device="cpu"),
        port=0, params=tree)
    server.start()
    try:
        assert server.decoder is None and server.engine.ready
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=120)
        try:
            conn.request("POST", f"/v1/models/{NAME}:predict",
                         body=json.dumps({"instances": [
                             {"images": img.tolist()} for img in x]}))
            resp = conn.getresponse()
            status, body = resp.status, json.loads(resp.read())
        finally:
            conn.close()
        with pytest.raises(ValueError, match="shape"):
            server.handle_predict(NAME, {"instances": [
                {"images": np.zeros((16, 16, 3)).tolist()}]})
    finally:
        server.stop()
    assert status == 200
    preds = body["predictions"]
    _close(np.asarray([p["probabilities"] for p in preds]),
           np.asarray(ref["probabilities"])[:2])
    assert [p["classes"] for p in preds] == \
        np.asarray(ref["classes"])[:2].tolist()


def test_loop_trains_resnet():
    result = tloop.run(tloop.RunConfig(
        model=NAME, device="cpu", batch_size=2, steps=2, log_every=1),
        log=lambda *a: None)
    assert result["step"] == 2 and np.isfinite(result["loss"])
    assert result["samples_per_sec"] > 0


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = tregistry.get_model(NAME)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.init(spec.config, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.run(tloop.RunConfig(model=NAME, steps=1), log=lambda *a: None)
