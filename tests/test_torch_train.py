"""The port's training path against the JAX package's, on the CPU.

``loss_fn`` and its gradients, each optimizer (with clipping and the
schedule), three train steps (also with gradient accumulation), the data
stream and the loop's result keys are held against their JAX counterparts
on the same numpy inputs and the same weights (the JAX tree converted with
``weights.params_from_numpy``). Unported options must raise (remat and the
chunked loss: tests/test_torch_remat.py; checkpoints, the token store and
the profiler: tests/test_torch_checkpoint.py).

Tolerances: float32 on both sides with sums in another order. Losses and
metrics agree to 1e-5 relative; gradients to 1e-4 of their largest
element; optimizer trees to 1e-5; parameters after three steps to 1e-4
relative and 1e-5 absolute.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train import loop as jloop  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import loop as tloop  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train import trainer as ttrainer  # noqa: E402

# A tiny config at head_dim 128 that asks for the splash kernel by name.
TINY_HD128 = dict(vocab_size=128, d_model=256, n_layers=2, n_heads=2,
                  n_kv_heads=1, d_ff=256, max_seq_len=64, remat=False,
                  scan_layers=False, attn_impl="splash", attn_block_k=16)


def _models(name, **overrides):
    jm = jregistry.get_model(name, dtype=jnp.float32, **overrides)
    tm = tregistry.get_model(name, dtype=torch.float32, **overrides)
    return jm, tm


def _params(jm, tm, seed=0):
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                            jm.config))
    return tree, weights.params_from_numpy(tree, tm.config, device="cpu",
                                           dtype=torch.float32)


def _flat_np(tree):
    return weights.flatten(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name,overrides", [
    ("lm-test-tiny", {}),
    ("lm-test-tiny", {"scan_layers": False}),
    ("lm-test-tiny", TINY_HD128),
], ids=["tiny-scan", "tiny-unrolled", "hd128-splash"])
def test_loss_fn_and_grads_match_jax(name, overrides):
    """``scan_layers`` only chose JAX's representation: the port runs the
    same loop for either value, and both match JAX."""
    jm, tm = _models(name, **overrides)
    tree, params = _params(jm, tm)
    batch = tdata.synthetic_batch(tm, 2, 24, seed=1)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(batch["tokens"])},
                             jm.config), has_aux=True)(tree)
    flat = weights.flatten(params)
    leaves = {k: p.clone().requires_grad_(True) for k, p in flat.items()}
    loss, met = tm.loss_fn(weights._unflatten(leaves),
                           tdata.place_batch(batch, torch.device("cpu")),
                           tm.config)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("loss", "z_loss", "tokens"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   rtol=1e-5)
    for path, ref in _flat_np(jgrads).items():
        got = leaves[path].grad.numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), path


def test_apply_casts_weights_and_serving_dtype_params_still_work():
    """bf16 compute from f32 masters equals bf16 compute from bf16-stored
    weights: the cast happens at each use."""
    tm = tregistry.get_model("lm-test-tiny")
    g = torch.Generator().manual_seed(0)
    masters = tm.init(tm.config, generator=g, device="cpu",
                      param_dtype=torch.float32)
    stored = {k: v if k in ttransformer.NORM_LEAVES else v.bfloat16()
              for k, v in weights.flatten(masters).items()}
    tokens = torch.randint(0, 256, (2, 8), generator=g)
    a = tm.apply(masters, tokens, tm.config)
    b = tm.apply(weights._unflatten(stored), tokens, tm.config)
    assert a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _opt_tree(seed):
    """Factored ([2, 128, 160], [130, 140]) and unfactored ([2, 16],
    [8], [3, 200]) leaves."""
    rng = np.random.RandomState(seed)
    shapes = {"stack": (2, 128, 160), "mat": (130, 140), "norm": (2, 16),
              "bias": (8,), "thin": (3, 200)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name,extra", [
    ("adamw", {}), ("adamw", {"mu_dtype": "bfloat16"}), ("adam", {}),
    ("sgd", {}), ("adafactor", {}), ("adafactor", {"grad_clip_norm": 0.0}),
], ids=["adamw", "adamw-mu-bf16", "adam", "sgd", "adafactor",
        "adafactor-noclip"])
def test_optimizers_match_optax(name, extra):
    """Five updates; a clip norm of 30 clips some steps' gradients (norms
    15-60) and not others; warmup 2 of 6 steps, so the first update is 0
    and the cosine decay is reached. With a bf16 first moment a sum that
    lands on a rounding boundary may round the other way: one bf16 ulp of
    mu (2^-8 relative) moves that element by up to lr * 2^-8 = 2e-4 an
    update, so up to 1e-3 over five."""
    atol = 1e-3 if extra.get("mu_dtype") else 1e-6
    cfg = joptim.OptimizerConfig(name=name, learning_rate=0.05,
                                 warmup_steps=2, total_steps=6,
                                 grad_clip_norm=extra.pop(
                                     "grad_clip_norm", 30.0), **extra)
    tcfg = toptim.OptimizerConfig(**{f: getattr(cfg, f) for f in
                                     cfg.__dataclass_fields__})
    params_np = _opt_tree(0)
    jopt = joptim.build(cfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    topt = toptim.build(tcfg)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    tstate = topt.init(tparams)
    for i in range(5):
        grads = {k: v * (0.2 + i) for k, v in _opt_tree(10 + i).items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        with torch.no_grad():
            topt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                        tstate, tparams)
        for k in params_np:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=atol, err_msg=f"{k} step {i}")


def test_schedule_matches_optax():
    cfg = toptim.OptimizerConfig(learning_rate=1e-3, warmup_steps=3,
                                 total_steps=10)
    ref = joptim.schedule(joptim.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=3, total_steps=10))
    lr = toptim.schedule(cfg)
    assert lr(0) == 0.0
    for c in range(14):
        np.testing.assert_allclose(lr(c), float(ref(c)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("opt_name,accum", [("adamw", 1), ("adafactor", 1),
                                            ("adafactor", 2)])
def test_three_train_steps_match_jax(opt_name, accum):
    jm, tm = _models("lm-test-tiny")
    opt_cfg = joptim.OptimizerConfig(name=opt_name, learning_rate=1e-2,
                                     warmup_steps=1, total_steps=10)
    tcfg = toptim.OptimizerConfig(name=opt_name, learning_rate=1e-2,
                                  warmup_steps=1, total_steps=10)
    tree, params = _params(jm, tm)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, tree),
        opt_state=joptim.build(opt_cfg).init(tree))
    tstate = ttrainer.TrainState(
        step=0, params=params,
        opt_state=toptim.build(tcfg).init(weights.flatten(params)))
    jstep = jtrainer.build_train_step(jm, opt_cfg, accum_steps=accum)
    tstep = ttrainer.build_train_step(tm, tcfg, accum_steps=accum)
    stream = tdata.synthetic_stream(tm, 4, 16, seed=3)
    if accum > 1:
        stream = tdata.stack_microbatches(stream, accum)
    for _ in range(3):
        batch = next(stream)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, tdata.place_batch(
            batch, torch.device("cpu")))
        assert set(tmet) == set(jmet)
        for key in ("loss", "z_loss", "tokens", "grad_norm", "step"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-5, err_msg=key)
    assert tstate.step == int(jstate.step) == 3
    got = weights.flatten(weights.params_to_numpy(tstate.params))
    for path, ref in _flat_np(jstate.params).items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_grad_dtype_bfloat16_differentiates_a_bf16_view():
    tm = tregistry.get_model("lm-test-tiny", dtype=torch.float32)
    cfg = toptim.OptimizerConfig(name="adafactor", warmup_steps=0,
                                 grad_dtype="bfloat16")
    state = ttrainer.init_state(torch.Generator().manual_seed(0), tm, cfg,
                                device="cpu")
    step = ttrainer.build_train_step(tm, cfg)
    before = weights.params_to_numpy(state.params)
    state, met = step(state, tdata.place_batch(
        tdata.synthetic_batch(tm, 2, 8), torch.device("cpu")))
    assert all(p.dtype == torch.float32
               for p in weights.flatten(state.params).values())
    assert np.isfinite(float(met["grad_norm"]))
    after = weights.params_to_numpy(state.params)
    assert np.abs(after["layers"]["attn"]["wq"]
                  - before["layers"]["attn"]["wq"]).max() > 0


def test_synthetic_batches_equal_jax():
    jm = jregistry.get_model("lm-test-tiny")
    tm = tregistry.get_model("lm-test-tiny")
    jstream = jdata.stack_microbatches(
        jdata.synthetic_stream(jm, 3, 10, seed=7, start_step=2), 2)
    tstream = tdata.stack_microbatches(
        tdata.synthetic_stream(tm, 3, 10, seed=7, start_step=2), 2)
    for _ in range(2):
        np.testing.assert_array_equal(next(tstream)["tokens"],
                                      next(jstream)["tokens"])


def test_loop_result_keys_equal_jax():
    logs = []
    common = dict(model="lm-test-tiny", batch_size=8, seq_len=16, steps=2,
                  log_every=1, prefetch=2)
    jres = jloop.run(jloop.RunConfig(**common), log=lambda *a: None)
    tres = tloop.run(tloop.RunConfig(device="cpu", **common),
                     log=logs.append)
    assert set(tres) == set(jres)
    assert tres["step"] == 2 and np.isfinite(tres["loss"])
    assert tres["devices"] == 1 and tres["reshards"] == []
    assert logs[-1].startswith("kubeflow-tpu-metrics: ")
    assert "grad_norm=" in logs[0]


@pytest.mark.parametrize("buckets", [None, (0.01, 0.1, 1.0)])
def test_step_time_histogram_quantiles_equal_jax(buckets):
    """The loop's step-time p50/p99 come from the copied Histogram, which
    must estimate exactly as the JAX package's does, the +Inf overflow
    included."""
    from kubeflow_tpu.observability.metrics import Histogram as JHistogram
    from kubeflow_tpu_torch.observability.metrics import Histogram

    values = np.random.RandomState(0).lognormal(-3.0, 1.5, size=200)
    ours, theirs = Histogram(buckets), JHistogram(buckets)
    assert ours.quantile(0.5) == theirs.quantile(0.5) == 0.0
    for v in values:
        ours.observe(float(v))
        theirs.observe(float(v))
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    with pytest.raises(ValueError):
        ours.quantile(1.5)


def test_loop_main_needs_cuda_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.main(['{"model": "lm-test-tiny", "steps": 1}'])
    assert tloop.main(['{"model": "lm-test-tiny", "steps": 1, "seq_len": 8,'
                       ' "batch_size": 2, "device": "cpu"}']) == 0
    assert '"step": 1' in capsys.readouterr().out.splitlines()[-1]


@pytest.mark.parametrize("field,value", [
    ("elastic_poll_steps", 5), ("elastic_poll_steps", 1),
    ("mesh", {"sequence": 2}), ("mesh", {"pipeline": 2}),
])
def test_loop_refuses_unported_options_before_any_step(field, value):
    """Elastic resharding is still to come (checkpoints, the token store
    and the profiler now run: tests/test_torch_checkpoint.py; every mesh
    axis in gangs: tests/test_torch_distributed_*.py,
    tests/test_torch_moe_parallel.py and tests/test_torch_pipeline.py). A
    sequence or pipeline mesh of two needs a gang of two: one process
    refuses it, as JAX's MeshConfig does, before any step."""
    cfg = tloop.RunConfig(device="cpu", steps=1, **{field: value})
    match = "not yet ported" if field != "mesh" else \
        "1 devices not divisible by fixed axes product 2"
    with pytest.raises(ValueError, match=match):
        tloop.run(cfg, log=lambda *a: None)


def test_loop_refuses_the_job_status_environment():
    with pytest.raises(ValueError, match="not yet ported"):
        tloop.run(tloop.RunConfig(device="cpu", steps=1),
                  environ={"KUBEFLOW_TPU_JOB_NAME": "job"})


# Meshes with a sequence or a pipeline axis of 2 (stand-ins: what the
# mesh checks read of a DeviceMesh; the checks refuse before any
# collective).
SEQUENCE_MESH = SimpleNamespace(
    mesh_dim_names=("data", "pipeline", "fsdp", "expert", "sequence",
                    "tensor"), mesh=torch.zeros(1, 1, 1, 1, 2, 1))
PIPELINE_MESH = SimpleNamespace(
    mesh_dim_names=SEQUENCE_MESH.mesh_dim_names,
    mesh=torch.zeros(1, 2, 1, 1, 1, 1))
COMPOSES = "composes with dp/fsdp/tp, not \\(yet\\) with MoE or context"


@pytest.mark.parametrize("overrides,mesh,match", [
    ({"pipeline_stages": 2, "context_parallel": True}, PIPELINE_MESH,
     COMPOSES),
    ({"pipeline_stages": 2, "n_experts": 4}, PIPELINE_MESH, COMPOSES),
    ({"pipeline_stages": 3}, PIPELINE_MESH,
     "n_layers 2 not divisible by pipeline_stages 3"),
    ({"pipeline_stages": 2, "remat": True, "remat_policy": "llm_attn"},
     PIPELINE_MESH, "'llm_attn' is incompatible with pipeline_stages>1"),
])
def test_model_refuses_unported_training_options(overrides, mesh, match):
    """The layouts JAX refuses, with its messages: pipeline stages with a
    mixture of experts or with ring attention, stages that do not divide
    the layers, and "llm_attn" under stages (ring attention, pipeline
    stages and every mesh axis train: tests/test_torch_pipeline.py,
    tests/test_torch_ring_attention.py; remat, scan_group_size and
    loss_chunks: tests/test_torch_remat.py)."""
    tm = tregistry.get_model("lm-test-tiny", **overrides)
    params = tm.init(tm.config, generator=torch.Generator().manual_seed(0),
                     device="cpu", param_dtype=torch.float32)
    batch = {"tokens": torch.zeros(1, 5, dtype=torch.int32)}
    with pytest.raises(ValueError, match=match):
        tm.loss_fn(params, batch, tm.config, mesh=mesh)


def test_remat_only_raises_under_autograd_and_mesh_raises():
    """remat decides what the backward keeps, so it opens regions only
    while autograd records: an inference forward and a recorded one give
    the same logits, and the recorded one differentiates. Without
    context parallelism a sequence axis holds the same rows on each of
    its ranks: the forward over it is the plain one, and the step builds;
    pipeline stages that do not divide the layers raise JAX's message."""
    tm = tregistry.get_model("llama-1b", d_model=64, n_heads=4,
                             n_kv_heads=2, d_ff=64, n_layers=1,
                             vocab_size=32, dtype=torch.float32)
    assert tm.config.remat and tm.config.remat_policy == "dots"
    params = tm.init(tm.config, generator=torch.Generator().manual_seed(0),
                     device="cpu", param_dtype=torch.float32)
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    with torch.no_grad():
        ref = tm.apply(params, tokens, tm.config)
    assert ref.shape == (1, 4, 32)
    wq = params["layers"]["attn"]["wq"].requires_grad_(True)
    out = tm.apply(params, tokens, tm.config)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out.square().sum().backward()
    assert wq.grad is not None and wq.grad.abs().max() > 0
    with torch.no_grad():
        over = ttransformer.hidden_states(params, tokens, tm.config,
                                          mesh=SEQUENCE_MESH)[0]
        plain = ttransformer.hidden_states(params, tokens, tm.config)[0]
    torch.testing.assert_close(over, plain, rtol=0, atol=0)
    ttrainer.build_train_step(tm, toptim.OptimizerConfig(),
                              mesh=SEQUENCE_MESH)
    staged = dataclasses.replace(tm.config, pipeline_stages=3)
    with pytest.raises(ValueError, match="not divisible by pipeline_stages"):
        ttransformer.hidden_states(params, tokens, staged,
                                   mesh=PIPELINE_MESH)


def test_presets_carry_the_jax_training_fields():
    from kubeflow_tpu.models import transformer as jtransformer

    fields = ("remat", "remat_policy", "scan_layers", "attn_impl",
              "attn_block_k", "loss_chunks", "scan_group_size",
              "context_parallel", "pipeline_stages",
              "pipeline_microbatches")
    for name, jcfg in jtransformer.PRESETS.items():
        tcfg = ttransformer.PRESETS[name]
        for f in fields:
            assert getattr(tcfg, f) == getattr(jcfg, f), (name, f)
