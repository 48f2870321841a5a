"""The port's train step over a data x FSDP mesh, in gangs of 2-4 CPU
processes over gloo, against the JAX package's mesh train step.

Each gang runs the port's trainer (``init_state``/``build_train_step``
with a ``DeviceMesh`` built from the JaxJob environment,
``parallel.launch``) from the JAX initial state, handed across as a
checkpoint, for three steps on its rank's rows of seeded global batches,
and ends with a checkpoint of the whole state written by rank 0. JAX runs
``build_train_step`` on ``build_mesh(MeshConfig(...), devices=jax.devices()
[:W])`` over the same global batches; the port's single process runs them
too. The cases:

- the transformer at data=2, fsdp=2, fsdp=3 (``d_model`` 128 over 3
  shards: 43, 43 and 42 rows, the last padded; JAX's jit refuses an
  output sharding the degree does not divide, so that case's reference is
  JAX's step on one device, the same function) and data=2 x fsdp=2,
  widths overridden so adafactor factors the sharded leaves (``lm-test-tiny``
  never factors), with targets masked at random so each rank counts a
  different number of valid targets; 2-step gradient accumulation and
  sgd's sharded momentum at fsdp=2 (not adamw: at these widths a few
  embedding rows get gradients near adam's eps, whose update JAX's own
  mesh and single-device steps already disagree on by 3e-5);
- ``bert-test-tiny`` at data=2, whose ranks mask different numbers of MLM
  positions (sgd, as ``tests/test_torch_bert.py`` holds its steps: the
  key bias's gradient is zero up to rounding, which an update that
  normalises turns into a step whose sign is the rounding's);
- ``resnet-test-tiny`` at data=2: sync batch norm, whose running
  statistics land in the checkpoint's parameters;
- BERT over sequence=2, pipeline=2 and data=2 x sequence=2, ResNet over
  sequence=2 and pipeline=2: no rule or batch spec of theirs names those
  axes, so their ranks are replicas of the same rows, and the targets
  (JAX's ``tokens``) count once;
- the transformer over the tensor axis (Megatron's split): tensor=2,
  data=2 x tensor=2, fsdp=2 x tensor=2 (adafactor factors ``attn/wq``,
  sharded on both its dims), tensor=2 with ``loss_chunks`` 2 (the
  chunked loss over vocabulary-sharded logits) and tensor=2 under remat
  ``"dots"`` (the regions replay the forward's collectives). A tensor
  group holds the same rows, so only the batch axes count targets.

Tolerances are ``tests/test_torch_train.py``'s: float32 on both sides with
sums in another order. Metrics (loss, z_loss, tokens, grad_norm, step) to
1e-5 relative each step; parameters and optimizer slots after three
steps to 1e-4 relative and 1e-5 absolute.

Each case runs under a 120 s limit (and a 120 s process-group timeout), so
none can hang the suite. The gangs stay up across cases, one per size
(``tests/_torch_gang.py``): each case is a job its ranks run on a mesh
they build and free. A case hands its job to the gang, then runs JAX's
steps and the port's single process while the gang trains; the single
process's run is kept for the next case with the same inputs (model,
optimizer, initial state and batches), whose result it is.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as tcheckpoint  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_gang import (  # noqa: E402
    GangPool,
    in_background,
    jax_initial_state,
    single_process,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
GANG_TIMEOUT_S = 120

# One job of a gang's rank: restore the step-0 state the test wrote,
# train STEPS steps on this rank's rows, save the whole state; every rank
# writes its metrics.
JOB = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, MeshConfig,
    axis_index, axis_size, build_mesh, destroy_mesh)
from kubeflow_tpu_torch.train import checkpoint, data, trainer
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.weights import flatten
def run(a, info):
    mesh = build_mesh(MeshConfig(**a["mesh"]), device_type="cpu")
    model = get_model(a["model"], dtype=torch.float32, **a["overrides"])
    opt_cfg = OptimizerConfig(**a["optimizer"])
    ckpt = checkpoint.Checkpointer(a["dir"], opt_cfg, async_saves=False)
    state = trainer.init_state(torch.Generator().manual_seed(1), model,
                               opt_cfg, mesh, device="cpu")
    state, _ = ckpt.restore_latest(state)
    step_fn = trainer.build_train_step(model, opt_cfg, mesh,
                                       accum_steps=a["accum"])
    r, n = axis_index(mesh, BATCH_AXES), axis_size(mesh, BATCH_AXES)
    batches = np.load(a["batches"])
    metrics, counts = [], []
    for i in range(a["steps"]):
        b = data.local_rows({k: batches[f"{k}/{i}"] for k in a["keys"]},
                            r, n, microbatched=a["accum"] > 1)
        counts.append(int(sum((v >= 0).sum() for k, v in b.items()
                              if k in ("targets", "mlm_labels"))))
        state, met = step_fn(state, data.place_batch(b, torch.device("cpu")))
        metrics.append({k: float(v) for k, v in met.items()})
    ckpt.save(a["steps"], state)
    ckpt.close()
    with open(a["out"] + f".{info.process_id}", "w") as f:
        json.dump({"metrics": metrics, "counts": counts,
                   "param_shapes": {k: list(v.shape) for k, v in
                                    flatten(state.params).items()}}, f)
    destroy_mesh(mesh)
"""

# adafactor factors a leaf whose two largest axes are both >= 128.
WIDE = dict(d_model=128, d_ff=256)

CASES = {
    "transformer-data2": dict(model="lm-test-tiny", overrides=WIDE,
                              mesh={"data": 2}, opt="adafactor"),
    "transformer-fsdp2": dict(model="lm-test-tiny", overrides=WIDE,
                              mesh={"fsdp": 2}, opt="adafactor"),
    "transformer-fsdp3-padded": dict(model="lm-test-tiny", overrides=WIDE,
                                     mesh={"fsdp": 3}, opt="adafactor",
                                     jax_mesh=False),
    "transformer-data2xfsdp2": dict(model="lm-test-tiny", overrides=WIDE,
                                    mesh={"data": 2, "fsdp": 2},
                                    opt="adafactor"),
    "transformer-fsdp2-accum2": dict(model="lm-test-tiny", overrides=WIDE,
                                     mesh={"fsdp": 2}, opt="adafactor",
                                     accum=2),
    "transformer-fsdp2-sgd": dict(model="lm-test-tiny", overrides=WIDE,
                                  mesh={"fsdp": 2}, opt="sgd"),
    "transformer-tensor2": dict(model="lm-test-tiny", overrides=WIDE,
                                mesh={"tensor": 2}, opt="adafactor"),
    "transformer-data2xtensor2": dict(model="lm-test-tiny", overrides=WIDE,
                                      mesh={"data": 2, "tensor": 2},
                                      opt="adafactor"),
    "transformer-fsdp2xtensor2": dict(model="lm-test-tiny", overrides=WIDE,
                                      mesh={"fsdp": 2, "tensor": 2},
                                      opt="adafactor"),
    "transformer-tensor2-chunked": dict(
        model="lm-test-tiny", overrides=dict(WIDE, loss_chunks=2),
        mesh={"tensor": 2}, opt="adafactor"),
    "transformer-tensor2-remat-dots": dict(
        model="lm-test-tiny",
        overrides=dict(WIDE, remat=True, remat_policy="dots"),
        mesh={"tensor": 2}, opt="adafactor"),
    "bert-data2": dict(model="bert-test-tiny", overrides={},
                       mesh={"data": 2}, opt="sgd"),
    "resnet-data2": dict(model="resnet-test-tiny", overrides={},
                         mesh={"data": 2}, opt="adafactor"),
    # No rule or batch spec of BERT or ResNet names sequence or pipeline:
    # their ranks are replicas, on the same rows, counting each target
    # once.
    "bert-sequence2": dict(model="bert-test-tiny", overrides={},
                           mesh={"sequence": 2}, opt="sgd"),
    "bert-pipeline2": dict(model="bert-test-tiny", overrides={},
                           mesh={"pipeline": 2}, opt="sgd"),
    "bert-data2xsequence2": dict(model="bert-test-tiny", overrides={},
                                 mesh={"data": 2, "sequence": 2}, opt="sgd"),
    "resnet-sequence2": dict(model="resnet-test-tiny", overrides={},
                             mesh={"sequence": 2}, opt="adafactor"),
    "resnet-pipeline2": dict(model="resnet-test-tiny", overrides={},
                             mesh={"pipeline": 2}, opt="adafactor"),
}


@pytest.fixture(scope="module")
def gangs():
    pool = GangPool(JOB, ROOT)
    yield pool
    pool.close()


def _ranks(mesh):
    return int(np.prod(list(mesh.values())))


def _global_batch(tm, rows, seed):
    """A seeded global batch of ``rows`` rows; the LM's targets are masked
    (-1) at random, so ranks count different numbers of valid ones."""
    if tm.family != "transformer":
        return tdata.synthetic_batch(tm, rows, 16, seed=seed)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tm.config.vocab_size, (rows, 17), np.int32)
    targets = np.where(rng.random((rows, 16)) < 0.25, -1,
                       tokens[:, 1:]).astype(np.int32)
    return {"inputs": tokens[:, :-1], "targets": targets}


def _batches(tm, rows, accum):
    out = []
    for i in range(STEPS):
        micro = [_global_batch(tm, rows, 100 + i * accum + j)
                 for j in range(accum)]
        out.append(micro[0] if accum == 1 else
                   {k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return out


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _assert_states_close(got: dict, want: dict):
    assert set(got) == set(want)
    for path, ref in want.items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def _assert_metrics_close(got: list, want: list):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for key, ref in w.items():
            np.testing.assert_allclose(g[key], ref, rtol=1e-5,
                                       err_msg=f"{key} step {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_train_steps_match_jax(case, tmp_path, gangs):
    spec = CASES[case]
    accum = spec.get("accum", 1)
    w = _ranks(spec["mesh"])
    jm = jregistry.get_model(spec["model"], dtype=jnp.float32,
                             **spec["overrides"])
    tm = tregistry.get_model(spec["model"], dtype=torch.float32,
                             **spec["overrides"])
    opt = dict(name=spec["opt"], learning_rate=1e-2, warmup_steps=1,
               total_steps=10)
    jcfg, tcfg = joptim.OptimizerConfig(**opt), toptim.OptimizerConfig(**opt)
    batches = _batches(tm, 2 * w, accum)

    # JAX's initial state, which the port's gang starts from.
    jmesh = jbuild_mesh(JMeshConfig(**spec["mesh"]),
                        devices=jax.devices()[:w]) \
        if spec.get("jax_mesh", True) else None
    jstate = jax_initial_state(
        jax, jtrainer, jm, jcfg, jmesh,
        (spec["model"], json.dumps(spec["overrides"], sort_keys=True),
         json.dumps(opt, sort_keys=True)))
    start = _jax_flat(jstate)

    # The port's gang, from the same state, trains while JAX and the
    # single process run here.
    ckpt_dir = str(tmp_path / "ckpt")
    tcheckpoint.save(ckpt_dir, 0, weights.state_from_numpy(
        start, tcfg, device="cpu"), tcfg)
    np.savez(tmp_path / "batches.npz", **{
        f"{k}/{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    args = dict(model=spec["model"], overrides=spec["overrides"],
                mesh=spec["mesh"], optimizer=opt, dir=ckpt_dir,
                batches=str(tmp_path / "batches.npz"), keys=list(batches[0]),
                steps=STEPS, accum=accum, out=str(tmp_path / "out"))
    gang = gangs.get(w)
    gang.submit(args)

    # The port's single process over the same global batches, beside
    # JAX's steps.
    single = in_background(
        single_process, tm, tcfg, start, batches, accum,
        (spec["model"], json.dumps(spec["overrides"], sort_keys=True),
         json.dumps(opt, sort_keys=True), accum))

    # JAX: the mesh step over the global batches.
    jstep = jtrainer.build_train_step(jm, jcfg, jmesh, accum_steps=accum)
    jmets = []
    for b in batches:
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jmets.append({k: float(v) for k, v in jmet.items()})

    tmets, tstate_np = single.result()
    gang.wait(args, GANG_TIMEOUT_S)
    ranks = [json.load(open(f"{tmp_path / 'out'}.{i}")) for i in range(w)]
    for r in ranks:  # every rank reports the same global metrics
        _assert_metrics_close(r["metrics"], jmets)
    got = tcheckpoint._load(ckpt_dir, STEPS)
    _assert_states_close(got, _jax_flat(jstate))
    _assert_metrics_close(ranks[0]["metrics"], tmets)
    _assert_states_close(got, tstate_np)

    batch_ranks = spec["mesh"].get("data", 1) * spec["mesh"].get("fsdp", 1)
    if tm.family != "resnet" and batch_ranks > 1:
        # ranks count different valid targets
        assert len({tuple(r["counts"]) for r in ranks}) > 1
    if {"sequence", "pipeline"} & set(spec["mesh"]):
        # ranks 2i and 2i + 1 (the replica axis is the inner one) hold
        # the same rows
        assert all(ranks[i]["counts"] == ranks[i + 1]["counts"]
                   for i in range(0, w, 2))
    if "tensor" in spec["mesh"]:
        # a tensor group holds the same rows, and each rank a block of
        # the split leaves: half the query columns of wq
        assert len({tuple(r["counts"]) for r in ranks[:2]}) == 1
        hq = tm.config.n_heads * tm.config.head_dim
        wq_cols = [r["param_shapes"]["layers/attn/wq"][-1] for r in ranks]
        assert wq_cols == [hq // 2] * w
    if tm.family == "resnet":  # sync-BN moved the running statistics
        mean = "params/stem/bn/mean"
        assert np.abs(got[mean] - start[mean]).max() > 0
    if "fsdp" in spec["mesh"] and spec["opt"] == "adafactor":
        # adafactor factors a leaf sharded over fsdp: its moments are
        # whole on each rank, as JAX replicates them.
        wq = "opt_state/1/0/v_row/layers/attn/wq"
        assert got[wq].shape == start[wq].shape != (1,)
