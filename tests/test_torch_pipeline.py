"""Pipeline stages and the sequence axis in training, against the JAX
package.

- ``parallel.pipeline``: ``stage_layer_ranges`` against JAX's, and
  ``pipeline_apply`` in a gloo gang of two over ``pipeline`` (each rank
  holding its stage's layers of a toy ``tanh(h @ w)`` stack) at 2 and 4
  microbatches against JAX's ``pipeline_apply`` on its CPU mesh: the
  output on every stage and the gradients of ``sum(out * c)`` (each
  stage's layers; the input's, whole on every stage) against
  ``jax.grad``, within 1e-5.
- The trainer over ``sequence`` (``context_parallel``) and ``pipeline``
  (``pipeline_stages``): gloo gangs of 2-4 run the port's
  ``init_state``/``build_train_step`` on ``lm-test-tiny`` (widths raised
  so adafactor factors the sharded leaves) over sequence 2, data 2 x
  sequence 2, pipeline 2, data 2 x pipeline 2 and pipeline 2 x tensor 2,
  (sgd there: JAX's ``init_state`` cannot lay adafactor's placeholder
  moments of the norm leaves over ``pipeline``), and ``moe-test-tiny``
  over sequence 2 at a capacity factor of 0.5
  (every expert overflows, so each choice's queue position must be
  global, across the ring's chunks), from JAX's initial state, for two
  steps on each rank's rows (a sequence rank: its chunk of their
  tokens), targets masked at random so ranks count different numbers;
  JAX's ``build_train_step`` on ``build_mesh(MeshConfig(...))`` over the
  same global batches is the reference. Metrics (loss, z_loss, tokens,
  grad_norm) within 1e-5 relative each step; the whole state after the
  steps within 1e-4 relative and 1e-5 absolute.
- The rotary offset: the same sequence gang with each rank's rotary
  positions started at 0 instead of ``rank_in_sequence * T_local`` leaves
  JAX's loss, which the gang with the offset holds.

Each gang runs under a 120 s limit.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from kubeflow_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_apply as jpipeline_apply,
)
from kubeflow_tpu.parallel.pipeline import (  # noqa: E402
    stage_layer_ranges as jstage_layer_ranges,
)
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.parallel.launch import launch  # noqa: E402
from kubeflow_tpu_torch.parallel.pipeline import (  # noqa: E402
    stage_layer_ranges,
)
from kubeflow_tpu_torch.train import checkpoint as tcheckpoint  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run_gang(worker: str, args: dict, w: int):
    procs = launch([sys.executable, "-c", worker, json.dumps(args)], w,
                   env=ENV, cwd=ROOT, timeout=GANG_TIMEOUT_S)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{p.stderr[-3000:]}"


@pytest.mark.parametrize("layers,stages", [(4, 2), (6, 3), (2, 1), (5, 2),
                                           (4, 0)])
def test_stage_layer_ranges_match_jax(layers, stages):
    try:
        want = jstage_layer_ranges(layers, stages)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            stage_layer_ranges(layers, stages)
        return
    assert stage_layer_ranges(layers, stages) == want


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------

APPLY_WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.parallel import collectives as c
from kubeflow_tpu_torch.parallel.distributed import initialize_from_env, shutdown
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, axis_index, build_mesh
from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply
a = json.loads(sys.argv[1])
info = initialize_from_env(device="cpu", timeout_s=120)
mesh = build_mesh(MeshConfig(data=1, pipeline=2), device_type="cpu")
s = axis_index(mesh, "pipeline")
g = np.load(a["inputs"])
per = g["w"].shape[0] // 2
w = torch.from_numpy(g["w"][s * per:(s + 1) * per].copy()).requires_grad_(True)
x = torch.from_numpy(g["x"]).requires_grad_(True)
out = {}
for n_micro in (2, 4):
    c.reset_counts()
    y = pipeline_apply(lambda layer, h: torch.tanh(h @ layer["w"]), {"w": w},
                       x, mesh, n_micro=n_micro)
    (y * torch.from_numpy(g["c"])).sum().backward()
    out[f"y/{n_micro}"] = y.detach().numpy()
    out[f"dw/{n_micro}"] = w.grad.numpy().copy()
    out[f"dx/{n_micro}"] = x.grad.numpy().copy()
    out[f"permutes/{n_micro}"] = np.array(c.CALLS["ppermute"])
    w.grad, x.grad = None, None
np.savez(a["out"] + f".{info.process_id}", **out)
shutdown()
"""

L_TOY, B_TOY, D_TOY = 4, 8, 16


@pytest.fixture(scope="module")
def apply_gang(tmp_path_factory):
    rng = np.random.default_rng(3)
    inputs = {"w": (rng.standard_normal((L_TOY, D_TOY, D_TOY)) * 0.3
                    ).astype(np.float32),
              "x": rng.standard_normal((B_TOY, D_TOY)).astype(np.float32),
              "c": rng.standard_normal((B_TOY, D_TOY)).astype(np.float32)}
    root = tmp_path_factory.mktemp("gpipe")
    np.savez(root / "inputs.npz", **inputs)
    _run_gang(APPLY_WORKER, dict(inputs=str(root / "inputs.npz"),
                                 out=str(root / "out")), 2)
    return inputs, [dict(np.load(f"{root / 'out'}.{i}.npz"))
                    for i in range(2)]


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_apply_matches_jax(apply_gang, n_micro):
    inputs, ranks = apply_gang
    mesh = jbuild_mesh(JMeshConfig(data=1, pipeline=2),
                       devices=jax.devices()[:2])
    w, x, c = (jnp.asarray(inputs[n]) for n in "wxc")

    def run(w, x):
        return jpipeline_apply(lambda lw, h: jnp.tanh(h @ lw), w, x, mesh,
                               n_micro=n_micro)

    def both(w, x):
        y, vjp = jax.vjp(run, w, x)
        return y, vjp(c)

    with mesh:
        y, (dw, dx) = jax.jit(both)(w, x)
    per = L_TOY // 2
    for s, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"y/{n_micro}"], np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[f"dw/{n_micro}"],
                                   np.asarray(dw)[s * per:(s + 1) * per],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[f"dx/{n_micro}"], np.asarray(dx),
                                   rtol=1e-5, atol=1e-5)
        # n_micro + S - 1 steps, one permute each, forward and backward.
        assert int(got[f"permutes/{n_micro}"]) == 2 * (n_micro + 1)


# ---------------------------------------------------------------------------
# The trainer over sequence and pipeline
# ---------------------------------------------------------------------------

STEPS = 2

TRAIN_WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.models import transformer
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.distributed import initialize_from_env, shutdown
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, MeshConfig,
    axis_index, axis_size, build_mesh)
from kubeflow_tpu_torch.train import checkpoint, data, trainer
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
a = json.loads(sys.argv[1])
if a["no_offset"]:  # each rank's rotary positions from 0: a wrong model
    transformer._rope_table = lambda cfg, tokens, mesh: \\
        transformer.rotary_frequencies(cfg.head_dim, tokens.shape[1],
                                       theta=cfg.rope_theta)
info = initialize_from_env(device="cpu", timeout_s=120)
mesh = build_mesh(MeshConfig(**a["mesh"]), device_type="cpu")
model = get_model(a["model"], dtype=torch.float32, **a["overrides"])
opt_cfg = OptimizerConfig(**a["optimizer"])
ckpt = checkpoint.Checkpointer(a["dir"], opt_cfg, async_saves=False)
state = trainer.init_state(torch.Generator().manual_seed(1), model,
                           opt_cfg, mesh, device="cpu")
state, _ = ckpt.restore_latest(state)
step_fn = trainer.build_train_step(model, opt_cfg, mesh)
r, n = axis_index(mesh, BATCH_AXES), axis_size(mesh, BATCH_AXES)
batches = np.load(a["batches"])
metrics, counts = [], []
for i in range(a["steps"]):
    b = data.local_rows({k: batches[f"{k}/{i}"] for k in ("inputs", "targets")},
                        r, n)
    if model.config.context_parallel:
        b = data.local_tokens(b, axis_index(mesh, "sequence"),
                              axis_size(mesh, "sequence"))
    counts.append(int((b["targets"] >= 0).sum()))
    state, met = step_fn(state, data.place_batch(b, torch.device("cpu")))
    metrics.append({k: float(v) for k, v in met.items()})
ckpt.save(a["steps"], state)
ckpt.close()
with open(a["out"] + f".{info.process_id}", "w") as f:
    json.dump({"metrics": metrics, "counts": counts,
               "wq": list(state.params["layers"]["attn"]["wq"].shape)}, f)
shutdown()
"""

WIDE = dict(d_model=128, d_ff=256)
CP = dict(WIDE, context_parallel=True)
PP = dict(WIDE, pipeline_stages=2, pipeline_microbatches=2)
# JAX's init_state cannot shard adafactor's (1,) placeholder of a norm
# leaf's factored moment over pipeline; the pipeline cases train with
# sgd's momentum, sharded on the layer dim like its leaf.
CASES = {
    "sequence2": dict(mesh={"sequence": 2}, overrides=CP),
    "data2xsequence2": dict(mesh={"data": 2, "sequence": 2}, overrides=CP),
    "pipeline2": dict(mesh={"pipeline": 2}, overrides=PP, opt="sgd"),
    "data2xpipeline2": dict(mesh={"data": 2, "pipeline": 2}, overrides=PP,
                            opt="sgd"),
    "pipeline2xtensor2": dict(mesh={"pipeline": 2, "tensor": 2},
                              overrides=PP, opt="sgd"),
    "pipeline2-remat-llm": dict(mesh={"pipeline": 2}, overrides=dict(
        PP, remat=True, remat_policy="llm"), opt="sgd"),
    "moe-sequence2": dict(model="moe-test-tiny", mesh={"sequence": 2},
                          overrides=dict(context_parallel=True,
                                         expert_capacity_factor=0.5)),
}


def _batches(vocab, rows):
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(200 + i)
        tokens = rng.integers(0, vocab, (rows, 17), np.int32)
        targets = np.where(rng.random((rows, 16)) < 0.25, -1,
                           tokens[:, 1:]).astype(np.int32)
        out.append({"inputs": tokens[:, :-1], "targets": targets})
    return out


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _train_gang(tmp_path, case: str, no_offset: bool = False):
    """(JAX's metrics, JAX's final state, the gang's ranks, the gang's
    final state)."""
    spec = CASES[case]
    name = spec.get("model", "lm-test-tiny")
    w = int(np.prod(list(spec["mesh"].values())))
    jm = jregistry.get_model(name, dtype=jnp.float32, **spec["overrides"])
    opt = dict(name=spec.get("opt", "adafactor"), learning_rate=1e-2,
               warmup_steps=1, total_steps=10)
    jcfg, tcfg = joptim.OptimizerConfig(**opt), toptim.OptimizerConfig(**opt)
    batches = _batches(jm.config.vocab_size, 4 * spec["mesh"].get("data", 1))
    jmesh = jbuild_mesh(JMeshConfig(**spec["mesh"]),
                        devices=jax.devices()[:w])
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg, jmesh)
    start = _jax_flat(jstate)
    jstep = jtrainer.build_train_step(jm, jcfg, jmesh)
    jmets = []
    for b in batches:
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jmets.append({k: float(v) for k, v in jmet.items()})
    ckpt_dir = str(tmp_path / "ckpt")
    tcheckpoint.save(ckpt_dir, 0, weights.state_from_numpy(
        start, tcfg, device="cpu"), tcfg)
    np.savez(tmp_path / "batches.npz", **{
        f"{k}/{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    _run_gang(TRAIN_WORKER, dict(
        model=name, overrides=spec["overrides"], mesh=spec["mesh"],
        optimizer=opt, dir=ckpt_dir, batches=str(tmp_path / "batches.npz"),
        steps=STEPS, out=str(tmp_path / "out"), no_offset=no_offset), w)
    ranks = [json.load(open(f"{tmp_path / 'out'}.{i}")) for i in range(w)]
    return jmets, _jax_flat(jstate), ranks, tcheckpoint._load(ckpt_dir, STEPS)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_train_steps_match_jax(case, tmp_path):
    jmets, jflat, ranks, got = _train_gang(tmp_path, case)
    for r in ranks:  # every rank reports the same global metrics
        for i, (g, want) in enumerate(zip(r["metrics"], jmets)):
            assert set(g) == set(want), i
            for key, ref in want.items():
                np.testing.assert_allclose(g[key], ref, rtol=1e-5,
                                           err_msg=f"{key} step {i}")
    assert set(got) == set(jflat)
    for path, ref in jflat.items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    mesh = CASES[case]["mesh"]
    if "sequence" in mesh:
        # the ranks of a sequence group count different targets
        assert len({tuple(r["counts"]) for r in ranks[:2]}) > 1
    if "pipeline" in mesh:
        # each stage holds its layer of the two; tensor splits wq's heads
        cols = 128 // mesh.get("tensor", 1)
        assert [r["wq"] for r in ranks] == [[1, 128, cols]] * len(ranks)


def test_sequence_gang_needs_each_ranks_rotary_offset(tmp_path):
    """Rotary positions from 0 on every rank is a different model: its
    losses leave JAX's by more than the tolerance the gang with the
    offset keeps (a rank's own chunk attends alike, the rotation being
    relative; its earlier chunks' keys sit at the wrong distance)."""
    jmets, _jflat, ranks, _got = _train_gang(tmp_path, "sequence2",
                                             no_offset=True)
    got = [m["loss"] for m in ranks[0]["metrics"]]
    want = [m["loss"] for m in jmets]
    assert not np.allclose(got, want, rtol=1e-5, atol=0), (got, want)
