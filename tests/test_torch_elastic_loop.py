"""The port loop's reshard point against its restore reference and against
JAX's elastic run, on the CPU.

Each case is one gang of four gloo processes running the port's loop
twice (``parallel.launch``):

- live: from a step-0 checkpoint of JAX's initial state, on a first mesh
  of ``start`` ranks, an injected source that turns to ``target`` at the
  poll before step 3 (grow 2 -> 4 or shrink 4 -> 2; the ranks outside the
  mesh stay in the loop), 6 steps;
- the reference: the live run's checkpoints up to the reshard step, that
  step restored into a mesh of ``target`` ranks, the tail run with no
  resize.

The live run is bit for bit its reference from the reshard step on: each
step's logged loss, the final loss and every leaf of the final
checkpoint. JAX's loop runs the same elastic schedule on 8 <-> 4 virtual
CPU devices from the same state (JAX's global batch of 8 rows is each
port process's batch, which every batch rank takes whole: the mean loss
and gradient of a batch taken n times are the batch's own), and the port
is within the gang tolerance of it (``tests/test_torch_distributed_gang.py``:
losses 1e-5 relative, the final state 1e-4 relative and 1e-5 absolute).
Meshes: dp, dp x fsdp 2 and dp x tp 2, each way, and the dp shrink with
2-step gradient accumulation (the stream re-anchors in microbatches); the
grows run here, the shrinks in ``tests/test_torch_elastic_shrink.py``.
Every gang runs under a 120 s limit.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from kubeflow_tpu.train import loop as jloop  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.parallel.launch import launch  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as tcheckpoint  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
STEPS, FLIP = 6, 3
TINY = {"n_layers": 1, "d_model": 32, "d_ff": 64, "n_heads": 2,
        "n_kv_heads": 2}
OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)

# One rank: the live run, then (after rank 0 copies its checkpoints up to
# the reshard step) the restore reference; each rank's results and rank
# 0's log lines.
WORKER = """
import json, os, shutil, sys, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.parallel.distributed import (barrier,
    initialize_from_env, shutdown)
from kubeflow_tpu_torch.train import loop
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
a = json.loads(sys.argv[1])
info = initialize_from_env(device="cpu", timeout_s=120)

def cfg(ckpt_dir):
    return loop.RunConfig(
        model="lm-test-tiny", model_overrides=a["tiny"], mesh=a["mesh"],
        optimizer=OptimizerConfig(**a["opt"]), batch_size=8, seq_len=16,
        steps=a["steps"], log_every=1, prefetch=2, accum_steps=a["accum"],
        graceful_shutdown=False, checkpoint_dir=ckpt_dir,
        checkpoint_every=10 ** 9, device="cpu")

def drive(ckpt_dir, source):
    lines = []
    result = loop.run(cfg(ckpt_dir), log=lambda *x: lines.append(
        " ".join(map(str, x))), mesh_source=source)
    return {"result": result, "lines": lines}

calls = []

def source():
    calls.append(1)  # the first mesh's poll, then one a step
    return a["target"] if len(calls) > a["flip"] + 1 else a["start"]

live = drive(a["live"], source)
barrier()
if info.process_id == 0:
    shutil.copytree(a["live"], a["ref"])
    for entry in os.listdir(a["ref"]):
        if entry.isdigit() and int(entry) > a["flip"]:
            shutil.rmtree(os.path.join(a["ref"], entry))
barrier()
ref = drive(a["ref"], lambda: a["target"])
print(json.dumps({"live": live, "ref": ref}))
shutdown()
"""

MESHES = {"dp": {"data": -1}, "dp_fsdp": {"data": -1, "fsdp": 2},
          "dp_tp": {"data": -1, "tensor": 2}}
# (mesh, direction, accumulation steps); the shrinks run in
# tests/test_torch_elastic_shrink.py, so each file stays short.
GROW = {f"{m}-grow": (m, "grow", 1) for m in MESHES}
SHRINK = {f"{m}-shrink": (m, "shrink", 1) for m in MESHES}
SHRINK["dp-shrink-accum2"] = ("dp", "shrink", 2)


def _losses(lines):
    out = {}
    for line in lines:
        m = re.match(r"step=(\d+) loss=(\S+)", line)
        if m:
            out[int(m.group(1))] = m.group(2)
    return out


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _jax_elastic(jm, jopt, mesh, start, target, accum, ck_dir):
    """JAX's loop on ``start`` -> ``target`` virtual devices from the
    step-0 checkpoint in ``ck_dir``: its log lines and final state."""
    fired, lines = [], []

    def log_hook(msg):
        msg = str(msg)
        lines.append(msg)
        if re.match(rf"step={FLIP} ", msg):
            fired.append(True)

    cfg = jloop.RunConfig(
        model="lm-test-tiny", mesh=JMeshConfig(**mesh), optimizer=jopt,
        model_overrides=dict(TINY, dtype=jnp.float32), batch_size=8,
        seq_len=16, steps=STEPS, log_every=1, prefetch=2,
        accum_steps=accum, graceful_shutdown=False, checkpoint_dir=ck_dir,
        checkpoint_every=10 ** 9)
    result = jloop.run(cfg, log=log_hook,
                       mesh_source=lambda: target if fired else start)
    like = jtrainer.init_state(jax.random.PRNGKey(0), jm, jopt, None)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        x.shape, x.dtype, sharding=jax.sharding.SingleDeviceSharding(
            jax.devices()[0])), like)
    final = jcheckpoint.restore(ck_dir, STEPS, abstract)
    return result, _losses(lines), _jax_flat(final)


def check_reshard_point(mesh_kind, direction, accum, tmp_path):
    """One case: the gang's live and reference runs, JAX's elastic run."""
    mesh = MESHES[mesh_kind]
    start, target = (2, 4) if direction == "grow" else (4, 2)
    jm = jregistry.get_model("lm-test-tiny", dtype=jnp.float32, **TINY)
    jopt = joptim.OptimizerConfig(**OPT)
    topt = toptim.OptimizerConfig(**OPT)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jopt, jbuild_mesh(
        JMeshConfig(**mesh), devices=jax.devices()[:8]))
    start_flat = _jax_flat(jstate)

    # The port's gang from JAX's initial state.
    live, ref = str(tmp_path / "live"), str(tmp_path / "ref")
    tcheckpoint.save(live, 0, weights.state_from_numpy(
        start_flat, topt, device="cpu"), topt)
    procs = launch([sys.executable, "-c", WORKER, json.dumps(dict(
        mesh=mesh, start=start, target=target, flip=FLIP, accum=accum,
        steps=STEPS, tiny=dict(TINY, dtype="float32"), opt=OPT, live=live,
        ref=ref))], 4, env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
        timeout=GANG_TIMEOUT_S)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{p.stderr[-3000:]}"
    ranks = [json.loads(p.stdout.strip().splitlines()[-1]) for p in procs]

    # Live: one reshard at the flip, on every rank alike.
    r0 = ranks[0]["live"]["result"]
    assert r0["reshard_count"] == 1 and r0["step"] == STEPS
    event = r0["reshards"][0]
    assert (event["direction"], event["step"], event["method"]) == (
        direction, FLIP, "device")
    assert (event["from_devices"], event["to_devices"]) == (start, target)
    assert r0["devices"] == target
    for r in ranks:
        got = r["live"]["result"]
        assert got["loss"] == r0["loss"] and got["devices"] == target
        assert [{k: v for k, v in e.items()
                 if k not in ("seconds", "downtime_seconds")}
                for e in got["reshards"]] == [
            {k: v for k, v in e.items()
             if k not in ("seconds", "downtime_seconds")}
            for e in r0["reshards"]]

    # Bit for bit the restore-into-target reference after the flip.
    rr0 = ranks[0]["ref"]["result"]
    assert rr0["reshard_count"] == 0 and rr0["devices"] == target
    losses = _losses(ranks[0]["live"]["lines"])
    ref_losses = _losses(ranks[0]["ref"]["lines"])
    assert sorted(ref_losses) == list(range(FLIP + 1, STEPS + 1))
    for s in ref_losses:
        assert losses[s] == ref_losses[s], (s, losses, ref_losses)
    assert r0["loss"] == rr0["loss"]
    got, want = tcheckpoint._load(live, STEPS), tcheckpoint._load(ref, STEPS)
    assert set(got) == set(want)
    for path in want:
        assert np.array_equal(got[path], want[path]), path

    # Within the gang tolerance of JAX's elastic run from the same state.
    jck = str(tmp_path / "jax")
    jcheckpoint.save(jck, 0, jstate)
    jstart, jtarget = (4, 8) if direction == "grow" else (8, 4)
    jresult, jlosses, jfinal = _jax_elastic(jm, jopt, mesh, jstart, jtarget,
                                            accum, jck)
    assert jresult["reshard_count"] == 1
    assert jresult["reshards"][0]["step"] == FLIP
    np.testing.assert_allclose(r0["loss"], jresult["loss"], rtol=1e-5)
    for s in range(1, STEPS + 1):
        assert abs(float(losses[s]) - float(jlosses[s])) <= 2e-4, s
    assert set(got) == set(jfinal)
    for path, leaf in jfinal.items():
        np.testing.assert_allclose(got[path], leaf, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("case", list(GROW))
def test_reshard_point_is_the_restore_reference_and_jax_s(case, tmp_path):
    check_reshard_point(*GROW[case], tmp_path)
