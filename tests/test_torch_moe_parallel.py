"""The mixture of experts over every mesh axis, and BERT and ResNet over
the model axes, against the JAX package.

Training: gangs of 2-4 CPU processes over gloo run the port's trainer
(``init_state``/``build_train_step`` with a ``DeviceMesh`` built from the
JaxJob environment, ``parallel.launch``) from the JAX initial state, handed
across as a checkpoint, for two steps on their ranks' rows of seeded
global batches, and end with a checkpoint of the whole state written by
rank 0. JAX runs ``build_train_step`` on ``build_mesh(MeshConfig(...),
devices=jax.devices()[:W])`` over the same global batches, and the port's
single process runs them too. The cases:

- ``moe-test-tiny`` (widths raised so adafactor factors the expert
  leaves, ``[L, E, D, F]`` on D and F) over data, fsdp, expert, tensor,
  data x expert, expert x tensor and fsdp x expert, at a capacity factor
  of 0.5: every
  expert overflows in the global batch, so a gang that took the capacity
  or the queue positions from its own rows, or counted the aux loss once a
  rank, leaves JAX's function; each case asserts that choices dropped;
- ``lm-test-tiny`` over expert (every leaf replicated there);
- ``bert-test-tiny`` over tensor and data x tensor (Megatron's layer, the
  vocabulary-split embedding and tied MLM head), with sgd as
  ``tests/test_torch_distributed_train.py`` trains BERT;
- ``resnet-test-tiny`` over tensor (nothing split; sync-BN over the batch
  axes only), with sgd: a batch norm's bias whose gradient is near zero
  takes a first adafactor step whose sign is the rounding's.

Serving: the MoE decoder at tp 1, 2 and 4 (every shard on the host)
against JAX's ``ContinuousDecoder`` at tp 1 and 2 on ``moe-test-tiny`` at
f32: greedy streams on the paged and dense layouts, a tp=2 -> tp=1
handoff and a live push.

Tolerances are ``tests/test_torch_distributed_train.py``'s: metrics to
1e-5 relative each step; parameters and optimizer slots to 1e-4 relative
and 1e-5 absolute. Greedy tokens must be identical. Each gang runs under a
120 s limit (and a 120 s process-group timeout). The training cases run
as jobs of gangs that stay up across cases, one per size, while JAX's
steps and the port's single process run in the test's process
(``tests/_torch_gang.py``).
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
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.parallel.launch import launch  # noqa: E402
from kubeflow_tpu_torch.serving import handoff as thandoff  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
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
STEPS = 2
GANG_TIMEOUT_S = 120

# One job of a gang's rank: restore the step-0 state the test wrote,
# train STEPS steps on this rank's rows counting the MoE choices dropped
# past capacity, save the whole state; every rank writes its metrics.
JOB = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.models.transformer import count_dropped
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
    step_fn = trainer.build_train_step(model, opt_cfg, mesh)
    r, n = axis_index(mesh, BATCH_AXES), axis_size(mesh, BATCH_AXES)
    batches = np.load(a["batches"])
    metrics, counts, dropped = [], [], 0
    for i in range(a["steps"]):
        b = data.local_rows({k: batches[f"{k}/{i}"] for k in a["keys"]},
                            r, n)
        counts.append(int(sum((v >= 0).sum() for k, v in b.items()
                              if k in ("targets", "mlm_labels"))))
        with count_dropped() as drops:
            state, met = step_fn(state,
                                 data.place_batch(b, torch.device("cpu")))
        dropped += int(sum(drops))
        metrics.append({k: float(v) for k, v in met.items()})
    ckpt.save(a["steps"], state)
    ckpt.close()
    with open(a["out"] + f".{info.process_id}", "w") as f:
        json.dump({"metrics": metrics, "counts": counts, "dropped": dropped,
                   "param_shapes": {k: list(v.shape) for k, v in
                                    flatten(state.params).items()}}, f)
    destroy_mesh(mesh)
"""

# adafactor factors a leaf whose two largest axes are both >= 128; a
# capacity factor at which every expert overflows in the global batch.
MOE = dict(d_model=128, d_ff=256, expert_capacity_factor=0.5)
WIDE = dict(d_model=128, d_ff=256)

CASES = {
    "moe-data2": dict(model="moe-test-tiny", overrides=MOE,
                      mesh={"data": 2}, opt="adafactor"),
    "moe-fsdp2": dict(model="moe-test-tiny", overrides=MOE,
                      mesh={"fsdp": 2}, opt="adafactor"),
    "moe-expert2": dict(model="moe-test-tiny", overrides=MOE,
                        mesh={"expert": 2}, opt="adafactor"),
    "moe-tensor2": dict(model="moe-test-tiny", overrides=MOE,
                        mesh={"tensor": 2}, opt="adafactor"),
    "moe-data2xexpert2": dict(model="moe-test-tiny", overrides=MOE,
                              mesh={"data": 2, "expert": 2},
                              opt="adafactor"),
    "moe-expert2xtensor2": dict(model="moe-test-tiny", overrides=MOE,
                                mesh={"expert": 2, "tensor": 2},
                                opt="adafactor"),
    "moe-fsdp2xexpert2": dict(model="moe-test-tiny", overrides=MOE,
                              mesh={"fsdp": 2, "expert": 2},
                              opt="adafactor"),
    "transformer-expert2": dict(model="lm-test-tiny", overrides=WIDE,
                                mesh={"expert": 2}, opt="adafactor"),
    "bert-tensor2": dict(model="bert-test-tiny", overrides={},
                         mesh={"tensor": 2}, opt="sgd"),
    "bert-data2xtensor2": dict(model="bert-test-tiny", overrides={},
                               mesh={"data": 2, "tensor": 2}, opt="sgd"),
    "resnet-tensor2": dict(model="resnet-test-tiny", overrides={},
                           mesh={"tensor": 2}, opt="sgd"),
}

# The leaf each case splits over a model axis, and its shape on a rank.
SPLIT = {
    "moe-expert2": ("layers/mlp/gate", [2, 2, 128, 256]),
    "moe-tensor2": ("layers/mlp/down", [2, 4, 128, 128]),
    "moe-data2xexpert2": ("layers/mlp/up", [2, 2, 128, 256]),
    "moe-expert2xtensor2": ("layers/mlp/gate", [2, 2, 128, 128]),
    "moe-fsdp2xexpert2": ("layers/mlp/down", [2, 2, 256, 64]),
    "bert-tensor2": ("layers/mlp/wi", [2, 64, 64]),
    "bert-data2xtensor2": ("embed/word", [128, 64]),
}


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


@pytest.fixture(scope="module")
def gangs():
    pool = GangPool(JOB, ROOT)
    yield pool
    pool.close()


@pytest.mark.parametrize("case", list(CASES))
def test_model_axes_train_steps_match_jax(case, tmp_path, gangs):
    spec = CASES[case]
    w = _ranks(spec["mesh"])
    jm = jregistry.get_model(spec["model"], dtype=jnp.float32,
                             **spec["overrides"])
    tm = tregistry.get_model(spec["model"], dtype=torch.float32,
                             **spec["overrides"])
    # No warmup: the first update moves the state (the biases that start
    # at zero among it), so the second step's forward reads moved leaves.
    opt = dict(name=spec["opt"], learning_rate=1e-2, warmup_steps=0,
               total_steps=10)
    jcfg, tcfg = joptim.OptimizerConfig(**opt), toptim.OptimizerConfig(**opt)
    batches = [_global_batch(tm, 2 * w, 100 + i) for i in range(STEPS)]

    # JAX's initial state, which the port's gang starts from.
    jmesh = jbuild_mesh(JMeshConfig(**spec["mesh"]),
                        devices=jax.devices()[:w])
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
                steps=STEPS, out=str(tmp_path / "out"))
    gang = gangs.get(w)
    gang.submit(args)

    # The port's single process over the same global batches, beside
    # JAX's steps.
    single = in_background(
        single_process, tm, tcfg, start, batches, 1,
        (spec["model"], json.dumps(spec["overrides"], sort_keys=True),
         json.dumps(opt, sort_keys=True), 1))

    # JAX: the mesh step over the global batches.
    jstep = jtrainer.build_train_step(jm, jcfg, jmesh)
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

    # The steps moved a matrix past the state tolerance, so a gang that
    # skipped or garbled an update fails the comparisons above.
    for path in ("params/layers/attn/wq", "params/stem/conv"):
        if path in got:
            moved = np.abs(got[path] - start[path]) / (
                1e-5 + 1e-4 * np.abs(start[path]))
            assert moved.max() > 1
    if getattr(tm.config, "n_experts", 0):
        assert "router_aux_loss" in jmets[0]
        # experts overflowed in the global batch
        assert sum(r["dropped"] for r in ranks) > 0
    if case in SPLIT:
        path, shape = SPLIT[case]
        assert all(r["param_shapes"][path] == shape for r in ranks)
    batch_ranks = w // (spec["mesh"].get("tensor", 1)
                        * spec["mesh"].get("expert", 1))
    if tm.family != "resnet" and batch_ranks > 1:
        # ranks count different valid targets
        assert len({tuple(r["counts"]) for r in ranks}) > 1
    if batch_ranks < w:  # a model-axis group holds the same rows
        assert len({tuple(r["counts"]) for r in ranks[:2]}) == 1
    if tm.family == "resnet":  # sync-BN moved the running statistics
        mean = "params/stem/bn/mean"
        assert np.abs(got[mean] - start[mean]).max() > 0


# ---------------------------------------------------------------------------
# Serving: the MoE decoder over tensor shards
# ---------------------------------------------------------------------------

PROBES = [[5, 11, 7, 3, 13, 2, 17, 9, 4, 6, 19, 8, 23, 29], [1, 2, 3],
          [9] * 9, list(range(4, 20))]


@pytest.fixture(scope="module")
def moe_tp():
    # 4 kv heads so the tp=4 leg shards evenly; f32 so greedy is
    # identical across mesh shapes.
    spec = jregistry.get_model("moe-test-tiny", n_kv_heads=4,
                               dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tcfg = ttransformer.config("moe-test-tiny", n_kv_heads=4,
                               dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return spec, jparams, tcfg, weights.params_from_numpy(tree, tcfg, "cpu")


def _kw(kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prefill_len", 32)
    kw.setdefault("max_new_tokens", 16)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("stream_timeout_s", 120.0)
    return kw


def _decoder(moe_tp, tp=1, params=None, **kw):
    _spec, _jparams, tcfg, whole = moe_tp
    return ContinuousDecoder(whole if params is None else params, tcfg,
                             tp_shards=tp, tp_devices=["cpu"] * tp,
                             **_kw(kw))


def _probe(d):
    return [d.generate(p, 6, timeout=120)["tokens"] for p in PROBES]


def _streams(make):
    d = make()
    try:
        return _probe(d), d.metrics()
    finally:
        d.stop()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_moe_greedy_streams_equal_across_meshes_and_jax(moe_tp, layout):
    """The port's MoE decoder at tp 1, 2 and 4 and JAX's at tp 1 and 2
    emit the same greedy tokens; a shard holds every expert and its
    d_ff columns."""
    spec, jparams, _tcfg, _params = moe_tp
    ref, _ = _streams(lambda: JaxDecoder(jparams, spec.config, tp_shards=1,
                                         **_kw(dict(kv_layout=layout))))
    jax2, _ = _streams(lambda: JaxDecoder(jparams, spec.config, tp_shards=2,
                                          **_kw(dict(kv_layout=layout))))
    assert jax2 == ref
    for tp in (1, 2, 4):
        got, m = _streams(lambda: _decoder(moe_tp, tp, kv_layout=layout))
        assert got == ref, f"port tp={tp}"
        assert m["tp_shards"] == tp
    d = _decoder(moe_tp, 2, kv_layout=layout)
    try:
        gate = d.params[1]["layers"]["mlp"]["gate"]
    finally:
        d.stop()
    assert tuple(gate.shape) == (2, 4, 64, 64)


def test_moe_handoff_and_push_across_mesh_shapes(moe_tp):
    """A tp=2 export imports into a tp=1 replica and decodes as a
    colocated one; a live push of a whole tree into a tp=2 replica is cut
    on the experts' d_ff dim, and its streams equal a tp=1 replica cold
    started on the new weights."""
    spec, _jparams, tcfg, _params = moe_tp
    prompt = PROBES[0] + [31]
    kw = dict(prefix_cache_slots=4, prefix_cache_min_len=4)
    colo = _decoder(moe_tp, 1, **kw)
    try:
        ref = colo.generate(prompt, 6, timeout=120)["tokens"]
    finally:
        colo.stop()
    exp, imp = _decoder(moe_tp, 2, **kw), _decoder(moe_tp, 1, **kw)
    try:
        handoff = exp.export_prompt(prompt)
        assert handoff["tp_shards"] == 2
        assert imp.import_prompt(thandoff.unpack(json.loads(json.dumps(
            thandoff.pack(handoff)))))
        assert imp.generate(prompt, 6, timeout=120)["tokens"] == ref
        assert imp.metrics()["kv_handoff_imports"] == 1
    finally:
        exp.stop()
        imp.stop()

    new = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(1),
                                             spec.config))
    cold_ref, _ = _streams(lambda: ContinuousDecoder(
        weights.params_from_numpy(new, tcfg, "cpu"), tcfg, **_kw({})))
    d = _decoder(moe_tp, 2)
    try:
        before = _probe(d)
        assert d.update_weights(new) == 1
        assert _probe(d) == cold_ref != before
        whole, version = d.weights_snapshot()
        assert version == 1
        np.testing.assert_array_equal(
            whole["layers"]["mlp"]["down"].numpy(),
            new["layers"]["mlp"]["down"])
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# An expert leaf over three axes; the loop and the CLI
# ---------------------------------------------------------------------------

# Eight ranks, expert x fsdp x tensor = 2 x 2 x 2: each cuts a seeded
# [L, E, D, F] leaf by the MoE rule, joins it back, and takes the leaf's
# means over D and F and over every element from its shard.
SHARD_WORKER = """
import json, sys
import torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.models.transformer import config, partition_rules
from kubeflow_tpu_torch.parallel.distributed import initialize_from_env, shutdown
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.parallel.sharding import (ShardedLeaf, dim_shards,
    shard, spec_for_path, unshard)
info = initialize_from_env(device="cpu", timeout_s=120)
mesh = build_mesh(MeshConfig(data=1, expert=2, fsdp=2, tensor=2),
                  device_type="cpu")
full = torch.randn((2, 4, 6, 10), generator=torch.Generator().manual_seed(0))
spec = spec_for_path("layers/mlp/gate",
                     partition_rules(config("moe-test-tiny")))
local = shard(full, spec, mesh)
leaf = ShardedLeaf(tuple(full.shape), tuple(dim_shards(full.shape, spec,
                                                       mesh)), mesh)
out = {"spec": list(spec), "local": list(local.shape),
       "round_trip": bool(torch.equal(unshard(local, spec, mesh,
                                              full.shape), full)),
       "mean_d": float((leaf.mean(local, 2) - full.mean(2)).abs().max()),
       "mean_f": float((leaf.mean(local, 3) - full.mean(3)).abs().max()),
       "mean_all": float((leaf.mean_all(local) - full.mean()).abs())}
with open(sys.argv[1] + f".{info.process_id}", "w") as f:
    json.dump(out, f)
shutdown()
"""


def test_expert_leaf_shards_over_three_axes(tmp_path):
    """An expert leaf ``P(None, expert, fsdp, tensor)`` at 2 x 2 x 2 is
    ``[L, E/2, D/2, F/2]`` on a rank, joins back bit for bit, and its
    means over D and F (adafactor's) and over every element span the
    shards."""
    out = str(tmp_path / "out")
    procs = launch([sys.executable, "-c", SHARD_WORKER, out], 8,
                   env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
                   timeout=GANG_TIMEOUT_S)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {i}:\n{p.stderr[-3000:]}" for i, p in enumerate(procs))
    for i in range(8):
        r = json.load(open(f"{out}.{i}"))
        assert r["spec"] == [None, "expert", "fsdp", "tensor"]
        assert r["local"] == [2, 2, 3, 5] and r["round_trip"]
        assert max(r["mean_d"], r["mean_f"], r["mean_all"]) < 1e-6


@pytest.mark.parametrize("mesh", [{"expert": 2}, {"data": 2},
                                  {"tensor": 2}],
                         ids=["expert2", "data2", "tensor2"])
def test_moe_gang_trains_through_the_loop(mesh):
    """``python -m kubeflow_tpu_torch.train.loop`` as a user starts it, in
    a gang of two with ``"mesh"``: every rank finishes, process 0 logs
    the router aux loss and the result's step."""
    cfg = dict(model="moe-test-tiny", batch_size=2, seq_len=16, steps=2,
               log_every=1, device="cpu", mesh=mesh)
    procs = launch([sys.executable, "-m", "kubeflow_tpu_torch.train.loop",
                    json.dumps(cfg)], 2,
                   env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
                   timeout=GANG_TIMEOUT_S)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {i}:\n{p.stderr[-3000:]}" for i, p in enumerate(procs))
    assert "router_aux_loss=" in procs[0].stdout
    assert json.loads(procs[0].stdout.strip().splitlines()[-1])["step"] == 2


def test_cli_serves_moe_over_tensor_shards(monkeypatch):
    """``--tp-shards 2 --model-name moe-test-tiny --device cpu`` serves a
    request, both shards on the host."""
    import http.client

    from kubeflow_tpu_torch.serving import __main__ as cli
    from kubeflow_tpu_torch.serving.server import ModelServer

    seen = {}

    def serve_once(self):
        self.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=60)
            conn.request("POST", "/v1/models/moe-test-tiny:predict",
                         body=json.dumps({"instances": [
                             {"tokens": [1, 2, 3], "max_new_tokens": 4}]}))
            seen["predict"] = json.loads(conn.getresponse().read())
            conn.close()
            seen["shards"] = self.decoder.tp_shards
        finally:
            self.stop()

    monkeypatch.setattr(ModelServer, "serve_forever", serve_once)
    assert cli.main(["--model-name", "moe-test-tiny", "--device", "cpu",
                     "--grpc-port", "-1", "--rest-port", "0",
                     "--max-seq-len", "16", "--kv-layout", "paged",
                     "--kv-block-size", "8", "--tp-shards", "2"]) == 0
    assert len(seen["predict"]["predictions"][0]["tokens"]) == 4
    assert seen["shards"] == 2
