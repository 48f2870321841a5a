"""The port's parallel package (``kubeflow_tpu_torch/parallel/``) against
the JAX package's: ``MeshConfig``, ``hybrid_shapes``, the rank placement
and the partition rules' specs of every leaf of each family's train state
on the same inputs, in this process; and, in gangs of 3 and 4 CPU
processes over gloo, the agreements (``global_any``, ``global_min_int``,
``barrier``), the collectives' values and gradients over named axes and
tuples of them, and the shard / unshard round trip, a dim the degree does
not divide included. Each gang runs under a 120 s limit.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel import distributed as jdistributed  # noqa: E402
from kubeflow_tpu.parallel import mesh as jmesh  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.parallel.sharding import tree_specs as jtree_specs  # noqa: E402,E501
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.parallel import distributed as tdistributed  # noqa: E402,E501
from kubeflow_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from kubeflow_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from kubeflow_tpu_torch.parallel.launch import Gang, launch  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train import trainer as ttrainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The mesh's arithmetic, in this process
# ---------------------------------------------------------------------------


def _both(fn):
    """(result or the exception's type and text) of fn(module) for JAX's
    mesh module and the port's."""
    out = []
    for module in (jmesh, tmesh):
        try:
            out.append(fn(module))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


@pytest.mark.parametrize("degrees,n", [
    (dict(data=-1, tensor=2), 8), (dict(data=3, tensor=2), 8),
    (dict(data=-1, fsdp=3), 8), (dict(data=-1, fsdp=-1), 8),
    (dict(data=2, fsdp=2), 4), (dict(fsdp=-1), 3), (dict(), 1),
], ids=["wildcard", "too-many", "indivisible", "two-wildcards",
        "data2xfsdp2", "fsdp-rest", "default-one"])
def test_mesh_config_resolve_matches_jax(degrees, n):
    jax_out, port_out = _both(lambda m: m.MeshConfig(**degrees).resolve(n))
    assert port_out == jax_out


@pytest.mark.parametrize("data,slices", [(4, 2), (3, 2), (2, 1)])
def test_hybrid_shapes_match_jax(data, slices):
    degrees = {"data": data, "pipeline": 1, "fsdp": 2, "expert": 1,
               "sequence": 1, "tensor": 2}
    jax_out, port_out = _both(lambda m: m.hybrid_shapes(degrees, slices))
    assert port_out == jax_out
    assert tmesh.MESH_AXES == jmesh.MESH_AXES


@pytest.mark.parametrize("degrees,n,slices", [
    (dict(data=2, fsdp=2), 4, None), (dict(data=4, fsdp=2), 8, None),
    (dict(data=4, fsdp=2), 8, 2), (dict(data=-1, tensor=2), 8, None),
])
def test_rank_placement_is_jax_cpu_placement(degrees, n, slices):
    """Rank r sits where JAX's CPU branch puts the r-th device."""
    devices = jax.devices()[:n]
    placed = jmesh.arrange_devices(jmesh.MeshConfig(**degrees),
                                   devices=devices, num_slices=slices)
    ids = np.vectorize(lambda d: devices.index(d))(placed)
    np.testing.assert_array_equal(
        tmesh.arrange_ranks(tmesh.MeshConfig(**degrees), n,
                            num_slices=slices), ids)


FAMILIES = [("lm-test-tiny", dict(d_model=128, d_ff=256)),
            ("moe-test-tiny", {}), ("bert-test-tiny", {}),
            ("resnet-test-tiny", {})]


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw"])
@pytest.mark.parametrize("name,overrides", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_tree_specs_match_jax_on_every_state_leaf(name, overrides, opt_name):
    """Every leaf of the train state (parameters, optimizer slots, counts)
    gets JAX's spec, by path, with the rank fallback."""
    jm = jregistry.get_model(name, **overrides)
    tm = tregistry.get_model(name, **overrides)
    jcfg = joptim.OptimizerConfig(name=opt_name)
    jstate = jax.eval_shape(lambda: jtrainer.init_state(
        jax.random.PRNGKey(0), jm, jcfg))
    want = {path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jtree_specs(jstate, jm.partition_rules(jm.config)),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}
    tcfg = toptim.OptimizerConfig(name=opt_name)
    tstate = ttrainer.init_state(torch.Generator().manual_seed(0), tm, tcfg,
                                 device="cpu")
    flat = weights.state_to_numpy(tstate, tcfg)
    got = tsharding.tree_specs({k: np.shape(v) for k, v in flat.items()},
                               tm.partition_rules(tm.config))
    assert got == want
    assert tuple(tm.batch_partition_spec(tm.config)) == tuple(
        jm.batch_partition_spec(jm.config))
    if opt_name == "adafactor" and name == "lm-test-tiny":
        # the factored moments of a sharded leaf fall back to replicated
        assert got["opt_state/1/0/v_row/layers/attn/wq"] == ()
        assert got["params/layers/attn/wq"] == (None, "fsdp", "tensor")


def test_restrict_and_shard_arithmetic():
    spec = (None, "fsdp", "tensor")
    assert tsharding.restrict(spec, tmesh.BATCH_AXES) == (None, "fsdp", None)
    assert tsharding.restrict((("data", "fsdp"), "sequence"),
                              tmesh.BATCH_AXES) == (("data", "fsdp"), None)
    last = tsharding.DimShard(1, ("fsdp",), 128, 3, 2)
    assert (last.chunk, last.valid) == (43, 42)
    assert tsharding.DimShard(0, ("fsdp",), 2, 4, 3).valid == 0


def test_local_rows_cut_the_global_batch_in_rank_order():
    tm = tregistry.get_model("bert-test-tiny")
    batch = tdata.synthetic_batch(tm, 6, 8, seed=3)
    parts = [tdata.local_rows(batch, r, 3) for r in range(3)]
    for k, v in batch.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                      v)
    stacked = {k: np.stack([v, v + 1]) for k, v in batch.items()}
    part = tdata.local_rows(stacked, 1, 3, microbatched=True)
    np.testing.assert_array_equal(part["tokens"], stacked["tokens"][:, 2:4])
    with pytest.raises(ValueError, match="does not split"):
        tdata.local_rows(batch, 0, 4)


def test_process_info_and_rendezvous_errors_match_jax():
    env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476",
           "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3",
           "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
           "MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.2:8080"}
    for environ in (env, {}):
        j = jdistributed.process_info_from_env(environ)
        t = tdistributed.process_info_from_env(environ)
        assert vars(t) == vars(j)
        assert (t.is_distributed, t.is_multislice) == \
            (j.is_distributed, j.is_multislice)
    for bad in ({"JAX_NUM_PROCESSES": "2"}, {"MEGASCALE_NUM_SLICES": "2"}):
        errors = []
        for module in (jdistributed, tdistributed):
            with pytest.raises(RuntimeError) as e:
                module.initialize_from_env(dict(bad))
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_one_process_agrees_with_itself():
    """Without a process group the agreements are local no-ops."""
    assert tdistributed.global_any(True) and not \
        tdistributed.global_any(False)
    assert tdistributed.global_min_int(7) == 7
    tdistributed.barrier()
    assert tdistributed.initialize_from_env({}).num_processes == 1


def test_mesh_checks_name_the_unported_axis():
    moe = tregistry.get_model("moe-test-tiny")  # 4 experts
    data2xexpert2 = SimpleNamespace(mesh_dim_names=tmesh.MESH_AXES,
                                    mesh=torch.zeros(2, 1, 1, 2, 1, 1))
    moe.check_mesh(moe.config, data2xexpert2)
    expert3 = SimpleNamespace(mesh_dim_names=tmesh.MESH_AXES,
                              mesh=torch.zeros(1, 1, 1, 3, 1, 1))
    with pytest.raises(ValueError, match="expert degree 3 must divide "
                       "n_experts 4"):
        moe.check_mesh(moe.config, expert3)


# ---------------------------------------------------------------------------
# Gangs: agreements, collectives, shard round trips
# ---------------------------------------------------------------------------

WORKER = """
import sys
import torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.parallel import collectives as c
from kubeflow_tpu_torch.parallel import distributed as d
from kubeflow_tpu_torch.parallel import sharding as s
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.train.trainer import StateLayout, TrainState

data, fsdp = int(sys.argv[1]), int(sys.argv[2])
info = d.initialize_from_env(device="cpu", timeout_s=120)
mesh = build_mesh(MeshConfig(data=data, fsdp=fsdp), device_type="cpu")
r, w = info.process_id, data * fsdp

def eq(a, b):
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (a, b)

# Agreements: any, min, barrier.
assert d.global_any(r == 1) and not d.global_any(False)
assert d.global_min_int(10 + (w - r)) == 11
d.barrier("x")

both = ("data", "fsdp")
# Indices and sizes; the tuple is data-major, so it is the rank.
assert c.axis_size(mesh, both) == w and c.axis_index(mesh, both) == r
assert c.axis_index(mesh, "fsdp") == r % fsdp
assert c.axis_index(mesh, "data") == r // fsdp
with torch.no_grad():
    x = torch.tensor([float(r + 1)])
    eq(c.psum(x, mesh, both), [w * (w + 1) / 2])
    eq(c.pmean(x, mesh, both), [(w + 1) / 2])
    peers = [r - r % fsdp + i for i in range(fsdp)]
    eq(c.psum(x, mesh, "fsdp"), [float(sum(p + 1 for p in peers))])
    eq(c.allreduce_mean(mesh, both)(x), [(w + 1) / 2])
    eq(c.all_gather(x, mesh, both), torch.arange(1.0, w + 1))
    eq(c.all_gather(x, mesh, both, tiled=False),
       torch.arange(1.0, w + 1)[:, None])
    m = torch.arange(2.0 * w).reshape(2, w) * (r + 1)
    eq(c.reduce_scatter(m, mesh, both, dim=1),
       torch.arange(2.0 * w).reshape(2, w)[:, r:r + 1] * w * (w + 1) / 2)
    eq(c.ring_permute(x, mesh, "data", shift=1),
       [float((r - fsdp) % w + 1)])
    eq(c.global_norm_sq([x, 2 * x], mesh, both),
       5.0 * sum((i + 1) ** 2 for i in range(w)))
    y = torch.tensor([float(r + 1), 0.0])
    c.reset_counts()
    assert c.psum_(y, mesh, both) is y  # in place
    eq(y, [w * (w + 1) / 2, 0.0])
    assert c.CALLS == {"all_reduce": 1, "all_gather": 0,
                       "reduce_scatter": 0, "ppermute": 0} \
        and c.BYTES["all_reduce"] == 8

# Gradients: each rank's loss is its term of one global loss.
x = torch.full((3,), float(r + 1), requires_grad=True)
c.psum(x * (r + 1), mesh, both).sum().backward()
eq(x.grad, torch.full((3,), float(w * (r + 1))))
x = torch.ones(2, requires_grad=True)
weights = (r + 1) * torch.arange(2.0 * w)
(c.all_gather(x, mesh, both) * weights).sum().backward()
eq(x.grad, w * (w + 1) / 2 * torch.arange(2.0 * w)[2 * r:2 * r + 2])
x = torch.ones(2 * w, requires_grad=True)
(c.reduce_scatter(x, mesh, both) * (r + 1)).sum().backward()
eq(x.grad, torch.arange(1.0, w + 1).repeat_interleave(2))

# Shard / unshard, padded where the degree does not divide the dim.
full = torch.arange(5.0 * 7).reshape(5, 7)
for spec in [(None, "fsdp"), ("data",), (None, both), ()]:
    eq(s.unshard(s.shard(full, spec, mesh), spec, mesh, full.shape), full)
local = s.shard(full, (None, both), mesh)
n = -(-7 // w)
valid = max(0, min(n, 7 - r * n))
eq(local[:, :valid], full[:, r * n:r * n + valid])
assert not local[:, valid:].any()  # the padding holds zeros

# A checkpoint's gather: the whole state on rank 0 alone.
layout = StateLayout(mesh, [s.PartitionRule("w", (None, both))],
                     {"w": full.shape})
state = layout.shard_state(TrainState(
    0, {"w": full}, {"count": 0, "mu": {"w": 2 * full}}))
whole = layout.gather_state(state)
if r == 0:
    eq(whole.params["w"], full)
    eq(whole.opt_state["mu"]["w"], 2 * full)
else:
    assert whole is None
d.shutdown()
print("ok")
"""


@pytest.mark.parametrize("data,fsdp", [(3, 1), (2, 2), (1, 3)],
                         ids=["data3", "data2xfsdp2", "fsdp3"])
def test_gang_agreements_collectives_and_shards(data, fsdp):
    procs = launch([sys.executable, "-c", WORKER, str(data), str(fsdp)],
                   data * fsdp, env=dict(os.environ, OMP_NUM_THREADS="1"),
                   cwd=ROOT, timeout=120)
    for i, p in enumerate(procs):
        assert p.returncode == 0 and p.stdout.strip() == "ok", \
            f"rank {i}:\n{p.stderr[-3000:]}"


JOB_WORKER = """
import os
from kubeflow_tpu_torch.parallel.launch import serve_jobs
rank = os.environ["JAX_PROCESS_ID"]
def run(a):
    if a.get("fail") == rank:
        raise ValueError("rank " + rank + " refuses")
    with open(a["out"] + "." + rank, "a") as f:
        f.write(str(os.getpid()) + "\\n")
serve_jobs(run)
"""


def test_gang_keeps_its_ranks_across_jobs_and_closes_on_a_failure(
        tmp_path):
    gang = Gang(2, JOB_WORKER, cwd=ROOT, grace=2.0)
    try:
        for _ in range(2):
            gang.run({"out": str(tmp_path / "a")}, timeout=60)
        pids = [(tmp_path / f"a.{i}").read_text().split() for i in range(2)]
        assert [p.pid for p in gang.procs] == [int(p[0]) for p in pids]
        assert all(len(set(p)) == 1 and len(p) == 2 for p in pids)
        with pytest.raises(RuntimeError, match="rank 1 refuses"):
            gang.run({"out": str(tmp_path / "b"), "fail": "1"}, timeout=60)
        assert not gang.alive()
    finally:
        gang.close()


@pytest.mark.parametrize("fail", [False, True])
def test_serve_jobs_publishes_each_status_whole(tmp_path, monkeypatch, fail):
    """A rank's status file appears only whole: the waiter polls for it
    and reads it at once, so an empty or partial file would read as a
    failure. Every status is written under another name and renamed."""
    import io

    from kubeflow_tpu_torch.parallel import launch as tlaunch

    real_replace, seen = os.replace, []

    def replace(src, dst):
        seen.append((os.path.exists(dst), open(src).read()))
        real_replace(src, dst)

    def run(job):
        if fail:
            raise ValueError("refused")

    monkeypatch.setattr(tlaunch.os, "replace", replace)
    monkeypatch.setenv(tlaunch.ENV_PROCESS_ID, "0")
    outs = [str(tmp_path / j) for j in "ab"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(f'{{"out": "{out}"}}\n' for out in outs)))
    tlaunch.serve_jobs(run)
    # The first failure ends the loop.
    ran = outs[:1] if fail else outs
    status = [open(f"{out}.0.done").read() for out in ran]
    assert seen == [(False, s) for s in status]
    assert all(("refused" in s) if fail else s == "ok" for s in status)
    assert sorted(os.listdir(tmp_path)) == [f"{j}.0.done" for j in "ab"[
        :len(ran)]]


# ---------------------------------------------------------------------------
# Tensor parallelism: Megatron's pair, the tensor split, the head mapping
# ---------------------------------------------------------------------------

MEGATRON_WORKER = """
import torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.parallel import collectives as c
from kubeflow_tpu_torch.parallel import distributed as d
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

info = d.initialize_from_env(device="cpu", timeout_s=120)
mesh = build_mesh(MeshConfig(data=1, tensor=2), device_type="cpu")
r, tp = info.process_id, 2
g = torch.Generator().manual_seed(0)
x = torch.randn(3, 4, generator=g, dtype=torch.float64)
w1 = torch.randn(4, 6, generator=g, dtype=torch.float64)
w2 = torch.randn(6, 4, generator=g, dtype=torch.float64)
head = torch.randn(4, 8, generator=g, dtype=torch.float64)
labels = torch.tensor([1, 7, 4])


def loss_of(h, logits):
    return (h ** 2).sum() + torch.nn.functional.cross_entropy(
        logits, labels, reduction="sum")


def grads(x, w1, w2, head, reduce, gather):
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2, head)]
    x, w1, w2, head = leaves
    h = reduce(torch.tanh(c.copy_to_tensor(x, mesh) @ w1) @ w2)
    logits = gather(c.copy_to_tensor(h, mesh) @ head)
    loss_of(h, logits).backward()
    return [t.grad for t in leaves]


# The unsharded reference, in this process.
leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2, head)]
h = torch.tanh(leaves[0] @ leaves[1]) @ leaves[2]
loss_of(h, h @ leaves[3]).backward()
ref = [t.grad for t in leaves]
cols, rows = slice(3 * r, 3 * r + 3), slice(4 * r, 4 * r + 4)
local = (x, w1[:, cols], w2[cols], head[:, rows])
want = (ref[0], ref[1][:, cols], ref[2][cols], ref[3][:, rows])

c.reset_counts()
got = grads(*local, lambda t: c.reduce_from_tensor(t, mesh),
            lambda t: c.gather_from_tensor(t, mesh))
for a, b in zip(got, want):
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
# Forward: one reduce and one gather; backward: two copies' psums.
assert c.CALLS == {"all_reduce": 3, "all_gather": 1, "reduce_scatter": 0,
                   "ppermute": 0}, \\
    c.CALLS

# psum's backward (each rank's loss its own term) hands every tensor rank
# tp x its gradient: the check above fails on it.
bad = grads(*local, lambda t: c.psum(t, mesh, "tensor"),
            lambda t: c.gather_from_tensor(t, mesh))
torch.testing.assert_close(bad[1], tp * want[1], rtol=1e-12, atol=1e-12)
assert not torch.allclose(bad[1], want[1])
d.shutdown()
print("ok")
"""


def test_megatron_pair_gives_the_unsharded_gradients():
    """copy_to_tensor / reduce_from_tensor / gather_from_tensor in a gang
    of two: a toy column-then-row-parallel block and a vocabulary-split
    head give each rank its slice of the unsharded gradients (float64,
    to 1e-12); psum in reduce_from_tensor's place gives tp x."""
    procs = launch([sys.executable, "-c", MEGATRON_WORKER], 2,
                   env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
                   timeout=120)
    for i, p in enumerate(procs):
        assert p.returncode == 0 and p.stdout.strip() == "ok", \
            f"rank {i}:\n{p.stderr[-3000:]}"


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_split_and_merge_tensor_round_trip(tp):
    """split_tensor cuts each leaf the rules put on ``tensor`` into tp
    contiguous blocks (JAX's shard of that dim) and leaves the rest
    whole; merge_tensor joins them back bit for bit."""
    tm = tregistry.get_model("lm-test-tiny", n_kv_heads=4)
    params = tm.init(tm.config, generator=torch.Generator().manual_seed(0),
                     device="cpu", param_dtype=torch.float32)
    rules = tm.partition_rules(tm.config)
    shards = tsharding.split_tensor(params, rules, tp)
    assert len(shards) == tp
    flat = weights.flatten(params)
    specs = tsharding.tree_specs(flat, rules)
    for i, shard in enumerate(shards):
        for path, leaf in weights.flatten(shard).items():
            dim = tsharding.tensor_dim(specs[path])
            if dim is None:
                assert leaf is flat[path]
                continue
            n = flat[path].shape[dim] // tp
            assert leaf.is_contiguous()
            assert torch.equal(leaf, flat[path].narrow(dim, i * n, n))
    merged = weights.flatten(tsharding.merge_tensor(shards, rules))
    assert all(torch.equal(merged[k], v) for k, v in flat.items())
    assert tsharding.tensor_dim(specs["layers/attn/wo"]) == 1
    assert tsharding.tensor_dim(specs["embed/kernel"]) == 0
    with pytest.raises(ValueError, match="not divisible"):
        tsharding.split_tensor(params, rules, 3)


def test_gqa_heads_of_a_tensor_rank_read_its_kv_heads():
    """Hq 4 over Hkv 2 at tp 2: rank r's contiguous query heads (2r,
    2r+1) belong to its contiguous KV head r (G = 2), so attention over a
    rank's heads equals those heads of the whole attention."""
    from kubeflow_tpu_torch.models.transformer import shard_config
    from kubeflow_tpu_torch.ops.attention import flash_attention

    cfg = tregistry.get_model("lm-test-tiny", n_heads=4, n_kv_heads=2,
                              dtype=torch.float32).config
    local = shard_config(cfg, 2)
    assert (local.n_heads, local.n_kv_heads, local.head_dim) == (
        2, 1, cfg.head_dim)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, 4, 8, generator=g)
    k, v = (torch.randn(2, 6, 2, 8, generator=g) for _ in range(2))
    whole = flash_attention(q, k, v, causal=True)
    for r in range(2):
        part = flash_attention(q[:, :, 2 * r:2 * r + 2], k[:, :, r:r + 1],
                               v[:, :, r:r + 1], causal=True)
        torch.testing.assert_close(part, whole[:, :, 2 * r:2 * r + 2],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        shard_config(cfg, 4)
