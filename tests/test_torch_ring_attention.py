"""Ring attention over the ``sequence`` axis and the chunked-prefill ring
read, against the JAX package.

- ``parallel.ring_attention.ring_attention`` in gloo gangs of 2 and 4 CPU
  processes over ``sequence`` and of 4 over data 2 x sequence 2, causal
  and not, against JAX's ``ring_attention`` on its 8-device CPU mesh over
  the same global ``[B, H, T, D]`` inputs: each rank's chunk of the output
  and of the gradients of ``sum(out * w)`` (``w`` a seeded cotangent)
  against ``jax.grad``, within 1e-5 at f32. Each gang also checks the
  ring permute: its sends and its gradient (the permute the other way).
- ``ops.attention.ring_span_attention`` at cp 1, 2 and 4 (one process
  drives the shards) against JAX's at cp 1, 2 and 4 (a ``serving_mesh``
  of the CPU devices), within 1e-5, on rows one of which sees no key of
  the first block the ring hands one of its shards: the finite ``-1e30``
  of the fold flushes it to zero where ``-inf`` would give NaN.

Inputs come from a numpy seed. Each gang runs under a 120 s limit.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops.attention import (  # noqa: E402
    ring_span_attention as jring_span,
)
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from kubeflow_tpu.parallel.mesh import serving_mesh as jserving_mesh  # noqa: E402
from kubeflow_tpu.parallel.ring_attention import (  # noqa: E402
    reference_attention as jreference,
)
from kubeflow_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention as jring_attention,
)
from kubeflow_tpu_torch.ops.attention import ring_span_attention  # noqa: E402
from kubeflow_tpu_torch.parallel import ring_attention as tring  # noqa: E402
from kubeflow_tpu_torch.parallel.launch import launch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
B, H, T, D = 2, 2, 16, 8

# One rank: its chunk of the global inputs, the ring forward and the
# gradients of sum(out * w), causal and not; then the permute's checks.
WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.parallel import collectives as c
from kubeflow_tpu_torch.parallel.distributed import initialize_from_env, shutdown
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, MeshConfig,
    axis_index, axis_size, build_mesh)
from kubeflow_tpu_torch.parallel.ring_attention import ring_attention
a = json.loads(sys.argv[1])
info = initialize_from_env(device="cpu", timeout_s=120)
mesh = build_mesh(MeshConfig(**a["mesh"]), device_type="cpu")
rb, nb = axis_index(mesh, BATCH_AXES), axis_size(mesh, BATCH_AXES)
rs, ns = axis_index(mesh, "sequence"), axis_size(mesh, "sequence")
g = np.load(a["inputs"])
def mine(x):
    b, t = x.shape[0] // nb, x.shape[2] // ns
    return torch.from_numpy(x[rb * b:(rb + 1) * b, :, rs * t:(rs + 1) * t].copy())
out = {}
c.reset_counts()
for causal in (True, False):
    q, k, v = (mine(g[n]).requires_grad_(True) for n in "qkv")
    o = ring_attention(q, k, v, mesh, causal=causal)
    (o * mine(g["w"])).sum().backward()
    for n, t in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        out[f"{n}/{int(causal)}"] = t.detach().numpy()
calls = dict(c.CALLS)
# The permute: rank i gets rank i - shift's value; its gradient goes back.
x = torch.tensor([float(rs + 1)], requires_grad=True)
y = c.ring_permute(x * 2, mesh, "sequence", shift=1)
(y * (rs + 1)).sum().backward()
out["permuted"] = y.detach().numpy()
out["permute_grad"] = x.grad.numpy()
np.savez(a["out"] + f".{info.process_id}", **out)
json.dump({"calls": calls, "rb": rb, "rs": rs},
          open(a["out"] + f".{info.process_id}.json", "w"))
shutdown()
"""

MESHES = {"sequence2": {"sequence": 2}, "sequence4": {"sequence": 4},
          "data2xsequence2": {"data": 2, "sequence": 2}}


def _inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((B, H, T, D)).astype(np.float32)
            for n in "qkvw"}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Each mesh's gang, run once: every rank's arrays and counts."""
    inputs = _inputs()
    root = tmp_path_factory.mktemp("ring")
    np.savez(root / "inputs.npz", **inputs)
    results = {}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for name, mesh in MESHES.items():
        w = int(np.prod(list(mesh.values())))
        args = dict(mesh=mesh, inputs=str(root / "inputs.npz"),
                    out=str(root / name))
        procs = launch([sys.executable, "-c", WORKER, json.dumps(args)], w,
                       env=env, cwd=ROOT, timeout=GANG_TIMEOUT_S)
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"{name} rank {i}:\n{p.stderr[-3000:]}"
        results[name] = [
            (dict(np.load(f"{root / name}.{i}.npz")),
             json.load(open(f"{root / name}.{i}.json"))) for i in range(w)]
    return inputs, results


def _jax_ring(inputs, mesh_degrees, causal):
    """JAX's ring output and the gradients of sum(out * w)."""
    w = int(np.prod(list(mesh_degrees.values())))
    mesh = jbuild_mesh(JMeshConfig(**mesh_degrees), devices=jax.devices()[:w])
    q, k, v, cot = (jnp.asarray(inputs[n]) for n in "qkvw")

    def ring(q, k, v):
        return jring_attention(q, k, v, mesh, causal=causal)

    def both(q, k, v):
        out, vjp = jax.vjp(ring, q, k, v)
        return out, vjp(cot)

    with mesh:
        out, grads = jax.jit(both)(q, k, v)
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", list(MESHES))
def test_ring_attention_gang_matches_jax(gangs, name, causal):
    inputs, results = gangs
    mesh = MESHES[name]
    nb, ns = mesh.get("data", 1), mesh["sequence"]
    want = _jax_ring(inputs, mesh, causal)
    for arrays, meta in results[name]:
        b, t = B // nb, T // ns
        rows = slice(meta["rb"] * b, (meta["rb"] + 1) * b)
        cols = slice(meta["rs"] * t, (meta["rs"] + 1) * t)
        for key, ref in want.items():
            np.testing.assert_allclose(
                arrays[f"{key}/{int(causal)}"], ref[rows, :, cols],
                rtol=1e-5, atol=1e-5, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_permute_and_its_gradient(gangs, name):
    """The ring's traffic: n - 1 permutes of one K/V buffer a forward and
    as many a backward; a permute by +1 hands rank i rank i-1's value and
    its gradient back the other way."""
    _, results = gangs
    ns = MESHES[name]["sequence"]
    for arrays, meta in results[name]:
        rs = meta["rs"]
        # Two calls (causal and not), forward and backward each.
        assert meta["calls"]["ppermute"] == 2 * 2 * (ns - 1)
        np.testing.assert_array_equal(arrays["permuted"],
                                      [2.0 * ((rs - 1) % ns + 1)])
        # d/dx of sum over ranks j of (j + 1) * 2 * x_{j-1}: 2 (rs + 2).
        np.testing.assert_array_equal(arrays["permute_grad"],
                                      [2.0 * ((rs + 1) % ns + 1)])


def test_reference_and_one_chunk_fold_match_jax():
    inputs = _inputs()
    q, k, v = (torch.from_numpy(inputs[n]) for n in "qkv")
    for causal in (True, False):
        want = np.asarray(jreference(*(jnp.asarray(inputs[n]) for n in "qkv"),
                                     causal=causal))
        np.testing.assert_allclose(
            tring.reference_attention(q, k, v, causal=causal).numpy(), want,
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tring.ring_attention(q, k, v, None, causal=causal).numpy(), want,
            rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The chunked-prefill ring read
# ---------------------------------------------------------------------------

SPAN_B, SPAN_S, SPAN_T, SPAN_HQ, SPAN_HKV, SPAN_HD = 2, 8, 32, 4, 2, 8


def _span_inputs():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((SPAN_B, SPAN_S, SPAN_HQ, SPAN_HD), np.float32)
    k = rng.standard_normal((SPAN_B, SPAN_T, SPAN_HKV, SPAN_HD), np.float32)
    v = rng.standard_normal((SPAN_B, SPAN_T, SPAN_HKV, SPAN_HD), np.float32)
    # Row 0 at position 0: at cp 2 the second shard's queries (positions
    # 4..7) see no key of its own block (16..31), the ring's first.
    pos = np.array([0, 20], np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_ring_span_attention_matches_jax(cp):
    q, k, v, pos = _span_inputs()
    mesh = jserving_mesh(1, cp=cp, devices=jax.devices()[:cp])
    # The ring twin is a shard_map over the sequence axis alone: JAX runs
    # it under jit, as its decoder does.
    fn = jax.jit(functools.partial(jring_span, n_kv_heads=SPAN_HKV,
                                   mesh=mesh if cp > 1 else None))
    with mesh:
        want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(pos)))
    got = ring_span_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), n_kv_heads=SPAN_HKV,
        devices=[torch.device("cpu")] * cp)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ring_span_masked_first_block_stays_finite():
    """Shard 1 of cp 2 folds a wholly masked block first: with the finite
    -1e30 it folds junk at weight one and the next block flushes it; the
    result equals the one-shard fold."""
    q, k, v, pos = (torch.from_numpy(x) for x in _span_inputs())
    whole = ring_span_attention(q, k, v, pos, n_kv_heads=SPAN_HKV)
    ring = ring_span_attention(q, k, v, pos, n_kv_heads=SPAN_HKV,
                               devices=["cpu", "cpu"])
    torch.testing.assert_close(ring, whole, rtol=1e-5, atol=1e-5)
    bias = tring.span_bias(pos, SPAN_S // 2, SPAN_T // 2, SPAN_S // 2,
                           SPAN_T // 2)
    assert bool((bias[0] < -1e29).all())  # row 0's first block: no key


def test_ring_span_refuses_widths_the_ring_does_not_divide():
    q, k, v, pos = (torch.from_numpy(x) for x in _span_inputs())
    with pytest.raises(ValueError, match="must divide the 3-way"):
        ring_span_attention(q, k, v, pos, n_kv_heads=SPAN_HKV,
                            devices=["cpu"] * 3)
