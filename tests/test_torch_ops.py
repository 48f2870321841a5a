"""The port's ops against the JAX package's, on the same numpy inputs.

Paged decode attention (the plain version of the CUDA kernel), the int8
KV quantizer, RMSNorm (plain and the kernel switch) and rotary are held
against their JAX counterparts on the CPU. JAX's Pallas kernels run in
interpret mode, as the JAX package's own tests run them. The kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.models.decode as jdecode  # noqa: E402
from kubeflow_tpu.ops import attention as jattn  # noqa: E402
from kubeflow_tpu.ops import norms as jnorms  # noqa: E402
from kubeflow_tpu.ops import rotary as jrotary  # noqa: E402
from kubeflow_tpu_torch import kernels  # noqa: E402
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402
from kubeflow_tpu_torch.ops import norms as tnorms  # noqa: E402
from kubeflow_tpu_torch.ops import rotary as trotary  # noqa: E402


def _pools(quant: bool, seed: int = 7):
    """Numpy inputs of one paged decode call: sentinel entries (== N) in
    every row's tail, a parked row (pos == MB*Bs) and a row with pos < 0."""
    rng = np.random.RandomState(seed)
    n, bs, hkv, g, hd, b, mb = 9, 8, 2, 2, 16, 5, 4
    q = rng.randn(b, hkv * g, hd).astype(np.float32)
    kp = rng.randn(n, bs, hkv, hd).astype(np.float32)
    vp = rng.randn(n, bs, hkv, hd).astype(np.float32)
    table = np.full((b, mb), n, np.int32)
    table[0, :3] = [2, 5, 1]
    table[1, :2] = [0, 7]
    table[2, :4] = [3, 4, 6, 8]
    table[3, :4] = [1, 2, 3, 4]
    table[4, :1] = [5]
    pos = np.array([17, 9, 31, mb * bs, -1], np.int32)
    if quant:
        kp = {k: np.array(v) for k, v in
              jdecode._quantize_kv(jnp.asarray(kp)).items()}
        vp = {k: np.array(v) for k, v in
              jdecode._quantize_kv(jnp.asarray(vp)).items()}
    return q, kp, vp, table, pos, hkv


def _to(tree, fn):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else fn(tree)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("implementation", ["xla", "pallas"])
def test_paged_decode_plain_matches_jax(quant, implementation):
    q, kp, vp, table, pos, hkv = _pools(quant)
    kw = {"interpret": True} if implementation == "pallas" else {}
    ref = jattn.paged_decode_attention(
        jnp.asarray(q), _to(kp, jnp.asarray), _to(vp, jnp.asarray),
        jnp.asarray(table), jnp.asarray(pos), n_kv_heads=hkv,
        implementation=implementation, **kw)
    out = tattn.paged_decode_attention(
        torch.from_numpy(q), _to(kp, torch.from_numpy),
        _to(vp, torch.from_numpy), torch.from_numpy(table),
        torch.from_numpy(pos), n_kv_heads=hkv)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # The row with pos < 0 attends nothing and returns exact zeros.
    assert not out[4].any()


_SPLIT_MB = 7


def _split_pools(kv: str):
    """Numpy inputs of one paged decode call for the split arithmetic, as
    (q, k pool, v pool, table, pos, Hkv) with pools in f32 (``kv`` "bf16":
    values exact in bf16) or quantized dicts: a sentinel inside a live
    span, sentinel tails, a row whose later splits lie wholly past pos, a
    parked row (pos == MB*Bs) and a row with pos < 0."""
    rng = np.random.RandomState(11)
    n, bs, hkv, g, hd, b, mb = 40, 8, 2, 2, 16, 5, _SPLIT_MB
    q = rng.randn(b, hkv * g, hd).astype(np.float32)
    kp = rng.randn(n, bs, hkv, hd).astype(np.float32)
    vp = rng.randn(n, bs, hkv, hd).astype(np.float32)
    table = rng.permutation(n)[:b * mb].reshape(b, mb).astype(np.int32)
    pos = np.array([50, 9, mb * bs - 1, mb * bs, -1], np.int32)
    table[0, 2] = n      # sentinel inside the live span: clamps to N-1
    table[1, 2:] = n     # sentinel tail past pos
    table[4] = n         # pos < 0: attends nothing
    if kv == "bf16":
        q, kp, vp = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                     for x in (q, kp, vp))
    if kv == "int8":
        kp, vp = ({k: np.array(v) for k, v in
                   jdecode._quantize_kv(jnp.asarray(x)).items()}
                  for x in (kp, vp))
    return q, kp, vp, table, pos, hkv


_jax_paged_refs: dict = {}


def _jax_paged_ref(kv: str, implementation: str):
    """JAX's paged_decode_attention on ``_split_pools(kv)``, once per
    (kv, implementation): it does not depend on the split."""
    key = (kv, implementation)
    if key not in _jax_paged_refs:
        q, kp, vp, table, pos, hkv = _split_pools(kv)
        dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
        kw = {"interpret": True} if implementation == "pallas" else {}
        _jax_paged_refs[key] = np.asarray(jattn.paged_decode_attention(
            jnp.asarray(q), _to(kp, lambda x: jnp.asarray(x, dt)),
            _to(vp, lambda x: jnp.asarray(x, dt)), jnp.asarray(table),
            jnp.asarray(pos), n_kv_heads=hkv,
            implementation=implementation, **kw))
    return _jax_paged_refs[key]


@pytest.mark.parametrize("implementation", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("cols_per_split", [1, 2, 5, _SPLIT_MB])
def test_paged_decode_split_plain_matches_jax(cols_per_split, kv,
                                              implementation):
    """The kernel's split-and-combine arithmetic, in plain PyTorch, against
    JAX's walk (XLA, and the Pallas kernel in interpret mode), f32 math on
    the same values, within 1e-5."""
    q, kp, vp, table, pos, hkv = _split_pools(kv)
    ref = _jax_paged_ref(kv, implementation)
    b, hq, hd = q.shape
    qg = torch.from_numpy(q).reshape(b, hkv, hq // hkv, hd)
    kt, vt = _to(kp, torch.from_numpy), _to(vp, torch.from_numpy)
    if kv == "bf16":
        qg, kt, vt = qg.bfloat16(), kt.bfloat16(), vt.bfloat16()
    out = tattn._paged_decode_split_plain(
        qg, kt, vt, torch.from_numpy(table), torch.from_numpy(pos),
        hd ** -0.5, cols_per_split)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.reshape(b, hq, hd).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    assert not out[4].any()  # pos < 0 writes exact zeros


@pytest.mark.parametrize("batch,hkv,mb,sms", [
    (8, 8, 18, 132), (1, 8, 256, 132), (32, 8, 128, 132), (1, 1, 1, 132),
    (1, 1, 3, 132), (6, 4, 5, 132), (64, 8, 2048, 132), (1, 8, 4096, 132),
    (1, 1, 100_000, 132), (512, 8, 64, 132), (2, 2, 17, 8)])
def test_paged_splits_cover_the_table(batch, hkv, mb, sms):
    """The wrapper's split choice: at least one split, at least two
    columns a split where MB allows, no more columns a split than the
    kernel takes, every column covered and no split wholly past MB."""
    splits, cps = kernels.paged_splits(batch, hkv, mb, sms)
    assert 1 <= splits <= kernels.PAGED_MAX_SPLITS
    assert cps <= kernels.PAGED_MAX_COLS
    assert cps >= min(2, mb)
    assert splits * cps >= mb > (splits - 1) * cps
    pairs = batch * hkv
    if pairs < sms and mb // 2 >= -(-sms // pairs):
        assert pairs * splits >= sms  # a CTA for every SM at least


def test_paged_decode_cpu_runs_plain_and_counts_no_launch():
    q, kp, vp, table, pos, hkv = _pools(False)
    kernels.reset_launches()
    tattn.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(pos), n_kv_heads=hkv)
    assert kernels.LAUNCHES["paged_decode_attention"] == 0


def test_paged_decode_rejects_mesh_and_bad_group():
    q, kp, vp, table, pos, hkv = _pools(False)
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(pos))
    with pytest.raises(ValueError, match="not yet ported"):
        tattn.paged_decode_attention(*args, n_kv_heads=hkv, mesh=object())
    with pytest.raises(ValueError, match="not a multiple"):
        tattn.paged_decode_attention(*args, n_kv_heads=3)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never takes a CPU tensor to its kernel: the op-level
    dispatch does that, and the kernel entry points raise."""
    q, kp, vp, table, pos, hkv = _pools(False)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.paged_decode(
            torch.from_numpy(q).reshape(5, hkv, 2, 16),
            torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(pos), 0.25)
    from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_triton(torch.ones(2, 8), torch.ones(8), 1e-6)


def test_quantize_kv_codes_equal_jax():
    """Round half to even on both sides: the int8 codes are equal, the
    scales equal to f32 rounding. Exact halves are planted on purpose."""
    rng = np.random.RandomState(3)
    vals = rng.randn(3, 5, 2, 16).astype(np.float32)
    vals[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: halves to round
    vals[1, 1, 1] = 0.0                          # all-zero vector
    ref = jdecode._quantize_kv(jnp.asarray(vals))
    out = tdecode._quantize_kv(torch.from_numpy(vals))
    assert out["q"].dtype == torch.int8
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_allclose(out["scale"].numpy(),
                               np.asarray(ref["scale"]), rtol=1e-7)
    assert not out["q"][1, 1, 1].any() and out["scale"][1, 1, 1] == 0


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("implementation", [None, "kernel"])
def test_rms_norm_matches_jax(implementation):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 64) * 3).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    jimpl = None if implementation is None else "pallas"
    ref32 = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                            implementation=jimpl)
    out32 = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            eps=1e-5, implementation=implementation)
    np.testing.assert_allclose(out32.numpy(), np.asarray(ref32), rtol=1e-6,
                               atol=1e-6)
    ref16 = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            eps=1e-5, implementation=jimpl)
    out16 = tnorms.rms_norm(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w), eps=1e-5,
                            implementation=implementation)
    assert out16.dtype == torch.bfloat16
    # Within one bf16 ulp: neighbouring bit patterns (same sign).
    diff = np.abs(_bf16_bits(out16.view(torch.int16).numpy())
                  - _bf16_bits(ref16))
    assert diff.max() <= 1


def test_rms_norm_rejects_unknown_implementation():
    with pytest.raises(ValueError, match="unknown implementation"):
        tnorms.rms_norm(torch.ones(2, 4), torch.ones(4), implementation="x")


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 32).astype(np.float32)
    w, b = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    ref = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_rotary_matches_jax():
    cos_j, sin_j = jrotary.rotary_frequencies(16, 40, theta=500_000.0)
    cos_t, sin_t = trotary.rotary_frequencies(16, 40, theta=500_000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-6,
                               atol=1e-6)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    positions = rng.randint(0, 40, size=(2, 5)).astype(np.int32)
    for pos in (None, positions):
        ref = jrotary.apply_rotary(
            jnp.asarray(x), cos_j, sin_j,
            positions=None if pos is None else jnp.asarray(pos))
        out = trotary.apply_rotary(
            torch.from_numpy(x), cos_t, sin_t,
            positions=None if pos is None else torch.from_numpy(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_rms_norm_kernel_path_gradients_match_jax_vjp():
    """The kernel path's autograd Function (plain forward on the CPU, the
    closed-form backward it carries on every device) against jax.grad of
    JAX's custom-VJP kernel path, float32, within 1e-5."""
    import jax

    rng = np.random.RandomState(5)
    x = (rng.randn(3, 5, 64) * 2).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    dy = rng.randn(3, 5, 64).astype(np.float32)
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(jnorms._rms_norm_fused(a, b, 1e-5) * dy),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tnorms.rms_norm(xt, wt, eps=1e-5, implementation="kernel")
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
