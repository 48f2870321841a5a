"""The port's flash attention against the JAX package's, on the CPU.

The same numpy q/k/v (and output cotangent) go through JAX's
``flash_attention`` with ``jax.grad`` and the port's with
``torch.autograd``, for every implementation name. Off the TPU, JAX routes
``"splash"``/``"pallas"`` to its blockwise ``_flash`` path, and on CPU
tensors the port runs the plain versions of its CUDA kernels, so these
tests pin the plain versions (and the ``_FlashAttention`` function around
them) to the reference; the kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda.py``).

Tolerance: float32 on both sides, sums in another order, so values and
gradients agree to 2e-5 relative and absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import attention as jattn  # noqa: E402
from kubeflow_tpu_torch import kernels  # noqa: E402
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402

TOL = 2e-5
IMPLEMENTATIONS = [None, "splash", "pallas", "xla", "plain"]


def _inputs(b, t, s_len, hq, hkv, d, masked_row: bool, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, hq, d).astype(np.float32)
    k = rng.randn(b, s_len, hkv, d).astype(np.float32)
    v = rng.randn(b, s_len, hkv, d).astype(np.float32)
    g = rng.randn(b, t, hq, d).astype(np.float32)
    mask = None
    if masked_row:
        mask = rng.rand(b, s_len) > 0.3
        mask[0, :] = False  # batch row 0 attends nothing: its rows are 0
    return q, k, v, g, mask


def _jax(q, k, v, g, mask, **kw):
    def f(q, k, v):
        out = jattn.flash_attention(
            q, k, v, kv_mask=None if mask is None else jnp.asarray(mask),
            **kw)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out, *grads)]


def _torch(q, k, v, g, mask, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = tattn.flash_attention(
        qt, kt, vt, kv_mask=None if mask is None else torch.from_numpy(mask),
        **kw)
    out.backward(torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("implementation", IMPLEMENTATIONS)
@pytest.mark.parametrize("causal,masked_row", [(True, False), (False, False),
                                               (False, True), (True, True)])
@pytest.mark.parametrize("hkv", [2, 4], ids=["G2", "G1"])
def test_flash_attention_matches_jax(implementation, causal, masked_row,
                                     hkv):
    """Values and q/k/v gradients; S = 12 is not a multiple of block_k = 5
    (one block, as in JAX) and 12 of the default block either."""
    q, k, v, g, mask = _inputs(2, 12, 12, 4, hkv, 16, masked_row)
    kw = dict(causal=causal, implementation=implementation, block_k=5)
    ref = _jax(q, k, v, g, mask, **kw)
    out = _torch(q, k, v, g, mask, **kw)
    for name, a, r in zip(("out", "dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL, err_msg=name)
    if masked_row:
        assert not out[0][0].any() and not out[1][0].any()


@pytest.mark.parametrize("block_k", [4, 8, None])
def test_flash_blockwise_walk_matches_jax_with_several_blocks(block_k):
    """S = 16 split into 4 or 2 kv blocks (or one), T != S: the online
    softmax across blocks and the top-left causal alignment."""
    q, k, v, g, mask = _inputs(1, 10, 16, 4, 2, 8, masked_row=False, seed=3)
    kw = dict(causal=True, implementation="xla", block_k=block_k)
    for a, r in zip(_torch(q, k, v, g, mask, **kw),
                    _jax(q, k, v, g, mask, **kw)):
        np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL)


def test_flash_lse_matches_jax_and_masks_to_minus_1e30():
    q, k, v, _g, mask = _inputs(2, 6, 6, 2, 1, 8, masked_row=True, seed=4)
    kvm_j = jnp.repeat(jnp.asarray(mask, jnp.float32)[:, None], 1,
                       axis=1).reshape(2, 6, 1)
    fold = (lambda x: x.transpose(0, 2, 1, 3).reshape(2, 1, 2, 6, 8))
    ref_out, ref_lse = jattn._flash_fwd_xla(
        jnp.asarray(fold(q)).reshape(2, 2, 6, 8),
        jnp.asarray(k[:, :, 0]), jnp.asarray(v[:, :, 0]), kvm_j,
        causal=True, scale=8 ** -0.5, block_k=6)
    out, lse = tattn._flash_fwd_plain(
        torch.from_numpy(fold(q)).reshape(2, 2, 6, 8),
        torch.from_numpy(k[:, :, 0]), torch.from_numpy(v[:, :, 0]),
        torch.from_numpy(np.array(kvm_j)), causal=True, scale=8 ** -0.5,
        block_k=6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)
    assert (lse[0] == -1e30).all()


def test_flash_attention_bf16_keeps_dtype():
    q, k, v, _g, _m = _inputs(1, 8, 8, 2, 1, 8, masked_row=False)
    out = tattn.flash_attention(*(torch.from_numpy(x).bfloat16()
                                  for x in (q, k, v)))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_flash_attention_on_cpu_launches_no_kernel():
    q, k, v, g, _m = _inputs(1, 8, 8, 2, 1, 8, masked_row=False)
    kernels.reset_launches()
    _torch(q, k, v, g, None, implementation="splash")
    assert kernels.LAUNCHES["flash_attention_fwd"] == 0
    assert kernels.LAUNCHES["flash_attention_bwd"] == 0


def test_flash_attention_rejects_bad_arguments():
    q, k, v, _g, _m = _inputs(1, 8, 8, 3, 2, 8, masked_row=False)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(ValueError, match="not a multiple"):
        tattn.flash_attention(*args)
    with pytest.raises(ValueError, match="unknown implementation"):
        tattn.flash_attention(args[0][:, :, :2], *args[1:],
                              implementation="ring")


def test_flash_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, g, _m = _inputs(1, 8, 8, 2, 1, 64, masked_row=False)
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_fwd(q, k, v, None, True, 0.125)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_bwd(q, k, v, None, q, lse, g, True, 0.125)
