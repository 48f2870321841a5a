"""The port's hand-written kernels against their plain PyTorch versions,
on a CUDA device. Every test here is marked ``cuda`` and skips on a host
without one; on the card run ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Nothing here imports JAX: the plain versions are pinned to
the JAX package by the CPU tests (``tests/test_torch_ops.py``).

Tolerances: the kernels compute in float32 like their plain versions and
differ only in the order of the sums, so the paged decode output agrees
to 2e-3 and the bf16 RMSNorm output to one bf16 ulp. The flash kernels
agree with the plain blockwise path on the same inputs to 1e-4 (f32 out)
and 1e-4 of the largest reference gradient (f32: the CUDA-core route,
which sums in another order and nothing more). bf16 runs on the tensor
cores, which round P to bf16 before P.V and dV, and dS to bf16 before dQ
and dK, as SDPA's flash kernels do; the plain path keeps them in f32.
So the bf16 limits are taken against SDPA's own error on the same inputs,
measured in the same test: out within max(1e-2, 2 x SDPA's largest
error), each gradient's largest error within 2e-2 of the largest
reference gradient, and each gradient's difference within max(2^-8, 2 x
SDPA's) of the reference's norm.
"""

import pytest

torch = pytest.importorskip("torch")

from chip_smoke import sdpa_run  # noqa: E402
from kubeflow_tpu_torch import kernels  # noqa: E402
from kubeflow_tpu_torch.models.decode import _quantize_kv  # noqa: E402
from kubeflow_tpu_torch.ops.attention import (  # noqa: E402
    _paged_decode_plain, _paged_decode_split_plain)
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402
from kubeflow_tpu_torch.ops.norms import _rms_norm_plain, rms_norm  # noqa: E402,E501


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(dev, kv, b, hkv, group, hd, bs, mb, pos, seed=0):
    """Random pools of B*MB blocks behind a permuted table, sentinel (== N)
    tails past each row's pos; returns (q, k pool, v pool, table, pos)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = b * mb
    dt = torch.float32 if kv == "f32" else torch.bfloat16
    q = torch.randn(b, hkv, group, hd, generator=g, device=dev).to(dt)

    def pool():
        p = torch.randn(n, bs, hkv, hd, generator=g, device=dev)
        return _quantize_kv(p) if kv == "int8" else p.to(dt)

    kp, vp = pool(), pool()
    table = torch.randperm(n, generator=g, device=dev).to(
        torch.int32).reshape(b, mb)
    for row, p in enumerate(pos):
        table[row, (p // bs + 1) if p >= 0 else 0:] = n
    return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32, device=dev)


def _paged_check(dev, q, kp, vp, table, pos):
    """The kernel against _paged_decode_plain and against the split
    arithmetic at the kernel's own split (_paged_decode_split_plain),
    within 2e-3; one launch. Returns the kernel's output."""
    hd = q.shape[-1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, cps = kernels.paged_splits(q.shape[0], q.shape[1], table.shape[1], sms)
    ref = _paged_decode_plain(q, kp, vp, table, pos, hd ** -0.5)
    split_ref = _paged_decode_split_plain(q, kp, vp, table, pos, hd ** -0.5,
                                          cps)
    kernels.reset_launches()
    out = kernels.paged_decode(q, kp, vp, table, pos, hd ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_attention"] == 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-3
    assert (out - split_ref).abs().max().item() <= 2e-3
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("hd,bs,group", [(128, 16, 2), (64, 8, 4),
                                         (128, 8, 1), (128, 32, 8),
                                         (64, 64, 2), (128, 64, 8),
                                         (64, 24, 3)])
def test_paged_decode_kernel_matches_plain(cuda, kv, hd, bs, group):
    b, hkv, mb = 6, 4, 5
    q, kp, vp, table, pos = _paged_case(
        cuda, kv, b, hkv, group, hd, bs, mb,
        [3 * bs + 2, 2 * bs, 4 * bs - 1, mb * bs, 0, -1])
    table[2, 0] = table.shape[0] * mb  # sentinel inside the live span
    out = _paged_check(cuda, q, kp, vp, table, pos)
    assert not out[5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_kernel_long_row(cuda, kv):
    """One row of 4096 positions (MB 256): the splits carry the row."""
    q, kp, vp, table, pos = _paged_case(cuda, kv, 1, 8, 2, 128, 16, 256,
                                        [4095])
    _paged_check(cuda, q, kp, vp, table, pos)


@pytest.mark.cuda
def test_paged_decode_kernel_more_splits_than_live_columns(cuda):
    """64 table columns give 32 splits; the rows hold 0-3 live columns,
    so most CTAs start past pos and return at once."""
    q, kp, vp, table, pos = _paged_case(cuda, "bf16", 3, 1, 4, 128, 16, 64,
                                        [20, 47, 5])
    _paged_check(cuda, q, kp, vp, table, pos)


@pytest.mark.cuda
def test_paged_decode_kernel_is_bit_identical_across_runs(cuda):
    q, kp, vp, table, pos = _paged_case(cuda, "bf16", 2, 8, 2, 128, 16, 256,
                                        [4095, 1000])
    first = kernels.paged_decode(q, kp, vp, table, pos, 128 ** -0.5)
    second = kernels.paged_decode(q, kp, vp, table, pos, 128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 1, 96, device=cuda)
    pool = torch.zeros(2, 16, 1, 96, device=cuda)
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kernels.paged_decode(q, pool, pool, table, pos, 1.0)
    q, pool = q[..., :64].contiguous(), pool[..., :64].contiguous()
    with pytest.raises(ValueError, match="int32"):
        kernels.paged_decode(q, pool, pool, table.long(), pos, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.paged_decode(q, pool[:, :8], pool[:, :8], table, pos, 1.0)
    odd = pool[:, :12].contiguous()
    with pytest.raises(ValueError, match="block size 12"):
        kernels.paged_decode(q, odd, odd, table, pos, 1.0)
    wide = torch.zeros(1, 1, 9, 64, device=cuda)
    with pytest.raises(ValueError, match="query group 9"):
        kernels.paged_decode(wide, pool, pool, table, pos, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 2048])
def test_rms_norm_kernel_matches_plain(cuda, rows):
    from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

    g = torch.Generator(device=cuda).manual_seed(0)
    x = (3 * torch.randn(rows, 2048, generator=g, device=cuda)).bfloat16()
    w = torch.randn(2048, generator=g, device=cuda)
    out = rms_norm_triton(x, w, 1e-5)
    ref = _rms_norm_plain(x, w, 1e-5)
    diff = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    assert diff.max().item() <= 1


def _flash_run(q, k, v, g, mask, implementation, causal):
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = tattn.flash_attention(*leaves, causal=causal, kv_mask=mask,
                                implementation=implementation)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,s_len,hq,hkv,hd,causal,masked", [
    (2, 128, 128, 8, 2, 128, True, False),   # G=4, tile-aligned
    (1, 100, 100, 4, 4, 64, True, False),    # G=1, ragged, hd 64
    (2, 70, 130, 4, 2, 64, False, True),     # S != T, full row masked
    (1, 130, 70, 8, 1, 128, True, True),     # T > S, causal and mask
])
def test_flash_kernels_match_plain(cuda, dtype, b, t, s_len, hq, hkv, hd,
                                   causal, masked):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rand(b, t, hq, hd), rand(b, s_len, hkv, hd), \
        rand(b, s_len, hkv, hd)
    g = rand(b, t, hq, hd)
    mask = None
    if masked:
        mask = torch.rand(b, s_len, generator=gen, device=cuda) > 0.3
        mask[0] = False  # every key of batch row 0 masked
    f32 = dtype == torch.float32
    # The plain path in f32 on the same values, and in bf16 SDPA's own
    # error against it (see the module docstring).
    ref = _flash_run(q.float(), k.float(), v.float(), g.float(), mask,
                     "xla", causal)
    out_tol = 1e-4 if f32 else max(
        1e-2, 2 * _errors(sdpa_run(q, k, v, g, mask, causal), ref)[0][0])
    kernels.reset_launches()
    for impl in ("splash", "pallas", None):
        got = _flash_run(q, k, v, g, mask, impl, causal)
        torch.cuda.synchronize()
        assert (got[0].float() - ref[0].float()).abs().max().item() <= (
            out_tol)
        for a, r in zip(got[1:], ref[1:]):
            scale = r.float().abs().max().item() or 1.0
            assert (a.float() - r.float()).abs().max().item() <= (
                (1e-4 if f32 else 2e-2) * scale)
        if masked:
            assert not got[0][0].any() and not got[1][0].any()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 3
    assert kernels.LAUNCHES["flash_attention_bwd"] == 3


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    kv = torch.zeros(1, 8, 1, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim.*implementation='xla'"):
        kernels.flash_fwd(q, kv, kv, None, True, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(q, kv, kv, implementation="splash")
    q, kv = q[..., :64].contiguous(), kv[..., :64].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kernels.flash_fwd(q[:, ::2], kv[:, ::2], kv[:, ::2], None, True, 0.1)
    with pytest.raises(ValueError, match="is on cpu"):
        kernels.flash_fwd(q, kv.cpu(), kv, None, True, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        kernels.flash_fwd(q.half(), kv.half(), kv.half(), None, True, 0.1)
    # The plain path takes what the kernel does not.
    out = tattn.flash_attention(q[..., :48], kv[..., :48], kv[..., :48],
                                implementation="xla")
    assert out.shape == (1, 8, 2, 48)


@pytest.mark.cuda
def test_rms_norm_kernel_path_propagates_gradients(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 2048, generator=g, device=cuda)
    w = torch.randn(2048, generator=g, device=cuda)
    dy = torch.randn(64, 2048, generator=g, device=cuda)
    grads = []
    for impl in ("kernel", None):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = rms_norm(xl, wl, eps=1e-5, implementation=impl)
        assert y.grad_fn is not None
        y.backward(dy)
        grads.append((xl.grad, wl.grad))
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def _errors(got, ref):
    """Per output: (largest abs error, difference norm / reference norm)."""
    out = []
    for a, r in zip(got, ref):
        d = a.float() - r.float()
        out.append((d.abs().max().item(),
                    (d.norm() / r.float().norm().clamp_min(1e-30)).item()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("t,s_len,hq,hkv,hd,causal,masked", [
    (64, 64, 4, 4, 64, True, False),        # G=1, one tile
    (127, 127, 8, 2, 128, True, False),     # G=4, one short tile
    (128, 128, 8, 1, 64, False, True),      # G=8, a whole row masked
    (129, 129, 4, 1, 128, True, True),      # one past a tile, masked
    (192, 192, 8, 8, 128, False, False),    # G=1, 1.5 forward tiles
    (2048, 2048, 8, 1, 128, True, False),   # G=8, the training length
    (2048, 2048, 4, 4, 64, True, True),     # G=1, hd 64, masked
    (192, 64, 4, 1, 128, True, False),      # T > S, causal
    (64, 192, 8, 1, 64, True, True),        # S > T, causal, masked
    (129, 2048, 4, 4, 128, True, False),    # S >> T, causal
    (2048, 127, 8, 2, 64, True, False),     # T >> S, causal
])
def test_flash_bf16_tensor_core_kernels_match_plain(cuda, t, s_len, hq, hkv,
                                                    hd, causal, masked):
    b = 2
    gen = torch.Generator(device=cuda).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device=cuda).to(torch.bfloat16)

    q, k, v = rand(b, t, hq, hd), rand(b, s_len, hkv, hd), \
        rand(b, s_len, hkv, hd)
    g = rand(b, t, hq, hd)
    mask = None
    if masked:
        mask = torch.rand(b, s_len, generator=gen, device=cuda) > 0.3
        mask[0] = False  # every key of batch row 0 masked
    # The plain path in f32 on the same bf16 values.
    ref = _flash_run(q.float(), k.float(), v.float(), g.float(), mask,
                     "xla", causal)
    kernels.reset_launches()
    got = _flash_run(q, k, v, g, mask, "splash", causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
    sdpa = _errors(sdpa_run(q, k, v, g, mask, causal), ref)
    errs = _errors(got, ref)
    assert all(torch.isfinite(x).all() for x in got)
    assert errs[0][0] <= max(1e-2, 2 * sdpa[0][0]), (errs, sdpa)
    for (err, rel), (_, sdpa_rel), r in zip(errs[1:], sdpa[1:], ref[1:]):
        assert err <= 2e-2 * r.float().abs().max().item(), (errs, sdpa)
        assert rel <= max(2.0 ** -8, 2 * sdpa_rel), (errs, sdpa)
    if masked:
        assert not got[0][0].any() and not got[1][0].any()
        assert not got[2][0].any() and not got[3][0].any()


@pytest.mark.cuda
def test_flash_bf16_dkdv_are_bit_identical_across_runs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device=cuda).to(torch.bfloat16)

    q, k, v, g = rand(2, 640, 16, 128), rand(2, 640, 2, 128), \
        rand(2, 640, 2, 128), rand(2, 640, 16, 128)
    out, lse = kernels.flash_fwd(q, k, v, None, True, 128 ** -0.5)
    first = kernels.flash_bwd(q, k, v, None, out, lse, g, True, 128 ** -0.5)
    second = kernels.flash_bwd(q, k, v, None, out, lse, g, True, 128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
