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
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

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
    (2, 256, 256, 24, 4, 128, True, False),  # G=6, flagship-deep's heads
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
    (2048, 2048, 24, 4, 128, True, False),  # G=6, flagship-deep's shape
    (2048, 2048, 16, 4, 64, True, False),   # G=4, hd 64, moe-1b's shape
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_fwd_at_the_predict_shape(cuda, dtype):
    """llama-1b's plain predict: B 8, T = S = 256 (two 128-row query
    tiles), Hq 16, Hkv 8 (G 2), D 128, causal, no kv mask. The forward
    kernel and its lse against the plain forward in f32 on the same
    values; bf16's out limit stands on SDPA's own error, as above."""
    b, t, hq, hkv, hd = 8, 256, 16, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rand(b, t, hq, hd), rand(b, t, hkv, hd), rand(b, t, hkv, hd)
    scale = hd ** -0.5
    kvm = tattn._fold_mask(None, b, t, hkv, cuda)
    ref_out, ref_lse = tattn._flash_fwd_plain(
        tattn._fold_q(q.float(), hkv), tattn._fold_kv(k.float()),
        tattn._fold_kv(v.float()), kvm, causal=True, scale=scale,
        block_k=t)
    ref_out, ref_lse = tattn._unfold_q(ref_out, b), ref_lse.reshape(b, hq, t)
    kernels.reset_launches()
    out, lse = kernels.flash_fwd(q, k, v, None, True, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    out_tol = 1e-4
    if dtype == torch.bfloat16:
        sdpa = sdpa_run(q, k, v, rand(b, t, hq, hd), None, True)
        out_tol = max(1e-2, 2 * (sdpa[0] - ref_out).abs().max().item())
    assert (out.float() - ref_out).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_dense_decode_on_the_card_matches_the_cpu(cuda):
    """The dense layout's admission (a padded bucket that repeats a
    slot), a retired row's write-back and four decode steps, in f32 on
    the card and on the CPU: the same tokens, logits within 1e-4."""
    from kubeflow_tpu_torch.models import decode as tdecode
    from kubeflow_tpu_torch.models import transformer

    cfg = transformer.config("lm-test-tiny", dtype=torch.float32)
    params = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    admit = dict(slots=torch.tensor([0, 1, 2, 2], dtype=torch.int32),
                 toks=torch.tensor([[5, 9, 2, 7, 1], [3, 3, 0, 0, 0],
                                    [8, 1, 4, 4, 2], [8, 1, 4, 4, 2]],
                                   dtype=torch.int32),
                 lengths=torch.tensor([5, 2, 5, 5], dtype=torch.int32),
                 remaining=torch.tensor([6, 6, 6, 6], dtype=torch.int32),
                 temps=torch.zeros(4))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        a = _on(admit, dev)
        state = tdecode.init_decode_state(cfg, 4, 16, device=dev)
        state, last, tok, _ = tdecode.admit_rows_and_step(
            state, _on(params, dev), cfg, a["slots"], a["toks"],
            a["lengths"], a["remaining"], a["temps"])
        tdecode.retire_row(state, 1)
        toks = [tok]
        for _ in range(4):
            state, tok, _ = tdecode.decode_step(state, _on(params, dev), cfg)
            toks.append(tok)
        runs.append((torch.stack(toks).cpu(), last.cpu(),
                     state["last_logits"].cpu(), state["cache"]["k"].cpu()))
    (cpu_toks, *cpu_f), (card_toks, *card_f) = runs
    assert torch.equal(cpu_toks, card_toks)
    for c, g in zip(cpu_f, card_f):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
def test_paged_span_attention_on_the_card_matches_plain(cuda, kv):
    """The grouped span walk (SPAN_GROUP_POSITIONS a step) on the card
    against the one-block walk ``_paged_span_plain`` on the same inputs,
    at llama-1b's chunk shape cut to 40 blocks: a [1, 128] span at 500
    and a second row with sentinels and a parked tail. Both are plain
    PyTorch in f32 over the same values (the int8 payloads dequantized
    alike), so they differ only in the order of their sums: 1e-5."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, s_w, hkv, group, hd, bs, mb = 2, 128, 8, 2, 128, 16, 40
    n = b * mb
    dt = torch.float32 if kv == "f32" else torch.bfloat16
    q = torch.randn(b, s_w, hkv * group, hd, generator=g, device=cuda).to(dt)

    def pool():
        p = torch.randn(n, bs, hkv, hd, generator=g, device=cuda)
        return _quantize_kv(p) if kv == "int8" else p.to(dt)

    kp, vp = pool(), pool()
    table = torch.randperm(n, generator=g, device=cuda).to(
        torch.int32).reshape(b, mb)
    table[1, 20:] = n
    table[1, 3] = n
    pos = torch.tensor([500, 300], dtype=torch.int32, device=cuda)
    out = tattn.paged_span_attention(q, kp, vp, table, pos, n_kv_heads=hkv)
    ref = tattn._paged_span_plain(q.reshape(b, s_w, hkv, group, hd), kp, vp,
                                  table, pos, hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref.reshape(out.shape), rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
def test_block_forward_fused_on_the_card_matches_gathered(cuda):
    """``_block_forward`` (the suffix prefill and chunk forward) in f32
    on the card: the fused span walk against the gathered read, with a
    span that spills past the row; logits within 1e-4, pools equal to
    1e-5, and the card's logits within 1e-4 of the CPU's."""
    from kubeflow_tpu_torch.models import decode as tdecode
    from kubeflow_tpu_torch.models import transformer

    cfg = transformer.config("lm-test-tiny", dtype=torch.float32)
    params = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    table = torch.tensor([[3, 0, 7, 5], [1, 9, 12, 12], [2, 4, 6, 8]],
                         dtype=torch.int32)
    toks = torch.tensor([[5, 9, 2, 7, 1, 3], [3, 3, 8, 1, 2, 2],
                         [8, 1, 4, 4, 2, 6]], dtype=torch.int32)
    pos = torch.tensor([29, 14, 0], dtype=torch.int32)
    shape = (cfg.n_layers, 12, 8, cfg.n_kv_heads, cfg.head_dim)
    gen = torch.Generator().manual_seed(1)
    pools = {side: torch.randn(shape, generator=gen) for side in "kv"}
    runs = {}
    for name, dev, fused in (("cpu", torch.device("cpu"), False),
                             ("gathered", cuda, False),
                             ("fused", cuda, True)):
        state = tdecode.init_paged_state(cfg, 3, 12, 8, 4, device=dev)
        for side in ("k", "v"):
            state["pool"][side].copy_(pools[side])
        logits = tdecode._block_forward(
            _on(params, dev), cfg, state["pool"]["k"], state["pool"]["v"],
            toks.to(dev), pos.to(dev), table.to(dev), fused)
        runs[name] = (logits.cpu(), state["pool"]["k"].cpu())
    torch.testing.assert_close(runs["fused"][0], runs["gathered"][0],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(runs["fused"][1], runs["gathered"][1],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(runs["gathered"][0], runs["cpu"][0],
                               rtol=1e-4, atol=1e-4)


def _spec_cfg():
    """lm-test-tiny widened to head_dim 64, which the paged kernel takes."""
    from kubeflow_tpu_torch.models import transformer

    return transformer.config("lm-test-tiny", dtype=torch.float32,
                              d_model=256, n_heads=4, n_kv_heads=2)


@pytest.mark.cuda
def test_verify_step_fused_on_the_card_matches_gathered(cuda):
    """Two ``verify_step`` rounds in f32 on the card from one admitted
    paged state, with ``kv_fused`` (the span walk scores, the paged
    kernel reads the commit pass) and without (both gathered): the same
    tokens and emitted masks, last logits within 2e-3, pools within
    1e-4. The drafts are each row's greedy chain with one miss, so rows
    accept, reject, hit the budget cap and the cache end."""
    from kubeflow_tpu_torch.models import decode as tdecode
    from kubeflow_tpu_torch.models import transformer

    cfg = _spec_cfg()
    params = transformer.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    slots, nb, bs, mb, k_w = 4, 16, 16, 3, 4
    table = torch.arange(slots * mb, dtype=torch.int32,
                         device=cuda).reshape(slots, mb)
    gen = torch.Generator(device=cuda).manual_seed(1)
    lens = torch.tensor([5, 17, 44, 9], dtype=torch.int32, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (slots, 44), generator=gen,
                         device=cuda, dtype=torch.int32)
    base = tdecode.init_paged_state(cfg, slots, nb, bs, mb, device=cuda)
    base["block_table"].copy_(table)
    tdecode.paged_admit_rows_and_step(
        base, params, cfg, torch.arange(slots, device=cuda), toks, lens,
        torch.tensor([20, 3, 20, 20], dtype=torch.int32, device=cuda),
        torch.zeros(slots, device=cuda))

    def clone(state):
        return {k: (clone(v) if isinstance(v, dict) else
                    v.clone() if torch.is_tensor(v) else v)
                for k, v in state.items()}

    ref = clone(base)
    _, chain, _ = tdecode.decode_chunk(ref, params, cfg, 2 * (k_w + 1))
    chain = chain.T.to(torch.int32)
    runs = {}
    for fused in (False, True):
        state = clone(base)
        got = []
        for r in range(2):
            draft = chain[:, r * (k_w + 1): r * (k_w + 1) + k_w].clone()
            draft[0, 2] = (draft[0, 2] + 1) % cfg.vocab_size
            _, out, emitted = tdecode.verify_step(
                state, params, cfg, draft,
                torch.full((slots,), k_w, dtype=torch.int32, device=cuda),
                kv_fused=fused)
            got.append((out.cpu(), emitted.cpu()))
        torch.cuda.synchronize()
        runs[fused] = (got, state["last_logits"].cpu(),
                       state["pool"]["k"].cpu(), state["length"].cpu())
    (g_tok, g_last, g_pool, g_len), (f_tok, f_last, f_pool, f_len) = (
        runs[False], runs[True])
    for (ga, ge), (fa, fe) in zip(g_tok, f_tok):
        assert torch.equal(ga, fa) and torch.equal(ge, fe)
    assert torch.equal(g_len, f_len)
    assert torch.isfinite(f_last).all()
    torch.testing.assert_close(f_last, g_last, rtol=0, atol=2e-3)
    torch.testing.assert_close(f_pool, g_pool, rtol=1e-4, atol=1e-4)
    assert g_tok[0][1][0].sum() == 3  # two accepted, then the correction


@pytest.mark.cuda
def test_dense_span_forward_on_the_card_drops_the_spill(cuda):
    """The dense ``_block_forward`` in f32 on the card over caches that
    are a view of a buffer one row wider: the last row spans past its
    end, the middle row is parked. The guard row behind the caches, the
    parked row and every position before a span stay byte for byte;
    logits within 1e-4 and caches within 1e-5 of the CPU's."""
    from kubeflow_tpu_torch.models import decode as tdecode
    from kubeflow_tpu_torch.models import transformer

    cfg = _spec_cfg()
    params = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    total = 32
    shape = (cfg.n_layers, 4, total, cfg.n_kv_heads, cfg.head_dim)
    gen = torch.Generator().manual_seed(2)
    bufs = {s: torch.randn(shape, generator=gen) for s in "kv"}
    toks = torch.tensor([[5, 9, 2, 7, 1, 3], [3, 3, 8, 1, 2, 2],
                         [8, 1, 4, 4, 2, 6]], dtype=torch.int32)
    pos = torch.tensor([0, total, 29], dtype=torch.int32)
    runs = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        buf = {s: b.to(dev) for s, b in bufs.items()}
        logits = tdecode._block_forward(
            _on(params, dev), cfg, buf["k"][:, :3], buf["v"][:, :3],
            toks.to(dev), pos.to(dev), None)
        runs[name] = (logits.cpu(), {s: b.cpu() for s, b in buf.items()})
    for s in "kv":
        after, before = runs["card"][1][s], bufs[s]
        assert torch.equal(after[:, 3], before[:, 3])        # the guard row
        assert torch.equal(after[:, 1], before[:, 1])        # parked
        assert torch.equal(after[:, 0, 6:], before[:, 0, 6:])
        assert torch.equal(after[:, 2, :29], before[:, 2, :29])
        torch.testing.assert_close(after, runs["cpu"][1][s], rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(runs["card"][0][[0, 2]],
                               runs["cpu"][0][[0, 2]], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [
    {"remat_policy": p} for p in ("dots", "dots_batched", "llm", "llm_qkv",
                                  "llm_attn", "llm_res", "none")] + [
    {"remat_policy": "llm", "scan_layers": True, "scan_group_size": 2}],
    ids=["dots", "dots_batched", "llm", "llm_qkv", "llm_attn", "llm_res",
         "none", "group2"])
def test_remat_on_equals_off_through_the_flash_kernel(cuda, overrides):
    """flagship-deep's heads (24 over 4, hd 128) at two layers and d 3072,
    f32: each remat policy gives the loss and gradients of remat off, with
    the flash kernels on every layer (and the forward again in the
    backward where the policy recomputes it). Both runs do the same f32
    operations on the same values, so they agree to 1e-6 relative."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch import weights
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_batch

    def grads(remat):
        m = get_model("flagship-deep", dtype=torch.float32, n_layers=2,
                      remat=remat, **overrides)
        params = m.init(m.config, generator=torch.Generator(
            device=cuda).manual_seed(0), device=cuda,
            param_dtype=torch.float32)
        leaves = {k: p.requires_grad_(True)
                  for k, p in weights.flatten(params).items()}
        batch = place_batch(synthetic_batch(m, 1, 256, seed=1), cuda)
        kernels.reset_launches()
        loss, _ = m.loss_fn(params, batch, m.config)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.item(), {k: p.grad for k, p in leaves.items()},
                dict(kernels.LAUNCHES))

    loss_on, on, launches_on = grads(True)
    loss_off, off, launches_off = grads(False)
    assert launches_off["flash_attention_fwd"] == 2
    assert launches_on["flash_attention_bwd"] == 2
    reruns = overrides["remat_policy"] not in ("llm_res", "llm_attn") or \
        overrides.get("scan_group_size", 1) > 1
    assert launches_on["flash_attention_fwd"] == (4 if reruns else 2)
    assert abs(loss_on - loss_off) <= 1e-6 * abs(loss_off)
    for k, g in off.items():
        assert (on[k] - g).abs().max().item() <= \
            1e-6 * g.abs().max().item(), k


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
def test_exported_blocks_imported_read_the_same_through_the_kernel(cuda,
                                                                   kv):
    """The host tier's and the handoff's round trip on CUDA pools: blocks
    exported, copied to the host, and imported into other blocks of a
    second pool are bit for bit the originals (int8 codes and scales
    alike, never quantized again), and the paged kernel reading them
    through a table pointing at the new blocks returns, bit for bit, what
    it returned over the originals (and what the plain read returns,
    within 2e-3)."""
    from kubeflow_tpu_torch.models.decode import export_blocks, import_blocks

    b, hkv, group, hd, bs, mb = 3, 8, 2, 128, 16, 5
    q, kp, vp, table, pos = _paged_case(cuda, kv, b, hkv, group, hd, bs,
                                        mb, [3 * bs + 2, 2 * bs, mb * bs])
    live = sorted({int(x) for x in table.flatten().tolist()
                   if x < table.shape[0] * mb})
    before = _paged_check(cuda, q, kp, vp, table, pos)

    def stacked(p):  # the [L, N, ...] layout of a decode state's pool
        if isinstance(p, dict):
            return {k: v[None].clone() for k, v in p.items()}
        return p[None].clone()

    pool = {"k": stacked(kp), "v": stacked(vp)}
    payload = export_blocks(pool, live)
    host = {s: ({k: v.cpu() for k, v in p.items()} if isinstance(p, dict)
                else p.cpu()) for s, p in payload.items()}
    # A second pool, zeroed, whose block i takes original block live[i]
    # at a permuted place.
    fresh = {s: ({k: torch.zeros_like(v) for k, v in p.items()}
                 if isinstance(p, dict) else torch.zeros_like(p))
             for s, p in pool.items()}
    n = table.shape[0] * mb
    dst = torch.randperm(n, generator=torch.Generator().manual_seed(1))[
        :len(live)].tolist()
    import_blocks(fresh, dst, host)
    back = export_blocks(fresh, dst)
    for s in ("k", "v"):
        a, c = payload[s], back[s]
        for x, y in (zip(a.values(), c.values()) if isinstance(a, dict)
                     else ((a, c),)):
            assert torch.equal(x, y)
    remap = torch.full((n + 1,), n, dtype=torch.int32, device=cuda)
    remap[torch.tensor(live, device=cuda)] = torch.tensor(
        dst, dtype=torch.int32, device=cuda)
    table2 = remap[table.long()]

    def layer0(p):
        return {k: v[0] for k, v in p.items()} if isinstance(p, dict) \
            else p[0]

    after = _paged_check(cuda, q, layer0(fresh["k"]), layer0(fresh["v"]),
                         table2, pos)
    assert torch.equal(after, before)
    with pytest.raises(IndexError):
        export_blocks(fresh, [n])


# ---------------------------------------------------------------------------
# The other model families' shapes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_kernel_at_moe_1b_serving_shape(cuda, kv):
    """moe-1b's paged read: 8 slots, Hkv 4, G 4, hd 64, Bs 16, 18 columns
    (max_seq_len 256 + 32 new), a parked row and a row with pos < 0."""
    q, kp, vp, table, pos = _paged_case(
        cuda, kv, 8, 4, 4, 64, 16, 18,
        [7, 40, 100, 150, 200, 287, 18 * 16, -1])
    out = _paged_check(cuda, q, kp, vp, table, pos)
    assert not out[7].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h", [(8, 128, 12), (2, 512, 12), (32, 128, 6)],
                         ids=["T128", "T512", "T128-tensor-rank"])
def test_flash_kernels_at_bert_shape(cuda, dtype, b, t, h):
    """BERT's attention: non-causal over a key-padding mask, hd 64, G 1
    (bert-base's 12 heads, or the 6 of one of two tensor ranks at its
    training batch), the default implementation as models/bert.py calls it,
    against the plain path in f32 on the same values: f32 within 1e-4 (of
    the largest reference gradient for the gradients), bf16 under the
    module's SDPA-relative limits. Row 0 masks every key: 0 out and 0
    gradients."""
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, k, v, g = (rand(b, t, h, 64) for _ in range(4))
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
    mask = torch.arange(t, device=cuda)[None, :] < lengths[:, None]
    mask[0] = False
    ref = _flash_run(q.float(), k.float(), v.float(), g.float(), mask,
                     "xla", False)
    kernels.reset_launches()
    got = _flash_run(q, k, v, g, mask, None, False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
    assert all(torch.isfinite(x).all() for x in got)
    errs = _errors(got, ref)
    if dtype == torch.float32:
        assert errs[0][0] <= 1e-4, errs
        for (err, _), r in zip(errs[1:], ref[1:]):
            assert err <= 1e-4 * r.abs().max().item(), errs
    else:
        sdpa = _errors(sdpa_run(q, k, v, g, mask, False), ref)
        assert errs[0][0] <= max(1e-2, 2 * sdpa[0][0]), (errs, sdpa)
        for (err, rel), (_, sdpa_rel), r in zip(errs[1:], sdpa[1:], ref[1:]):
            assert err <= 2e-2 * r.float().abs().max().item(), (errs, sdpa)
            assert rel <= max(2.0 ** -8, 2 * sdpa_rel), (errs, sdpa)
    assert not got[0][0].any() and not got[1][0].any()


@pytest.mark.cuda
def test_moe_decode_steps_through_the_kernel_match_gathered(cuda):
    """An MoE model at moe-1b's attention layout (hd 64, G 4) in f32:
    admission of three rows and four decode steps on a paged state with
    the fused read (the paged kernel) and with the gathered read: the
    same tokens, logits within 2e-3. Three rows a step over 4 experts at
    capacity 2 make the routing depend on the rows that share it."""
    from kubeflow_tpu_torch.models import decode as tdecode
    from kubeflow_tpu_torch.models import transformer

    cfg = transformer.config("moe-test-tiny", dtype=torch.float32,
                             d_model=256, n_heads=4, n_kv_heads=1)
    params = transformer.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    slots, nb, bs, mb = 4, 16, 16, 4
    table = torch.arange(slots * mb, dtype=torch.int32,
                         device=cuda).reshape(slots, mb)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (3, 24), generator=gen,
                         device=cuda, dtype=torch.int32)
    runs = {}
    for fused in (False, True):
        state = tdecode.init_paged_state(cfg, slots, nb, bs, mb,
                                         device=cuda)
        state["block_table"].copy_(table)
        kernels.reset_launches()
        state, last, tok, _ = tdecode.paged_admit_rows_and_step(
            state, params, cfg, torch.arange(3, device=cuda), toks,
            torch.tensor([24, 9, 17], dtype=torch.int32, device=cuda),
            torch.full((3,), 8, dtype=torch.int32, device=cuda),
            torch.zeros(3, device=cuda), kv_fused=fused)
        out = [tok]
        for _ in range(4):
            state, tok, _ = tdecode.decode_step(state, params, cfg,
                                                kv_fused=fused)
            out.append(tok)
        torch.cuda.synchronize()
        runs[fused] = (torch.stack(out).cpu(), state["last_logits"].cpu(),
                       kernels.LAUNCHES["paged_decode_attention"])
    assert runs[True][2] == 5 * cfg.n_layers and runs[False][2] == 0
    assert torch.equal(runs[True][0], runs[False][0])
    torch.testing.assert_close(runs[True][1], runs[False][1], rtol=0,
                               atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero", "equal_columns"])
def test_moe_routing_ties_on_the_card_break_as_jax(cuda, kind):
    """CUDA's topk leaves the order of ties unspecified too: the port's
    routing on the card puts the lower expert first (JAX's lax.top_k:
    experts [0, 1] of eight equal probabilities, [1, 2] of softmax([0, 1,
    1, 0, 1, 0, 0, 0])), and moe_ffn with a tied router (f32) equals the
    CPU's, which tests/test_torch_moe.py holds against JAX."""
    from kubeflow_tpu_torch.models import transformer

    for logits, want in (([0.0] * 8, [0, 1]),
                         ([0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0], [1, 2])):
        probs = torch.softmax(torch.tensor([logits], device=cuda), -1)
        _, idx = transformer.top_k_experts(probs.repeat(4096, 1), 2)
        assert (idx.cpu() == torch.tensor(want)).all()
    cfg = transformer.config("moe-test-tiny", dtype=torch.float32)
    params = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    mlp = {k: w[0] for k, w in params["layers"]["mlp"].items()}
    if kind == "zero":
        mlp["router"] = torch.zeros_like(mlp["router"])
    else:
        mlp["router"][:, 1] = mlp["router"][:, 0]
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(3))
    ref, ref_aux = transformer.moe_ffn(x, mlp, cfg)
    out, aux = transformer.moe_ffn(
        x.to(cuda), {k: w.to(cuda) for k, w in mlp.items()}, cfg)
    torch.testing.assert_close(out.cpu(), ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_mesh_step_at_world_one_over_nccl_equals_the_no_mesh_step(cuda):
    """A process group of one rank over NCCL and a 1x1x1x1x1x1 mesh: three
    f32 train steps of the mesh path (its all-reduces of the gradients,
    the loss's count and the metrics, at world size 1) equal the no-mesh
    path's within 1e-6 relative, losses, gradient norms and parameters."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel import distributed, mesh as tmesh
    from kubeflow_tpu_torch.train import data, trainer
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.weights import flatten

    model = get_model("lm-test-tiny", dtype=torch.float32, d_model=128,
                      n_heads=2, n_kv_heads=1, d_ff=256)  # hd 64
    opt_cfg = OptimizerConfig(name="adafactor", warmup_steps=1)
    distributed.initialize_gang({}, device="cuda")
    try:
        runs = []
        for mesh in (None, tmesh.single_device_mesh("cuda")):
            state = trainer.init_state(
                torch.Generator(device=cuda).manual_seed(0), model, opt_cfg,
                mesh, device=cuda)
            step = trainer.build_train_step(model, opt_cfg, mesh)
            stream = data.synthetic_stream(model, 2, 64, seed=5)
            mets = []
            for _ in range(3):
                state, met = step(state, data.place_batch(next(stream),
                                                          cuda))
                mets.append([float(met["loss"]), float(met["grad_norm"])])
            runs.append((mets, flatten(state.params)))
    finally:
        distributed.shutdown()
    (m0, p0), (m1, p1) = runs
    torch.testing.assert_close(torch.tensor(m1), torch.tensor(m0),
                               rtol=1e-6, atol=0)
    for k, p in p0.items():
        torch.testing.assert_close(p1[k], p, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Tensor parallelism: the kernels at a shard's shapes, two shards on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
def test_paged_decode_kernel_at_the_tp2_shard_shape(cuda, kv):
    """llama-1b's paged read on one of two tensor shards: 8 slots, Hkv 4
    (8 over 2), G 2, hd 128, Bs 16, 18 columns, a parked row and a row
    with pos < 0; the shard's pool is its own contiguous tensor."""
    q, kp, vp, table, pos = _paged_case(
        cuda, kv, 8, 4, 2, 128, 16, 18,
        [7, 40, 100, 150, 200, 287, 18 * 16, -1])
    out = _paged_check(cuda, q, kp, vp, table, pos)
    assert not out[7].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_at_the_tensor_rank_shape(cuda, dtype):
    """flagship-1b's attention on one of two tensor ranks: Hq 16 over Hkv
    2 (G 8), hd 128, causal, 1 x 2048 rows, through "splash" as the model
    calls it, under the module's limits against the plain path."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, g = rand(1, 2048, 16, 128), rand(1, 2048, 16, 128)
    k, v = rand(1, 2048, 2, 128), rand(1, 2048, 2, 128)
    ref = _flash_run(q.float(), k.float(), v.float(), g.float(), None,
                     "xla", True)
    kernels.reset_launches()
    got = _flash_run(q, k, v, g, None, "splash", True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
    errs = _errors(got, ref)
    if dtype == torch.float32:
        assert errs[0][0] <= 1e-4, errs
        for (err, _), r in zip(errs[1:], ref[1:]):
            assert err <= 1e-4 * r.abs().max().item(), errs
    else:
        sdpa = _errors(sdpa_run(q, k, v, g, None, True), ref)
        assert errs[0][0] <= max(1e-2, 2 * sdpa[0][0]), (errs, sdpa)
        for (err, rel), (_, sdpa_rel), r in zip(errs[1:], sdpa[1:], ref[1:]):
            assert err <= 2e-2 * r.float().abs().max().item(), (errs, sdpa)
            assert rel <= max(2.0 ** -8, 2 * sdpa_rel), (errs, sdpa)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_tp2_decoder_on_one_card_matches_tp1(cuda, kv_dtype):
    """Two tensor shards on ``["cuda:0", "cuda:0"]`` (the kernel once a
    shard a layer, on each shard's contiguous pool, one after the other
    on the card's stream), float32, greedy: the stream equals the tp=1
    decoder's and the paged kernel launches twice as often."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    tm = registry.get_model("llama-1b", d_model=512, n_heads=4,
                            n_kv_heads=4, d_ff=256, n_layers=2,
                            vocab_size=512, dtype=torch.float32)
    params = tm.init(tm.config, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    prompts = [[5, 9, 2, 7, 1] * 4, list(range(3, 40)), [11, 12]]
    streams, launched = {}, {}
    for tp in (1, 2):
        d = ContinuousDecoder(params, tm.config, slots=4, prefill_len=64,
                              max_new_tokens=16, kv_layout="paged",
                              kv_block_size=16, kv_fused=True,
                              kv_dtype=kv_dtype, tp_shards=tp,
                              tp_devices=["cuda:0"] * tp)
        try:
            kernels.reset_launches()
            streams[tp] = [d.generate(p, 12, timeout=120)["tokens"]
                           for p in prompts]
            launched[tp] = kernels.LAUNCHES["paged_decode_attention"]
        finally:
            d.stop()
    assert streams[2] == streams[1]
    assert launched[2] == 2 * launched[1] > 0


# ---------------------------------------------------------------------------
# The mixture of experts over tensor shards: the kernels at moe-1b's shard
# and tensor-rank shapes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
def test_paged_decode_kernel_at_the_moe_tp2_shard_shape(cuda, kv):
    """moe-1b's paged read on one of two tensor shards: 8 slots, Hkv 2 (4
    over 2), G 4, hd 64, Bs 16, 18 columns, a parked row and a row with
    pos < 0."""
    q, kp, vp, table, pos = _paged_case(
        cuda, kv, 8, 2, 4, 64, 16, 18,
        [7, 40, 100, 150, 200, 287, 18 * 16, -1])
    out = _paged_check(cuda, q, kp, vp, table, pos)
    assert not out[7].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_at_the_moe_tensor_rank_shape(cuda, dtype):
    """moe-1b's attention on one of two tensor ranks: Hq 8 over Hkv 2 (G
    4), hd 64, causal, 1 x 2048 rows, through the model's implementation
    (None: the kernels), under the module's limits against the plain
    path."""
    gen = torch.Generator(device=cuda).manual_seed(6)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, g = rand(1, 2048, 8, 64), rand(1, 2048, 8, 64)
    k, v = rand(1, 2048, 2, 64), rand(1, 2048, 2, 64)
    ref = _flash_run(q.float(), k.float(), v.float(), g.float(), None,
                     "xla", True)
    kernels.reset_launches()
    got = _flash_run(q, k, v, g, None, None, True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
    errs = _errors(got, ref)
    if dtype == torch.float32:
        assert errs[0][0] <= 1e-4, errs
        for (err, _), r in zip(errs[1:], ref[1:]):
            assert err <= 1e-4 * r.abs().max().item(), errs
    else:
        sdpa = _errors(sdpa_run(q, k, v, g, None, True), ref)
        assert errs[0][0] <= max(1e-2, 2 * sdpa[0][0]), (errs, sdpa)
        for (err, rel), (_, sdpa_rel), r in zip(errs[1:], sdpa[1:], ref[1:]):
            assert err <= 2e-2 * r.float().abs().max().item(), (errs, sdpa)
            assert rel <= max(2.0 ** -8, 2 * sdpa_rel), (errs, sdpa)


# ---------------------------------------------------------------------------
# The sequence and pipeline axes: the ring's span read on the card, the
# flash kernels inside the pipeline's stages
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_ring_span_read_on_the_card_matches_the_gathered_read(cuda):
    """The chunked-prefill ring over two shards of the card (a 32-token
    chunk at positions 64-95 of a 128-position row, Hq 8 over Hkv 4, hd
    64), float32: within 1e-5 of the one-shard fold and of the gathered
    read the decoder takes without a ring."""
    from kubeflow_tpu_torch.models.decode import _gqa_attention
    from kubeflow_tpu_torch.models.transformer import config

    cfg = config("lm-test-tiny", n_heads=8, n_kv_heads=4, d_model=512,
                 dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(1, 32, 8, 64, generator=gen, device=cuda)
    k, v = (torch.randn(1, 128, 4, 64, generator=gen, device=cuda)
            for _ in range(2))
    pos = torch.tensor([64], dtype=torch.int32, device=cuda)
    ring = tattn.ring_span_attention(q, k, v, pos, n_kv_heads=4,
                                     devices=["cuda:0", "cuda:0"])
    whole = tattn.ring_span_attention(q, k, v, pos, n_kv_heads=4)
    cols = 64 + torch.arange(32, device=cuda)[None]
    mask = (torch.arange(128, device=cuda)[None, None, :]
            <= cols[:, :, None])[:, None, None]
    gathered = _gqa_attention(q, k, v, mask, cfg).reshape(1, 32, 8, 64)
    assert torch.isfinite(ring).all()
    torch.testing.assert_close(ring, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ring, gathered, rtol=1e-5, atol=1e-5)


# One rank of a gloo gang of two on cuda:0 over {"pipeline": 2}: f32
# steps of a 2-layer model (one layer a stage), the flash kernels in each
# stage, and the same steps in one process through the plain attention.
PIPELINE_WORKER = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from kubeflow_tpu_torch import kernels
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.distributed import initialize_from_env, shutdown
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.train import data, trainer
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
out = sys.argv[1]
info = initialize_from_env(device="cuda", backend="gloo", timeout_s=300)
dev = torch.device("cuda", 0)
mesh = build_mesh(MeshConfig(data=1, pipeline=2), device_type="cuda")
kw = dict(dtype=torch.float32, d_model=256, n_heads=4, n_kv_heads=2,
          d_ff=256, pipeline_stages=2, pipeline_microbatches=2)
opt = OptimizerConfig(name="sgd", warmup_steps=1)
batches = [data.place_batch(data.synthetic_batch(
    get_model("lm-test-tiny", **kw), 4, 64, seed=i), dev) for i in range(2)]

def run(m, impl):
    model = get_model("lm-test-tiny", attn_impl=impl, **kw)
    st = trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                            model, opt, m, device=dev)
    fn = trainer.build_train_step(model, opt, m)
    mets = []
    for b in batches:
        st, met = fn(st, b)
        mets.append([float(met["loss"]), float(met["grad_norm"])])
    return mets

kernels.reset_launches()
gang = run(mesh, None)
launches = dict(kernels.LAUNCHES)
one = run(None, "xla") if info.process_id == 0 else None
json.dump({"gang": gang, "one": one, "launches": launches},
          open(out + f".{info.process_id}", "w"))
shutdown()
"""


@pytest.mark.cuda
def test_pipeline_stages_run_the_flash_kernels_on_the_card(cuda, tmp_path):
    """A gloo gang of two pipeline stages on the card, float32, 2 steps
    at 4 x 64 rows in 2 microbatches: each stage launches the flash
    forward and backward once a microbatch a step (its one layer, no
    remat), and the gang's losses and gradient norms equal one process's
    through the plain attention within 1e-5 relative."""
    import json
    import os
    import sys

    from kubeflow_tpu_torch.parallel.launch import launch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = launch([sys.executable, "-c", PIPELINE_WORKER,
                    str(tmp_path / "out")], 2, cwd=root, timeout=300)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{p.stderr[-3000:]}"
    ranks = [json.load(open(f"{tmp_path / 'out'}.{i}")) for i in range(2)]
    for r in ranks:
        assert r["launches"]["flash_attention_fwd"] == 2 * 2
        assert r["launches"]["flash_attention_bwd"] == 2 * 2
        torch.testing.assert_close(torch.tensor(r["gang"]),
                                   torch.tensor(ranks[0]["one"]),
                                   rtol=1e-5, atol=0)
