"""The port's hand-written kernels against their plain PyTorch versions,
on a CUDA device. Every test here is marked ``cuda`` and skips on a host
without one; on the card run ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Nothing here imports JAX: the plain versions are pinned to
the JAX package by the CPU tests (``tests/test_torch_ops.py``).

Tolerances: the kernels compute in float32 like their plain versions and
differ only in the order of the sums, so the paged decode output agrees
to 2e-3 and the bf16 RMSNorm output to one bf16 ulp.
"""

import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch import kernels  # noqa: E402
from kubeflow_tpu_torch.models.decode import _quantize_kv  # noqa: E402
from kubeflow_tpu_torch.ops.attention import _paged_decode_plain  # noqa: E402,E501
from kubeflow_tpu_torch.ops.norms import _rms_norm_plain  # noqa: E402


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("hd,bs,group", [(128, 16, 2), (64, 8, 4),
                                         (128, 8, 1)])
def test_paged_decode_kernel_matches_plain(cuda, kv, hd, bs, group):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, hkv, mb = 6, 4, 5
    n = b * mb
    dt = torch.float32 if kv == "f32" else torch.bfloat16
    q = torch.randn(b, hkv, group, hd, generator=g, device=cuda).to(dt)

    def pool():
        p = torch.randn(n, bs, hkv, hd, generator=g, device=cuda)
        return _quantize_kv(p) if kv == "int8" else p.to(dt)

    kp, vp = pool(), pool()
    table = torch.randperm(n, generator=g, device=cuda).to(
        torch.int32).reshape(b, mb)
    table[1, 3:] = n          # sentinel tail
    table[2, 0] = n           # sentinel inside the live span: clamps
    table[5] = n              # pos < 0 below: attends nothing
    pos = torch.tensor([3 * bs + 2, 2 * bs, 4 * bs - 1, mb * bs, 0, -1],
                       dtype=torch.int32, device=cuda)
    ref = _paged_decode_plain(q, kp, vp, table, pos, hd ** -0.5)
    kernels.reset_launches()
    out = kernels.paged_decode(q, kp, vp, table, pos, hd ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_attention"] == 1
    assert (out - ref).abs().max().item() <= 2e-3
    assert not out[5].any()


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
