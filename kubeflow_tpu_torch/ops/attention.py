"""Paged single-token decode attention; counterpart of the block-table part
of ``kubeflow_tpu/ops/attention.py`` (``paged_decode_attention`` and its
helpers).

Pools may be quantized: ``{"q": int8 [N, Bs, Hkv, hd], "scale": f32
[N, Bs, Hkv]}`` with one abs-max scale per (position, kv head). Scores,
softmax and accumulation run in f32 with an online softmax over the block
table, so the gathered ``[B, MB*Bs, Hkv, hd]`` view is never built.

:func:`paged_decode_attention` launches the CUDA kernel
(``csrc/paged_decode.cu`` through :func:`kubeflow_tpu_torch.kernels.
paged_decode`) for CUDA tensors and runs :func:`_paged_decode_plain` for
CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch import kernels

_NEG_INF = -1e30


def _kv_payload(pool):
    """The payload array of a (possibly quantized) block pool."""
    return pool["q"] if isinstance(pool, dict) else pool


def _read_block(pool, blk):
    """Gather ONE physical block per row ([B] ids → [B, Bs, Hkv, hd] f32),
    dequantizing int8 payloads against their per-position scales."""
    if isinstance(pool, dict):
        return pool["q"][blk].float() * pool["scale"][blk][..., None]
    return pool[blk].float()


def _paged_decode_plain(qg, k_pool, v_pool, table, pos, sm_scale):
    """Plain version of the kernel (``_paged_decode_xla``'s walk as a
    Python loop over table columns). qg: [B, Hkv, G, hd]; pools:
    [N, Bs, Hkv, hd] (or quantized dicts); table: [B, MB]; pos: [B].
    Returns [B, Hkv, G, hd] f32."""
    payload = _kv_payload(k_pool)
    n, bs = payload.shape[0], payload.shape[1]
    b, hkv, g, hd = qg.shape
    mb = table.shape[1]
    dev = qg.device
    q32 = qg.float()
    pos = pos.long()
    m = torch.full((b, hkv, g, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, hd), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, device=dev)
    for j in range(mb):
        # Sentinel entries (>= N) clamp to the last block; the span mask
        # hides whatever they surface.
        blk = table[:, j].long().clamp(0, n - 1)
        k_b = _read_block(k_pool, blk)
        v_b = _read_block(v_pool, blk)
        s = torch.einsum("bkgd,bskd->bkgs", q32, k_b) * sm_scale
        span = j * bs + offs[None, :]
        s = torch.where((span <= pos[:, None])[:, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgs,bskd->bkgd", p, v_b)
        m = m_new
    ok = m > _NEG_INF / 2
    return torch.where(ok, acc / torch.where(l == 0.0, torch.ones_like(l), l),
                       torch.zeros_like(acc))


def paged_decode_attention(q, k_pool, v_pool, table, pos, *,
                           n_kv_heads: int, scale: float | None = None,
                           mesh=None, axis: str = "tensor"):
    """Fused single-token attention over a paged KV pool.

    q: [B, Hq, hd] (one decode token per row, already rotary-embedded);
    k_pool/v_pool: [N, Bs, Hkv, hd] block pools, or quantized dicts
    ``{"q": int8, "scale": f32 [N, Bs, Hkv]}``; table: [B, MB] int32 block
    table (entries >= N are unallocated sentinels); pos: [B] int32 — row
    ``b`` attends virtual positions ``<= pos[b]``. Returns [B, Hq, hd] f32.

    CUDA tensors go through the hand-written kernel (or raise); CPU
    tensors through the plain version. ``mesh`` (tensor parallelism) is
    not yet ported."""
    if mesh is not None:
        raise ValueError("paged_decode_attention over a mesh (tensor "
                         "parallelism) is not yet ported")
    b, hq, hd = q.shape
    if hq % n_kv_heads:
        raise ValueError(
            f"query heads {hq} not a multiple of kv heads {n_kv_heads}")
    group = hq // n_kv_heads
    sm_scale = (hd ** -0.5) if scale is None else scale
    qg = q.reshape(b, n_kv_heads, group, hd)
    if q.device.type == "cpu":
        out = _paged_decode_plain(qg, k_pool, v_pool, table, pos, sm_scale)
    else:
        out = kernels.paged_decode(qg.contiguous(), k_pool, v_pool, table,
                                   pos, sm_scale)
    return out.reshape(b, hq, hd)
