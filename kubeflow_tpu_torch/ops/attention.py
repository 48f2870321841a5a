"""Attention ops; counterpart of ``kubeflow_tpu/ops/attention.py``.

Two parts are ported:

- **Flash attention** (``flash_attention``), training's attention: the
  blockwise online-softmax forward and the recompute-from-logsumexp
  backward, GQA-native. :class:`_FlashAttention` launches the CUDA kernels
  of ``csrc/flash_attention.cu`` (through :func:`kubeflow_tpu_torch.kernels.
  flash_fwd` / ``flash_bwd``) for CUDA tensors and runs the plain versions
  :func:`_flash_fwd_plain` / :func:`_flash_bwd_plain` (ports of JAX's
  ``_flash_fwd_xla`` / ``_flash_bwd_xla``) for CPU tensors.
- **Paged single-token decode** (``paged_decode_attention``), serving's
  attention. Pools may be quantized: ``{"q": int8 [N, Bs, Hkv, hd],
  "scale": f32 [N, Bs, Hkv]}`` with one abs-max scale per (position, kv
  head). Scores, softmax and accumulation run in f32 with an online
  softmax over the block table, so the gathered ``[B, MB*Bs, Hkv, hd]``
  view is never built. :func:`paged_decode_attention` launches the CUDA
  kernel (``csrc/paged_decode.cu``) for CUDA tensors and runs
  :func:`_paged_decode_plain` for CPU tensors.

Neither has another path: a CUDA tensor reaches its kernel or raises.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch import kernels

_NEG_INF = -1e30
# Default block widths, as in the JAX package: the plain blockwise path
# takes DEFAULT_BLOCK_K when the caller leaves block_k=None. The CUDA
# kernels choose their own tiles and ignore both.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 2048
_IMPLEMENTATIONS = (None, "splash", "pallas", "xla", "plain")


def _causal_mask(q_start, k_start, bq, bk, device=None):
    """[bq, bk] bool: query q_start+i sees key k_start+j iff j-th key
    position <= i-th query position (top-left aligned)."""
    q_pos = q_start + torch.arange(bq, device=device)[:, None]
    k_pos = k_start + torch.arange(bk, device=device)[None, :]
    return q_pos >= k_pos


def _block_width(block_k: int, s_len: int) -> int:
    """The plain path's kv block: odd lengths take one block, as in JAX."""
    block_k = min(block_k, s_len)
    return s_len if s_len % block_k else block_k


def _flash_fwd_plain(q, k, v, kvm, *, causal, scale, block_k):
    """Plain version of the forward kernel (``_flash_fwd_xla``'s scan as a
    Python loop over kv blocks, f32 throughout). q: [BKV, G, T, D]; k, v:
    [BKV, S, D]; kvm: [BKV, S, 1]. Returns (out in q's dtype, lse
    [BKV, G, T, 1] f32)."""
    bkv, g, t, d = q.shape
    s_len = k.shape[1]
    block_k = _block_width(block_k, s_len)
    dev = q.device
    q32, k32, v32 = q.float(), k.float(), v.float()
    m = torch.full((bkv, g, t, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bkv, g, t, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bkv, g, t, d), dtype=torch.float32, device=dev)
    for j in range(s_len // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        s = torch.einsum("bgqd,bkd->bgqk", q32, k32[:, blk]) * scale
        if causal:
            mask = _causal_mask(0, j * block_k, t, block_k, dev)
            s = torch.where(mask[None, None], s, _NEG_INF)
        s = torch.where(kvm[:, blk, 0][:, None, None, :] > 0, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bgqk,bkd->bgqd", p, v32[:, blk])
        m = m_new
    # Rows with every key masked never saw a finite score: zeros, not
    # mean(V), and lse -1e30.
    valid = m > _NEG_INF / 2
    out = torch.where(valid, acc / l, 0.0).to(q.dtype)
    lse = torch.where(valid, m + torch.log(l), _NEG_INF)
    return out, lse


def _flash_bwd_plain(q, k, v, kvm, out, lse, g_out, *, causal, scale,
                     block_k):
    """Plain version of the backward kernels (``_flash_bwd_xla``): p
    recomputed blockwise from lse. Shapes as :func:`_flash_fwd_plain`;
    returns (dq, dk, dv) in the inputs' dtypes."""
    bkv, g, t, d = q.shape
    s_len = k.shape[1]
    block_k = _block_width(block_k, s_len)
    dev = q.device
    q32, g32 = q.float(), g_out.float()
    k32, v32 = k.float(), v.float()
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros((bkv, g, t, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(s_len // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        k_b, v_b = k32[:, blk], v32[:, blk]
        s = torch.einsum("bgqd,bkd->bgqk", q32, k_b) * scale
        if causal:
            mask = _causal_mask(0, j * block_k, t, block_k, dev)
            s = torch.where(mask[None, None], s, _NEG_INF)
        s = torch.where(kvm[:, blk, 0][:, None, None, :] > 0, s, _NEG_INF)
        # All-masked rows carry lse -1e30: their p (and so their
        # gradients) must be 0, not exp(0) = 1 per key.
        p = torch.where(lse > _NEG_INF / 2, torch.exp(s - lse), 0.0)
        dp = torch.einsum("bgqd,bkd->bgqk", g32, v_b)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bgqk,bkd->bgqd", ds, k_b)
        dks.append(torch.einsum("bgqk,bgqd->bkd", ds, q32))
        dvs.append(torch.einsum("bgqk,bgqd->bkd", p, g32))
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def _plain_attention(q, k, v, kvm, *, causal, scale):
    """Materialized [G, T, S] scores, differentiated by autograd (JAX's
    ``"plain"``). q: [BKV, G, T, D]; k, v: [BKV, S, D]; kvm [BKV, S, 1]."""
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * scale
    t, s_len = q.shape[2], k.shape[1]
    if causal:
        mask = _causal_mask(0, 0, t, s_len, q.device)
        s = torch.where(mask[None, None], s, _NEG_INF)
    s = torch.where(kvm[..., 0][:, None, None, :] > 0, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    valid = m > _NEG_INF / 2  # all-masked rows -> zeros, matching flash
    p = torch.exp(s - torch.where(valid, m, 0.0))
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    out = torch.where(valid, acc / torch.where(l == 0, 1.0, l), 0.0)
    return out.to(q.dtype)


def _fold_q(x, hkv):
    """[B, T, Hq, D] -> [B*Hkv, G, T, D] (query head h = kv head h // G)."""
    b, t, hq, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * hkv, hq // hkv, t, d)


def _unfold_q(x, b):
    """[B*Hkv, G, T, D] -> [B, T, Hq, D]."""
    bkv, g, t, d = x.shape
    return x.reshape(b, (bkv // b) * g, t, d).permute(0, 2, 1, 3)


def _fold_kv(x):
    """[B, S, Hkv, D] -> [B*Hkv, S, D]."""
    b, s_len, hkv, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * hkv, s_len, d)


def _unfold_kv(x, b):
    """[B*Hkv, S, D] -> [B, S, Hkv, D]."""
    bkv, s_len, d = x.shape
    return x.reshape(b, bkv // b, s_len, d).permute(0, 2, 1, 3)


def _fold_mask(kv_mask, b, s_len, hkv, device):
    """[B, S] (or None: all keys) -> JAX's kvm layout [B*Hkv, S, 1] f32."""
    kvm = (torch.ones((b, s_len), dtype=torch.float32, device=device)
           if kv_mask is None else kv_mask.float())
    return kvm.repeat_interleave(hkv, dim=0).reshape(b * hkv, s_len, 1)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward, on the [B, T, Hq, D] layout.

    ``use_kernel`` launches the CUDA kernels (the caller passes it for CUDA
    tensors); otherwise the plain versions run. Saves q, k, v, the kv mask,
    out and lse, as JAX's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, block_k, use_kernel):
        b, hkv = q.shape[0], k.shape[2]
        if use_kernel:
            out, lse = kernels.flash_fwd(q, k, v, kv_mask, causal, scale)
        else:
            kvm = _fold_mask(kv_mask, b, k.shape[1], hkv, q.device)
            out_f, lse_f = _flash_fwd_plain(
                _fold_q(q, hkv), _fold_kv(k), _fold_kv(v), kvm,
                causal=causal, scale=scale, block_k=block_k)
            out = _unfold_q(out_f, b).contiguous()
            lse = lse_f.reshape(b, q.shape[2], q.shape[1])
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.block_k, ctx.use_kernel = block_k, use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if ctx.use_kernel:
            dq, dk, dv = kernels.flash_bwd(q, k, v, kv_mask, out, lse, g,
                                           ctx.causal, ctx.scale)
        else:
            b, hkv = q.shape[0], k.shape[2]
            hq, t = q.shape[2], q.shape[1]
            kvm = _fold_mask(kv_mask, b, k.shape[1], hkv, q.device)
            dq_f, dk_f, dv_f = _flash_bwd_plain(
                _fold_q(q, hkv), _fold_kv(k), _fold_kv(v), kvm,
                _fold_q(out, hkv), lse.reshape(b * hkv, hq // hkv, t, 1),
                _fold_q(g, hkv), causal=ctx.causal, scale=ctx.scale,
                block_k=ctx.block_k)
            dq, dk, dv = (_unfold_q(dq_f, b), _unfold_kv(dk_f, b),
                          _unfold_kv(dv_f, b))
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, kv_mask=None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int | None = None,
                    implementation: str | None = None):
    """Multi-head / grouped-query flash attention, JAX's layout and
    contract: q [B, T, Hq, D]; k, v [B, S, Hkv, D] with Hq a multiple of
    Hkv (query head h reads kv head h // G); ``kv_mask`` optional [B, S],
    truthy = attend. Returns [B, T, Hq, D] in q's dtype. A row that masks
    every key returns 0.

    ``implementation``:

    - None, ``"splash"``, ``"pallas"`` (the JAX names of its TPU kernels):
      the CUDA kernels for CUDA tensors (raising for a shape they do not
      take), the plain blockwise path for CPU tensors;
    - ``"xla"``: the plain blockwise path (online softmax over kv blocks of
      ``block_k``, backward recomputed from lse) on any device;
    - ``"plain"``: materialized scores, differentiated by autograd.

    ``block_q`` is accepted for JAX's signature and unused, as it is in
    JAX's paths."""
    del block_q
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(f"unknown implementation {implementation!r}; one of "
                         f"{_IMPLEMENTATIONS}")
    b, t, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    scale = (d ** -0.5) if scale is None else scale
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    if implementation == "plain":
        kvm = _fold_mask(kv_mask, b, s_len, hkv, q.device)
        out = _plain_attention(_fold_q(q, hkv), _fold_kv(k), _fold_kv(v),
                               kvm, causal=causal, scale=scale)
        return _unfold_q(out, b)
    use_kernel = q.device.type == "cuda" and implementation != "xla"
    if use_kernel:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(
        q, k, v, kv_mask, causal, float(scale),
        DEFAULT_BLOCK_K if block_k is None else block_k, use_kernel)


def _kv_payload(pool):
    """The payload array of a (possibly quantized) block pool."""
    return pool["q"] if isinstance(pool, dict) else pool


def _read_block(pool, blk):
    """Gather ONE physical block per row ([B] ids → [B, Bs, Hkv, hd] f32),
    dequantizing int8 payloads against their per-position scales."""
    if isinstance(pool, dict):
        return pool["q"][blk].float() * pool["scale"][blk][..., None]
    return pool[blk].float()


def _paged_walk(q32, k_pool, v_pool, table, pos, sm_scale, cols):
    """The online softmax over table columns ``cols`` from an empty state
    (``_paged_decode_xla``'s walk as a Python loop). q32: [B, Hkv, G, hd]
    f32; pos: [B] int64. Returns (m, l, acc) f32."""
    payload = _kv_payload(k_pool)
    n, bs = payload.shape[0], payload.shape[1]
    b, hkv, g, hd = q32.shape
    dev = q32.device
    m = torch.full((b, hkv, g, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, hd), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, device=dev)
    for j in cols:
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
    return m, l, acc


def _finish(m, l, acc):
    """acc / l, and 0 for a row that saw no key."""
    ok = m > _NEG_INF / 2
    return torch.where(ok, acc / torch.where(l == 0.0, torch.ones_like(l), l),
                       torch.zeros_like(acc))


def _paged_decode_plain(qg, k_pool, v_pool, table, pos, sm_scale):
    """Plain version of the kernel: one walk over every table column.
    qg: [B, Hkv, G, hd]; pools: [N, Bs, Hkv, hd] (or quantized dicts);
    table: [B, MB]; pos: [B]. Returns [B, Hkv, G, hd] f32."""
    return _finish(*_paged_walk(qg.float(), k_pool, v_pool, table,
                                pos.long(), sm_scale, range(table.shape[1])))


def _paged_decode_split_plain(qg, k_pool, v_pool, table, pos, sm_scale,
                              cols_per_split):
    """Plain version of the kernel's split-and-combine arithmetic (tests
    only). Split s walks table columns [s*cps, (s+1)*cps) from an empty
    state into a partial (m, l, acc); a split that starts past pos[b]
    stays empty (m = -1e30, l = 0, acc = 0). The partials combine in split
    order, each rescaled by exp(m_s - M); a row that saw nothing writes 0.
    Shapes as :func:`_paged_decode_plain`."""
    bs = _kv_payload(k_pool).shape[1]
    mb = table.shape[1]
    q32, pos = qg.float(), pos.long()
    parts = []
    for start in range(0, mb, cols_per_split):
        m, l, acc = _paged_walk(q32, k_pool, v_pool, table, pos, sm_scale,
                                range(start, min(start + cols_per_split, mb)))
        live = (start * bs <= pos)[:, None, None, None]
        parts.append((torch.where(live, m, _NEG_INF),
                      torch.where(live, l, 0.0), torch.where(live, acc, 0.0)))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_tot = torch.zeros_like(parts[0][1])
    acc_tot = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - big_m)
        l_tot = l_tot + l * w
        acc_tot = acc_tot + acc * w
    return _finish(big_m, l_tot, acc_tot)


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
