"""Autoregressive decoding over a paged KV cache for the transformer family.

Counterpart of ``kubeflow_tpu/models/decode.py`` for the paged layout
that ``serving/continuous.py`` drives: prefill a round's admissions into a
scratch dense cache and scatter them into the block pool
(:func:`paged_admit_rows_and_step`), then one token (:func:`decode_step`)
or ``steps`` tokens (:func:`decode_chunk`) for every slot. ``kv_fused``
reads the cache through the paged decode kernel instead of gathering the
dense ``[slots, total]`` view.

PyTorch runs eagerly, so the JAX ``lax.scan`` over layers is a loop over
``L`` reading views of the stacked ``[L, ...]`` weights and pools, and the
decode state is updated IN PLACE where JAX donates it
(``donate_argnames=("state",)``).

JAX drops out-of-bounds scatters and clamps out-of-bounds gathers; torch
does neither (it raises on the CPU and corrupts memory on CUDA), so every
such write is filtered and every such read clamped here, explicitly:
parked rows (``pos == total``), sentinel table entries (``== N``) and the
rotary lookup of a parked row.

The dense layout, the prefix pool, speculation and chunked prefill are not
yet ported.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    _head_kernel,
    _layer,
    _mlp,
)
from kubeflow_tpu_torch.ops.attention import _kv_payload as _kv_arr
from kubeflow_tpu_torch.ops.attention import paged_decode_attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import rotary_frequencies

_NEG_INF = -1e30


def _pool_layer(pool, i: int):
    """Layer ``i``'s view of a stacked pool (fp tensor or int8 dict)."""
    if isinstance(pool, dict):
        return {"q": pool["q"][i], "scale": pool["scale"][i]}
    return pool[i]


def init_cache(cfg: TransformerConfig, batch: int, total_len: int, device):
    """Per-layer K/V cache, stacked on a leading layer dim like the params."""
    shape = (cfg.n_layers, batch, total_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _gqa_attention(q, k_cache, v_cache, mask, cfg):
    """Grouped-query attention over a KV cache, K/V read at kv-head width.
    q: [B, S, H, hd]; cache: [B, T, Hkv, hd]; mask broadcastable to
    [B, Hkv, G, S, T]. Returns [B, S, H*hd]."""
    b, s, _h, hd = q.shape
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, s, cfg.n_kv_heads, group, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k_cache.float()) * (hd ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1).to(cfg.dtype)
    # JAX promotes a bf16 p against f32 (dequantized int8) values to f32.
    dt = torch.promote_types(p.dtype, v_cache.dtype)
    return torch.einsum("bkgst,btkd->bskgd", p.to(dt),
                        v_cache.to(dt)).reshape(b, s, cfg.n_heads * hd)


def _rope(x, cos, sin):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _qkv(x, layer, cfg, rope_bt):
    b, s, _d = x.shape
    hd = cfg.head_dim
    cos, sin = rope_bt
    q = (x @ layer["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ layer["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ layer["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return _rope(q, cos, sin), _rope(k, cos, sin), v


def _cached_attention(x, layer, cfg, rope_bt, k_cache, v_cache, pos, valid):
    """x: [B, S, D] at cache slots pos..pos+S; attends over the full cache
    masked by ``valid`` [B, total]. Writes the caches in place (the JAX
    function returns new ones). Returns out [B, S, D]."""
    s = x.shape[1]
    total = k_cache.shape[1]
    if pos + s > total:
        raise ValueError(f"cache write {pos}..{pos + s} past {total} slots")
    q, k, v = _qkv(x, layer, cfg, rope_bt)
    k_cache[:, pos:pos + s] = k
    v_cache[:, pos:pos + s] = v
    dev = x.device
    j_idx = torch.arange(total, device=dev)[None, None, :]
    i_idx = pos + torch.arange(s, device=dev)[None, :, None]
    mask = (j_idx <= i_idx) & valid[:, None, :]
    out = _gqa_attention(q, k_cache, v_cache, mask[:, None, None], cfg)
    return out @ layer["wo"]


def forward_cached(params, tokens, cfg: TransformerConfig, cache, pos,
                   positions, valid):
    """tokens [B, S] at cache slots pos..pos+S with true sequence positions
    ``positions`` [B, S] → logits [B, S, V] f32; ``cache`` is written in
    place."""
    cos_t, sin_t = rotary_frequencies(cfg.head_dim, cache["k"].shape[2],
                                      theta=cfg.rope_theta,
                                      device=tokens.device)
    rope_bt = (cos_t[positions], sin_t[positions])
    x = params["embed"]["kernel"][tokens]
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["ln_attn"], eps=cfg.norm_eps)
        x = x + _cached_attention(h, layer["attn"], cfg, rope_bt,
                                  cache["k"][i], cache["v"][i], pos, valid)
        h = rms_norm(x, layer["ln_mlp"], eps=cfg.norm_eps)
        x = x + _mlp(h, layer["mlp"], cfg)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return (x @ _head_kernel(params, cfg)).float()


def _top_k_mask(logits, top_k: int):
    """Mask everything below the k-th logit to -1e30 (no-op for top_k=0)."""
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, _NEG_INF),
                             logits)
    return logits


def sample_token(logits, generator, temperature, top_k: int = 0):
    """logits [B, V], temperature [B] (<=0 → greedy), static top_k. The
    sampled draw is Gumbel-max, like ``jax.random.categorical``: the same
    distribution, not the same numbers. Greedy ties take the first
    index, as in JAX."""
    greedy = torch.argmax(logits, dim=-1)
    logits = _top_k_mask(logits, top_k)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(logits / temp + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------
#
# The pool is ``[L, num_blocks, block_size, Hkv, hd]``; slot ``b``'s virtual
# position ``p`` lives at block ``table[b, p // Bs]``, offset ``p % Bs``.
# Table entries are initialised to ``num_blocks`` (the unallocated
# sentinel): writes through them are dropped and reads clamp into junk the
# span mask already excludes.


def _quantize_kv(vals):
    """Abs-max int8 quantization of K/V values ``[..., H, hd]`` with one
    f32 scale per (position, head): ``{"q": int8, "scale": [..., H]}``.
    All-zero vectors map to scale 0 → exact zeros on dequant.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    v32 = vals.float()
    scale = torch.amax(torch.abs(v32), dim=-1) / 127.0
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(v32 / safe[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def _pool_gather(pool, table):
    """Read a layer's block pool ``[N, Bs, H, hd]`` through block table
    ``[B, MB]`` into virtual rows ``[B, MB*Bs, H, hd]``. Sentinel entries
    clamp to the last block; quantized pools dequantize to f32."""
    arr = _kv_arr(pool)
    n, _bs, h, hd = arr.shape
    b = table.shape[0]
    idx = table.long().clamp(0, n - 1)
    if isinstance(pool, dict):
        q = pool["q"][idx].reshape(b, -1, h, hd).float()
        s = pool["scale"][idx].reshape(b, -1, h)
        return q * s[..., None]
    return arr[idx].reshape(b, -1, h, hd)


def _write_index(table, cols, n: int, bs: int):
    """Where ``_pool_write`` lands each of ``cols`` [B, S]: the (row,
    token) pairs to keep and their physical (block, offset). Out-of-range
    cols (rows parked at ``total``) and sentinel table entries are
    FILTERED OUT here — JAX drops those scatters; torch would fault."""
    mb = table.shape[1]
    cols = cols.long()
    blk = torch.gather(table.long(), 1, torch.clamp(cols // bs, 0, mb - 1))
    keep = (cols >= 0) & (cols < mb * bs) & (blk < n)
    rows, toks = keep.nonzero(as_tuple=True)
    return rows, toks, blk[rows, toks], cols[rows, toks] % bs


def _pool_write(pool, table, cols, vals, index=None):
    """Scatter ``vals`` [B, S, H, hd] IN PLACE at per-row virtual
    positions ``cols`` [B, S] through the block table; dropped writes are
    filtered (:func:`_write_index`, or a precomputed ``index`` of it).
    Quantized pools quantize at scatter time, payload and scales
    together."""
    arr = _kv_arr(pool)
    rows, toks, blk, off = (index if index is not None
                            else _write_index(table, cols, arr.shape[0],
                                              arr.shape[1]))
    v = vals[rows, toks]
    if isinstance(pool, dict):
        qd = _quantize_kv(v)
        pool["q"][blk, off] = qd["q"]
        pool["scale"][blk, off] = qd["scale"]
    else:
        pool[blk, off] = v.to(pool.dtype)
    return pool


def _ragged_attention(x, layer, cfg, rope_bt, k_cache, v_cache, pos_b, valid,
                      table, fused=False, write_index=None):
    """Single-token attention where row ``b`` writes virtual position
    ``pos_b[b]`` of its paged row. x: [B, 1, D]; pos_b: [B]; valid:
    [B, total]; caches: one layer's block pools, written in place. With
    ``fused`` the read is the paged decode kernel (no gathered view);
    otherwise the row is gathered at block granularity."""
    b, s, _d = x.shape
    hd = cfg.head_dim
    q, k, v = _qkv(x, layer, cfg, rope_bt)
    _pool_write(k_cache, table, pos_b[:, None], k, write_index)
    _pool_write(v_cache, table, pos_b[:, None], v, write_index)
    if fused:
        # The decode step's validity mask is exactly "positions <= pos_b"
        # (the just-written token included): the kernel's span contract.
        out = paged_decode_attention(
            q[:, 0], k_cache, v_cache, table, pos_b,
            n_kv_heads=cfg.n_kv_heads,
        ).reshape(b, s, cfg.n_heads * hd).to(cfg.dtype)
        return out @ layer["wo"]
    k_read = _pool_gather(k_cache, table)
    v_read = _pool_gather(v_cache, table)
    out = _gqa_attention(q, k_read, v_read, valid[:, None, None, None, :],
                         cfg)
    # Quantized pools dequantize to f32; fold back to the compute dtype.
    return out.to(cfg.dtype) @ layer["wo"]


def retire_row(state, slot: int):
    """Host-initiated early stop: clear ``active`` and park the row's
    write position at ``total`` so later steps neither sample for it nor
    land its writes. In place."""
    total = _state_kv(state)[3]
    state["active"][slot] = False
    state["length"][slot] = total
    return state


def _state_kv(state):
    """``(k, v, table, total)`` of a paged decode state: the stacked block
    pools ``[L, N, Bs, H, hd]``, the ``[slots, max_blocks]`` table and the
    virtual row width. (JAX's ``_with_kv`` has no counterpart: the pools
    are written in place.)"""
    if "pool" not in state:
        raise ValueError("the dense KV layout is not yet ported")
    k = state["pool"]["k"]
    table = state["block_table"]
    return k, state["pool"]["v"], table, table.shape[1] * _kv_arr(k).shape[2]


def _single_token_forward(params, cfg: TransformerConfig, k_pool, v_pool,
                          tok, pos_b, table, fused=False):
    """One [B, 1] forward at per-row virtual positions ``pos_b`` against
    the stacked pools (written in place). Returns logits [B, V] f32."""
    n, bs = _kv_arr(k_pool).shape[1], _kv_arr(k_pool).shape[2]
    total = table.shape[1] * bs
    dev = tok.device
    cos_t, sin_t = rotary_frequencies(cfg.head_dim, total,
                                      theta=cfg.rope_theta, device=dev)
    # A parked row sits at pos == total; JAX clamps its table lookup.
    rpos = torch.clamp(pos_b.long(), 0, total - 1)[:, None]
    rope_bt = (cos_t[rpos], sin_t[rpos])
    x = params["embed"]["kernel"][tok.long()][:, None]
    valid = torch.arange(total, device=dev)[None, :] <= pos_b[:, None]
    # Every layer writes the same (row, position) set: filter once.
    widx = _write_index(table, pos_b[:, None], n, bs)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["ln_attn"], eps=cfg.norm_eps)
        x = x + _ragged_attention(
            h, layer["attn"], cfg, rope_bt, _pool_layer(k_pool, i),
            _pool_layer(v_pool, i), pos_b, valid, table, fused, widx)
        h = rms_norm(x, layer["ln_mlp"], eps=cfg.norm_eps)
        x = x + _mlp(h, layer["mlp"], cfg)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return (x @ _head_kernel(params, cfg)).float()[:, 0]


def _decode_step_body(state, params, cfg: TransformerConfig, top_k: int,
                      eos_id: int | None, fused: bool = False):
    """One decode step, in place. A row that samples ``eos_id`` is parked
    on the device (active cleared, write position parked at ``total``
    like :func:`retire_row`). Returns (state, tok [slots], emit
    [slots])."""
    k0, v0, table, total = _state_kv(state)
    emit = state["active"].clone()
    tok = sample_token(state["last_logits"], state["generator"],
                       state["temperature"], top_k)
    p_b = state["length"]
    logits = _single_token_forward(params, cfg, k0, v0, tok, p_b, table,
                                   fused)
    step_inc = emit.to(torch.int32)
    length = p_b + step_inc
    remaining = state["remaining"] - step_inc
    active = emit & (remaining > 0) & (length < total)
    if eos_id is not None:
        hit_eos = emit & (tok == eos_id)
        active = active & ~hit_eos
        length = torch.where(hit_eos, torch.full_like(length, total), length)
    state["length"].copy_(length)
    state["remaining"].copy_(remaining)
    state["active"].copy_(active)
    state["last_logits"].copy_(torch.where(emit[:, None], logits,
                                           state["last_logits"]))
    return state, tok, emit


@torch.inference_mode()
def decode_step(state, params, cfg: TransformerConfig, top_k: int = 0,
                eos_id: int | None = None, kv_fused: bool = False):
    """One token for every active row: sample from each row's last logits,
    run the [slots, 1] forward at per-row positions, refresh the state in
    place. Returns (state, sampled token [slots], emitted mask [slots])."""
    return _decode_step_body(state, params, cfg, top_k, eos_id, kv_fused)


@torch.inference_mode()
def decode_chunk(state, params, cfg: TransformerConfig, steps: int,
                 top_k: int = 0, eos_id: int | None = None,
                 kv_fused: bool = False):
    """``steps`` decode steps in a loop (JAX fuses them into one dispatch
    with ``lax.scan``). Returns (state, tokens [steps, slots], emitted
    [steps, slots])."""
    toks, emits = [], []
    for _ in range(steps):
        state, tok, emit = _decode_step_body(state, params, cfg, top_k,
                                             eos_id, kv_fused)
        toks.append(tok)
        emits.append(emit)
    return state, torch.stack(toks), torch.stack(emits)


def init_paged_state(cfg: TransformerConfig, slots: int, num_blocks: int,
                     block_size: int, max_blocks_per_seq: int, seed: int = 0,
                     kv_dtype: str = "fp", *, device="cuda"):
    """Paged server decode state: a block pool ``[L, num_blocks,
    block_size, Hkv, hd]`` shared by all slots, a per-slot block table and
    the per-slot scalars. ``kv_dtype="int8"`` stores the pool quantized
    (int8 payload + one f32 scale per (layer, position, kv head), indexed
    by the same block ids). ``generator`` takes the place of JAX's key."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if kv_dtype == "int8":
        def _pool():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=dev)}
        pool = {"k": _pool(), "v": _pool()}
    elif kv_dtype in ("", "fp"):
        pool = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return {
        "pool": pool,
        "block_table": torch.full((slots, max_blocks_per_seq), num_blocks,
                                  dtype=torch.int32, device=dev),
        "length": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "remaining": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
        "temperature": torch.zeros((slots,), dtype=torch.float32,
                                   device=dev),
        "last_logits": torch.zeros((slots, cfg.vocab_size),
                                   dtype=torch.float32, device=dev),
        "generator": generator,
    }


def _paged_admit_rows_body(state, params, cfg: TransformerConfig, slots,
                           prompt_tokens, prompt_lengths, remaining,
                           temperature):
    """Prefill a round's admissions into a scratch dense cache (the dense
    path's math), then scatter each row's K/V into the pool blocks the
    host allocated for its slot (``state["block_table"][slots]``);
    sentinel entries are filtered out. ``slots`` may repeat only as bucket
    padding that duplicates a real admission verbatim, so duplicate
    indices carry identical payloads. In place; returns (state, last
    [K, V])."""
    pool_k, pool_v = state["pool"]["k"], state["pool"]["v"]
    n, bs = _kv_arr(pool_k).shape[1], _kv_arr(pool_k).shape[2]
    mb = state["block_table"].shape[1]
    total = mb * bs
    b, t0 = prompt_tokens.shape
    dev = prompt_tokens.device
    cache = init_cache(cfg, b, total, dev)
    prompt_lengths = torch.clamp(prompt_lengths, min=1)
    valid = (torch.arange(total, device=dev)[None, :]
             < prompt_lengths[:, None])
    positions = torch.arange(t0, device=dev)[None].expand(b, t0)
    logits = forward_cached(params, prompt_tokens.long(), cfg, cache, 0,
                            positions, valid)
    last = logits[torch.arange(b, device=dev), prompt_lengths.long() - 1]
    slots = slots.long()
    rows_tbl = state["block_table"][slots].long()  # [b, mb]
    rows, cols = (rows_tbl < n).nonzero(as_tuple=True)
    blk = rows_tbl[rows, cols]
    for pool, side in ((pool_k, "k"), (pool_v, "v")):
        upd = cache[side].reshape(cfg.n_layers, b, mb, bs, cfg.n_kv_heads,
                                  cfg.head_dim)[:, rows, cols]
        if isinstance(pool, dict):
            qd = _quantize_kv(upd)
            pool["q"][:, blk] = qd["q"]
            pool["scale"][:, blk] = qd["scale"]
        else:
            pool[:, blk] = upd
    state["length"][slots] = prompt_lengths.to(torch.int32)
    state["remaining"][slots] = remaining.to(torch.int32)
    state["active"][slots] = remaining > 0
    state["temperature"][slots] = temperature.float()
    state["last_logits"][slots] = last
    return state, last


@torch.inference_mode()
def paged_admit_rows_and_step(state, params, cfg: TransformerConfig, slots,
                              prompt_tokens, prompt_lengths, remaining,
                              temperature, top_k: int = 0,
                              eos_id: int | None = None,
                              kv_fused: bool = False):
    """Prefill ``[K, T0]`` prompts, scatter them into the slots' allocated
    pool blocks, AND run one decode step for every active row. The host
    must have written each admitted slot's block-table row first. Returns
    (state, prefill last-logits [K, V], sampled token [slots], emitted
    mask [slots])."""
    state, last = _paged_admit_rows_body(state, params, cfg, slots,
                                         prompt_tokens, prompt_lengths,
                                         remaining, temperature)
    state, tok, emit = _decode_step_body(state, params, cfg, top_k, eos_id,
                                         kv_fused)
    return state, last, tok, emit
