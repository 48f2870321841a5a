"""Autoregressive decoding with a KV cache for the transformer family.

Counterpart of ``kubeflow_tpu/models/decode.py``:

- the lockstep :func:`generate` (prefill, then a loop of single-token
  forwards against the cache);
- the continuous-batching primitives ``serving/continuous.py`` drives, on
  both KV layouts. Dense: one ``[total]`` cache row per slot
  (:func:`init_decode_state`, :func:`prefill`, :func:`insert_row`,
  :func:`admit_rows_and_step`). Paged: a block pool behind per-slot block
  tables (:func:`init_paged_state`, :func:`paged_admit_rows_and_step`);
  ``kv_fused`` reads it through the paged decode kernel instead of
  gathering the dense ``[slots, total]`` view. Either layout then takes
  one token (:func:`decode_step`) or ``steps`` tokens
  (:func:`decode_chunk`) for every slot;
- the dense prefix pool (:func:`init_prefix_pool`,
  :func:`store_prefix_row`, :func:`store_prefix_cache`,
  :func:`admit_prefix_and_step`);
- the paged prefix path and chunked prefill, both riding the span
  forward :func:`_block_forward` (K/V written at per-row start
  positions, into the dense rows or through the block table):
  :func:`paged_admit_prefix_and_step` (suffix-only prefill over
  refcount-shared blocks), :func:`paged_prefill_chunk` (an interior
  chunk of a long admission), :func:`store_blocks` (the paged prime)
  and :func:`copy_block` (the copy-on-write of a partly shared tail
  block);
- the context-parallel span read (``ring`` of :func:`_block_forward`,
  :func:`paged_prefill_chunk` and :func:`paged_admit_prefix_and_step`)
  and a replica of pipeline stages (see the comment on the shards below);
- the KV handoff: :func:`export_blocks` gathers pool blocks into a
  standalone payload (fp arrays, or int8 codes with their scales) and
  :func:`import_blocks` scatters one into other blocks as it came, with
  no second quantization — the halves of the prefill/decode handoff, of
  the host tier's demotion and promotion and of a stream's suspension;
- speculative decoding on either layout: :func:`verify_step` and
  :func:`verify_chunk` (a [slots, K] scoring pass through the span
  forward, then the single-token commit pass), and the draft model's
  :func:`extend_and_propose` (``serving/speculative.py`` holds the
  proposers).

PyTorch runs eagerly, so the JAX ``lax.scan`` over layers is a loop over
``L`` reading views of the stacked ``[L, ...]`` weights and caches, and
the decode state and the prefix pool are updated IN PLACE where JAX
donates the state or returns a new pool.

JAX drops out-of-bounds scatters, clamps out-of-bounds gathers and clamps
the start of ``dynamic_update_slice``; torch does none of these (it raises
on the CPU and corrupts memory on CUDA), so here every such write is
filtered and every such read clamped explicitly: parked rows (``pos ==
total``) write back what they hold, sentinel table entries (``== N``) are
filtered, the rotary lookup of a parked row clamps, and a row or pool
index out of range, or a cache write past the row's end, raises. A span
that runs past its row (JAX's "cache-tail spill") loses the columns past
the row the same way: :func:`_write_index` filters them on the paged
layout, :func:`_dense_write_index` lands them on what the row already
holds on the dense one.

Speculation draws its accept and resample randomness from the state's
``generator`` where JAX splits its threefry key: greedy rows are exact,
sampled rows keep the target distribution, not JAX's numbers.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    _ffn,
    _head_kernel,
    _layer,
    shard_config,
)
from kubeflow_tpu_torch.ops.attention import _kv_payload as _kv_arr
from kubeflow_tpu_torch.ops.attention import (
    paged_decode_attention,
    paged_span_attention,
    ring_span_attention,
)
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import rotary_frequencies
from kubeflow_tpu_torch.parallel.collectives import reduce_shards
from kubeflow_tpu_torch.parallel.mesh import PipelineStages, TensorShards
from kubeflow_tpu_torch.parallel.sharding import split_kv_heads, vocab_rows

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Tensor-parallel shards and pipeline stages (serving/continuous.py's
# tp_shards, pp_stages)
# ---------------------------------------------------------------------------
#
# A tensor-parallel replica hands every function below a TensorShards of
# per-shard parameter trees (the Megatron split of split_tensor) and a
# state whose KV payload, dense rows or paged pool, fp or {"q", "scale"},
# is a TensorShards of per-shard tensors over the KV-head dim
# (shard_decode_state). Each layer runs on every shard's heads and
# d_ff columns; the partial outputs of wo and down are summed across the
# shards (reduce_shards) into every shard's copy of the residual. The
# embedding is looked up per vocabulary shard and summed, and the logits
# are the shards' vocabulary slices side by side, so sampling sees the
# whole row. Block ids index the undivided block dim: the tables,
# lengths, logits and the generator stay once, on shard 0's device, and
# the allocator, trie, refcount/CoW and handoff never see the split. A
# plain tree and plain tensors are one shard: the unsharded path, op for
# op.
#
# A pipeline-parallel replica (serving/continuous.py's pp_stages) hands
# them a PipelineStages of per-stage values instead, each a plain value or
# the stage's TensorShards: stage s holds its range of the stacked layer
# leaves and of the KV store's layer dim (and every other leaf whole, as
# JAX replicates them over pipeline). The layers run stage by stage, the
# residual moved to the next stage's devices; the embedding is stage 0's,
# the head the last stage's, and the logits come back to stage 0's
# shard 0's device with the tables and the generator. The chunk
# dispatches' ``ring`` (context parallelism) holds each stage's shards'
# ring devices.


def _stage_list(x) -> list:
    """The per-stage values of a pipeline-staged value (a one-stage list
    otherwise)."""
    return list(x) if isinstance(x, PipelineStages) else [x]


def _shard_values(x) -> list:
    return list(x) if isinstance(x, TensorShards) else [x]


def _parts(x) -> list:
    """Every (stage, shard) part of ``x`` in stage-major order: the
    tensors a whole-store operation touches one by one (a pool and a
    cache of one replica have the same parts)."""
    return [p for st in _stage_list(x) for p in _shard_values(st)]


def _first(x):
    """Stage 0's shard 0's value (the value itself when unsharded)."""
    while isinstance(x, (PipelineStages, TensorShards)):
        x = x[0]
    return x


def _map(fn, *xs):
    """``fn`` over the parts of ``xs`` (zipped), keeping ``xs[0]``'s
    stages and shards."""
    if isinstance(xs[0], PipelineStages):
        return PipelineStages(_map(fn, *a) for a in zip(*map(_stage_list,
                                                             xs)))
    if isinstance(xs[0], TensorShards):
        return TensorShards(fn(*a) for a in zip(*map(_shard_values, xs)))
    return fn(*xs)


def _on(x, dev):
    """``x`` (a tensor, None, or a tuple of them) on ``dev``."""
    if isinstance(x, tuple):
        return tuple(_on(t, dev) for t in x)
    return x if x is None or x.device == dev else x.to(dev)


_shard_config = functools.lru_cache(maxsize=16)(shard_config)


@functools.lru_cache(maxsize=16)
def _stage_config(cfg: TransformerConfig, pp: int) -> TransformerConfig:
    """The config of one of ``pp`` pipeline stages: its share of the
    layers."""
    return cfg if pp == 1 else replace(cfg, n_layers=cfg.n_layers // pp)


def _shards(params, cfg: TransformerConfig) -> list:
    """(parameters, config, device) of each shard of one stage: ``cfg``
    itself for an unsharded tree, else one shard's view of it
    (``shard_config``)."""
    parts = _shard_values(params)
    scfg = _shard_config(cfg, len(parts))
    return [(p, scfg, p["embed"]["kernel"].device) for p in parts]


def _stages(params, cfg: TransformerConfig) -> list:
    """:func:`_shards` of each pipeline stage, stage order (one stage for
    an unstaged tree)."""
    stages = _stage_list(params)
    scfg = _stage_config(cfg, len(stages))
    return [_shards(p, scfg) for p in stages]


def _embed(shards, tokens) -> list:
    """Each shard's copy of the embeddings of ``tokens`` (long): shard
    ``i`` holds rows ``i * V/tp ..`` of the table, looks up the tokens it
    holds, zeros the rest, and the shards' rows are summed (one nonzero
    term a token)."""
    if len(shards) == 1:
        return [shards[0][0]["embed"]["kernel"][tokens]]
    return reduce_shards([vocab_rows(p["embed"]["kernel"], tokens, i)
                          for i, (p, _cfg, _dev) in enumerate(shards)])


def _logits(stages, xs):
    """Final norm and head on each shard of the last stage, f32, the
    vocabulary slices side by side on stage 0's shard 0's device (where
    the tables, lengths and logits live)."""
    out = []
    for (p, cfg, _dev), x in zip(stages[-1], xs):
        x = rms_norm(x, p["final_norm"], eps=cfg.norm_eps)
        out.append((x @ _head_kernel(p, cfg)).float())
    home = stages[0][0][2]
    if len(out) == 1:
        return _on(out[0], home)
    return torch.cat([o.to(home) for o in out], dim=-1)


def _layers(stages, xs, attend, token_valid=None) -> list:
    """The layer stack over a replica's stages and shards from stage 0's
    shards' residuals ``xs``: ``attend(st, i, s, h, attn, cfg)`` is stage
    ``st``'s shard ``s``'s attention output at its layer ``i`` for its
    normed input ``h`` (its heads through its rows of wo); the FFN is its
    d_ff columns. Each sublayer's partial outputs are summed across the
    stage's shards into every residual; the residual moves to the next
    stage's shards (their devices) between stages. Returns the last
    stage's shards' residuals."""
    for st, shards in enumerate(stages):
        if st:
            xs = [_on(xs[0], dev) for _p, _c, dev in shards]
        tvs = [_on(token_valid, dev) for _p, _c, dev in shards]
        for i in range(shards[0][1].n_layers):
            layers = [_layer(p, i) for p, _c, _d in shards]
            parts = [attend(st, i, s, rms_norm(x, layer["ln_attn"],
                                               eps=cfg.norm_eps),
                            layer["attn"], cfg)
                     for s, ((_p, cfg, _d), x, layer)
                     in enumerate(zip(shards, xs, layers))]
            xs = [x + part for x, part in zip(xs, reduce_shards(parts))]
            parts = [_ffn(rms_norm(x, layer["ln_mlp"], eps=cfg.norm_eps),
                          layer["mlp"], cfg, tv)[0]
                     for (_p, cfg, _d), x, layer, tv
                     in zip(shards, xs, layers, tvs)]
            xs = [x + part for x, part in zip(xs, reduce_shards(parts))]
    return xs


def _stage_args(stages, *values) -> list:
    """``values`` (tensors, None or tuples of them) on each shard's
    device, indexed [stage][shard]."""
    return [[_on(values, dev) for _p, _c, dev in shards] for shards in stages]


def _kv_stages(side) -> list:
    """One side of a KV store as [stage][shard] parts."""
    return [_shard_values(st) for st in _stage_list(side)]


def _new_cache(params, cfg: TransformerConfig, batch: int, total_len: int,
               device):
    """A zeroed dense cache for ``params``: one per stage and shard
    (their layers and KV heads, on their devices) for a staged or
    sharded tree."""
    if not isinstance(params, (TensorShards, PipelineStages)):
        return init_cache(cfg, batch, total_len, device)
    out = {"k": [], "v": []}
    for p, shards in zip(_stage_list(params), _stages(params, cfg)):
        caches = [init_cache(c, batch, total_len, dev)
                  for _p, c, dev in shards]
        for side, parts in out.items():
            parts.append(TensorShards(c[side] for c in caches)
                         if isinstance(p, TensorShards) else caches[0][side])
    if isinstance(params, PipelineStages):
        return {side: PipelineStages(v) for side, v in out.items()}
    return {side: v[0] for side, v in out.items()}


def _layer_slice(side, start: int, stop: int):
    """Layers ``[start, stop)`` of one side of a stacked KV store (fp or
    ``{"q", "scale"}``), as contiguous tensors of their own."""
    if isinstance(side, dict):
        return {k: v[start:stop].clone() for k, v in side.items()}
    return side[start:stop].clone()


def _split_side(side, stages: list):
    """One side of a KV store cut for a replica whose stage ``st`` runs
    on the tensor shards of ``stages[st]`` (their devices)."""
    n = _kv_arr(side).shape[0] // len(stages)
    out = []
    for st, devices in enumerate(stages):
        part = side if len(stages) == 1 else \
            _layer_slice(side, st * n, (st + 1) * n)
        if len(devices) > 1:
            out.append(split_kv_heads(part, devices))
        elif isinstance(part, dict):
            out.append({k: v.to(devices[0]) for k, v in part.items()})
        else:
            out.append(part.to(devices[0]))
    return PipelineStages(out) if len(stages) > 1 else out[0]


def shard_decode_state(state, devices, stages: int = 1):
    """A decode state (or a dense prefix pool: any ``{"k", "v"}`` tree)
    for a replica of ``stages`` pipeline stages of ``len(devices) /
    stages`` tensor shards each (``devices`` stage-major): its KV payload,
    dense rows or paged pool, fp or ``{"q", "scale"}``, cut on its
    leading layer dim into the stages' layer ranges
    (``parallel.pipeline.stage_layer_ranges``) and each range over the
    KV-head dim into one contiguous tensor a shard on its device (JAX's
    ``shard_decode_state`` with ``pp_axis``); the tables, lengths, logits
    and the generator stay as they are, once."""
    tp = len(devices) // stages
    per_stage = [list(devices[st * tp:(st + 1) * tp])
                 for st in range(stages)]
    if set(state) == {"k", "v"}:
        return {s: _split_side(state[s], per_stage) for s in ("k", "v")}
    out = dict(state)
    for name in ("pool", "cache"):
        if name in state:
            out[name] = {s: _split_side(state[name][s], per_stage)
                         for s in ("k", "v")}
    return out


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
    q, k, v = _qkv(x, layer, cfg, rope_bt)
    k_cache[:, pos:pos + s] = k
    v_cache[:, pos:pos + s] = v
    dev = x.device
    j_idx = torch.arange(total, device=dev)[None, None, :]
    i_idx = pos + torch.arange(s, device=dev)[None, :, None]
    mask = (j_idx <= i_idx) & valid[:, None, :]
    out = _gqa_attention(q, k_cache, v_cache, mask[:, None, None], cfg)
    return out @ layer["wo"]


def _moe_valid(cfg: TransformerConfig, width: int, n, dev):
    """[rows, width] bool: the first ``n`` columns of each row (``n`` an
    int, or a [rows] tensor), the tokens that claim MoE expert capacity;
    None for a dense model, whose FFN reads no mask, so its calls spend
    no launches on one."""
    if not cfg.n_experts:
        return None
    if isinstance(n, torch.Tensor):
        n = n[:, None]
    return torch.arange(width, device=dev)[None, :] < n


def forward_cached(params, tokens, cfg: TransformerConfig, cache, pos,
                   positions, valid, token_valid=None):
    """tokens [B, S] at cache slots pos..pos+S with true sequence positions
    ``positions`` [B, S] → logits [B, S, V] f32; ``cache`` is written in
    place. ``token_valid`` ([B, S] bool) marks the real tokens of this
    block: MoE routing gives padding no expert capacity. A block that
    would end past the cache raises (JAX's ``dynamic_update_slice`` would
    clamp its start and overwrite earlier slots)."""
    total = _first(cache["k"]).shape[2]
    if not 0 <= pos <= total - tokens.shape[1]:
        raise ValueError(f"cache write {pos}..{pos + tokens.shape[1]} "
                         f"outside {total} slots")
    cos_t, sin_t = rotary_frequencies(cfg.head_dim, total,
                                      theta=cfg.rope_theta,
                                      device=tokens.device)
    rope_bt = (cos_t[positions], sin_t[positions])
    stages = _stages(params, cfg)
    ks, vs = _kv_stages(cache["k"]), _kv_stages(cache["v"])
    args = _stage_args(stages, *rope_bt, valid)

    def attend(st, i, s, h, attn, c):
        cos, sin, valid_s = args[st][s]
        return _cached_attention(h, attn, c, (cos, sin), ks[st][s][i],
                                 vs[st][s][i], pos, valid_s)

    xs = _layers(stages, _embed(stages[0], tokens), attend, token_valid)
    return _logits(stages, xs)


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


def _dense_write_index(pos_b, s: int, total: int):
    """Where a dense write of ``s`` tokens a row at ``pos_b`` lands, at a
    fixed shape: (rows [B, 1], positions [B, S] clamped into the row, the
    token each position takes [B, S], keep [B, 1, 1, 1]). A column past
    the row (the span's cache-tail spill) lands on the row's last
    position with that position's own token, and a parked row (``pos ==
    total``) keeps nothing, so duplicate indices always carry the same
    value — JAX drops those scatters; torch would fault."""
    dev = pos_b.device
    pos = pos_b.long()[:, None]
    cols = torch.clamp(pos + torch.arange(s, device=dev)[None, :], 0,
                       total - 1)
    rows = torch.arange(pos_b.shape[0], device=dev)[:, None]
    return (rows, cols, torch.clamp(cols - pos, 0, s - 1),
            (pos < total)[:, :, None, None])


def _dense_write(cache, new, index) -> None:
    """Write ``new`` [B, S, H, hd] into one layer's dense rows through
    ``index`` (:func:`_dense_write_index`), in place: a dropped position
    gets back what it holds."""
    rows, cols, src, keep = index
    cache[rows, cols] = torch.where(keep, new[rows, src], cache[rows, cols])


def _ragged_attention(x, layer, cfg, rope_bt, k_cache, v_cache, pos_b, valid,
                      table, fused=False, write_index=None):
    """Single-token attention where row ``b`` writes position ``pos_b[b]``
    of its row. x: [B, 1, D]; pos_b: [B]; valid: [B, total]; caches: one
    layer's dense ``[slots, total, H, hd]`` rows (``table`` None) or block
    pools, written in place. A dense row writes through
    ``write_index`` (:func:`_dense_write_index`): a parked row writes back
    what it holds. On a paged pool ``fused`` reads through the paged
    decode kernel (no gathered view); otherwise the row is gathered at
    block granularity."""
    b, s, _d = x.shape
    hd = cfg.head_dim
    q, k, v = _qkv(x, layer, cfg, rope_bt)
    if table is None:
        _dense_write(k_cache, k, write_index)
        _dense_write(v_cache, v, write_index)
        out = _gqa_attention(q, k_cache, v_cache,
                             valid[:, None, None, None, :], cfg)
        return out @ layer["wo"]
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
    """``(k, v, table, total)`` of a decode state on either layout: dense
    ``[L, slots, total, H, hd]`` caches (table None), or the paged block
    pools ``[L, N, Bs, H, hd]``, the ``[slots, max_blocks]`` table and the
    virtual row width. (JAX's ``_with_kv`` has no counterpart: the caches
    are written in place.)"""
    if "pool" in state:
        k = state["pool"]["k"]
        table = state["block_table"]
        return (k, state["pool"]["v"], table,
                table.shape[1] * _kv_arr(_first(k)).shape[2])
    k = state["cache"]["k"]
    return k, state["cache"]["v"], None, _first(k).shape[2]


def _single_token_forward(params, cfg: TransformerConfig, k_pool, v_pool,
                          tok, pos_b, table, fused=False, token_valid=None):
    """One [B, 1] forward at per-row positions ``pos_b`` against the
    stacked dense caches (``table`` None) or block pools, written in
    place. ``token_valid`` [B] marks the rows whose token claims MoE
    capacity. Returns logits [B, V] f32."""
    dev = tok.device
    k0 = _first(k_pool)
    # Every layer writes the same (row, position) set: index it once.
    if table is None:
        total = k0.shape[2]
        widx = _dense_write_index(pos_b, 1, total)
    else:
        n, bs = _kv_arr(k0).shape[1], _kv_arr(k0).shape[2]
        total = table.shape[1] * bs
        widx = _write_index(table, pos_b[:, None], n, bs)
    cos_t, sin_t = rotary_frequencies(cfg.head_dim, total,
                                      theta=cfg.rope_theta, device=dev)
    # A parked row sits at pos == total; JAX clamps its table lookup.
    rpos = torch.clamp(pos_b.long(), 0, total - 1)[:, None]
    rope_bt = (cos_t[rpos], sin_t[rpos])
    valid = torch.arange(total, device=dev)[None, :] <= pos_b[:, None]
    tv = None if token_valid is None else token_valid[:, None]
    stages = _stages(params, cfg)
    ks, vs = _kv_stages(k_pool), _kv_stages(v_pool)
    args = _stage_args(stages, *rope_bt, pos_b, valid, table, widx)

    def attend(st, i, s, h, attn, c):
        cos, sin, pos_s, valid_s, table_s, widx_s = args[st][s]
        return _ragged_attention(
            h, attn, c, (cos, sin), _pool_layer(ks[st][s], i),
            _pool_layer(vs[st][s], i), pos_s, valid_s, table_s, fused,
            widx_s)

    xs = _layers(stages, [x[:, None] for x in _embed(stages[0],
                                                      tok.long())],
                 attend, tv)
    return _logits(stages, xs)[:, 0]


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
                                   fused, token_valid=emit)
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


def _span_attention(x, layer, cfg, rope_bt, k_pool, v_pool, cols, table,
                    fused, write_index, ring=None):
    """Block attention where row ``b``'s ``S`` tokens occupy positions
    ``cols[b]`` = ``pos_b[b] + 0..S-1`` of its dense row (``table`` None)
    or of the paged pool — the S-wide sibling of
    :func:`_ragged_attention`. Token ``s`` attends every position ``<=
    pos_b + s`` (its own K/V was just written). The write goes through
    ``write_index`` (:func:`_dense_write_index`, or :func:`_write_index`
    of ``cols``), which drops parked rows, sentinel entries and the
    cache-tail spill past the row. ``fused`` reads the paged pool
    through :func:`paged_span_attention` instead of gathering the dense
    view; ``ring`` (the devices of the shard's context-parallel ring)
    folds the gathered paged read through :func:`ring_span_attention`.
    Caches written in place."""
    b, s, _d = x.shape
    hd = cfg.head_dim
    q, k, v = _qkv(x, layer, cfg, rope_bt)
    if table is None:
        _dense_write(k_pool, k, write_index)
        _dense_write(v_pool, v, write_index)
        total = k_pool.shape[1]
        mask = (torch.arange(total, device=x.device)[None, None, :]
                <= cols[:, :, None])
        out = _gqa_attention(q, k_pool, v_pool, mask[:, None, None], cfg)
        return out @ layer["wo"]
    _pool_write(k_pool, table, cols, k, write_index)
    _pool_write(v_pool, table, cols, v, write_index)
    if fused:
        out = paged_span_attention(
            q, k_pool, v_pool, table, cols[:, 0],
            n_kv_heads=cfg.n_kv_heads,
        ).reshape(b, s, cfg.n_heads * hd).to(cfg.dtype)
        return out @ layer["wo"]
    k_read = _pool_gather(k_pool, table)
    v_read = _pool_gather(v_pool, table)
    if ring is not None:
        out = ring_span_attention(q, k_read, v_read, cols[:, 0],
                                  n_kv_heads=cfg.n_kv_heads, devices=ring)
        return (out.to(cfg.dtype).reshape(b, s, cfg.n_heads * hd)
                @ layer["wo"])
    total = k_read.shape[1]
    mask = (torch.arange(total, device=x.device)[None, None, :]
            <= cols[:, :, None])
    out = _gqa_attention(q, k_read, v_read, mask[:, None, None], cfg)
    return out.to(cfg.dtype) @ layer["wo"]


def _block_forward(params, cfg: TransformerConfig, k_pool, v_pool, tokens,
                   pos_b, table, fused=False, ring=None, token_valid=None):
    """[B, S] forward writing K/V at per-row start positions ``pos_b`` [B]
    into the stacked dense caches (``table`` None) or, through the block
    table, the pools, in place → logits [B, S, V] f32. The verify scoring
    pass, the draft model's catch-up feed (dense), the suffix-only
    prefill of a prefix hit and every chunk of a chunked admission ride
    this; ``fused`` walks the paged span read instead of gathering it.
    Columns past the row (``pos_b + s >= total``) are dropped and their
    rotary lookup clamps, as JAX's scatter and gather do. ``token_valid``
    ([B, S] bool) marks the tokens that claim MoE capacity. ``ring``
    (context parallelism; paged, gathered) holds each stage's shards'
    ring devices, ``ring[stage][shard]``: the span read of every layer
    folds through :func:`ring_span_attention` over them."""
    dev = tokens.device
    s = tokens.shape[1]
    cols = pos_b.long()[:, None] + torch.arange(s, device=dev)[None, :]
    k0 = _first(k_pool)
    # Every layer writes the same (row, token) set: index it once.
    if table is None:
        total = k0.shape[2]
        widx = _dense_write_index(pos_b, s, total)
    else:
        n, bs = _kv_arr(k0).shape[1], _kv_arr(k0).shape[2]
        total = table.shape[1] * bs
        widx = _write_index(table, cols, n, bs)
    cos_t, sin_t = rotary_frequencies(cfg.head_dim, total,
                                      theta=cfg.rope_theta, device=dev)
    rpos = torch.clamp(cols, 0, total - 1)
    rope_bt = (cos_t[rpos], sin_t[rpos])
    stages = _stages(params, cfg)
    ks, vs = _kv_stages(k_pool), _kv_stages(v_pool)
    args = _stage_args(stages, *rope_bt, cols, table, widx)

    def attend(st, i, s, h, attn, c):
        cos, sin, cols_s, table_s, widx_s = args[st][s]
        return _span_attention(
            h, attn, c, (cos, sin), _pool_layer(ks[st][s], i),
            _pool_layer(vs[st][s], i), cols_s, table_s, fused, widx_s,
            None if ring is None else ring[st][s])

    xs = _layers(stages, _embed(stages[0], tokens.long()), attend,
                 token_valid)
    return _logits(stages, xs)


# ---------------------------------------------------------------------------
# Speculative decoding (serving/speculative.py holds the host-side proposers)
# ---------------------------------------------------------------------------
#
# A verify step is two forwards: the [slots, K] scoring pass writes the
# draft K/V and scores every draft position, then a single-token commit
# pass writes the first non-draft token's K/V at ``p_b + n_eff`` and
# refreshes ``last_logits``, so the decode-state invariant (``length``
# positions live, ``last_logits`` predicting position ``length``) holds
# on exit and verify composes with decode_step / decode_chunk /
# retire_row. A rejected tail needs no rollback: validity derives from
# ``length``, so not advancing past the accepted region IS the rollback
# (the rejected draft K/V stays behind, unread, until overwritten).


def _target_probs(logits, temperature, top_k: int):
    """The distribution :func:`sample_token` samples from (top-k mask and
    temperature floor), for speculative accept and resample. logits
    [..., V]; temperature broadcastable to logits[..., 0]."""
    logits = _top_k_mask(logits, top_k)
    temp = torch.clamp(temperature, min=1e-6)[..., None]
    return torch.softmax(logits / temp, dim=-1)


def _verify_step_body(state, params, cfg: TransformerConfig, draft,
                      draft_len, top_k: int, eos_id: int | None,
                      fused: bool = False):
    """One speculative verify, in place: score ``draft`` [slots, K]
    against the decode state, accept each row's longest matching prefix
    (greedy: equal to the argmax; sampled: with probability p(draft)),
    commit the first non-draft token. Returns (state, tokens [slots,
    K+1] int32, emitted [slots, K+1]), ``emitted`` a per-row prefix
    mask."""
    k0, v0, table, total = _state_kv(state)
    slots, k_w = draft.shape
    dev = draft.device
    gen = state["generator"]
    emit0 = state["active"].clone()
    p_b = state["length"].clone()
    temp = state["temperature"]
    draft = draft.long()
    in_draft = torch.arange(k_w, device=dev)[None, :] < draft_len[:, None]
    block_logits = _block_forward(
        params, cfg, k0, v0, draft, p_b, table, fused,
        token_valid=emit0[:, None] & in_draft if cfg.n_experts else None)
    # prev_logits[:, i] predicts draft position i.
    prev_logits = torch.cat(
        [state["last_logits"][:, None], block_logits[:, : k_w - 1]], dim=1)
    greedy_ok = draft == torch.argmax(prev_logits, dim=-1)
    probs = _target_probs(prev_logits, temp[:, None], top_k)
    p_draft = torch.gather(probs, -1, draft[..., None])[..., 0]
    # A deterministic proposer's q is a point mass: accept w.p. p(d).
    sampled_ok = torch.rand((slots, k_w), generator=gen, device=dev) < p_draft
    ok = torch.where((temp <= 0.0)[:, None], greedy_ok, sampled_ok) & in_draft
    n = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    # Accepted drafts + 1 commit, capped by the row's budget and its
    # cache (the cap only drops accepted drafts).
    n_eff = torch.minimum(n, torch.clamp(state["remaining"] - 1, min=0))
    n_eff = torch.minimum(n_eff, torch.clamp(total - 1 - p_b, min=0))
    rows = torch.arange(slots, device=dev)
    all_logits = torch.cat([prev_logits, block_logits[:, k_w - 1:]], dim=1)
    commit_logits = all_logits[rows, n_eff.long()]
    d_at = draft[rows, torch.clamp(n_eff, max=k_w - 1).long()]
    rejected = (n_eff == n) & (n_eff < draft_len)
    # Top-k BEFORE the rejection mask, so the resample stays inside the
    # target's top-k support.
    vocab = torch.arange(commit_logits.shape[-1], device=dev)
    res_logits = torch.where(
        rejected[:, None] & (vocab[None, :] == d_at[:, None]),
        torch.full_like(commit_logits, _NEG_INF),
        _top_k_mask(commit_logits, top_k))
    commit = sample_token(res_logits, gen, temp, top_k=0)
    commit = torch.where(n_eff < n, d_at.to(torch.int32), commit)

    idx = torch.arange(k_w + 1, device=dev)[None, :]
    draft_pad = torch.cat(
        [draft, torch.zeros((slots, 1), dtype=torch.long, device=dev)], dim=1)
    out = torch.where(idx < n_eff[:, None], draft_pad,
                      commit[:, None].long()).to(torch.int32)
    emitted = emit0[:, None] & (idx <= n_eff[:, None])
    hit_eos = torch.zeros((slots,), dtype=torch.bool, device=dev)
    if eos_id is not None:
        is_eos = ((out == eos_id) & emitted).to(torch.int32)
        # Keep the first EOS, drop its tail.
        emitted = emitted & (torch.cumsum(is_eos, dim=1) - is_eos == 0)
        hit_eos = ((out == eos_id) & emitted).any(dim=1)
    m = emitted.sum(dim=1).to(torch.int32)

    # The commit pass. Rows parked by EOS above still run it; their write
    # lands inside the row, whose length is parked at total, unread.
    logits2 = _single_token_forward(params, cfg, k0, v0, commit,
                                    p_b + n_eff, table, fused,
                                    token_valid=emit0)
    length = p_b + m
    remaining = state["remaining"] - m
    active = emit0 & (remaining > 0) & (length < total) & ~hit_eos
    state["length"].copy_(torch.where(hit_eos, torch.full_like(length, total),
                                      length))
    state["remaining"].copy_(remaining)
    state["active"].copy_(active)
    state["last_logits"].copy_(torch.where(emit0[:, None], logits2,
                                           state["last_logits"]))
    return state, out, emitted


@torch.inference_mode()
def verify_step(state, params, cfg: TransformerConfig, draft, draft_len,
                top_k: int = 0, eos_id: int | None = None,
                kv_fused: bool = False):
    """Score ``draft`` [slots, K] tokens (``draft_len`` [slots] real)
    against the decode state and emit each row's longest accepted prefix
    plus one committed target token (1..K+1 tokens a row). Greedy rows
    equal plain :func:`decode_step` chains; sampled rows
    rejection-resample, so their distribution is the target's. EOS parks
    rows as :func:`decode_step` does. Either layout; ``kv_fused`` (paged)
    walks the scoring read and reads the commit pass through the paged
    decode kernel. In place; returns (state, tokens [slots, K+1],
    emitted [slots, K+1])."""
    return _verify_step_body(state, params, cfg, draft, draft_len, top_k,
                             eos_id, kv_fused)


@torch.inference_mode()
def verify_chunk(state, params, cfg: TransformerConfig, drafts, draft_lens,
                 top_k: int = 0, eos_id: int | None = None,
                 kv_fused: bool = False):
    """``steps`` verify steps in a loop (JAX fuses them with
    ``lax.scan``): ``drafts`` [steps, slots, K], ``draft_lens`` [steps,
    slots]. A later step's drafts are chain continuations that simply
    fail verification after an early rejection. Returns (state, tokens
    [steps, slots, K+1], emitted likewise)."""
    outs, emits = [], []
    for draft, dlen in zip(drafts, draft_lens):
        state, out, emitted = _verify_step_body(state, params, cfg, draft,
                                                dlen, top_k, eos_id,
                                                kv_fused)
        outs.append(out)
        emits.append(emitted)
    return state, torch.stack(outs), torch.stack(emits)


@torch.inference_mode()
def extend_and_propose(state, params, cfg: TransformerConfig, feed,
                       feed_pos, feed_len, steps: int):
    """Draft-model helper on a dense decode state: force-feed each row's
    newly committed target tokens (``feed`` [slots, S], ``feed_len``
    real, from position ``feed_pos``) through the dense span forward,
    then decode ``steps`` greedy proposals a row. The next call's feed,
    at host-tracked confirmed positions, overwrites whatever the target
    rejected, so no rollback is needed. Rows with ``feed_pos`` at the
    cache end are parked (their writes drop). In place; returns (state,
    proposals [slots, steps] int32)."""
    block_logits = _block_forward(
        params, cfg, state["cache"]["k"], state["cache"]["v"], feed,
        feed_pos, None,
        token_valid=_moe_valid(cfg, feed.shape[1], feed_len, feed.device))
    rows = torch.arange(feed.shape[0], device=feed.device)
    last = block_logits[rows, torch.clamp(feed_len - 1, min=0).long()]
    live = feed_len > 0
    state["length"].copy_(feed_pos + feed_len)
    # A proposal budget only: the host resets remaining/active each round.
    state["remaining"].copy_(torch.where(live, steps + 1, 0))
    state["active"].copy_(live)
    state["temperature"].zero_()
    state["last_logits"].copy_(torch.where(live[:, None], last,
                                           state["last_logits"]))
    toks = []
    for _ in range(steps):
        state, tok, _emit = _decode_step_body(state, params, cfg, 0, None)
        toks.append(tok)
    return state, torch.stack(toks, dim=1)


def _new_generator(dev, seed: int) -> torch.Generator:
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return generator


def _slot_scalars(cfg: TransformerConfig, slots: int, dev) -> dict:
    """The per-slot scalars of a decode state, on either layout."""
    return {
        "length": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "remaining": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
        "temperature": torch.zeros((slots,), dtype=torch.float32,
                                   device=dev),
        "last_logits": torch.zeros((slots, cfg.vocab_size),
                                   dtype=torch.float32, device=dev),
    }


def _set_rows(state, slots, length, remaining, temperature, last) -> None:
    """Admit rows ``slots`` (an index tensor, or one int): write position
    ``length``, budget ``remaining`` (active while > 0), temperature and
    last logits. Values are tensors or Python numbers."""
    dev = state["length"].device
    remaining = torch.as_tensor(remaining, dtype=torch.int32, device=dev)
    state["length"][slots] = torch.as_tensor(length, dtype=torch.int32,
                                             device=dev)
    state["remaining"][slots] = remaining
    state["active"][slots] = remaining > 0
    state["temperature"][slots] = torch.as_tensor(
        temperature, dtype=torch.float32, device=dev)
    state["last_logits"][slots] = last


def _row_index(i, n: int, what: str) -> int:
    """One row index, checked: JAX clamps a ``dynamic_update_slice``
    start and drops a scatter out of range; the port raises."""
    i = int(i)
    if not 0 <= i < n:
        raise IndexError(f"{what} {i} outside [0, {n})")
    return i


def _check_rows(idx, n: int, what: str) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"{what} {idx.tolist()} outside [0, {n})")


def _prefill_rows(params, cfg: TransformerConfig, cache, prompt_tokens,
                  prompt_lengths, row_valid=None):
    """Prefill right-padded prompts ``[B, T0]`` into ``cache`` (written in
    place) from slot 0. Lengths clamp to >= 1, as in JAX, so a zero-length
    row reads its first logits rather than wrapping to the last. The
    prompt positions (of the rows ``row_valid`` marks, when given) claim
    MoE capacity. Returns (last-position logits [B, V] f32, clamped
    lengths)."""
    total = _first(cache["k"]).shape[2]
    b, t0 = prompt_tokens.shape
    dev = prompt_tokens.device
    lengths = torch.clamp(prompt_lengths, min=1)
    valid = torch.arange(total, device=dev)[None, :] < lengths[:, None]
    positions = torch.arange(t0, device=dev)[None].expand(b, t0)
    token_valid = _moe_valid(cfg, t0, lengths, dev)
    if token_valid is not None and row_valid is not None:
        token_valid = token_valid & row_valid[:, None]
    logits = forward_cached(params, prompt_tokens.long(), cfg, cache, 0,
                            positions, valid, token_valid)
    return logits[torch.arange(b, device=dev), lengths.long() - 1], lengths


@torch.inference_mode()
def generate(params, prompt_tokens, prompt_lengths, cfg: TransformerConfig,
             *, max_new_tokens: int, generator: torch.Generator, temperature,
             top_k: int = 0, row_valid=None):
    """prompt_tokens [B, T0] right-padded, prompt_lengths [B] →
    (generated [B, max_new_tokens] int32, prefill_logits [B, V] f32).

    The lockstep path: one prefill, then ``max_new_tokens`` single-token
    forwards against a ``[T0 + max_new_tokens]`` cache (JAX scans them in
    one compiled call). Row ``b``'s token at step ``t`` sits at cache slot
    ``T0 + t`` with true position ``length[b] + t``. ``temperature`` [B]:
    <= 0 decodes greedily. ``generator`` takes the place of JAX's key.
    ``row_valid`` [B] marks the real rows of a padded batch: pad rows
    claim no MoE expert capacity, in the prefill or the steps."""
    b, t0 = prompt_tokens.shape
    dev = prompt_tokens.device
    if not cfg.n_experts:
        row_valid = None  # only MoE routing reads it
    elif row_valid is None:
        row_valid = torch.ones((b,), dtype=torch.bool, device=dev)
    total = t0 + max_new_tokens
    cache = _new_cache(params, cfg, b, total, dev)
    last, lengths = _prefill_rows(params, cfg, cache, prompt_tokens,
                                  prompt_lengths, row_valid)
    valid = torch.arange(total, device=dev)[None, :] < lengths[:, None]
    logits, toks = last, []
    for i in range(max_new_tokens):
        tok = sample_token(logits, generator, temperature, top_k)
        valid[:, t0 + i] = True
        logits = forward_cached(params, tok[:, None].long(), cfg, cache,
                                t0 + i, (lengths + i)[:, None], valid,
                                None if row_valid is None
                                else row_valid[:, None])[:, 0]
        toks.append(tok)
    if not toks:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev), last
    return torch.stack(toks, dim=1), last


# ---------------------------------------------------------------------------
# Dense KV layout
# ---------------------------------------------------------------------------


@torch.inference_mode()
def prefill(params, prompt_tokens, prompt_lengths, cfg: TransformerConfig, *,
            total_len: int):
    """One prompt pass: tokens [B, T0] right-padded → (cache with
    ``total_len`` slots, last-position logits [B, V]). Slots past the true
    length hold pad junk that decode overwrites before the mask admits
    it."""
    cache = _new_cache(params, cfg, prompt_tokens.shape[0], total_len,
                       prompt_tokens.device)
    last, _ = _prefill_rows(params, cfg, cache, prompt_tokens,
                            prompt_lengths)
    return cache, last


def init_decode_state(cfg: TransformerConfig, slots: int, total_len: int,
                      seed: int = 0, *, device="cuda"):
    """Dense server decode state: ``slots`` in-flight rows over one
    ``[L, slots, total_len, Hkv, hd]`` cache. ``length`` is each row's
    next write slot (== tokens held so far); inactive rows are parked
    with ``active`` False. ``generator`` takes the place of JAX's key."""
    dev = resolve_device(device)
    return {"cache": init_cache(cfg, slots, total_len, dev),
            **_slot_scalars(cfg, slots, dev),
            "generator": _new_generator(dev, seed)}


@torch.inference_mode()
def insert_row(state, slot, row_cache, last_logits, length, remaining,
               temperature):
    """Copy a prefilled request (batch-1 :func:`prefill` outputs) into row
    ``slot`` of the dense state, in place. A slot out of range raises
    (JAX's ``dynamic_update_slice`` would clamp it onto the last row)."""
    slot = _row_index(slot, _first(state["cache"]["k"]).shape[1], "slot")
    t = _first(row_cache["k"]).shape[2]
    for side in ("k", "v"):
        for dst, src in zip(_parts(state["cache"][side]),
                            _parts(row_cache[side])):
            dst[:, slot, :t] = src[:, 0]
    _set_rows(state, slot, length, remaining, temperature, last_logits[0])
    return state


def _admit_rows_body(state, params, cfg: TransformerConfig, slots,
                     prompt_tokens, prompt_lengths, remaining, temperature):
    """Prefill a round's admissions into a scratch cache of the state's
    row width and copy each row into ``slots``, in place. ``slots`` may
    repeat only as bucket padding that duplicates a real admission
    verbatim, so duplicate indices carry identical rows and the scatter
    is deterministic. Returns (state, last [K, V])."""
    kc = _first(state["cache"]["k"])
    _check_rows(slots, kc.shape[1], "slots")
    cache = _new_cache(params, cfg, prompt_tokens.shape[0], kc.shape[2],
                       prompt_tokens.device)
    last, lengths = _prefill_rows(params, cfg, cache, prompt_tokens,
                                  prompt_lengths)
    slots = slots.long()
    for side in ("k", "v"):
        for dst, src in zip(_parts(state["cache"][side]),
                            _parts(cache[side])):
            dst[:, _on(slots, dst.device)] = src
    _set_rows(state, slots, lengths, remaining, temperature, last)
    return state, last


@torch.inference_mode()
def admit_rows_and_step(state, params, cfg: TransformerConfig, slots,
                        prompt_tokens, prompt_lengths, remaining, temperature,
                        top_k: int = 0, eos_id: int | None = None):
    """Fused dense admission: prefill ``[K, T0]`` prompts, copy them into
    rows ``slots``, AND run one decode step for every active row, so the
    new requests' first token comes back with the admission. Returns
    (state, prefill last-logits [K, V], sampled token [slots], emitted
    mask [slots])."""
    state, last = _admit_rows_body(state, params, cfg, slots, prompt_tokens,
                                   prompt_lengths, remaining, temperature)
    state, tok, emit = _decode_step_body(state, params, cfg, top_k, eos_id)
    return state, last, tok, emit


# ---------------------------------------------------------------------------
# Dense prefix pool (serving/prefix_cache.py holds the host-side trie)
# ---------------------------------------------------------------------------
#
# The K/V of a shared prompt prefix depends only on the prefix tokens, so
# it is computed once, parked in a pool row, and copied into a new
# request's row at admission; the request then prefills only its suffix.
# JAX keeps the pool functional (a store never touches the array an
# admission captured); here it is written in place, so the host pins
# (``PrefixCache`` refcounts) carry the whole guarantee: a store goes only
# to an unpinned row, and an admission copies its pinned row into the
# scratch cache before anything else runs.


def init_prefix_pool(cfg: TransformerConfig, pool_slots: int,
                     max_prefix_len: int, *, device="cuda"):
    """Device prefix pool: ``pool_slots`` rows of per-layer K/V for up to
    ``max_prefix_len`` positions, laid out like the decode cache."""
    return init_cache(cfg, pool_slots, max_prefix_len,
                      resolve_device(device))


def _store_prefix(pool, pool_slot, rows) -> None:
    """Write ``rows[side]`` ([L, >= P, H, hd], a shard each) into pool
    row ``pool_slot``."""
    pool_slot = _row_index(pool_slot, _first(pool["k"]).shape[1],
                           "pool_slot")
    plen = _first(pool["k"]).shape[2]
    for side in ("k", "v"):
        for dst, src in zip(_parts(pool[side]),
                            _parts(rows[side])):
            if src.shape[1] < plen:
                raise ValueError(f"rows of {src.shape[1]} positions "
                                 f"cannot fill a pool row of {plen}")
            dst[:, pool_slot] = src[:, :plen]


@torch.inference_mode()
def store_prefix_row(pool, pool_slot, state, row):
    """Publish dense decode-state row ``row``'s first ``max_prefix_len``
    cache positions into pool row ``pool_slot``, in place (the
    publish-on-finish path: a finished request's prompt region is its
    prefix)."""
    row = _row_index(row, _first(state["cache"]["k"]).shape[1], "row")
    _store_prefix(pool, pool_slot,
                  {side: _map(lambda t: t[:, row], state["cache"][side])
                   for side in "kv"})
    return pool


@torch.inference_mode()
def store_prefix_cache(pool, pool_slot, cache):
    """Publish a batch-1 :func:`prefill` cache into pool row
    ``pool_slot``, in place (the prime path: a shared system prompt
    pooled without touching the decode state or its generator)."""
    _store_prefix(pool, pool_slot,
                  {side: _map(lambda t: t[:, 0], cache[side])
                   for side in "kv"})
    return pool


def _admit_prefix_body(state, params, cfg: TransformerConfig, slot, pool,
                       pool_slot, prefix_len, suffix_tokens, prompt_len,
                       remaining, temperature):
    """Copy pool row ``pool_slot`` into a scratch row, prefill the suffix
    ``[1, S]`` from ``prefix_len`` on, and copy the row into ``slot``.
    Positions past ``prefix_len`` hold the donor's unrelated continuation
    until the suffix overwrites them; ``valid`` masks everything past
    ``prompt_len``. A suffix that would end past the row raises."""
    kc = _first(state["cache"]["k"])
    slot = _row_index(slot, kc.shape[1], "slot")
    pool_slot = _row_index(pool_slot, _first(pool["k"]).shape[1],
                           "pool_slot")
    prefix_len, prompt_len = int(prefix_len), int(prompt_len)
    total = kc.shape[2]
    s = suffix_tokens.shape[1]
    dev = suffix_tokens.device
    cache = _new_cache(params, cfg, 1, total, dev)
    plen = _first(pool["k"]).shape[2]
    for side in ("k", "v"):
        for dst, src in zip(_parts(cache[side]),
                            _parts(pool[side])):
            dst[:, 0, :plen] = src[:, pool_slot]
    suffix_len = max(prompt_len - prefix_len, 1)
    positions = prefix_len + torch.arange(s, device=dev)[None, :]
    valid = torch.arange(total, device=dev)[None, :] < prompt_len
    logits = forward_cached(params, suffix_tokens.long(), cfg, cache,
                            prefix_len, positions, valid,
                            _moe_valid(cfg, s, suffix_len, dev))
    last = logits[:, suffix_len - 1]
    for side in ("k", "v"):
        for dst, src in zip(_parts(state["cache"][side]),
                            _parts(cache[side])):
            dst[:, slot] = src[:, 0]
    _set_rows(state, slot, prompt_len, remaining, temperature, last[0])
    return state, last


@torch.inference_mode()
def admit_prefix_and_step(state, params, cfg: TransformerConfig, slot, pool,
                          pool_slot, prefix_len, suffix_tokens, prompt_len,
                          remaining, temperature, top_k: int = 0,
                          eos_id: int | None = None):
    """Prefix-hit admission: row ``slot`` takes pool row ``pool_slot``'s
    first ``prefix_len`` K/V positions, prefills ONLY the suffix
    (``suffix_tokens`` [1, S], padded to a length bucket), and one decode
    step runs for every active row — the prefix twin of
    :func:`admit_rows_and_step`. Returns (state, prefill last-logits
    [1, V], sampled token [slots], emitted mask [slots])."""
    state, last = _admit_prefix_body(state, params, cfg, slot, pool,
                                     pool_slot, prefix_len, suffix_tokens,
                                     prompt_len, remaining, temperature)
    state, tok, emit = _decode_step_body(state, params, cfg, top_k, eos_id)
    return state, last, tok, emit


# ---------------------------------------------------------------------------
# Paged KV layout: state and admission
# ---------------------------------------------------------------------------


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
    return {
        "pool": pool,
        "block_table": torch.full((slots, max_blocks_per_seq), num_blocks,
                                  dtype=torch.int32, device=dev),
        **_slot_scalars(cfg, slots, dev),
        "generator": _new_generator(dev, seed),
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
    n, bs = _kv_arr(_first(state["pool"]["k"])).shape[1:3]
    mb = state["block_table"].shape[1]
    total = mb * bs
    b = prompt_tokens.shape[0]
    cache = _new_cache(params, cfg, b, total, prompt_tokens.device)
    last, lengths = _prefill_rows(params, cfg, cache, prompt_tokens,
                                  prompt_lengths)
    slots = slots.long()
    rows_tbl = state["block_table"][slots].long()  # [b, mb]
    rows, cols = (rows_tbl < n).nonzero(as_tuple=True)
    blk = rows_tbl[rows, cols]
    for side in ("k", "v"):
        for pool, c in zip(_parts(state["pool"][side]),
                           _parts(cache[side])):
            r, col, bk = _on((rows, cols, blk), c.device)
            upd = c.reshape(c.shape[0], b, mb, bs, *c.shape[3:])[:, r, col]
            if isinstance(pool, dict):
                qd = _quantize_kv(upd)
                pool["q"][:, bk] = qd["q"]
                pool["scale"][:, bk] = qd["scale"]
            else:
                pool[:, bk] = upd
    _set_rows(state, slots, lengths, remaining, temperature, last)
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


def _paged_admit_prefix_body(state, params, cfg: TransformerConfig, slot,
                             prefix_len, suffix_tokens, prompt_len,
                             remaining, temperature, fused=False,
                             ring=None):
    """Suffix-only prefill through the slot's block table: the leading
    ``prefix_len`` positions are already backed by shared (and possibly
    one copied) blocks, which the forward reads in place, and only the
    suffix K/V is written, into the slot's owned blocks. In place;
    returns (state, last [1, V])."""
    slot = _row_index(slot, state["block_table"].shape[0], "slot")
    prefix_len, prompt_len = int(prefix_len), int(prompt_len)
    dev = suffix_tokens.device
    table_row = state["block_table"][slot][None]
    suffix_len = max(prompt_len - prefix_len, 1)
    logits = _block_forward(
        params, cfg, state["pool"]["k"], state["pool"]["v"], suffix_tokens,
        torch.tensor([prefix_len], dtype=torch.int32, device=dev),
        table_row, fused, ring,
        token_valid=_moe_valid(cfg, suffix_tokens.shape[1], suffix_len,
                               dev))
    last = logits[:, suffix_len - 1]
    _set_rows(state, slot, prompt_len, remaining, temperature, last[0])
    return state, last


@torch.inference_mode()
def paged_admit_prefix_and_step(state, params, cfg: TransformerConfig, slot,
                                prefix_len, suffix_tokens, prompt_len,
                                remaining, temperature, top_k: int = 0,
                                eos_id: int | None = None,
                                kv_fused: bool = False, ring=None):
    """Paged twin of :func:`admit_prefix_and_step`: the host mapped the
    donor's full blocks into ``slot``'s table (refcount-shared) and
    copied at most the one partly filled tail block (:func:`copy_block`),
    so this call prefills only the suffix ``[1, S]`` at ``prefix_len``
    and takes one decode step for every active row. The final chunk of
    a chunked admission rides it with ``prefix_len`` = the tokens already
    chunked in; ``ring`` (context parallelism, :func:`_block_forward`)
    reaches its span read only, the decode step reads as it does
    without. Returns (state, prefill last-logits [1, V], sampled token
    [slots], emitted mask [slots])."""
    state, last = _paged_admit_prefix_body(state, params, cfg, slot,
                                           prefix_len, suffix_tokens,
                                           prompt_len, remaining,
                                           temperature, kv_fused, ring)
    state, tok, emit = _decode_step_body(state, params, cfg, top_k, eos_id,
                                         kv_fused)
    return state, last, tok, emit


@torch.inference_mode()
def paged_prefill_chunk(state, params, cfg: TransformerConfig, slot, pos,
                        chunk_tokens, chunk_len, kv_fused: bool = False,
                        ring=None):
    """One bounded chunk of a long admission: forward ``chunk_tokens``
    ([1, S], right-padded past ``chunk_len`` real tokens) at virtual
    positions ``pos..pos+S-1`` of ``slot``'s row, writing K/V through its
    block table. Each chunk attends every position written before it,
    so a chain of chunks computes the K/V of one monolithic prefill. The
    row is left PARKED (``length`` at the table horizon, ``active``
    False), so decode steps between chunks drop their write for it and
    never read the half-built row. The final chunk goes through
    :func:`paged_admit_prefix_and_step`. Consumes no randomness, so
    chunked sampling matches monolithic. Pad positions write junk that
    the next chunk (or decode) overwrites before any mask admits it.
    ``ring``: the context-parallel span read (:func:`_block_forward`). In
    place; returns the state."""
    slot = _row_index(slot, state["block_table"].shape[0], "slot")
    dev = chunk_tokens.device
    table_row = state["block_table"][slot][None]
    _block_forward(params, cfg, state["pool"]["k"], state["pool"]["v"],
                   chunk_tokens,
                   torch.tensor([int(pos)], dtype=torch.int32, device=dev),
                   table_row, kv_fused, ring,
                   token_valid=_moe_valid(cfg, chunk_tokens.shape[1],
                                          int(chunk_len), dev))
    state["length"][slot] = _state_kv(state)[3]
    state["active"][slot] = False
    return state


@torch.inference_mode()
def store_blocks(pool, block_ids, cache):
    """Scatter a batch-1 :func:`prefill` cache into pool blocks
    ``block_ids`` ([nblk]; sentinel entries are dropped) — the paged
    prime (a shared system prompt pooled without touching the decode
    state or its generator). Quantized pools quantize here, so primed
    blocks carry their scales. In place; returns the pool."""
    for side in ("k", "v"):
        for dst, src in zip(_parts(pool[side]),
                            _parts(cache[side])):
            arr = _kv_arr(dst)
            n_layers, n, bs = arr.shape[0], arr.shape[1], arr.shape[2]
            ids = torch.as_tensor(block_ids, device=arr.device).long()
            nblk = ids.shape[0]
            keep = ids < n
            vals = src[:, 0, : nblk * bs].reshape(
                n_layers, nblk, bs, *arr.shape[3:])[:, keep.to(src.device)]
            if isinstance(dst, dict):
                qd = _quantize_kv(vals)
                dst["q"][:, ids[keep]] = qd["q"]
                dst["scale"][:, ids[keep]] = qd["scale"]
            else:
                dst[:, ids[keep]] = vals.to(dst.dtype)
    return pool


@torch.inference_mode()
def copy_block(pool, dst, src):
    """Copy block ``src``'s K/V over block ``dst`` on every layer — the
    copy-on-write of a partly filled shared tail block, the one device
    copy a prefix hit pays. Quantized pools copy payload and scales
    verbatim (no second quantization). In place, so it lands before the
    suffix prefill that reads the copy. Returns the pool."""
    n = _kv_arr(_first(pool["k"])).shape[1]
    dst = _row_index(dst, n, "dst block")
    src = _row_index(src, n, "src block")
    for side in ("k", "v"):
        for kv in _parts(pool[side]):
            for arr in (kv.values() if isinstance(kv, dict) else (kv,)):
                arr[:, dst] = arr[:, src]
    return pool


def _block_ids(block_ids, n: int, device):
    """``block_ids`` as a long tensor on ``device``, every id checked
    against ``[0, n)``: JAX drops (scatter) or clamps (gather) an id out
    of range; torch would fault, so the port raises."""
    ids = torch.as_tensor(block_ids, device=device).long().reshape(-1)
    _check_rows(ids, n, "block ids")
    return ids


@torch.inference_mode()
def export_blocks(pool, block_ids):
    """Gather pool blocks ``block_ids`` ([nblk]) into a standalone payload
    on the pool's device: ``{"k": [L, nblk, Bs, H, hd], "v": ...}`` for
    an fp pool, ``{"q", "scale"}`` a side for an int8 one (the codes AND
    their per-(position, head) scales), so an importer lands the pool's
    content exactly. A pure gather: the pool is untouched. A sharded
    pool's payload holds every head (the shards' heads side by side, on
    shard 0's device) of every layer (a staged pool's stages one after
    another), so any mesh shape imports it."""
    arr = _kv_arr(_first(pool["k"]))
    ids = _block_ids(block_ids, arr.shape[1], arr.device)

    def _take(kv):
        if isinstance(kv, dict):
            return {"q": kv["q"][:, _on(ids, kv["q"].device)],
                    "scale": kv["scale"][:, _on(ids, kv["q"].device)]}
        return kv[:, _on(ids, kv.device)]

    def _cat(parts, dims):
        if len(parts) == 1:
            return parts[0]
        if isinstance(parts[0], dict):
            return {"q": torch.cat([p["q"].to(arr.device) for p in parts],
                                   dim=dims[0]),
                    "scale": torch.cat([p["scale"].to(arr.device)
                                        for p in parts], dim=dims[1])}
        return torch.cat([p.to(arr.device) for p in parts], dim=dims[0])

    def _whole(side):
        # Each stage's heads side by side, the stages' layers one after
        # another.
        return _cat([_cat([_take(kv) for kv in _shard_values(st)], (-2, -1))
                     for st in _stage_list(side)], (0, 0))

    return {"k": _whole(pool["k"]), "v": _whole(pool["v"])}


@torch.inference_mode()
def import_blocks(pool, block_ids, payload):
    """Scatter an :func:`export_blocks` payload (on any device) into pool
    blocks ``block_ids`` IN PLACE, as it came: int8 codes and scales are
    copied, never quantized again. The payload must match the pool's
    layout, block shape and dtype (an fp payload into an fp pool of the
    same dtype, an int8 one into an int8 pool); ids out of range raise.
    A payload holds every head and layer, whatever mesh exported it; a
    staged pool takes each stage's layers of it and a sharded pool each
    shard's heads. Returns the pool."""
    arr = _kv_arr(_first(pool["k"]))
    ids = _block_ids(block_ids, arr.shape[1], arr.device)

    def _put(stages, vals, what, head_dim):
        heads = sum(d.shape[head_dim] for d in stages[0])
        layers = sum(st[0].shape[0] for st in stages)
        want = (layers, ids.shape[0], *stages[0][0].shape[2:])
        want = want[:head_dim] + (heads,) + want[head_dim + 1:]
        if tuple(vals.shape) != want:
            raise ValueError(f"payload {what} shape {tuple(vals.shape)} "
                             f"does not fit {ids.shape[0]} blocks of a "
                             f"pool {tuple(stages[0][0].shape)} x "
                             f"{len(stages[0])} shards x {len(stages)} "
                             "stages")
        if vals.dtype != stages[0][0].dtype:
            raise ValueError(f"payload {what} dtype {vals.dtype} != pool "
                             f"dtype {stages[0][0].dtype}")
        for dsts, layer_part in zip(stages, vals.split(
                [st[0].shape[0] for st in stages], dim=0)):
            parts = layer_part.split([d.shape[head_dim] for d in dsts],
                                     dim=head_dim)
            for dst, part in zip(dsts, parts):
                dst[:, _on(ids, dst.device)] = part.to(dst.device)

    for side in ("k", "v"):
        stages, vals = _kv_stages(pool[side]), payload[side]
        if isinstance(stages[0][0], dict) != isinstance(vals, dict):
            raise ValueError("payload and pool disagree on the KV layout "
                             "(fp against int8)")
        if isinstance(vals, dict):
            _put([[d["q"] for d in st] for st in stages], vals["q"],
                 f"{side}.q", 3)
            _put([[d["scale"] for d in st] for st in stages],
                 vals["scale"], f"{side}.scale", 3)
        else:
            _put(stages, vals, side, 3)
    return pool
