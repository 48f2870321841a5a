"""Decoder-only transformer LM: configuration, presets, parameters and
the training forward.

Counterpart of ``kubeflow_tpu/models/transformer.py``: the same
Llama-style block (RMSNorm pre-norm, rotary positions, grouped-query
attention, SwiGLU MLP) and the same stacked ``[L, ...]`` parameter layout,
so a JAX parameter tree converts leaf for leaf (``weights.py``).

:func:`hidden_states`, :func:`apply` and :func:`loss_fn` are the training
forward (serving runs ``models/decode.py``). Weights are cast to
``cfg.dtype`` at each use, as JAX does, so float32 master weights train and
weights stored in ``cfg.dtype`` still serve. Attention goes through
``ops.attention.flash_attention`` with ``cfg.attn_impl``: the CUDA flash
kernels on the card.

The layers run as a Python loop. ``scan_layers`` only chose JAX's
representation of that loop (``lax.scan`` or unrolled, the same function),
so either value runs the loop here; with ``scan_group_size > 1`` the remat
regions wrap groups of that many layers, as JAX's grouped scan does.
``remat`` runs JAX's ``jax.checkpoint`` policies as
``torch.utils.checkpoint`` regions while autograd records
(:func:`_remat_layer`), and ``loss_chunks`` the chunked LM loss. Options
whose port is still to come raise ``ValueError("... not yet ported")``
where training reaches them: ``context_parallel``, ``pipeline_stages > 1``
and a mesh; MoE presets are refused by :func:`config`.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.attention import FLASH_FWD_OP, flash_attention
from kubeflow_tpu_torch.ops.losses import (
    chunked_lm_head_loss,
    softmax_cross_entropy,
)
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rotary, rotary_frequencies


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # Mixture-of-Experts FFN (0 = dense). Listed so the MoE presets keep
    # their shapes; config() rejects them until moe_ffn is ported.
    n_experts: int = 0
    expert_top_k: int = 2
    # Training fields of the JAX config, with its defaults; see the module
    # docstring for which of them run here.
    context_parallel: bool = False
    remat: bool = True
    pipeline_stages: int = 0
    attn_impl: str | None = None
    attn_block_k: int | None = None
    remat_policy: str = "dots"
    scan_layers: bool = True
    loss_chunks: int = 0
    scan_group_size: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# Named presets; the shapes of kubeflow_tpu/models/transformer.py:PRESETS.
PRESETS: dict[str, TransformerConfig] = {
    "llama3-8b": TransformerConfig(
        vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14_336, rope_theta=500_000.0,
    ),
    "llama-1b": TransformerConfig(
        vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=8, d_ff=5632,
    ),
    "lm-test-tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False,
    ),
    "flagship-1b": TransformerConfig(
        vocab_size=32_000, d_model=4096, n_layers=3, n_heads=32,
        n_kv_heads=4, d_ff=20_480, max_seq_len=2048, remat=False,
        scan_layers=False, attn_impl="splash", attn_block_k=1024,
    ),
    "flagship-deep": TransformerConfig(
        vocab_size=32_000, d_model=3072, n_layers=16, n_heads=24,
        n_kv_heads=4, d_ff=6656, max_seq_len=2048, remat=True,
        remat_policy="llm", scan_layers=False, loss_chunks=0,
        attn_impl="splash", attn_block_k=1024,
    ),
    "moe-1b": TransformerConfig(
        vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16,
        n_kv_heads=4, d_ff=3584, n_experts=8, expert_top_k=2,
    ),
    "moe-test-tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False, n_experts=4,
        expert_top_k=2,
    ),
}


def config(name: str, **overrides) -> TransformerConfig:
    """A preset with overrides; ``dtype`` may be a torch dtype or its name
    ("float32"), as a JSON run config gives it."""
    if isinstance(overrides.get("dtype"), str):
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    cfg = replace(PRESETS[name], **overrides)
    if cfg.n_experts:
        raise NotImplementedError(
            f"model {name!r} is a mixture-of-experts preset; moe_ffn is "
            "not yet ported to the PyTorch package")
    return cfg


# Leaves that rms_norm reads in float32; every other leaf is a matmul or
# embedding weight, stored once in cfg.dtype (JAX casts it at each use).
NORM_LEAVES = ("layers/ln_attn", "layers/ln_mlp", "final_norm")


def init(cfg: TransformerConfig, *, generator: torch.Generator,
         device: str | torch.device = "cuda",
         param_dtype: torch.dtype | None = None) -> dict:
    """Parameter dict with the JAX tree's layout and distributions:
    normal × fan_in^-0.5 for every dense weight, ones for the norms.
    Dense weights are stored in ``param_dtype``: ``cfg.dtype`` by default
    (serving), float32 for training's master weights, as JAX keeps them.
    Values differ from JAX's for the same seed (a torch generator is not
    a threefry key); tests that need equal weights convert the JAX tree
    with :func:`kubeflow_tpu_torch.weights.params_from_numpy`."""
    dev = resolve_device(device)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    dtype = cfg.dtype if param_dtype is None else param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def stack(shape, fan_in):
        return dense((cfg.n_layers, *shape), fan_in)

    params = {
        "embed": {"kernel": dense((cfg.vocab_size, d), d)},
        "layers": {
            "attn": {
                "wq": stack((d, cfg.n_heads * hd), d),
                "wk": stack((d, cfg.n_kv_heads * hd), d),
                "wv": stack((d, cfg.n_kv_heads * hd), d),
                "wo": stack((cfg.n_heads * hd, d), cfg.n_heads * hd),
            },
            "mlp": {
                "gate": stack((d, f), d),
                "up": stack((d, f), d),
                "down": stack((f, d), f),
            },
            "ln_attn": torch.ones((cfg.n_layers, d), device=dev),
            "ln_mlp": torch.ones((cfg.n_layers, d), device=dev),
        },
        "final_norm": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense((d, cfg.vocab_size), d)}
    return params


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _not_yet(what: str):
    return ValueError(f"{what} is not yet ported to the PyTorch package")


def _check_trainable(cfg: TransformerConfig, mesh) -> None:
    """Raise for options whose port is still to come (see the module
    docstring), then for the layer layouts JAX refuses, with its
    messages."""
    if mesh is not None:
        raise _not_yet("the model forward over a mesh")
    if cfg.context_parallel:
        raise _not_yet("context_parallel (ring attention)")
    if cfg.pipeline_stages > 1:
        raise _not_yet("pipeline_stages > 1")
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one "
                         f"of {REMAT_POLICIES}")
    if cfg.remat and cfg.remat_policy == "llm_attn":
        if cfg.n_experts:
            raise ValueError(
                "remat_policy='llm_attn' applies to dense FFN layers; "
                "MoE models should use 'llm' or 'dots'")
        if cfg.scan_group_size > 1:
            raise ValueError(
                "remat_policy='llm_attn' is incompatible with "
                "scan_group_size>1; use 'llm'")
    if cfg.scan_group_size > 1 and not cfg.scan_layers:
        raise ValueError(
            "scan_group_size applies to the lax.scan representation; "
            "set scan_layers=True (or drop scan_group_size)")
    if cfg.scan_group_size > 1 and cfg.n_layers % cfg.scan_group_size:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by scan_group_size "
            f"{cfg.scan_group_size}")


def _layer(params, i: int) -> dict:
    """Views of layer ``i``'s slice of the stacked ``[L, ...]`` weights."""
    lp = params["layers"]
    return {
        "attn": {k: w[i] for k, w in lp["attn"].items()},
        "mlp": {k: w[i] for k, w in lp["mlp"].items()},
        "ln_attn": lp["ln_attn"][i],
        "ln_mlp": lp["ln_mlp"][i],
    }


def _qkv(cfg: TransformerConfig, rope, h, attn):
    """Post-rope q [B, T, Hq, hd] and k, v [B, T, Hkv, hd] from the normed
    input ``h``."""
    b, t, _d = h.shape
    hd = cfg.head_dim
    cos, sin = rope
    q = (h @ attn["wq"].to(cfg.dtype)).reshape(b, t, cfg.n_heads, hd)
    k = (h @ attn["wk"].to(cfg.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    v = (h @ attn["wv"].to(cfg.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _attn_ctx(cfg: TransformerConfig, q, k, v):
    """The attention context [B, T, Hq*hd], the input of wo (JAX names it
    "attn_ctx")."""
    b, t = q.shape[:2]
    out = flash_attention(q, k, v, causal=True,
                          implementation=cfg.attn_impl,
                          block_k=cfg.attn_block_k)
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim)


def _attention(h, attn, cfg: TransformerConfig, rope):
    ctx = _attn_ctx(cfg, *_qkv(cfg, rope, h, attn))
    return ctx @ attn["wo"].to(cfg.dtype)


# Set while the ops of a value a region's selective checkpoint may keep
# run (``_keep``): the emulation of JAX's checkpoint_name for the gate and
# up products, which a region keeps instead of running again.
_KEEP = threading.local()


@contextlib.contextmanager
def _keep():
    _KEEP.on = True
    try:
        yield
    finally:
        _KEEP.on = False


def _mlp_in(cfg: TransformerConfig, h, mlp):
    """The gate and up products (JAX's "mlp_gate", "mlp_up")."""
    wg, wu = mlp["gate"].to(cfg.dtype), mlp["up"].to(cfg.dtype)
    with _keep():
        return h @ wg, h @ wu


def _mlp_out(cfg: TransformerConfig, gate, up, down):
    return (F.silu(gate) * up) @ down.to(cfg.dtype)


def _mlp(h, mlp, cfg: TransformerConfig):
    return _mlp_out(cfg, *_mlp_in(cfg, h, mlp), mlp["down"])


def _layer_fn(cfg: TransformerConfig, rope, x, layer):
    h = rms_norm(x, layer["ln_attn"], eps=cfg.norm_eps)
    x = x + _attention(h, layer["attn"], cfg, rope)
    h = rms_norm(x, layer["ln_mlp"], eps=cfg.norm_eps)
    return x + _mlp(h, layer["mlp"], cfg)


# ---------------------------------------------------------------------------
# Remat: JAX's jax.checkpoint policies as torch.utils.checkpoint regions
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("dots", "dots_batched", "llm", "llm_qkv", "llm_attn",
                  "llm_res", "none")
_MM = torch.ops.aten.mm.default
_BMM = torch.ops.aten.bmm.default


def _selective(ops=frozenset(), kept: bool = False):
    """``context_fn`` of a region that keeps the outputs of ``ops`` and,
    with ``kept``, of the ops run under :func:`_keep`, and recomputes every
    other op in the backward."""
    def policy(_ctx, func, *_args, **_kwargs):
        if func in ops or (kept and getattr(_KEEP, "on", False)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


# The context_fn of a region of whole layers, by policy. "dots" keeps the
# matrix products with no batch dimension (dots_with_no_batch_dims_saveable),
# "dots_batched" the batched ones too (dots_saveable); the flash kernels
# are no product, as JAX's Pallas kernels are none. In a group the "llm"
# family keeps the gate and up products, and "llm_res" the flash residuals
# too: a group is one region, so its other named values (attn_ctx, q/k/v)
# are recomputed.
_LAYERS_CONTEXT = {
    "none": None,
    "dots": _selective({_MM}),
    "dots_batched": _selective({_MM, _BMM}),
    "llm": _selective(kept=True),
    "llm_qkv": _selective(kept=True),
    "llm_res": _selective({FLASH_FWD_OP}, kept=True),
}


def _region(fn, *args, context_fn=None):
    """``fn(*args)`` as one checkpoint region: the backward keeps its
    inputs and runs it again (keeping what ``context_fn`` keeps)."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _ctx_region(cfg, rope, x, ln, attn):
    return _attn_ctx(cfg, *_qkv(cfg, rope, rms_norm(x, ln, eps=cfg.norm_eps),
                                attn))


def _qkv_region(cfg, rope, x, ln, attn):
    return _qkv(cfg, rope, rms_norm(x, ln, eps=cfg.norm_eps), attn)


def _mlp_in_region(cfg, x, ln, mlp):
    return _mlp_in(cfg, rms_norm(x, ln, eps=cfg.norm_eps), mlp)


def _wo_mlp_in_region(cfg, x, ctx, wo, ln, mlp):
    x = x + ctx @ wo.to(cfg.dtype)
    return (x, *_mlp_in_region(cfg, x, ln, mlp))


def _remat_layer(cfg: TransformerConfig, rope, x, layer):
    """One layer under remat, laid out as regions by ``cfg.remat_policy``.

    "none", "dots" and "dots_batched" run the layer as one region, keeping
    nothing, the plain products or every product. Torch has no
    checkpoint_name, so the "llm" family keeps its named values by making
    them region boundaries: each layer saves its input x, the attention
    context (the input of wo) and the gate and up products, and
    recomputes the rest. Regions: (x -> attn_ctx), (x, attn_ctx -> the
    residual after attention, gate, up; the products kept, not run
    again), (gate, up -> the MLP output; its down product runs again,
    where JAX drops it). "llm_qkv" splits the first region at the
    post-rope q, k, v (the backward keeps them and runs the projections
    again before the flash forward); "llm_res" keeps the flash forward's
    out and lse, so the backward does not run it again; "llm_attn" runs
    attention outside any region, on the kernel's own residuals."""
    policy, attn, mlp = cfg.remat_policy, layer["attn"], layer["mlp"]
    if policy in ("none", "dots", "dots_batched"):
        return _region(functools.partial(_layer_fn, cfg, rope), x, layer,
                       context_fn=_LAYERS_CONTEXT[policy])
    mlp_in = _selective(kept=True)
    if policy == "llm_attn":
        h = rms_norm(x, layer["ln_attn"], eps=cfg.norm_eps)
        x = x + _attention(h, attn, cfg, rope)
        gate, up = _region(_mlp_in_region, cfg, x, layer["ln_mlp"], mlp,
                           context_fn=mlp_in)
    else:
        if policy == "llm_qkv":
            qkv = _region(_qkv_region, cfg, rope, x, layer["ln_attn"], attn)
            ctx = _region(_attn_ctx, cfg, *qkv)
        else:
            ctx = _region(_ctx_region, cfg, rope, x, layer["ln_attn"], attn,
                          context_fn=(_selective({FLASH_FWD_OP})
                                      if policy == "llm_res" else None))
        x, gate, up = _region(_wo_mlp_in_region, cfg, x, ctx, attn["wo"],
                              layer["ln_mlp"], mlp, context_fn=mlp_in)
    return x + _region(_mlp_out, cfg, gate, up, mlp["down"])


def _group_fn(cfg: TransformerConfig, rope, x, layers: list):
    for layer in layers:
        x = _layer_fn(cfg, rope, x, layer)
    return x


def _embed_lookup(kernel, tokens, cfg: TransformerConfig):
    """Token embedding by gather (JAX's path without a tensor-parallel
    mesh). Gathering rows then casting equals casting then gathering."""
    return kernel[tokens.long()].to(cfg.dtype)


def hidden_states(params, tokens, cfg: TransformerConfig, *, mesh=None):
    """tokens [B, T] → (final-norm hidden [B, T, D] in cfg.dtype, aux loss
    0.0 — the MoE router loss of dense models). While autograd records,
    ``cfg.remat`` runs each layer (or each group of ``scan_group_size``
    layers) as checkpoint regions of ``cfg.remat_policy``; an inference
    forward opens none."""
    _check_trainable(cfg, mesh)
    t = tokens.shape[1]
    rope = rotary_frequencies(cfg.head_dim, t, theta=cfg.rope_theta,
                              device=tokens.device)
    x = _embed_lookup(params["embed"]["kernel"], tokens, cfg)
    layers = [_layer(params, i) for i in range(cfg.n_layers)]
    group = cfg.scan_group_size
    if not (cfg.remat and torch.is_grad_enabled()):
        for layer in layers:
            x = _layer_fn(cfg, rope, x, layer)
    elif group > 1:
        fn = functools.partial(_group_fn, cfg, rope)
        for i in range(0, cfg.n_layers, group):
            x = _region(fn, x, layers[i:i + group],
                        context_fn=_LAYERS_CONTEXT[cfg.remat_policy])
    else:
        for layer in layers:
            x = _remat_layer(cfg, rope, x, layer)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _head_kernel(params, cfg: TransformerConfig):
    if cfg.tie_embeddings:
        return params["embed"]["kernel"].T
    return params["lm_head"]["kernel"]


def apply(params, tokens, cfg: TransformerConfig, *, mesh=None,
          return_aux: bool = False):
    """tokens [B, T] int → logits [B, T, V] (cfg.dtype).
    ``return_aux=True`` also returns the aux loss (0.0, dense models)."""
    x, aux = hidden_states(params, tokens, cfg, mesh=mesh)
    logits = x @ _head_kernel(params, cfg).to(cfg.dtype)
    if return_aux:
        return logits, aux
    return logits


def loss_fn(params, batch, cfg: TransformerConfig, *, mesh=None):
    """Next-token LM loss with z-loss 1e-4. batch: {"tokens": [B, T+1]}
    (or separate "inputs"/"targets"); negative targets are ignored.
    ``cfg.loss_chunks`` applies the head and the loss in that many row
    chunks (``chunked_lm_head_loss``). Returns (loss, metrics)."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    if cfg.loss_chunks:
        x, _aux = hidden_states(params, inputs, cfg, mesh=mesh)
        b, t, d = x.shape
        return chunked_lm_head_loss(
            x.reshape(b * t, d), _head_kernel(params, cfg).to(cfg.dtype),
            targets.reshape(b * t), z_loss=1e-4, n_chunks=cfg.loss_chunks)
    logits = apply(params, inputs, cfg, mesh=mesh)
    return softmax_cross_entropy(logits, targets, z_loss=1e-4)
