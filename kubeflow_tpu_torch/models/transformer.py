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
so either value runs the loop here. Options whose port is still to come
raise ``ValueError("... not yet ported")`` where training reaches them:
``remat`` under autograd, ``scan_group_size > 1``, ``context_parallel``,
``pipeline_stages > 1``, ``loss_chunks > 0`` and a mesh; MoE presets are
refused by :func:`config`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.attention import flash_attention
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
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
    docstring). ``remat`` only decides what the backward keeps, so it
    raises only when autograd records this forward."""
    if mesh is not None:
        raise _not_yet("the model forward over a mesh")
    if cfg.context_parallel:
        raise _not_yet("context_parallel (ring attention)")
    if cfg.pipeline_stages > 1:
        raise _not_yet("pipeline_stages > 1")
    if cfg.scan_group_size > 1:
        raise _not_yet("scan_group_size > 1 (grouped layer scan)")
    if cfg.remat and torch.is_grad_enabled():
        raise _not_yet(f"remat=True (policy {cfg.remat_policy!r}); pass "
                       "remat=False")


def _layer(params, i: int) -> dict:
    """Views of layer ``i``'s slice of the stacked ``[L, ...]`` weights."""
    lp = params["layers"]
    return {
        "attn": {k: w[i] for k, w in lp["attn"].items()},
        "mlp": {k: w[i] for k, w in lp["mlp"].items()},
        "ln_attn": lp["ln_attn"][i],
        "ln_mlp": lp["ln_mlp"][i],
    }


def _attention(x, layer, cfg: TransformerConfig, rope):
    b, t, _d = x.shape
    hd = cfg.head_dim
    cos, sin = rope
    q = (x @ layer["wq"].to(cfg.dtype)).reshape(b, t, cfg.n_heads, hd)
    k = (x @ layer["wk"].to(cfg.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ layer["wv"].to(cfg.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    out = flash_attention(q, k, v, causal=True,
                          implementation=cfg.attn_impl,
                          block_k=cfg.attn_block_k)
    return out.reshape(b, t, cfg.n_heads * hd) @ layer["wo"].to(cfg.dtype)


def _mlp(x, layer, cfg: TransformerConfig):
    gate = x @ layer["gate"].to(cfg.dtype)
    up = x @ layer["up"].to(cfg.dtype)
    return (F.silu(gate) * up) @ layer["down"].to(cfg.dtype)


def _layer_fn(cfg: TransformerConfig, rope, x, layer):
    h = rms_norm(x, layer["ln_attn"], eps=cfg.norm_eps)
    x = x + _attention(h, layer["attn"], cfg, rope)
    h = rms_norm(x, layer["ln_mlp"], eps=cfg.norm_eps)
    return x + _mlp(h, layer["mlp"], cfg)


def _embed_lookup(kernel, tokens, cfg: TransformerConfig):
    """Token embedding by gather (JAX's path without a tensor-parallel
    mesh). Gathering rows then casting equals casting then gathering."""
    return kernel[tokens.long()].to(cfg.dtype)


def hidden_states(params, tokens, cfg: TransformerConfig, *, mesh=None):
    """tokens [B, T] → (final-norm hidden [B, T, D] in cfg.dtype, aux loss
    0.0 — the MoE router loss of dense models)."""
    _check_trainable(cfg, mesh)
    t = tokens.shape[1]
    rope = rotary_frequencies(cfg.head_dim, t, theta=cfg.rope_theta,
                              device=tokens.device)
    x = _embed_lookup(params["embed"]["kernel"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = _layer_fn(cfg, rope, x, _layer(params, i))
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
    Returns (loss, metrics)."""
    if cfg.loss_chunks:
        raise _not_yet("loss_chunks > 0 (chunked_lm_head_loss)")
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logits = apply(params, inputs, cfg, mesh=mesh)
    return softmax_cross_entropy(logits, targets, z_loss=1e-4)
