"""Decoder-only transformer LM: configuration, presets and parameters.

Counterpart of ``kubeflow_tpu/models/transformer.py``: the same
Llama-style block (RMSNorm pre-norm, rotary positions, grouped-query
attention, SwiGLU MLP) and the same stacked ``[L, ...]`` parameter layout,
so a JAX parameter tree converts leaf for leaf (``weights.py``).

Training knobs of the JAX config (remat, scan, attention implementation,
loss chunking) belong to the training slice and are not carried here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from kubeflow_tpu_torch.device import resolve_device


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
        d_ff=128, max_seq_len=128,
    ),
    "flagship-1b": TransformerConfig(
        vocab_size=32_000, d_model=4096, n_layers=3, n_heads=32,
        n_kv_heads=4, d_ff=20_480, max_seq_len=2048,
    ),
    "flagship-deep": TransformerConfig(
        vocab_size=32_000, d_model=3072, n_layers=16, n_heads=24,
        n_kv_heads=4, d_ff=6656, max_seq_len=2048,
    ),
    "moe-1b": TransformerConfig(
        vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16,
        n_kv_heads=4, d_ff=3584, n_experts=8, expert_top_k=2,
    ),
    "moe-test-tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, n_experts=4, expert_top_k=2,
    ),
}


def config(name: str, **overrides) -> TransformerConfig:
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
         device: str | torch.device = "cuda") -> dict:
    """Parameter dict with the JAX tree's layout and distributions:
    normal × fan_in^-0.5 for every dense weight, ones for the norms.
    Values differ from JAX's for the same seed (a torch generator is not
    a threefry key); tests that need equal weights convert the JAX tree
    with :func:`kubeflow_tpu_torch.weights.params_from_numpy`."""
    dev = resolve_device(device)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(cfg.dtype)

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
