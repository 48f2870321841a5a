"""BERT encoder; counterpart of ``kubeflow_tpu/models/bert.py``.

The same model and parameter tree as the JAX package's: learned position
embeddings, post-norm residuals, a GELU MLP (``jax.nn.gelu``'s default,
the tanh approximation), bidirectional attention over a key-padding mask,
and the MLM and NSP heads, with stacked ``[L, ...]`` layer weights, so a
JAX parameter tree converts leaf for leaf (``weights.py``).

Attention goes through ``ops.attention.flash_attention`` with
``causal=False`` and ``kv_mask=pad_mask``: the CUDA flash kernels on the
card. A query row whose keys are all masked (a pad row of a server batch)
returns 0. The rest is plain PyTorch on every device, as the JAX package
computes it without a Pallas kernel: ``layer_norm``, GELU, the
projections and the heads.

Precision follows JAX's reads: the embeddings are summed and normalised
in float32 before the cast to ``cfg.dtype``; the pooler and the MLM head
run in float32; the layers' weights and biases are cast to ``cfg.dtype``
at each use (:data:`COMPUTE_PREFIXES`). Over a mesh of the data and
fsdp axes (``mesh=``) each rank runs its rows of the batch and
:func:`loss_fn` normalises by the global count of masked positions.

Over the ``tensor`` axis each rank holds its block of the leaves JAX's
rules split (:func:`partition_rules`, Megatron's) and runs Megatron's
layer, as ``models/transformer.py`` does: wq/wk/wv and ``mlp/wi``
column-parallel on its heads and ``d_ff`` columns behind
``copy_to_tensor``, each adding its slice of the replicated bias; both
``wo`` row-parallel, summed by ``reduce_from_tensor`` before their
replicated bias is added once. The word embedding is split over the
vocabulary (a masked gather and a sum; the position and type tables stay
whole), and the tied MLM head computes the rank's vocabulary slice of the
logits in float32 with its slice of ``output_bias``, gathered whole by
``gather_from_tensor``. A replicated leaf that a rank reads only a slice
of (a column bias, ``output_bias``) goes behind ``copy_to_tensor``, so
every rank holds its whole gradient. Every leaf is replicated over
``expert``, ``sequence`` and ``pipeline``, whose ranks hold the same rows
(JAX's rules and batch spec name none of them).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.attention import flash_attention
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.ops.norms import layer_norm
from kubeflow_tpu_torch.parallel.collectives import (
    copy_to_tensor,
    gather_from_tensor,
    tensor_copy,
    tensor_sum,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_TENSOR,
    BATCH_AXES,
    axis_index,
    axis_size,
    tensor_mesh,
)
from kubeflow_tpu_torch.parallel.sharding import P, PartitionRule, vocab_lookup


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def leaf_dtype(self, path: str,
                   dtype: torch.dtype | None = None) -> torch.dtype:
        """The dtype the port stores leaf ``path`` in: the one JAX reads
        it in. The layers' projections and biases
        (:data:`COMPUTE_PREFIXES`) take ``dtype`` (default ``self.dtype``);
        the embeddings, layer norms, pooler and heads stay float32."""
        compute = dtype or self.dtype
        return (compute if path.startswith(COMPUTE_PREFIXES)
                else torch.float32)


# The shapes of kubeflow_tpu/models/bert.py:PRESETS.
PRESETS: dict[str, BertConfig] = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(d_model=1024, n_layers=24, n_heads=16,
                             d_ff=4096),
    "bert-test-tiny": BertConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=128,
    ),
}

# Paths of the leaves JAX casts to cfg.dtype at each use (the layers'
# projections and biases); every other leaf is read in float32.
COMPUTE_PREFIXES = ("layers/attn/", "layers/mlp/")


def config(name: str, **overrides) -> BertConfig:
    """A preset with overrides; ``dtype`` may be a torch dtype or its
    name."""
    if isinstance(overrides.get("dtype"), str):
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    return replace(PRESETS[name], **overrides)


def init(cfg: BertConfig, *, generator: torch.Generator,
         device: str | torch.device = "cuda",
         param_dtype: torch.dtype | None = None) -> dict:
    """Parameter dict with the JAX tree's layout and distributions (normal
    × fan_in^-0.5 for every dense weight, zeros for biases, ones and
    zeros for the norms). The layers' weights and biases are stored in
    ``param_dtype`` (``cfg.dtype`` by default, float32 for training's
    master weights); the rest in float32, as JAX reads them. Values
    differ from JAX's for the same seed."""
    dev = resolve_device(device)
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    dtype = cfg.dtype if param_dtype is None else param_dtype

    def dense(shape, fan_in, leaf_dtype=torch.float32):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(leaf_dtype)

    def stack(shape, fan_in):
        return dense((n, *shape), fan_in, dtype)

    def zeros(*shape, leaf_dtype=torch.float32):
        return torch.zeros(shape, dtype=leaf_dtype, device=dev)

    def ln(*shape):
        return {"scale": torch.ones(shape, device=dev), "bias": zeros(*shape)}

    return {
        "embed": {
            "word": dense((cfg.vocab_size, d), d),
            "position": dense((cfg.max_seq_len, d), d),
            "type": dense((cfg.type_vocab_size, d), d),
            "ln": ln(d),
        },
        "layers": {
            "attn": {
                "wq": stack((d, d), d),
                "wk": stack((d, d), d),
                "wv": stack((d, d), d),
                "wo": stack((d, d), d),
                **{b: zeros(n, d, leaf_dtype=dtype)
                   for b in ("bq", "bk", "bv", "bo")},
            },
            "mlp": {
                "wi": stack((d, f), d),
                "bi": zeros(n, f, leaf_dtype=dtype),
                "wo": stack((f, d), f),
                "bo2": zeros(n, d, leaf_dtype=dtype),
            },
            "ln_attn": ln(n, d),
            "ln_mlp": ln(n, d),
        },
        "pooler": {"kernel": dense((d, d), d), "bias": zeros(d)},
        "mlm": {
            "transform": dense((d, d), d),
            "transform_bias": zeros(d),
            "ln": ln(d),
            "output_bias": zeros(cfg.vocab_size),
        },
        "nsp": {"kernel": dense((d, 2), d), "bias": zeros(2)},
    }


def partition_rules(cfg: BertConfig) -> list[PartitionRule]:
    """JAX's layout: the word embeddings over tensor x fsdp, the layers'
    projections column- and row-parallel, the rest replicated."""
    return [
        PartitionRule(r"embed/word", P(AXIS_TENSOR, AXIS_FSDP)),
        PartitionRule(r"attn/w[qkv]", P(None, AXIS_FSDP, AXIS_TENSOR)),
        PartitionRule(r"attn/wo", P(None, AXIS_TENSOR, AXIS_FSDP)),
        PartitionRule(r"mlp/wi", P(None, AXIS_FSDP, AXIS_TENSOR)),
        PartitionRule(r"mlp/wo", P(None, AXIS_TENSOR, AXIS_FSDP)),
    ]


def batch_partition_spec(cfg: BertConfig) -> tuple:
    return P((AXIS_DATA, AXIS_FSDP), None)


def check_mesh(cfg: BertConfig, mesh) -> None:
    """Raise ValueError for a tensor degree that does not divide the
    heads, ``d_ff`` or the vocabulary. Every other axis trains: the
    ranks of ``sequence`` and ``pipeline`` are replicas, as in JAX (no
    rule or batch spec names them), holding the whole rows and every
    layer."""
    tp = axis_size(mesh, AXIS_TENSOR)
    for what in ("n_heads", "d_ff", "vocab_size"):
        if getattr(cfg, what) % tp:
            raise ValueError(f"tensor degree {tp} must divide {what} "
                             f"{getattr(cfg, what)}")


def _slice(bias, tmesh):
    """This rank's block of a replicated column bias (last dim) over
    ``tmesh``'s tensor axis, behind ``copy_to_tensor`` (each rank's
    gradient covers only its block; the sum gives every rank the whole);
    the bias as it is without one."""
    if tmesh is None:
        return bias
    cols = bias.shape[-1] // axis_size(tmesh, AXIS_TENSOR)
    return copy_to_tensor(bias, tmesh).narrow(
        -1, axis_index(tmesh, AXIS_TENSOR) * cols, cols)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _layer(params, i: int) -> dict:
    """Views of layer ``i``'s slice of the stacked ``[L, ...]`` weights."""
    lp = params["layers"]
    return {part: {k: w[i] for k, w in lp[part].items()}
            for part in ("attn", "mlp", "ln_attn", "ln_mlp")}


def _layer_fn(cfg: BertConfig, x, pad_mask, layer, tmesh=None):
    """One post-norm layer; over ``tmesh`` Megatron's (module
    docstring)."""
    b, t, d = x.shape
    a, dt = layer["attn"], cfg.dtype
    tp = 1 if tmesh is None else axis_size(tmesh, AXIS_TENSOR)
    xin = tensor_copy(x, tmesh)

    def heads(w, bias):
        return (xin @ w.to(dt) + _slice(bias, tmesh).to(dt)).reshape(
            b, t, cfg.n_heads // tp, cfg.head_dim)

    attn = flash_attention(heads(a["wq"], a["bq"]), heads(a["wk"], a["bk"]),
                           heads(a["wv"], a["bv"]), causal=False,
                           kv_mask=pad_mask).reshape(b, t, d // tp)
    attn = tensor_sum(attn @ a["wo"].to(dt), tmesh) + a["bo"].to(dt)
    x = layer_norm(x + attn, layer["ln_attn"]["scale"],
                   layer["ln_attn"]["bias"], eps=cfg.norm_eps)
    m = layer["mlp"]
    xin = tensor_copy(x, tmesh)
    h = _gelu(xin @ m["wi"].to(dt) + _slice(m["bi"], tmesh).to(dt))
    h = tensor_sum(h @ m["wo"].to(dt), tmesh) + m["bo2"].to(dt)
    return layer_norm(x + h, layer["ln_mlp"]["scale"],
                      layer["ln_mlp"]["bias"], eps=cfg.norm_eps)


def apply(params, tokens, cfg: BertConfig, *, type_ids=None, pad_mask=None,
          mesh=None):
    """tokens [B, T] → (sequence_output [B, T, D] in cfg.dtype, pooled
    [B, D] f32). ``pad_mask`` [B, T] (truthy = a real token) defaults to
    all ones, ``type_ids`` to zeros. ``cfg.remat`` runs each layer as one
    checkpoint region (JAX's ``jax.checkpoint`` with no policy) while
    autograd records."""
    if mesh is not None:
        check_mesh(cfg, mesh)
    b, t = tokens.shape
    if t > cfg.max_seq_len:
        raise ValueError(f"sequence length {t} exceeds the position table "
                         f"({cfg.max_seq_len})")
    dev = tokens.device
    if pad_mask is None:
        pad_mask = torch.ones((b, t), dtype=torch.float32, device=dev)
    if type_ids is None:
        type_ids = torch.zeros((b, t), dtype=torch.long, device=dev)
    tmesh = tensor_mesh(mesh)
    e = params["embed"]
    x = (vocab_lookup(e["word"], tokens, tmesh) + e["position"][:t][None]
         + e["type"][type_ids.long()])
    x = layer_norm(x, e["ln"]["scale"], e["ln"]["bias"],
                   eps=cfg.norm_eps).to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        if remat:
            x = checkpoint(_layer_fn, cfg, x, pad_mask, layer, tmesh,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_fn(cfg, x, pad_mask, layer, tmesh)
    pooled = torch.tanh(x[:, 0].float() @ params["pooler"]["kernel"]
                        + params["pooler"]["bias"])
    return x, pooled


def mlm_logits(params, sequence_output, cfg: BertConfig, *, mesh=None):
    """The MLM head in float32, tied to the word embeddings: [B, T, V].
    Over a tensor ``mesh`` each rank computes its vocabulary slice with
    its block of the embeddings and its slice of ``output_bias``, and the
    slices are gathered whole."""
    m = params["mlm"]
    h = _gelu(sequence_output.float() @ m["transform"] + m["transform_bias"])
    h = layer_norm(h, m["ln"]["scale"], m["ln"]["bias"], eps=cfg.norm_eps)
    tmesh = tensor_mesh(mesh)
    if tmesh is None:
        return h @ params["embed"]["word"].T + m["output_bias"]
    local = copy_to_tensor(h, tmesh) @ params["embed"]["word"].T \
        + _slice(m["output_bias"], tmesh)
    return gather_from_tensor(local, tmesh)


def loss_fn(params, batch, cfg: BertConfig, *, mesh=None):
    """Masked-LM pretraining loss. batch: tokens [B, T], mlm_labels [B, T]
    (negative = unmasked position), optional pad_mask. Returns (loss,
    metrics). Over ``mesh`` (this rank's rows) the loss is this rank's
    term of the global loss, normalised by the masked positions of every
    rank, and the metrics are global."""
    seq, _ = apply(params, batch["tokens"], cfg,
                   pad_mask=batch.get("pad_mask"), mesh=mesh)
    logits = mlm_logits(params, seq, cfg, mesh=mesh)
    return softmax_cross_entropy(logits, batch["mlm_labels"], mesh=mesh)
