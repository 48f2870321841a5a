"""Decoder-only transformer LM: configuration, presets, parameters and
the training forward.

Counterpart of ``kubeflow_tpu/models/transformer.py``: the same
Llama-style block (RMSNorm pre-norm, rotary positions, grouped-query
attention, SwiGLU MLP or, with ``n_experts``, the top-k mixture of experts
of :func:`moe_ffn`) and the same stacked ``[L, ...]`` parameter layout, so
a JAX parameter tree converts leaf for leaf (``weights.py``).

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
(:func:`_remat_layer`), and ``loss_chunks`` the chunked LM loss. The
forward runs over every mesh axis (:func:`loss_fn` with ``mesh=``): over
data and fsdp each rank runs its rows of the batch through the whole
model; the ranks of the model axes (expert and tensor) and of
``pipeline`` hold the same rows. Layouts JAX refuses raise its messages.

Over ``sequence`` with ``context_parallel`` each rank holds a chunk of its
rows' tokens: attention is the ring (``parallel/ring_attention.py``),
its K/V heads repeated to the query heads, the rotary positions those of
the rank's chunk (:func:`_rope_table`), and the loss a term over data x
fsdp x sequence (:func:`token_axes`). With ``pipeline_stages`` over a
mesh the layers run the GPipe schedule (``parallel/pipeline.py``) on the
stage's slice of the stacked leaves, each layer a remat region of
``cfg.remat_policy``; the embedding, final norm and head are replicated
over ``pipeline``, and every stage computes the head on the outputs the
schedule shares.

Over the ``tensor`` axis each rank holds its block of every leaf the
partition rules split (:func:`partition_rules`) and runs Megatron's
layer on it (:func:`shard_config` is its view of the config): wq/wk/wv
and gate/up column-parallel on its heads and ``d_ff`` columns behind
``copy_to_tensor``, wo and down row-parallel followed by
``reduce_from_tensor``, the embedding and the head split over the
vocabulary (the logits gathered whole). A rank's contiguous query heads
read its contiguous KV heads (``G = Hq / Hkv`` heads a group), so the
flash kernels run on each rank's heads unchanged. Remat regions replay
the forward's collectives when they recompute, in the same order on
every rank. A dense model replicates every leaf over ``expert``.

The JAX package computes :func:`moe_ffn` with einsums, ``top_k`` and a
``cumsum`` (no Pallas kernel), so it is plain PyTorch here on every
device; it dispatches by index instead of through the one-hot einsums,
which computes the same function without the ``[n, E, C]`` dispatch
tensor. Under GSPMD JAX's ``moe_ffn`` stays the function of the GLOBAL
batch; over a mesh the port computes that function from each rank's
rows: the capacity from the global token count, each choice's queue
position from every rank's counts (one all-gather of ``[k, E]`` integers
over the batch axes a layer), the rank's experts ``[e0, e0 + E/ep)`` on
its ``d_ff/tp`` columns, and the partial outputs summed over
``("expert", "tensor")``. JAX's batch spec replicates the rows over
``expert``, so that sum is the exact counterpart of GSPMD's dispatch,
with no all-to-all.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    batch_sum,
    chunked_lm_head_loss,
    softmax_cross_entropy,
)
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rotary, rotary_frequencies
from kubeflow_tpu_torch.parallel.collectives import (
    copy_to_tensor,
    gather_counts,
    gather_from_tensor,
    reduce_from_tensor,
    tensor_copy,
    tensor_sum,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    MODEL_AXES,
    axis_index,
    axis_size,
    tensor_mesh,
)
from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply
from kubeflow_tpu_torch.parallel.ring_attention import ring_attention
from kubeflow_tpu_torch.parallel.sharding import (
    P,
    PartitionRule,
    spec_axes,
    vocab_lookup,
)


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
    # Mixture-of-Experts FFN (0 = dense): top-k routing with a static
    # capacity per expert; dropped tokens ride the residual (moe_ffn).
    n_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # Training fields of the JAX config, with its defaults; see the module
    # docstring for which of them run here.
    context_parallel: bool = False
    remat: bool = True
    pipeline_stages: int = 0
    pipeline_microbatches: int = 4
    attn_impl: str | None = None
    attn_block_k: int | None = None
    remat_policy: str = "dots"
    scan_layers: bool = True
    loss_chunks: int = 0
    scan_group_size: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def leaf_dtype(self, path: str,
                   dtype: torch.dtype | None = None) -> torch.dtype:
        """The dtype the port stores leaf ``path`` in: the one JAX reads
        it in. Leaves JAX casts to ``dtype`` at each use take
        ``dtype`` (default ``self.dtype``); the norms and the MoE router
        (:data:`FLOAT32_LEAVES`) stay float32."""
        compute = dtype or self.dtype
        return torch.float32 if path in FLOAT32_LEAVES else compute


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
    return replace(PRESETS[name], **overrides)


@dataclass(frozen=True)
class TensorShardConfig(TransformerConfig):
    """One model-parallel rank's view of a config (:func:`shard_config`):
    its query and KV heads and its ``d_ff`` columns (``shards`` tensor
    shards), the whole ``head_dim``, and its experts
    ``[first_expert, first_expert + local_experts)`` of ``expert_shards``
    ranges; ``n_experts`` stays whole, as every rank routes over all of
    them. ``mesh`` is the training mesh the layer's collectives run over;
    None for a serving shard, whose replica sums the shards itself
    (``models/decode.py``)."""

    shards: int = 1
    expert_shards: int = 1
    expert_index: int = 0
    mesh: object = None

    @property
    def head_dim(self) -> int:
        return self.d_model // (self.n_heads * self.shards)

    @property
    def local_experts(self) -> int:
        return self.n_experts // self.expert_shards

    @property
    def first_expert(self) -> int:
        return self.expert_index * self.local_experts


def check_degrees(cfg: TransformerConfig, tp: int, ep: int = 1) -> None:
    """Raise unless the tensor degree ``tp`` divides the heads, the KV
    heads, ``d_ff`` and the vocabulary, and the expert degree ``ep``
    divides ``n_experts`` (a mixture of experts)."""
    for what in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
        if getattr(cfg, what) % tp:
            raise ValueError(f"tensor degree {tp} must divide {what} "
                             f"{getattr(cfg, what)}")
    if cfg.n_experts and cfg.n_experts % ep:
        raise ValueError(f"expert degree {ep} must divide n_experts "
                         f"{cfg.n_experts}")


def shard_config(cfg: TransformerConfig, tp: int, mesh=None
                 ) -> TransformerConfig:
    """The config one of ``tp`` tensor shards runs (``cfg`` itself at tp
    1 without a mesh); over a training ``mesh`` a mixture of experts also
    keeps this rank's range of experts on ``expert``. Raises as
    :func:`check_degrees` does."""
    if tp == 1 and mesh is None:
        return cfg
    ep = axis_size(mesh, AXIS_EXPERT) if mesh is not None and \
        cfg.n_experts else 1
    check_degrees(cfg, tp, ep)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("shards", "expert_shards", "expert_index",
                                "mesh")}
    fields.update(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                  d_ff=cfg.d_ff // tp)
    return TensorShardConfig(
        **fields, shards=tp, expert_shards=ep,
        expert_index=axis_index(mesh, AXIS_EXPERT) if ep > 1 else 0,
        mesh=mesh)


def _mesh(cfg: TransformerConfig):
    """The training mesh of a rank's view (:func:`shard_config`), else
    None: the mesh Megatron's collectives (``tensor_copy``,
    ``tensor_sum``) run over where its tensor degree is above 1."""
    return getattr(cfg, "mesh", None)


# Leaves that rms_norm reads in float32; every other leaf is a matmul or
# embedding weight, stored once in cfg.dtype (JAX casts it at each use).
NORM_LEAVES = ("layers/ln_attn", "layers/ln_mlp", "final_norm")
# Every leaf JAX reads in float32: the norms and the MoE router.
FLOAT32_LEAVES = (*NORM_LEAVES, "layers/mlp/router")


def init(cfg: TransformerConfig, *, generator: torch.Generator,
         device: str | torch.device = "cuda",
         param_dtype: torch.dtype | None = None) -> dict:
    """Parameter dict with the JAX tree's layout and distributions:
    normal × fan_in^-0.5 for every dense weight, ones for the norms.
    Dense weights are stored in ``param_dtype``: ``cfg.dtype`` by default
    (serving), float32 for training's master weights, as JAX keeps them;
    the MoE router is float32 either way, as JAX reads it.
    Values differ from JAX's for the same seed (a torch generator is not
    a threefry key); tests that need equal weights convert the JAX tree
    with :func:`kubeflow_tpu_torch.weights.params_from_numpy`."""
    dev = resolve_device(device)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    dtype = cfg.dtype if param_dtype is None else param_dtype

    def dense(shape, fan_in, leaf_dtype=dtype):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(leaf_dtype)

    def stack(shape, fan_in, leaf_dtype=dtype):
        return dense((cfg.n_layers, *shape), fan_in, leaf_dtype)

    if cfg.n_experts:
        e = cfg.n_experts
        mlp = {
            "router": stack((d, e), d, torch.float32),
            "gate": stack((e, d, f), d),
            "up": stack((e, d, f), d),
            "down": stack((e, f, d), f),
        }
    else:
        mlp = {
            "gate": stack((d, f), d),
            "up": stack((d, f), d),
            "down": stack((f, d), f),
        }
    params = {
        "embed": {"kernel": dense((cfg.vocab_size, d), d)},
        "layers": {
            "attn": {
                "wq": stack((d, cfg.n_heads * hd), d),
                "wk": stack((d, cfg.n_kv_heads * hd), d),
                "wv": stack((d, cfg.n_kv_heads * hd), d),
                "wo": stack((cfg.n_heads * hd, d), cfg.n_heads * hd),
            },
            "mlp": mlp,
            "ln_attn": torch.ones((cfg.n_layers, d), device=dev),
            "ln_mlp": torch.ones((cfg.n_layers, d), device=dev),
        },
        "final_norm": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense((d, cfg.vocab_size), d)}
    return params


def partition_rules(cfg: TransformerConfig) -> list[PartitionRule]:
    """JAX's DP x FSDP x TP (x EP) layout, rule for rule: stacked layer
    weights keep a leading L dim (on ``pipeline`` with pipeline stages);
    column-parallel wq/wk/wv/gate/up, row-parallel wo/down; MoE experts
    [L, E, ...] over ``expert``; the norms replicated."""
    ldim = AXIS_PIPELINE if cfg.pipeline_stages > 1 else None
    rules = [
        PartitionRule(r"embed/kernel", P(AXIS_TENSOR, AXIS_FSDP)),
        PartitionRule(r"attn/w[qkv]", P(ldim, AXIS_FSDP, AXIS_TENSOR)),
        PartitionRule(r"attn/wo", P(ldim, AXIS_TENSOR, AXIS_FSDP)),
    ]
    if cfg.pipeline_stages > 1:
        rules.append(PartitionRule(r"layers/ln_", P(AXIS_PIPELINE)))
    if cfg.n_experts:
        rules += [
            PartitionRule(r"mlp/router", P(ldim, AXIS_FSDP, None)),
            PartitionRule(r"mlp/(gate|up)",
                          P(ldim, AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR)),
            PartitionRule(r"mlp/down",
                          P(ldim, AXIS_EXPERT, AXIS_TENSOR, AXIS_FSDP)),
        ]
    else:
        rules += [
            PartitionRule(r"mlp/(gate|up)", P(ldim, AXIS_FSDP, AXIS_TENSOR)),
            PartitionRule(r"mlp/down", P(ldim, AXIS_TENSOR, AXIS_FSDP)),
        ]
    rules.append(PartitionRule(r"lm_head/kernel", P(AXIS_FSDP, AXIS_TENSOR)))
    return rules


def batch_partition_spec(cfg: TransformerConfig) -> tuple:
    if cfg.context_parallel:
        return P((AXIS_DATA, AXIS_FSDP), AXIS_SEQUENCE)
    return P((AXIS_DATA, AXIS_FSDP), None)


def token_axes(cfg: TransformerConfig) -> tuple[str, ...]:
    """The mesh axes the batch's tokens are split over, the axes each
    rank's loss is a term over: those of :func:`batch_partition_spec`
    (data x fsdp, and ``sequence`` under context parallelism)."""
    return spec_axes(batch_partition_spec(cfg))


def check_mesh(cfg: TransformerConfig, mesh) -> None:
    """Raise ValueError for degrees :func:`check_degrees` refuses. The
    forward runs over every axis: the batch axes and ``sequence`` (with
    ``context_parallel``) split the tokens, the model axes and
    ``pipeline`` (with ``pipeline_stages``) the leaves, and an axis that
    does neither holds the same rows and leaves on each of its ranks."""
    check_degrees(cfg, axis_size(mesh, AXIS_TENSOR),
                  axis_size(mesh, AXIS_EXPERT))


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _pipelined(cfg: TransformerConfig, mesh) -> bool:
    """Whether the forward runs the GPipe schedule (JAX: pipeline stages
    over a mesh; without a mesh the layers run in one loop)."""
    return cfg.pipeline_stages > 1 and mesh is not None


def _check_trainable(cfg: TransformerConfig, mesh) -> None:
    """Raise for the layouts JAX refuses, with its messages, in its
    order."""
    if mesh is not None:
        check_mesh(cfg, mesh)
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one "
                         f"of {REMAT_POLICIES}")
    attn_saved = cfg.remat and cfg.remat_policy == "llm_attn"
    if _pipelined(cfg, mesh):
        if cfg.n_experts or cfg.context_parallel:
            raise ValueError(
                "pipeline_stages composes with dp/fsdp/tp, not (yet) with "
                "MoE or context parallelism")
        if cfg.n_layers % cfg.pipeline_stages:
            raise ValueError(
                f"n_layers {cfg.n_layers} not divisible by "
                f"pipeline_stages {cfg.pipeline_stages}")
        if attn_saved:
            raise ValueError(
                "remat_policy='llm_attn' is incompatible with "
                "pipeline_stages>1 (stages checkpoint whole layers); "
                "use 'llm'")
        return
    if attn_saved:
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
    h = tensor_copy(h, _mesh(cfg))
    q = (h @ attn["wq"].to(cfg.dtype)).reshape(b, t, cfg.n_heads, hd)
    k = (h @ attn["wk"].to(cfg.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    v = (h @ attn["wv"].to(cfg.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _attn_ctx(cfg: TransformerConfig, q, k, v):
    """The attention context [B, T, Hq*hd], the input of wo (JAX names it
    "attn_ctx"): the flash kernels, or with ``context_parallel`` the ring
    over ``sequence`` with the KV heads repeated to the query heads (the
    ring is MHA), [B, T, H, D] laid out [B, H, T, D] for it."""
    b, t = q.shape[:2]
    if cfg.context_parallel:
        reps = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
        out = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), _mesh(cfg),
                             causal=True).transpose(1, 2)
    else:
        out = flash_attention(q, k, v, causal=True,
                              implementation=cfg.attn_impl,
                              block_k=cfg.attn_block_k)
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim)


def _attention(h, attn, cfg: TransformerConfig, rope):
    ctx = _attn_ctx(cfg, *_qkv(cfg, rope, h, attn))
    return tensor_sum(ctx @ attn["wo"].to(cfg.dtype), _mesh(cfg))


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
    h = tensor_copy(h, _mesh(cfg))
    with _keep():
        return h @ wg, h @ wu


def _mlp_out(cfg: TransformerConfig, gate, up, down):
    return tensor_sum((F.silu(gate) * up) @ down.to(cfg.dtype), _mesh(cfg))


def _mlp(h, mlp, cfg: TransformerConfig):
    return _mlp_out(cfg, *_mlp_in(cfg, h, mlp), mlp["down"])


def top_k_experts(probs, k: int):
    """(values, indices) of the ``k`` largest router probabilities of each
    row, largest first, as ``lax.top_k`` gives them: among equal
    probabilities (a zero or upcycled router ties) the lower expert comes
    first. ``torch.topk`` leaves the order of ties unspecified; a stable
    descending sort keeps JAX's."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(probs, -1, idx), idx


# The choices moe_ffn drops past capacity, added up while a count_dropped()
# block is open on this thread.
_DROPPED = threading.local()


@contextlib.contextmanager
def count_dropped():
    """Count the valid (token, choice) pairs that every :func:`moe_ffn`
    call of the block drops past an expert's capacity (over a mesh, this
    rank's rows; a remat region's recompute counts again). Yields a list
    of 0-d tensors, one a call: their sum is the count."""
    counts: list = []
    _DROPPED.counts = counts
    try:
        yield counts
    finally:
        _DROPPED.counts = None


def _exclusive(x, dim: int = 0):
    return torch.cumsum(x, dim) - x


def _queue_offsets(counts, mesh, axes):
    """Over ``mesh``, what the global queue position of each of this
    rank's choices adds to its position among the rank's own choices:
    ``counts`` [B, k, E] are the rank's choices per (row, slot, expert).
    The global order is priority-major (every slot-j choice before any
    slot j+1 choice) and, within a slot, the global token order: rows in
    the batch axes' order, and within a row its ``sequence`` chunks in
    ring order when ``axes`` (the token axes, :func:`token_axes`) include
    ``sequence``. Returns (offsets [B, k, E], every rank's slot-0
    choices per expert)."""
    local = counts.long()
    every = gather_counts(local, mesh, axes)  # [W, B, k, E]
    ns = axis_size(mesh, AXIS_SEQUENCE) if AXIS_SEQUENCE in axes else 1
    every = every.reshape(-1, ns, *local.shape)  # [row groups, ns, B, k, E]
    group, chunk = divmod(axis_index(mesh, axes), ns)
    total = every.sum((0, 1, 2))
    mine = every[group]  # this rank's rows, every chunk of them
    rows = mine.sum(0)
    offsets = (_exclusive(total) - _exclusive(local.sum(0))
               + every[:group].sum((0, 1, 2))
               + _exclusive(rows) - _exclusive(local) + mine[:chunk].sum(0))
    return offsets.float(), total[0].float()


def moe_ffn(x, mlp, cfg: TransformerConfig, token_valid=None):
    """JAX's GShard-style MoE FFN: top-k routing with a static capacity
    per expert. x: [B, T, D] → (y [B, T, D] in x's dtype, aux scalar f32,
    the load-balance loss E · Σ_e fraction_e · mean_prob_e).

    The router runs in float32; the top-k gates are renormalised. Each
    expert holds ``capacity = max(int(n·k/E·cf), k)`` slots, ``n = B·T``
    of this call, filled priority-major (every first choice before any
    second choice, in token order); choices past capacity are dropped
    and ride the residual. ``token_valid`` ([B, T] bool): padding claims
    no capacity and stays out of the aux statistics.

    Dispatch is by index, not by JAX's one-hot einsums: each kept
    (token, choice) names one slot of ``[E, C]``, the slots gather their
    tokens into ``[E, C, D]``, the experts run as batched matmuls, and
    each token gathers its kept slots' outputs back, weighted by its
    gates cast to ``cfg.dtype`` (JAX's ``combine``). One token fills a
    slot at most, so the gather equals the dispatch einsum exactly.

    Over a training mesh (``cfg`` a rank's view with its ``mesh``; no
    ``token_valid``) ``x`` is this rank's rows and the function is JAX's
    over the global batch (module docstring): ``n`` and the capacity are
    global, a choice's slot is its global queue position, and the rank
    fills only its own experts' slots of an ``[E/ep, C, D]`` buffer. The
    input and the gates go behind ``copy_to_tensor`` over the model axes
    (each rank's use of them is a part of their gradient) and the partial
    outputs are summed by ``reduce_from_tensor``. The aux returned is this
    rank's term of the global loss, ``E · Σ_e top1_frac[e] ·
    Σ_local probs[:, e] / n``, whose sum over the batch axes is JAX's aux,
    value and gradient."""
    b, t, d = x.shape
    e = cfg.n_experts
    k = min(cfg.expert_top_k, e)
    mesh = getattr(cfg, "mesh", None)
    if mesh is not None and token_valid is not None:
        raise ValueError("moe_ffn over a mesh takes no token_valid")
    n = b * t
    axes = token_axes(cfg)
    n_all = n if mesh is None else n * axis_size(mesh, axes)
    capacity = max(int(n_all * k / e * cfg.expert_capacity_factor), k)
    xf = x.reshape(n, d)
    logits = xf.float() @ mlp["router"].float()
    probs = torch.softmax(logits, dim=-1)  # [n, e]
    gate_vals, expert_idx = top_k_experts(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    oh_e = F.one_hot(expert_idx, e).float()  # [n, k, e]
    if token_valid is not None:
        tv = token_valid.reshape(n).float()
        oh_e = oh_e * tv[:, None, None]
        n_valid = torch.clamp(tv.sum(), min=1.0)
    else:
        n_valid = float(n_all)
    # Position of each (token, choice) in its expert, priority-major. The
    # scan runs along the last axis of the [e, k·n] transpose: CUDA scans
    # the outer axis of [k·n, e] one column of e at a time.
    flat = oh_e.transpose(0, 1).reshape(k * n, e)
    pos = (torch.cumsum(flat.t().contiguous(), dim=1).t() - flat).reshape(
        k, n, e).transpose(0, 1)
    split = mesh is not None and axis_size(mesh, MODEL_AXES) > 1
    if mesh is not None:
        offsets, top1_all = _queue_offsets(
            oh_e.reshape(b, t, k, e).sum(1), mesh, axes)
        pos = (pos.reshape(b, t, k, e) + offsets[:, None]).reshape(n, k, e)
    slot_pos = (pos * oh_e).sum(-1).long()  # [n, k]
    chosen = oh_e.sum(-1) > 0
    kept = (slot_pos < capacity) & chosen
    if getattr(_DROPPED, "counts", None) is not None:
        _DROPPED.counts.append((chosen & ~kept).sum().detach())
    # This rank's experts (all of them off a mesh).
    e0, e_local = getattr(cfg, "first_expert", 0), getattr(
        cfg, "local_experts", e)
    if e_local != e:
        kept = kept & (expert_idx >= e0) & (expert_idx < e0 + e_local)
    # Slot index of each kept choice; the rest point at a zero row.
    sink = e_local * capacity
    dest = torch.where(kept, (expert_idx - e0) * capacity + slot_pos, sink)
    token_of = torch.full((sink + 1,), n, dtype=torch.long,
                          device=x.device).scatter(
        0, dest.reshape(-1),
        torch.arange(n, device=x.device).repeat_interleave(k))
    if split:
        xf = copy_to_tensor(xf, mesh, MODEL_AXES)
        gate_vals = copy_to_tensor(gate_vals, mesh, MODEL_AXES)
    # index_select, not advanced indexing: its backward is an index_add,
    # where advanced indexing's sorts the indices first.
    zero = xf.new_zeros((1, d))
    expert_in = torch.cat([xf, zero]).index_select(0, token_of[:-1]).reshape(
        e_local, capacity, d)
    g = torch.bmm(expert_in, mlp["gate"].to(cfg.dtype))
    u = torch.bmm(expert_in, mlp["up"].to(cfg.dtype))
    out = torch.bmm(F.silu(g) * u, mlp["down"].to(cfg.dtype))
    out = torch.cat([out.reshape(sink, d), out.new_zeros((1, d))])
    combine = gate_vals.to(cfg.dtype).float()
    back = out.index_select(0, dest.reshape(-1)).reshape(n, k, d)
    y = (back.float() * combine[..., None]).sum(1).to(cfg.dtype)
    if split:
        y = reduce_from_tensor(y, mesh, MODEL_AXES)

    if mesh is not None:
        aux = e * (top1_all / n_valid * probs.sum(0) / n_valid).sum()
        return y.reshape(b, t, d).to(x.dtype), aux
    top1_frac = oh_e[:, 0, :].sum(0) / n_valid
    if token_valid is not None:
        mean_prob = (probs * tv[:, None]).sum(0) / n_valid
    else:
        mean_prob = probs.mean(0)
    aux = e * (top1_frac * mean_prob).sum()
    return y.reshape(b, t, d).to(x.dtype), aux


def _ffn(h, mlp, cfg: TransformerConfig, token_valid=None):
    """The layer's FFN on the normed input: (y, MoE aux or None)."""
    if cfg.n_experts:
        return moe_ffn(h, mlp, cfg, token_valid)
    return _mlp(h, mlp, cfg), None


def _layer_fn(cfg: TransformerConfig, rope, x, layer):
    """One layer: (x, the MoE aux or None)."""
    h = rms_norm(x, layer["ln_attn"], eps=cfg.norm_eps)
    x = x + _attention(h, layer["attn"], cfg, rope)
    h = rms_norm(x, layer["ln_mlp"], eps=cfg.norm_eps)
    y, aux = _ffn(h, layer["mlp"], cfg)
    return x + y, aux


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
    x = x + tensor_sum(ctx @ wo.to(cfg.dtype), _mesh(cfg))
    return (x, *_mlp_in_region(cfg, x, ln, mlp))


def _wo_moe_region(cfg, x, ctx, wo, ln, mlp):
    x = x + tensor_sum(ctx @ wo.to(cfg.dtype), _mesh(cfg))
    y, aux = moe_ffn(rms_norm(x, ln, eps=cfg.norm_eps), mlp, cfg)
    return x + y, aux


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
    attention outside any region, on the kernel's own residuals. An MoE
    layer keeps the same attention regions and runs wo and the whole
    MoE FFN as one region (JAX names nothing inside ``moe_ffn``).
    Returns (x, the MoE aux or None)."""
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
        if cfg.n_experts:
            return _region(_wo_moe_region, cfg, x, ctx, attn["wo"],
                           layer["ln_mlp"], mlp)
        x, gate, up = _region(_wo_mlp_in_region, cfg, x, ctx, attn["wo"],
                              layer["ln_mlp"], mlp, context_fn=mlp_in)
    return x + _region(_mlp_out, cfg, gate, up, mlp["down"]), None


def _add_aux(total, aux):
    return total if aux is None else total + aux


def _group_fn(cfg: TransformerConfig, rope, x, layers: list):
    total = None
    for layer in layers:
        x, aux = _layer_fn(cfg, rope, x, layer)
        total = aux if total is None else _add_aux(total, aux)
    return x, total


def _embed_lookup(kernel, tokens, cfg: TransformerConfig):
    """Token embedding by gather. Gathering rows then casting equals
    casting then gathering. Over a tensor mesh ``kernel`` is this rank's
    block of the vocabulary: each rank gathers the tokens it holds, zeros
    the rest, and the ranks' rows are summed (one nonzero term a token:
    the sum JAX's one-hot matmul computes there)."""
    return vocab_lookup(kernel, tokens, _mesh(cfg)).to(cfg.dtype)


def _rope_table(cfg: TransformerConfig, tokens, mesh):
    """The rotary tables of this rank's positions: ``0..T-1``, or under
    context parallelism over a mesh those of its chunk of the global
    sequence, from ``rank_in_sequence * T`` (JAX computes the table of
    the global length and GSPMD hands each rank its rows)."""
    t = tokens.shape[1]
    if not (cfg.context_parallel and mesh is not None):
        return rotary_frequencies(cfg.head_dim, t, theta=cfg.rope_theta,
                                  device=tokens.device)
    n, i = axis_size(mesh, AXIS_SEQUENCE), axis_index(mesh, AXIS_SEQUENCE)
    cos, sin = rotary_frequencies(cfg.head_dim, n * t, theta=cfg.rope_theta,
                                  device=tokens.device)
    return cos[i * t:(i + 1) * t], sin[i * t:(i + 1) * t]


def hidden_states(params, tokens, cfg: TransformerConfig, *, mesh=None):
    """tokens [B, T] → (final-norm hidden [B, T, D] in cfg.dtype, the MoE
    router aux summed over layers, f32; 0.0 for dense models). While
    autograd records,
    ``cfg.remat`` runs each layer (or each group of ``scan_group_size``
    layers) as checkpoint regions of ``cfg.remat_policy``; an inference
    forward opens none. With ``pipeline_stages`` over a mesh,
    ``params["layers"]`` is this stage's slice of the stacked leaves and
    the layers run the GPipe schedule (``parallel/pipeline.py``), each
    layer its own remat region under ``cfg.remat``, as JAX checkpoints
    each layer of a stage. Under ``context_parallel`` ``tokens`` is this
    rank's chunk of the sequence."""
    _check_trainable(cfg, mesh)
    if mesh is not None and (cfg.n_experts or cfg.context_parallel
                             or axis_size(mesh, AXIS_TENSOR) > 1):
        cfg = shard_config(cfg, axis_size(mesh, AXIS_TENSOR), mesh)
    rope = _rope_table(cfg, tokens, mesh)
    x = _embed_lookup(params["embed"]["kernel"], tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _pipelined(cfg, mesh):
        def one_layer(layer, h):
            if cfg.remat and torch.is_grad_enabled():
                return _remat_layer(cfg, rope, h, layer)[0]
            return _layer_fn(cfg, rope, h, layer)[0]

        x = pipeline_apply(one_layer, params["layers"], x, mesh,
                           n_micro=cfg.pipeline_microbatches)
        return rms_norm(x, params["final_norm"], eps=cfg.norm_eps), aux
    layers = [_layer(params, i) for i in range(cfg.n_layers)]
    group = cfg.scan_group_size
    if not (cfg.remat and torch.is_grad_enabled()):
        for layer in layers:
            x, layer_aux = _layer_fn(cfg, rope, x, layer)
            aux = _add_aux(aux, layer_aux)
    elif group > 1:
        fn = functools.partial(_group_fn, cfg, rope)
        for i in range(0, cfg.n_layers, group):
            x, group_aux = _region(
                fn, x, layers[i:i + group],
                context_fn=_LAYERS_CONTEXT[cfg.remat_policy])
            aux = _add_aux(aux, group_aux)
    else:
        for layer in layers:
            x, layer_aux = _remat_layer(cfg, rope, x, layer)
            aux = _add_aux(aux, layer_aux)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return x, aux


def _head_kernel(params, cfg: TransformerConfig):
    if cfg.tie_embeddings:
        return params["embed"]["kernel"].T
    return params["lm_head"]["kernel"]


def apply(params, tokens, cfg: TransformerConfig, *, mesh=None,
          return_aux: bool = False):
    """tokens [B, T] int → logits [B, T, V] (cfg.dtype).
    ``return_aux=True`` also returns the summed MoE router aux loss (0.0
    for dense models). Over a tensor mesh the head is this rank's block
    of the vocabulary and the logits are gathered whole."""
    x, aux = hidden_states(params, tokens, cfg, mesh=mesh)
    tmesh = tensor_mesh(mesh)
    if tmesh is None:
        logits = x @ _head_kernel(params, cfg).to(cfg.dtype)
    else:
        logits = gather_from_tensor(
            copy_to_tensor(x, tmesh) @ _head_kernel(params, cfg).to(
                cfg.dtype), tmesh)
    if return_aux:
        return logits, aux
    return logits


def loss_fn(params, batch, cfg: TransformerConfig, *, mesh=None):
    """Next-token LM loss with z-loss 1e-4. batch: {"tokens": [B, T+1]}
    (or separate "inputs"/"targets"); negative targets are ignored.
    ``cfg.loss_chunks`` applies the head and the loss in that many row
    chunks (``chunked_lm_head_loss``). An MoE model adds
    ``router_aux_loss`` × the summed aux, reported as
    ``metrics["router_aux_loss"]``. Returns (loss, metrics). Over ``mesh``
    (the batch is this rank's rows, and under ``context_parallel`` its
    chunk of the sequence; the same on every rank of an expert, tensor or
    pipeline group) the loss is this rank's term of the global loss over
    :func:`token_axes`, the aux's too (:func:`moe_ffn`), and the metrics
    are global."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    if cfg.loss_chunks:
        x, aux = hidden_states(params, inputs, cfg, mesh=mesh)
        x = tensor_copy(x, mesh)
        b, t, d = x.shape
        loss, metrics = chunked_lm_head_loss(
            x.reshape(b * t, d), _head_kernel(params, cfg).to(cfg.dtype),
            targets.reshape(b * t), z_loss=1e-4, n_chunks=cfg.loss_chunks,
            mesh=mesh, axes=token_axes(cfg))
    else:
        logits, aux = apply(params, inputs, cfg, mesh=mesh, return_aux=True)
        loss, metrics = softmax_cross_entropy(logits, targets, z_loss=1e-4,
                                              mesh=mesh,
                                              axes=token_axes(cfg))
    if cfg.n_experts and cfg.router_aux_loss:
        aux_loss = cfg.router_aux_loss * aux
        metrics["router_aux_loss"] = aux_loss if mesh is None else \
            cfg.router_aux_loss * batch_sum(aux, mesh, token_axes(cfg))
        loss = loss + aux_loss
    return loss, metrics
