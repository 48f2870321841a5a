"""ResNet image classifier; counterpart of ``kubeflow_tpu/models/resnet.py``
(the tf_cnn_benchmarks analogue).

The same network and parameter tree as the JAX package's: a 7×7/2 stem,
a 3×3/2 max-pool, bottleneck blocks (1×1, 3×3 with the stride, 1×1, a
projection on each stage's first block), global average pooling and a
float32 head; ``stages`` is a list of lists of blocks, as in JAX.

No part of it is a TPU kernel in the JAX package (``lax.conv_general_
dilated``, ``reduce_window`` and the batch norm's reductions), so it is
plain PyTorch on every device, with ``F.conv2d`` for the convolutions.

Layouts: images come in as NHWC, as JAX's API has them, and run as NCHW
tensors in the ``channels_last`` memory format (the same bytes). Conv
kernels stay HWIO in the parameter tree, as JAX stores them, so weights,
checkpoints and optimizer states (whose factored adafactor moments follow
the axis order) are JAX's byte for byte; each use casts one to OIHW.

Where XLA differs from PyTorch's defaults the port follows XLA:

- "SAME" padding pads ``total // 2`` before and the rest after, so the
  stride-2 stem at 224 pads 2 and 3 and a stride-2 3×3 at 56 pads 0 and
  1; the max-pool pads with -inf. :func:`_same_pads` computes them and
  uneven ones go through ``F.pad``.
- Batch norm in training normalises with the batch's mean and biased
  variance, in float32, and records running statistics merged as
  ``0.9·old + 0.1·batch`` (also biased), which the trainer folds back
  into the parameters (:func:`update_state`); the affine runs in the
  activations' dtype: ``x·inv + (bias − mean·inv)``.

Over a mesh of the data and fsdp axes (``mesh=``; every weight is
replicated, as JAX's empty partition rules have it) each rank runs its
rows of the batch, and training's batch norm is synchronised: the mean
over the global batch, then the biased variance as the global mean of
squared deviations from it (two psums, both differentiable), which is
what GSPMD computes for JAX's ``jnp.mean``/``jnp.var`` over a sharded
batch. JAX's rules and batch spec name no other axis: the ranks of expert,
tensor, sequence and pipeline hold the same rows and every weight whole
(replicas), and batch norm syncs over the batch axes only.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.parallel.collectives import psum
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    BATCH_AXES,
    axis_size,
)
from kubeflow_tpu_torch.parallel.sharding import P, PartitionRule


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    image_size: int = 224
    dtype: torch.dtype = torch.bfloat16

    def leaf_dtype(self, path: str,
                   dtype: torch.dtype | None = None) -> torch.dtype:
        """The dtype the port stores leaf ``path`` in: the one JAX reads
        it in. The conv kernels (:data:`CONV_LEAVES`) take ``dtype``
        (default ``self.dtype``); the batch norms and the head stay
        float32."""
        compute = dtype or self.dtype
        return (compute if path.rsplit("/", 1)[-1] in CONV_LEAVES
                else torch.float32)


# The shapes of kubeflow_tpu/models/resnet.py:PRESETS.
PRESETS: dict[str, ResNetConfig] = {
    "resnet50": ResNetConfig(),
    "resnet18": ResNetConfig(stage_sizes=(2, 2, 2, 2)),
    "resnet-test-tiny": ResNetConfig(
        stage_sizes=(1, 1), num_classes=10, width=8, image_size=32
    ),
}

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# Conv kernel leaves (HWIO): the only leaves JAX casts to cfg.dtype at
# use. The batch norms and the head are read in float32.
CONV_LEAVES = ("conv", "conv1", "conv2", "conv3", "proj")


def config(name: str, **overrides) -> ResNetConfig:
    """A preset with overrides; ``dtype`` may be a torch dtype or its
    name."""
    if isinstance(overrides.get("dtype"), str):
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    return replace(PRESETS[name], **overrides)


def init(cfg: ResNetConfig, *, generator: torch.Generator,
         device: str | torch.device = "cuda",
         param_dtype: torch.dtype | None = None) -> dict:
    """Parameter tree with the JAX layout and distributions: HWIO conv
    kernels normal × sqrt(2 / fan_in), stored in ``param_dtype``
    (``cfg.dtype`` by default, float32 for training's master weights);
    batch norms (scale 1, bias 0, running mean 0, var 1) and the head
    (normal × 0.01, bias 0) in float32. Values differ from JAX's for the
    same seed."""
    dev = resolve_device(device)
    dtype = cfg.dtype if param_dtype is None else param_dtype

    def conv(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        w = torch.randn(shape, generator=generator, device=dev)
        return (w * (2.0 / fan_in) ** 0.5).to(dtype)

    def bn(c):
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev),
                "mean": torch.zeros(c, device=dev),
                "var": torch.ones(c, device=dev)}

    w = cfg.width
    head_in = w * (2 ** (len(cfg.stage_sizes) - 1)) * 4
    params = {"stem": {"conv": conv((7, 7, 3, w)), "bn": bn(w)}}
    params["head"] = {
        "kernel": torch.randn((head_in, cfg.num_classes),
                              generator=generator, device=dev) * 0.01,
        "bias": torch.zeros(cfg.num_classes, device=dev),
    }
    params["stages"] = []
    in_c = w
    for stage_idx, n_blocks in enumerate(cfg.stage_sizes):
        stage = []
        mid_c = w * (2 ** stage_idx)
        out_c = mid_c * 4
        for block_idx in range(n_blocks):
            block = {
                "conv1": conv((1, 1, in_c, mid_c)), "bn1": bn(mid_c),
                "conv2": conv((3, 3, mid_c, mid_c)), "bn2": bn(mid_c),
                "conv3": conv((1, 1, mid_c, out_c)), "bn3": bn(out_c),
            }
            if block_idx == 0:
                block["proj"] = conv((1, 1, in_c, out_c))
                block["bn_proj"] = bn(out_c)
            stage.append(block)
            in_c = out_c
        params["stages"].append(stage)
    return params


def partition_rules(cfg: ResNetConfig) -> list[PartitionRule]:
    """None: convolutions are small, so every weight is replicated and
    only the batch is sharded (pure data parallelism), as in JAX."""
    return []


def batch_partition_spec(cfg: ResNetConfig) -> tuple:
    return P((AXIS_DATA, AXIS_FSDP), None, None, None)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w_hwio, stride: int = 1):
    """"SAME" convolution of an NCHW (channels_last) tensor by an HWIO
    kernel, cast to x's dtype at use."""
    kh, kw = w_hwio.shape[:2]
    w = w_hwio.permute(3, 2, 0, 1).to(x.dtype,
                                      memory_format=torch.channels_last)
    (top, bottom) = _same_pads(x.shape[2], kh, stride)
    (left, right) = _same_pads(x.shape[3], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _max_pool(x):
    """3×3/2 max-pool with XLA's "SAME" padding by -inf."""
    top, bottom = _same_pads(x.shape[2], 3, 2)
    left, right = _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel_size=3, stride=2)


def _sync_var_mean(x32, mesh):
    """(biased variance, mean) per channel over the global batch: the
    mean first, then the mean of squared deviations from it (two passes,
    as ``jnp.var`` computes; ``E[x²] - E[x]²`` would round differently)."""
    n = x32.numel() // x32.shape[1] * axis_size(mesh, BATCH_AXES)
    mean = psum(x32.sum(dim=(0, 2, 3)), mesh, BATCH_AXES) / n
    dev = x32 - mean[None, :, None, None]
    var = psum(torch.square(dev).sum(dim=(0, 2, 3)), mesh, BATCH_AXES) / n
    return var, mean


def _bn(x, p, *, stats=None, path="", mesh=None):
    """Batch norm of an NCHW tensor. Training (``stats`` a dict): the
    batch's mean and biased variance in float32 (over ``mesh``, the
    global batch's: sync-BN), with the merged running statistics recorded
    under ``path`` (no gradient). Eval: the stored statistics."""
    if stats is not None:
        if mesh is None:
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
        else:
            var, mean = _sync_var_mean(x.float(), mesh)
        with torch.no_grad():
            stats[path] = {
                "mean": BN_MOMENTUM * p["mean"] + (1 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * p["var"] + (1 - BN_MOMENTUM) * var,
            }
    else:
        mean, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + BN_EPS) * p["scale"]
    shift = p["bias"] - mean * inv
    return (x * inv.to(x.dtype)[None, :, None, None]
            + shift.to(x.dtype)[None, :, None, None])


def _block(x, p, stride: int, stats, path: str, mesh):
    h = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"], stats=stats,
                   path=f"{path}/bn1", mesh=mesh))
    h = F.relu(_bn(_conv(h, p["conv2"], stride), p["bn2"], stats=stats,
                   path=f"{path}/bn2", mesh=mesh))
    h = _bn(_conv(h, p["conv3"]), p["bn3"], stats=stats, path=f"{path}/bn3",
            mesh=mesh)
    if "proj" in p:
        x = _bn(_conv(x, p["proj"], stride), p["bn_proj"], stats=stats,
                path=f"{path}/bn_proj", mesh=mesh)
    return F.relu(x + h)


def apply(params, images, cfg: ResNetConfig, *, mesh=None, train=False):
    """images [B, H, W, 3] float (NHWC) → logits [B, num_classes] f32.

    ``train=True`` normalises with batch statistics and returns
    ``(logits, stats)``, stats mapping each batch norm's path
    (``"stages/0/1/bn2"``) to its new running statistics, for
    :func:`update_state`."""
    stats: dict | None = {} if train else None
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
    x = F.relu(_bn(_conv(x, params["stem"]["conv"], 2), params["stem"]["bn"],
                   stats=stats, path="stem/bn", mesh=mesh))
    x = _max_pool(x)
    for stage_idx, stage in enumerate(params["stages"]):
        for block_idx, block in enumerate(stage):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            x = _block(x, block, stride, stats,
                       f"stages/{stage_idx}/{block_idx}", mesh)
    # JAX's mean of a bf16 tensor accumulates in f32 and rounds to bf16.
    x = x.float().mean(dim=(2, 3)).to(cfg.dtype).float()
    logits = x @ params["head"]["kernel"] + params["head"]["bias"]
    return (logits, stats) if train else logits


@torch.no_grad()
def update_state(params, stats):
    """Fold the running statistics a ``train=True`` forward recorded into
    ``params`` IN PLACE (JAX returns a new tree) and return it: the
    non-gradient state channel the trainer applies after the optimizer
    step, over whatever the optimizer did to these leaves."""
    for path, value in stats.items():
        bn = params
        for part in path.split("/"):
            bn = bn[int(part)] if part.isdigit() else bn[part]
        bn["mean"].copy_(value["mean"])
        bn["var"].copy_(value["var"])
    return params


def loss_fn(params, batch, cfg: ResNetConfig, *, mesh=None):
    """batch: {"images": [B, H, W, 3], "labels": [B]}. The metrics carry
    the new running statistics under ``"_state_updates"``."""
    logits, stats = apply(params, batch["images"], cfg, mesh=mesh,
                          train=True)
    loss, metrics = softmax_cross_entropy(logits, batch["labels"],
                                          mesh=mesh)
    metrics = dict(metrics)
    metrics["_state_updates"] = stats
    return loss, metrics
