"""Inference engine: registry model + weights on a device.

Counterpart of ``kubeflow_tpu/serving/engine.py`` for the LM serving path
of this slice: ``pow2_bucket``, the :class:`EngineConfig` fields the port
honours (same names and defaults as the JAX config, plus ``device``) and
the LM boot of :class:`InferenceEngine`. Generation runs in
``serving/continuous.py``; the plain (non-generating) predict, checkpoint
restore and peer weight pulls are not yet ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import ModelSpec, get_model
from kubeflow_tpu_torch.weights import params_from_numpy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Smallest power of two >= ``n`` (floored at 1), clamped to ``cap``.
    The continuous decoder buckets its admission batch size and (with
    ``prefill_len_buckets``) the prefill length through this."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    if cap is not None:
        bucket = min(bucket, cap)
    return bucket


@dataclass
class EngineConfig:
    model: str = "lm-test-tiny"
    # Not yet ported: must stay None / empty (weights come from init).
    checkpoint_dir: str | None = None
    weight_peers: str = ""
    batch_size: int = 8
    max_seq_len: int = 128
    max_new_tokens: int = 16
    top_k: int = 0
    eos_id: int | None = None
    # Only "continuous" is ported ("lockstep" raises).
    decode_mode: str = "continuous"
    decode_chunk: int = 1
    prefill_len_buckets: int = 0
    # Only "paged" is ported; the JAX default "dense" raises at decoder
    # construction.
    kv_layout: str = "dense"
    kv_block_size: int = 16
    kv_pool_blocks: int = 0
    kv_dtype: str = "fp"
    kv_fused: bool = False
    stream_timeout_s: float = 60.0
    # Compute dtype override ("bfloat16"/"float32"); empty keeps the
    # preset's dtype.
    dtype: str = ""
    # Where the model runs. "cuda" raises without a CUDA device.
    device: str = "cuda"


class InferenceEngine:
    """The model spec and its weights on ``cfg.device``.

    Weights come from ``init`` with a generator seeded 0 on the device,
    or — given ``params`` — from a numpy parameter tree with the JAX
    layout (:func:`kubeflow_tpu_torch.weights.params_from_numpy`)."""

    def __init__(self, cfg: EngineConfig, *, params=None):
        if cfg.checkpoint_dir:
            raise ValueError("checkpoint_dir is not yet ported to the "
                             "PyTorch package")
        if cfg.weight_peers:
            raise ValueError("weight_peers is not yet ported to the PyTorch "
                             "package")
        if cfg.decode_mode != "continuous":
            raise ValueError(f"decode_mode {cfg.decode_mode!r} is not yet "
                             "ported (only 'continuous')")
        if cfg.dtype and cfg.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {cfg.dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        overrides = {"dtype": _DTYPES[cfg.dtype]} if cfg.dtype else {}
        self.model: ModelSpec = get_model(cfg.model, **overrides)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            self.params = self.model.init(self.model.config, generator=gen,
                                          device=self.device)
        else:
            self.params = params_from_numpy(params, self.model.config,
                                            self.device)
        # PyTorch runs eagerly: nothing is left to compile once the
        # weights sit on the device.
        self.ready = True

    def validate_instance(self, inst: dict) -> None:
        """Reject malformed instances before they reach the decoder."""
        if not isinstance(inst, dict):
            raise ValueError("each instance must be an object")
        toks = inst.get("tokens")
        if not isinstance(toks, list) or not toks:
            raise ValueError("each instance needs a non-empty 'tokens' list")
        if not all(isinstance(t, int) and not isinstance(t, bool)
                   for t in toks):
            raise ValueError("'tokens' must be a flat list of ints")
        vocab = self.model.config.vocab_size
        if any(t < 0 or t >= vocab for t in toks):
            raise ValueError(f"'tokens' must lie in [0, {vocab})")
        want = inst.get("max_new_tokens", 0)
        if not isinstance(want, int) or want < 0:
            raise ValueError("'max_new_tokens' must be a non-negative int")
        if want > self.cfg.max_new_tokens:
            raise ValueError(
                f"'max_new_tokens' {want} exceeds server limit "
                f"{self.cfg.max_new_tokens}")
        temp = inst.get("temperature", 0.0)
        if not isinstance(temp, (int, float)) or temp < 0:
            raise ValueError("'temperature' must be a non-negative number")

    def metadata(self) -> dict:
        cfg = self.model.config
        return {
            "name": self.cfg.model,
            "family": self.model.family,
            "batch_size": self.cfg.batch_size,
            "device": str(self.device),
            "config": {k: str(v) for k, v in vars(cfg).items()},
        }
