"""Inference engine: registry model + weights on a device → predict.

Counterpart of ``kubeflow_tpu/serving/engine.py`` for language models:
``pow2_bucket``, the :class:`EngineConfig` fields the port honours (same
names and defaults as the JAX config, plus ``device``) and
:class:`InferenceEngine`. Its ``predict_batch`` pads a batch to the
server's fixed shape and runs either the plain forward
(``transformer.apply``, whose attention is the flash kernel on the card)
or, for instances that ask for tokens, the lockstep ``generate``. The
continuous decoder (``serving/continuous.py``) serves generation in the
default decode mode. BERT and ResNet predicts, checkpoint restore and
peer weight pulls are not yet ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.decode import generate
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
    # "continuous": the continuous decoder, per-request lengths decoupled
    # and streamable. "lockstep": generation rides the dynamic batcher,
    # one prefill + decode loop per batch.
    decode_mode: str = "continuous"
    decode_chunk: int = 1
    # Prefix cache (continuous mode): trie entries for shared prompt
    # prefixes (0 disables; a pool row each on the dense layout,
    # refcount-shared blocks on the paged one), and the shortest prefix
    # worth caching.
    prefix_cache_slots: int = 0
    prefix_cache_min_len: int = 16
    prefill_len_buckets: int = 0
    # Speculative decoding (continuous mode): draft tokens verified per
    # round (0 disables), and where they come from: "ngram" (host-side
    # prompt/output lookup) or "model:<registry-name>" (a draft model
    # sharing the slot layout). Greedy outputs are unchanged.
    speculative_k: int = 0
    draft_mode: str = "ngram"
    # "dense" (one full-length row per slot) or "paged" (a block pool).
    kv_layout: str = "dense"
    kv_block_size: int = 16
    kv_pool_blocks: int = 0
    kv_dtype: str = "fp"
    kv_fused: bool = False
    stream_timeout_s: float = 60.0
    # Chunked prefill (paged): suffixes longer than this many tokens are
    # admitted as a chain of chunks (0 disables); max_prompt_len lifts the
    # prompt ceiling past max_seq_len (0 = max_seq_len).
    prefill_chunk_tokens: int = 0
    max_prompt_len: int = 0
    # Compute dtype override ("bfloat16"/"float32"); empty keeps the
    # preset's dtype.
    dtype: str = ""
    # Where the model runs. "cuda" raises without a CUDA device.
    device: str = "cuda"


def _predict_impl(model: ModelSpec, params, inputs: dict) -> dict:
    """The plain predict: logits at each row's last real position
    (causality makes them exact whatever padding follows), in f32, and
    their argmax."""
    if model.family != "transformer":
        raise ValueError(f"the {model.family} predict is not yet ported to "
                         "the PyTorch package")
    # Inference mode: nothing records a backward, so the forward runs
    # whatever the preset's remat (llama-1b's is True).
    with torch.inference_mode():
        logits = model.apply(params, inputs["tokens"], model.config)
        rows = torch.arange(logits.shape[0], device=logits.device)
        last = logits[rows, inputs["last_index"]].float()
        return {"logits": last, "next_token": torch.argmax(last, dim=-1)}


class InferenceEngine:
    """The model spec and its weights on ``cfg.device``, and a
    thread-safe predict over the server's fixed batch shape.

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
        if cfg.decode_mode not in ("continuous", "lockstep"):
            raise ValueError(f"unknown decode_mode {cfg.decode_mode!r}")
        if cfg.dtype and cfg.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {cfg.dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        overrides = {"dtype": _DTYPES[cfg.dtype]} if cfg.dtype else {}
        self.model: ModelSpec = get_model(cfg.model, **overrides)
        # Where the boot weights came from and the birth phases' seconds,
        # for the server's serving_weight_pulls_total and
        # serving_cold_start_seconds. Checkpoints and peer pulls are not
        # ported, so the source is always "init".
        self.weight_pull_source = "init"
        self.cold_start: dict[str, float] = {}
        t0 = time.perf_counter()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            self.params = self.model.init(self.model.config, generator=gen,
                                          device=self.device)
        else:
            self.params = params_from_numpy(params, self.model.config,
                                            self.device)
        self.cold_start["weights"] = time.perf_counter() - t0
        self._lock = threading.Lock()
        # Lockstep generation seeds a fresh generator per batch.
        self._seed = 0
        self._warm = False

    def warmup(self) -> None:
        """One predict through the serving shape (PyTorch compiles
        nothing; the first call builds the kernels on the card)."""
        self.predict_batch(self._example_instances(1))
        self._warm = True

    @property
    def ready(self) -> bool:
        return self._warm

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

    def _example_instances(self, n: int) -> list[dict]:
        return [{"tokens": [0] * 8}] * n

    def _pad_tokens(self, instances: list[dict]):
        """Instances' tokens right-padded to the server's fixed ``[batch,
        max_seq_len]`` shape (longer prompts cut at ``max_seq_len``), on
        the device, and each row's length (1 for pad rows)."""
        b, t = self.cfg.batch_size, self.cfg.max_seq_len
        tokens = np.zeros((b, t), np.int32)
        lengths = np.ones((b,), np.int32)
        for i, inst in enumerate(instances):
            seq = np.asarray(inst["tokens"], np.int32)[:t]
            tokens[i, : len(seq)] = seq
            lengths[i] = len(seq)
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def _generate_batch(self, instances: list[dict]) -> list[dict]:
        """Lockstep generation: prefill + a decode loop over the KV cache
        for the whole padded batch; per-row temperature, each row's
        requested length sliced out."""
        n = len(instances)
        b = self.cfg.batch_size
        tokens, lengths = self._pad_tokens(instances)
        temperature = np.zeros((b,), np.float32)
        for i, inst in enumerate(instances):
            temperature[i] = float(inst.get("temperature", 0.0))
        row_valid = np.zeros((b,), bool)
        row_valid[:n] = True
        dev = self.device
        with self._lock:
            self._seed += 1
            gen = torch.Generator(device=dev)
            gen.manual_seed(self._seed)
            toks, last = generate(
                self.params, tokens, lengths, self.model.config,
                max_new_tokens=self.cfg.max_new_tokens, generator=gen,
                temperature=torch.from_numpy(temperature).to(dev),
                top_k=self.cfg.top_k,
                row_valid=torch.from_numpy(row_valid).to(dev))
            toks, last = toks[:n].cpu().numpy(), last[:n].cpu().numpy()
        out = []
        for i, inst in enumerate(instances):
            want = min(int(inst.get("max_new_tokens", 0)),
                       self.cfg.max_new_tokens)
            pred = {
                "next_token": int(toks[i, 0]) if want else
                int(np.argmax(last[i])),
                "tokens": toks[i, :want].tolist(),
            }
            # Full-vocab logits are large as JSON: only for plain
            # predicts or on request.
            if not want or inst.get("return_logits"):
                pred["logits"] = last[i].tolist()
            out.append(pred)
        return out

    def predict_batch(self, instances: list[dict]) -> list[dict]:
        """Pad instances to the server batch, run, slice real results."""
        if len(instances) > self.cfg.batch_size:
            raise ValueError(
                f"batch {len(instances)} exceeds limit {self.cfg.batch_size}")
        if (self.model.family == "transformer"
                and any(inst.get("max_new_tokens") for inst in instances)):
            return self._generate_batch(instances)
        n = len(instances)
        tokens, lengths = self._pad_tokens(instances)
        with self._lock:
            out = _predict_impl(self.model, self.params, {
                "tokens": tokens, "last_index": lengths.long() - 1})
            out = {k: v[:n].cpu().numpy() for k, v in out.items()}
        return [{k: v[i].tolist() for k, v in out.items()} for i in range(n)]

    def metadata(self) -> dict:
        cfg = self.model.config
        return {
            "name": self.cfg.model,
            "family": self.model.family,
            "batch_size": self.cfg.batch_size,
            "device": str(self.device),
            "config": {k: str(v) for k, v in vars(cfg).items()},
        }
