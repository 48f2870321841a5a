"""Inference engine: registry model + weights on a device → predict.

Counterpart of ``kubeflow_tpu/serving/engine.py``: ``pow2_bucket``, the
:class:`EngineConfig` fields the port honours (same names and defaults
as the JAX config, plus ``device``) and :class:`InferenceEngine`. Its
``predict_batch`` pads a batch to the server's fixed shape and runs the
family's plain predict: for the transformer LM the last real position's
logits (``transformer.apply``, whose attention is the flash kernel on the
card) or, for instances that ask for tokens, the lockstep ``generate``;
for BERT the pooled output (tokens padded under a ``pad_mask``, the
flash kernel non-causal over it); for ResNet the class probabilities and
the argmax of ``[image_size, image_size, 3]`` images. The
continuous decoder (``serving/continuous.py``) serves generation in the
default decode mode. The boot weights come, in order, from the first
donor of ``weight_peers`` that answers (the chunked ``:pull`` transport
of ``serving/weights.py``), from the newest checkpoint under
``checkpoint_dir`` (the files ``train/checkpoint.py`` writes, from either
framework's trainer), or from the seeded init.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.decode import generate
from kubeflow_tpu_torch.models.registry import ModelSpec, get_model
from kubeflow_tpu_torch.serving import weights as weights_mod
from kubeflow_tpu_torch.weights import _unflatten, flatten, params_from_numpy

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
    # The newest checkpoint of a training run under this directory gives
    # the boot weights (the train state of the default optimizer, as the
    # JAX engine restores it); None boots from the seeded init.
    checkpoint_dir: str | None = None
    # Comma-separated "host:port" donors serving the same model: boot
    # pulls their weights over :pull, tried in order, falling back to
    # checkpoint_dir (then the init) when every donor fails.
    weight_peers: str = ""
    weight_pull_timeout_s: float = 30.0
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
    # Disaggregated role (paged): "" (colocated), "prefill" or "decode";
    # the :prefill/:import routes carry the handoff.
    serving_role: str = ""
    # Host-RAM KV tier budget in bytes (paged; 0 disables): evicted
    # prefixes demote there and QoS suspensions park there.
    host_kv_bytes: int = 0
    # The fleet KV economy (paged): distinct affinity keys the
    # prefix->holder directory tracks (0 disables it); the shared cold
    # content-addressed store ("mem://<name>[?bytes=n]"; empty disables),
    # where host-tier evictions demote; and the prefill tokens a peer or
    # cold import must save over the best local tier (0 = any deeper
    # match imports).
    kv_directory_size: int = 0
    cold_store_ref: str = ""
    kv_import_crossover_tokens: int = 0
    # QoS tenants, "name=weight[:rate[:burst[:priority]]]"
    # comma-separated (empty disables QoS), and the seconds of queue wait
    # worth one priority point (<= 0 disables aging).
    qos_tenants: str = ""
    qos_aging_s: float = 30.0
    # Tensor-parallel shards per replica (continuous mode): >1 runs the
    # decoder over tp shards, the weights Megatron-split by the model's
    # partition rules and the KV pool over its KV heads (block ids stay
    # host-global, so the prefix trie, the allocator's refcount/CoW and
    # the prefill->decode handoff are unchanged). Must divide the model's
    # n_kv_heads / n_heads / d_ff. The serving_kv_bytes_* gauges then
    # price the pool PER SHARD.
    tp_shards: int = 1
    # Context-parallel shards (continuous mode): >1 runs each prefill
    # chunk's attention ring-style over cp sequence shards (the gathered
    # paged span; decode steps stay as they are). Requires
    # prefill_chunk_tokens > 0 and the paged gather path (not kv_fused);
    # a power of two.
    cp_shards: int = 1
    # Pipeline-parallel decoder stages (continuous mode): >1 splits the
    # stacked layer weights AND the KV pool's layer dim into pp stages,
    # each a tensor group of tp shards (block ids stay host-global).
    # Must divide the model's n_layers; not with kv_fused.
    pp_stages: int = 1
    # The replica's tp * cp * pp devices in serving_mesh order (the
    # pipeline outermost, the tensor shards innermost; repeats allowed:
    # ("cuda:0", "cuda:0") holds two shards on one card). Empty:
    # cuda:0..n-1 on "cuda" (fewer visible GPUs raise), every shard on
    # the host on "cpu".
    tp_devices: tuple = ()
    # Compute dtype override ("bfloat16"/"float32"); empty keeps the
    # preset's dtype.
    dtype: str = ""
    # Where the model runs. "cuda" raises without a CUDA device.
    device: str = "cuda"


def _predict_impl(model: ModelSpec, params, inputs: dict) -> dict:
    """The family's plain predict. Transformer: logits at each row's last
    real position (causality makes them exact whatever padding follows),
    in f32, and their argmax. BERT: the pooled output, f32. ResNet: the
    softmax of the logits and their argmax."""
    cfg = model.config
    # Inference mode: nothing records a backward, so the forward runs
    # whatever the preset's remat (llama-1b's is True).
    with torch.inference_mode():
        if model.family == "transformer":
            logits = model.apply(params, inputs["tokens"], cfg)
            rows = torch.arange(logits.shape[0], device=logits.device)
            last = logits[rows, inputs["last_index"]].float()
            return {"logits": last, "next_token": torch.argmax(last, dim=-1)}
        if model.family == "bert":
            _seq, pooled = model.apply(params, inputs["tokens"], cfg,
                                       pad_mask=inputs["pad_mask"])
            return {"pooled": pooled.float()}
        if model.family == "resnet":
            logits = model.apply(params, inputs["images"], cfg)
            return {"probabilities": torch.softmax(logits, dim=-1),
                    "classes": torch.argmax(logits, dim=-1)}
    raise ValueError(model.family)


class InferenceEngine:
    """The model spec and its weights on ``cfg.device``, and a
    thread-safe predict over the server's fixed batch shape.

    Weights come from ``init`` with a generator seeded 0 on the device,
    or — given ``params`` — from a numpy parameter tree with the JAX
    layout (:func:`kubeflow_tpu_torch.weights.params_from_numpy`)."""

    def __init__(self, cfg: EngineConfig, *, params=None):
        if cfg.decode_mode not in ("continuous", "lockstep"):
            raise ValueError(f"unknown decode_mode {cfg.decode_mode!r}")
        if cfg.dtype and cfg.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {cfg.dtype!r}")
        if cfg.tp_shards < 1:
            raise ValueError(f"tp_shards must be >= 1, got {cfg.tp_shards}")
        if cfg.tp_shards > 1 and cfg.decode_mode != "continuous":
            raise ValueError("tp_shards > 1 requires decode_mode="
                             "'continuous'")
        for name in ("cp_shards", "pp_stages"):
            if getattr(cfg, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(cfg, name)}")
            if getattr(cfg, name) > 1 and cfg.decode_mode != "continuous":
                raise ValueError(f"{name} > 1 requires decode_mode="
                                 "'continuous'")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        overrides = {"dtype": _DTYPES[cfg.dtype]} if cfg.dtype else {}
        self.model: ModelSpec = get_model(cfg.model, **overrides)
        # Where the boot weights came from ("peer", "checkpoint" or
        # "init"), the donor's weights epoch (0 = boot weights), and the
        # birth phases' seconds, for the server's
        # serving_weight_pulls_total and serving_cold_start_seconds.
        self.weight_pull_source = "init"
        self.boot_weights_version = 0
        self.cold_start: dict[str, float] = {}
        t0 = time.perf_counter()
        if params is None:
            self.params = self._load_params()
        else:
            self.params = params_from_numpy(params, self.model,
                                            self.device)
        self.cold_start["weights"] = time.perf_counter() - t0
        self._lock = threading.Lock()
        # Lockstep generation seeds a fresh generator per batch.
        self._seed = 0
        self._warm = False

    def _load_params(self) -> dict:
        """The boot chain: peers, then the checkpoint, then the init."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        params = self.model.init(self.model.config, generator=gen,
                                 device=self.device)
        if self.cfg.weight_peers:
            pulled = self._pull_params_from_peers(params)
            if pulled is not None:
                return pulled
        if self.cfg.checkpoint_dir:
            params = self._restore_checkpoint(params)
            self.weight_pull_source = "checkpoint"
        return params

    @staticmethod
    def _cast_like(leaves: dict, reference) -> dict:
        """Host leaves onto the reference tree's device and leaf dtypes."""
        return _unflatten({
            p: leaves[p].to(ref.device, ref.dtype)
            for p, ref in flatten(reference).items()})

    def _pull_params_from_peers(self, reference):
        """Each donor of ``weight_peers`` in order over the chunked
        ``:pull`` envelope; the first whole tree wins (stamping the
        source and the donor's epoch). None when every donor fails: the
        caller falls back to the checkpoint, so a replica always boots."""
        for donor in [p.strip() for p in self.cfg.weight_peers.split(",")
                      if p.strip()]:
            try:
                leaves, version, _has_draft = weights_mod.pull_weights(
                    donor, self.cfg.model,
                    timeout=self.cfg.weight_pull_timeout_s)
                model_leaves, _ = weights_mod.split_namespaces(leaves)
                tree = weights_mod.unflatten_params(model_leaves, reference)
            except (OSError, ValueError) as e:
                # A dead, dying or misbehaving donor: nothing partial
                # survives the assembler; try the next.
                logging.getLogger(__name__).warning(
                    "weight pull from donor %s failed: %s", donor, e)
                continue
            self.weight_pull_source = "peer"
            self.boot_weights_version = int(version)
            return self._cast_like(flatten(tree), reference)
        return None

    def _restore_checkpoint(self, reference) -> dict:
        """The newest checkpoint's parameters (``train/checkpoint.py:
        restore_latest`` of the default optimizer's train state, as the
        JAX engine restores it), restored on the host and cast onto the
        serving tree. Raises ``FileNotFoundError`` when there is none."""
        from kubeflow_tpu_torch.train import checkpoint as ckpt_lib
        from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
        from kubeflow_tpu_torch.train.trainer import TrainState

        # The template fixes the leaves' shapes and order; restoring onto
        # the host keeps the optimizer's slots out of device memory.
        like = TrainState(step=0, params=_unflatten({
            p: torch.empty(ref.shape, dtype=torch.float32)
            for p, ref in flatten(reference).items()}), opt_state={})
        restored = ckpt_lib.restore_latest(self.cfg.checkpoint_dir, like,
                                           OptimizerConfig())
        if restored is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.cfg.checkpoint_dir}")
        return self._cast_like(flatten(restored[0].params), reference)

    def tp_devices(self) -> list[torch.device] | None:
        """The decoder's replica devices: ``tp_devices`` as named, every
        shard on the host for a CPU engine, else None (``serving_mesh``'s
        default, ``cuda:0`` .. ``cuda:n-1``)."""
        if self.cfg.tp_devices:
            return list(self.cfg.tp_devices)
        if self.device.type == "cpu":
            return [self.device] * (self.cfg.tp_shards * self.cfg.cp_shards
                                    * self.cfg.pp_stages)
        return None

    def warmup(self) -> None:
        """One predict through the serving shape (PyTorch compiles
        nothing; the first call builds the kernels on the card)."""
        self.predict_batch(self._example_instances(1))
        self._warm = True

    @property
    def ready(self) -> bool:
        return self._warm

    def validate_instance(self, inst: dict) -> None:
        """Reject malformed instances before they reach the decoder or a
        batch: token lists (transformer, BERT) or one image of the
        model's shape (ResNet)."""
        if not isinstance(inst, dict):
            raise ValueError("each instance must be an object")
        if self.model.family == "resnet":
            if "images" not in inst:
                raise ValueError("each instance needs 'images'")
            cfg = self.model.config
            try:
                arr = np.asarray(inst["images"], np.float32)
            except (TypeError, ValueError) as e:
                raise ValueError(f"'images' not numeric: {e}") from None
            want = (cfg.image_size, cfg.image_size, 3)
            if arr.shape != want:
                raise ValueError(
                    f"'images' shape {arr.shape} != expected {want}")
            return
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
        cfg = self.model.config
        if self.model.family == "resnet":
            return [{"images": np.zeros(
                (cfg.image_size, cfg.image_size, 3)).tolist()}] * n
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

    def _batch_inputs(self, instances: list[dict]) -> dict:
        """The plain predict's inputs at the server's fixed batch shape.
        Transformer: tokens and each row's last index. BERT: tokens and
        the ``pad_mask`` of the real positions (pad rows all 0). ResNet:
        the images, zeros past the real rows."""
        if self.model.family == "resnet":
            cfg = self.model.config
            images = np.zeros((self.cfg.batch_size, cfg.image_size,
                               cfg.image_size, 3), np.float32)
            for i, inst in enumerate(instances):
                images[i] = np.asarray(inst["images"], np.float32)
            return {"images": torch.from_numpy(images).to(self.device)}
        tokens, lengths = self._pad_tokens(instances)
        if self.model.family == "bert":
            pos = torch.arange(tokens.shape[1], device=self.device)
            mask = pos[None, :] < lengths[:, None]
            mask[len(instances):] = False
            return {"tokens": tokens, "pad_mask": mask.float()}
        return {"tokens": tokens, "last_index": lengths.long() - 1}

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
        inputs = self._batch_inputs(instances)
        with self._lock:
            out = _predict_impl(self.model, self.params, inputs)
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
