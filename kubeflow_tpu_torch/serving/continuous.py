"""Continuous-batching decode service with per-token streaming.

Counterpart of ``kubeflow_tpu/serving/continuous.py``: a persistent decode
state holds up to ``slots`` in-flight sequences, a round's admissions are
prefilled together in one power-of-two-bucketed batch fused with one
decode step, and every later round runs one decode step (``decode_step``)
or ``chunk_size`` of them (``decode_chunk``) for all slots. Tokens surface
through per-request queues as each step's sample lands.

Two KV layouts, as in JAX. ``"dense"`` (the default) reserves one
full-length cache row per slot (``admit_rows_and_step``). ``"paged"``
backs each request with blocks of a shared pool
(``paged_admit_rows_and_step``); admission is memory-aware there: a
request enters only when its worst-case block count fits the pool, and a
finished row frees its blocks at once.

The prefix cache (``prefix_cache_slots``): a host trie
(``serving/prefix_cache.py``) maps a new prompt to the deepest cached
prefix, which the admission reuses, prefilling only its suffix. On the
dense layout the trie fronts a device pool of prefix rows
(``admit_prefix_and_step``, ``store_prefix_row``). On the paged layout a
hit SHARES the donor's full blocks by refcount and copies at most one
partly filled tail block (``copy_block``), then prefills the suffix
through the block table (``paged_admit_prefix_and_step``); publishing a
finished prompt is bookkeeping only, and cache-held blocks are reclaimed
(LRU) under admission pressure. ``prime_prefix`` pools a prefix up front
on either layout.

Chunked prefill (``prefill_chunk_tokens``, paged only): a prompt whose
suffix is longer than one chunk is admitted as a chain of bounded chunk
calls (``paged_prefill_chunk``), one per scheduler round between decode
rounds, the last through ``paged_admit_prefix_and_step``. So one long
admission stalls live streams by at most a chunk, and ``max_prompt_len``
may exceed ``prefill_len``.

Speculative decoding (``speculative_k``, off by default): a proposer
(``serving/speculative.py``: host n-gram lookup or a small draft model)
drafts up to K tokens a row, and a verify round scores them all in one
``verify_step`` (``verify_chunk`` with ``chunk_size`` > 1), keeping each
row's longest accepted prefix plus one committed token. Greedy streams
equal speculation off; sampled rows rejection-resample, so their
distribution is unchanged. Per-slot draft length tunes itself (it shrinks
while a row's drafts keep missing, recovers on clean sweeps), and the
draft and accept counters land in :meth:`ContinuousDecoder.metrics`.

The single-replica serving features, on the paged layout:

- a host-RAM KV tier (``host_kv_bytes``, ``serving/kv_tier.py``): trie
  evictions DEMOTE their blocks to host memory (``export_blocks``)
  instead of freeing them, and a later trie miss promotes them back
  (``import_blocks``) and rides the ordinary prefix-hit admission;
- QoS (``qos``, ``serving/qos.py``): per-tenant token buckets at submit,
  weighted-fair + aged-priority ordering of the queue, deadline
  shedding, and, under memory pressure, SUSPENSION of the
  lowest-priority live stream (its KV parked, pinned, in the host tier;
  it resumes through a prefix hit on that payload);
- the prefill/decode handoff (``role``, :meth:`export_prompt`,
  :meth:`import_prompt`; ``serving/handoff.py`` is the envelope);
- live weight pushes (:meth:`update_weights`): the new tree is placed on
  the device with no lock held and swapped in by reference between
  dispatches; K/V cached under older weights is flushed or refused.

Instruments: a metric ``registry`` (TTFT, inter-token gap, queue wait,
dispatch time by kind, batch occupancy, chunk counters, weights epoch
and pushes) and a ``trace`` store of per-request timelines, served by
the model server's ``/monitoring/prometheus/metrics`` and
``/debug/requests``.

Tensor parallelism (``tp_shards`` > 1): one replica spreads the model
over ``tp_shards`` shards driven by this process, on the devices
``tp_devices`` names (default ``cuda:0`` .. ``cuda:tp-1``; repeats
allowed, so two shards may share one card). The parameters are cut by
the model's partition rules (``parallel/sharding.py:split_tensor``), the
KV store over its KV heads (``models/decode.py:shard_decode_state``);
block ids, tables, the allocator, the trie, refcount/CoW, the handoff
and the host tier never see the split, the byte gauges price the pool
per shard, and a handoff or a host-tier payload holds every head, so it
crosses mesh shapes. Every option composes with it, as in JAX. A mixture
of experts keeps every expert on each shard and its ``d_ff`` columns
(JAX's ``serving_mesh`` has no ``expert`` axis); every shard routes the
same tokens to the same slots, from the same ``token_valid``.

Context parallelism (``cp_shards`` > 1, paged, gathered, chunked
prefill): every chunk dispatch and the final admission of a chain fold
their span read through the ring over the replica's ``cp`` sequence
shards (``ops/attention.py:ring_span_attention``); decode steps read as
they do without. Pipeline stages (``pp_stages`` > 1, not fused): stage
``s`` holds its layer range (``parallel/pipeline.py:stage_layer_ranges``)
of the weights and of the KV store on its devices, each stage a tensor
group of ``tp_shards``; the residual moves from stage to stage, and
tables, lengths, logits and the generator stay once. The replica's
``tp * cp * pp`` devices come in JAX's ``serving_mesh`` order
(``tp_devices``; the pipeline outermost, the tensor shards innermost): a
stage's shards hold their weights and KV on the devices of its ring
shard 0, and ring shard ``c`` of each computes on its own. The byte
gauges price the pool per tensor shard, as JAX's do.

The fleet KV economy (paged): a prefix->holder directory shared by a
fleet's replicas (``kv_directory``, ``serving/kv_directory.py``), a
content-addressed cold store (``cold_store``, ``serving/cold_store.py``)
and a transport to pull a peer's prefix (``peer_fetch``; the fleet or the
server installs one). A publish or a demotion advertises the prefix; a
host-tier eviction packs its payload into the cold store. A submit whose
prompt misses the trie and the host tier probes the directory ON THE
CALLER'S THREAD, pulls the holder's :meth:`ContinuousDecoder.
export_prefix` as a handoff envelope (or matches the cold store) and
installs it, so the admission prefills only the tail. An envelope of a
weights epoch the decoder no longer serves is refused. The compile
cache's counters read what JAX's read with the cache off: eager PyTorch
compiles nothing to cache.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeflow_tpu_torch.models.decode import (
    admit_prefix_and_step,
    admit_rows_and_step,
    copy_block,
    decode_chunk,
    decode_step,
    export_blocks,
    import_blocks,
    init_decode_state,
    init_paged_state,
    init_prefix_pool,
    paged_admit_prefix_and_step,
    paged_admit_rows_and_step,
    paged_prefill_chunk,
    prefill,
    retire_row,
    shard_decode_state,
    store_blocks,
    store_prefix_cache,
    store_prefix_row,
    verify_chunk,
)
from kubeflow_tpu_torch.models.transformer import partition_rules
from kubeflow_tpu_torch.observability.metrics import MetricRegistry
from kubeflow_tpu_torch.observability.tracing import TraceStore
from kubeflow_tpu_torch.parallel.mesh import (
    PipelineStages,
    TensorShards,
    serving_mesh,
)
from kubeflow_tpu_torch.parallel.pipeline import stage_layer_ranges
from kubeflow_tpu_torch.parallel.sharding import merge_replica
from kubeflow_tpu_torch.serving.affinity import (
    DEFAULT_AFFINITY_TOKENS,
    prefix_affinity_key,
)
from kubeflow_tpu_torch.serving.engine import pow2_bucket
from kubeflow_tpu_torch.serving.handoff import tree_to_torch, unpack
from kubeflow_tpu_torch.serving.kv_allocator import (
    BlockAllocator,
    kv_bytes_per_token,
)
from kubeflow_tpu_torch.serving.kv_directory import COLD_HOLDER
from kubeflow_tpu_torch.serving.kv_tier import HostKvTier, payload_nbytes
from kubeflow_tpu_torch.serving.prefix_cache import PrefixCache
from kubeflow_tpu_torch.serving.qos import (
    DEFAULT_TENANT,
    DeadlineExceeded,
    QosPolicy,
    order_key,
    tenant_bucket,
)
from kubeflow_tpu_torch.serving.speculative import make_proposer
from kubeflow_tpu_torch.weights import _unflatten, flatten, replica_shards

_DONE = object()

# The compile cache's counters, as JAX's metrics() reports them with the
# cache off (eager PyTorch compiles no executable to cache).
_UNPORTED_METRICS = {
    "compile_cache_hits": 0, "compile_cache_misses": 0,
    "warm_seconds": 0.0,
}


class PromptTooLong(ValueError):
    """Terminal admission error: the request cannot be served by this
    replica at all (a prompt past ``max_prompt_len``, more KV blocks than
    the pool holds, or tokens plus budget beyond the virtual row), so
    deferring would wait forever. The model server maps this to HTTP
    413."""


@dataclass
class _Request:
    tokens: list[int]
    want: int
    temperature: float
    stream: queue.Queue = field(default_factory=queue.Queue)
    out: list[int] = field(default_factory=list)
    prefill_logits: np.ndarray | None = None
    # Lazy source for prefill_logits: (device tensor [K, V], row); only
    # callers that read the vocab-wide logits pay for the copy.
    prefill_src: tuple | None = None
    error: Exception | None = None
    done: threading.Event = field(default_factory=threading.Event)
    submit_t: float = field(default_factory=time.perf_counter)
    ttft_s: float | None = None
    finish_reason: str = "length"
    # Rounds this request sat at the head of admission blocked on memory
    # (the head-of-line bypass aging counter).
    defer_rounds: int = 0
    # The prefix-cache entry this request's admission read, pinned until
    # the request finishes.
    pinned_prefix: object = None
    # Paged layout: (entry, prefix_len, suffix_bucket) planned at pop
    # time, before the block reservation, so the entry is pinned before
    # reclaim runs and the reservation covers only the unshared blocks.
    admit_plan: tuple | None = None
    # The lifecycle timeline in the decoder's TraceStore, keyed by the
    # propagated X-Request-ID (or a minted one); last_emit_t feeds the
    # inter-token histogram.
    timeline: object = None
    last_emit_t: float | None = None
    # Chunked prefill: prompt tokens already written into the request's
    # blocks (-1 = not a chunked admission, or its chain finished). While
    # >= 0 the slot's row is PARKED (length = total, active False).
    chunk_pos: int = -1
    # True once the first chunk stamped the weights epoch, copied the
    # plan's shared tail block and mapped the table row.
    chunk_started: bool = False
    # QoS: owning tenant, base priority (the tenant's default unless the
    # request carried its own), and an absolute shed deadline (None =
    # never shed). ``host_key`` is set while the stream is SUSPENDED:
    # the pinned host-tier entry its resume re-imports. ``folded``:
    # emitted tokens an earlier suspension already folded into
    # ``tokens`` (a later one appends only out[folded:]).
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    deadline_t: float | None = None
    host_key: tuple | None = None
    folded: int = 0
    # Weights epoch this request's prefill ran under (stamped under the
    # state lock with the dispatch that reads the params). A finishing
    # stream publishes its prompt K/V only while this is still the live
    # epoch.
    weights_version: int = 0

    @property
    def want_left(self) -> int:
        return max(self.want - len(self.out), 0)

    def resolve_prefill_logits(self) -> np.ndarray | None:
        if self.prefill_logits is None and self.prefill_src is not None:
            arr, row = self.prefill_src
            self.prefill_logits = arr[row].cpu().numpy()
            self.prefill_src = None
        return self.prefill_logits


class StreamHandle:
    """Caller-side view of an in-flight generation."""

    def __init__(self, req: _Request, default_timeout: float = 60.0):
        self._req = req
        self._default_timeout = default_timeout

    def tokens(self, timeout: float | None = None):
        """Yield tokens as the decode loop emits them."""
        if timeout is None:
            timeout = self._default_timeout
        while True:
            try:
                item = self._req.stream.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("token stream timed out") from None
            if item is _DONE:
                if self._req.error is not None:
                    raise self._req.error
                return
            yield item

    def result(self, timeout: float | None = None, *,
               with_logits: bool | None = None) -> dict:
        """Block until the request finishes; returns the full prediction.
        ``with_logits`` fetches the vocab-wide prefill logits (default:
        only when the request emitted no tokens)."""
        if timeout is None:
            timeout = self._default_timeout
        if not self._req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if self._req.error is not None:
            raise self._req.error
        need = with_logits or (with_logits is None and not self._req.out)
        return {
            "tokens": list(self._req.out),
            "prefill_logits": (self._req.resolve_prefill_logits()
                               if need else self._req.prefill_logits),
            "ttft_s": self._req.ttft_s,
            "finish_reason": self._req.finish_reason,
        }

    @property
    def ttft_s(self) -> float | None:
        return self._req.ttft_s


class ContinuousDecoder:
    """Owns the device decode state and the scheduler thread.

    ``prefill_len`` fixes the prompt shape (prompts are right-padded to
    it); ``slots`` is the decode concurrency; a row is ``max_prompt_len +
    max_new_tokens`` positions (``max_prompt_len`` defaults to
    ``prefill_len`` and exceeds it only with chunked prefill). The device
    is the parameters' device; with ``tp_shards``, ``cp_shards`` or
    ``pp_stages`` above 1 the replica takes ``tp_devices`` (see the
    module docstring) and the tables, lengths and logits its first."""

    def __init__(self, params, cfg, *, slots: int, prefill_len: int,
                 max_new_tokens: int, top_k: int = 0,
                 eos_id: int | None = None, seed: int = 0,
                 chunk_size: int = 1, prefix_cache_slots: int = 0,
                 prefix_cache_min_len: int = 16,
                 prefill_len_buckets: int = 0, speculative_k: int = 0,
                 draft_mode: str = "ngram", kv_layout: str = "dense",
                 kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, kv_low_watermark: int = 0,
                 kv_dtype: str = "fp", kv_fused: bool = False,
                 stream_timeout_s: float = 60.0, role: str = "",
                 tp_shards: int = 1, tp_devices=None,
                 qos: QosPolicy | None = None,
                 host_kv_bytes: int = 0,
                 hol_bypass_limit: int = 4, hol_shield_rounds: int = 8,
                 prefill_chunk_tokens: int = 0, max_prompt_len: int = 0,
                 cp_shards: int = 1, pp_stages: int = 1,
                 kv_directory=None, cold_store=None, peer_fetch=None,
                 kv_import_crossover_tokens: int = 0,
                 kv_affinity_tokens: int = 0, replica_name: str = "",
                 boot_weights_version: int = 0):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        # Disaggregated role: "" (colocated), "prefill" (peers take its
        # finished prompt KV through export_prompt) or "decode" (resumes
        # imported prompts). The handoff rides the block pool.
        if role not in ("", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if role and kv_layout != "paged":
            raise ValueError("a fleet role requires kv_layout='paged'")
        if host_kv_bytes and kv_layout != "paged":
            raise ValueError("host_kv_bytes requires kv_layout='paged'")
        self.role = role
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        if kv_dtype == "int8" and kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged'")
        if kv_fused and kv_layout != "paged":
            raise ValueError("kv_fused requires kv_layout='paged'")
        # Chunked prefill: a suffix longer than one chunk is admitted as
        # a chain of chunk calls interleaved with decode rounds; the
        # chunk width bounds the gap one long admission puts into a live
        # stream, and max_prompt_len lifts the prompt ceiling past the
        # prefill width.
        self.prefill_chunk_tokens = max(0, int(prefill_chunk_tokens))
        if self.prefill_chunk_tokens:
            if kv_layout != "paged":
                raise ValueError(
                    "prefill_chunk_tokens requires kv_layout='paged' "
                    "(chunks scatter into the block pool)")
            if self.prefill_chunk_tokens > prefill_len:
                raise ValueError(
                    f"prefill_chunk_tokens {self.prefill_chunk_tokens} "
                    f"must be <= prefill_len {prefill_len} (chunks ride "
                    "the suffix buckets)")
        self.max_prompt_len = int(max_prompt_len) or prefill_len
        if self.max_prompt_len < prefill_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} must be >= "
                f"prefill_len {prefill_len}")
        if self.max_prompt_len > prefill_len and not self.prefill_chunk_tokens:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} > prefill_len "
                f"{prefill_len} requires prefill_chunk_tokens > 0 "
                "(a monolithic prefill is bounded by the prefill width)")
        self.tp_shards = max(1, int(tp_shards))
        self.cp_shards = max(1, int(cp_shards))
        self.pp_stages = max(1, int(pp_stages))
        if self.tp_shards > 1:
            if cfg.n_kv_heads % self.tp_shards:
                raise ValueError(
                    f"tp_shards {self.tp_shards} must divide n_kv_heads "
                    f"{cfg.n_kv_heads} (the KV pool shards by head)")
            if cfg.n_heads % self.tp_shards:
                raise ValueError(
                    f"tp_shards {self.tp_shards} must divide n_heads "
                    f"{cfg.n_heads}")
            if cfg.d_ff % self.tp_shards:
                raise ValueError(
                    f"tp_shards {self.tp_shards} must divide d_ff "
                    f"{cfg.d_ff}")
        if self.cp_shards > 1:
            if self.cp_shards & (self.cp_shards - 1):
                raise ValueError(
                    f"cp_shards {self.cp_shards} must be a power of two "
                    "(ring shards ride the pow2 chunk buckets)")
            if kv_layout != "paged":
                raise ValueError("cp_shards > 1 requires kv_layout="
                                 "'paged' (the ring reads the gathered "
                                 "paged span)")
            if kv_fused:
                raise ValueError(
                    "cp_shards > 1 uses the gathered ring read; it does "
                    "not compose with kv_fused")
            if not prefill_chunk_tokens:
                raise ValueError(
                    "cp_shards > 1 shards chunked-prefill attention; "
                    "set prefill_chunk_tokens > 0")
        if self.pp_stages > 1:
            if kv_fused:
                raise ValueError(
                    "pp_stages > 1 does not compose with kv_fused (the "
                    "fused kernel assumes an unsharded layer dim)")
            # Raises unless n_layers divides evenly.
            stage_layer_ranges(cfg.n_layers, self.pp_stages)
            cfg = dataclasses.replace(cfg, pipeline_stages=self.pp_stages)
        self._template = None
        self._ring = None
        if self.tp_shards * self.cp_shards * self.pp_stages > 1:
            tp, cp, pp = self.tp_shards, self.cp_shards, self.pp_stages
            self.tp_devices = serving_mesh(tp, cp=cp, pp=pp,
                                           devices=tp_devices)
            # Stage p's tensor shard t lives on ring shard 0's device,
            # ring shard c of it computes on device (p * cp + c) * tp + t.
            self._stage_devices = [
                self.tp_devices[p * cp * tp:p * cp * tp + tp]
                for p in range(pp)]
            if cp > 1:
                self._ring = [[[self.tp_devices[(p * cp + c) * tp + t]
                                for c in range(cp)] for t in range(tp)]
                              for p in range(pp)]
            self._rules = partition_rules(cfg)
            if tp * pp > 1:
                # The whole tree's paths, shapes and dtypes: what a push
                # is checked against before it is cut into parts.
                self._template = _unflatten({
                    p: torch.empty(t.shape, dtype=t.dtype, device="meta")
                    for p, t in flatten(params).items()})
            params = self._place_parts(
                replica_shards(params, cfg, tp, pp), None)
        else:
            self.tp_devices = [params["embed"]["kernel"].device]
            self._stage_devices = [self.tp_devices]
        self.params = params
        self.cfg = cfg
        # Shard 0's device: the tables, lengths, logits and the generator
        # live there. A weight push keeps it (update_weights places the
        # new tree on the same devices).
        self.device = self.tp_devices[0]
        self.slots = slots
        self.prefill_len = prefill_len
        self.max_new_tokens = max_new_tokens
        self.top_k = top_k
        self.eos_id = eos_id
        self.stream_timeout_s = float(stream_timeout_s)
        self.prefill_len_buckets = max(0, int(prefill_len_buckets))
        self.kv_layout = kv_layout
        self.kv_dtype = kv_dtype
        self.kv_fused = bool(kv_fused)
        # Decode steps per dispatch round (decode_chunk). 1 = one step per
        # round, the finest admission/streaming granularity.
        self.chunk_size = max(1, int(chunk_size))
        self.total_len = self.max_prompt_len + max_new_tokens
        if self.cp_shards > 1:
            floor = (prefill_len >> self.prefill_len_buckets
                     if self.prefill_len_buckets
                     else min(8, prefill_len))
            if floor % self.cp_shards:
                raise ValueError(
                    f"cp_shards {self.cp_shards} must divide the suffix "
                    f"bucket floor {floor} (every chunk dispatch shards "
                    "its query tokens over the sequence axis)")
            if self.total_len % self.cp_shards:
                raise ValueError(
                    f"cp_shards {self.cp_shards} must divide "
                    f"max_prompt_len + max_new_tokens = {self.total_len} "
                    "(the ring streams the gathered virtual row)")
        # Speculative decoding: K > 0 turns decode rounds into verify
        # rounds whenever the proposer has drafts; chunk_size > 1 runs
        # that many verify steps a round (verify_chunk).
        self.speculative_k = max(0, int(speculative_k))
        self._spec = (
            make_proposer(
                draft_mode, target_vocab=cfg.vocab_size, slots=slots,
                total_len=self.total_len,
                propose_steps=(self.chunk_size * self.speculative_k
                               + self.chunk_size - 1),
                seed=seed, device=self.device)
            if self.speculative_k > 0 else None)
        # Per-slot draft length, tuned in [1, speculative_k].
        self._slot_k = [self.speculative_k] * slots
        self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        self.kv_block_size = max(1, int(kv_block_size))
        if kv_layout == "paged":
            if self.total_len % self.kv_block_size:
                raise ValueError(
                    f"kv_block_size {self.kv_block_size} must divide "
                    f"max_prompt_len + max_new_tokens = {self.total_len}")
            mb = self.total_len // self.kv_block_size
            # 0 = worst-case parity with the dense reservation: the pool
            # can back every slot at full length.
            num_blocks = int(kv_pool_blocks) or slots * mb
            if num_blocks < mb:
                raise ValueError(
                    f"kv_pool_blocks {num_blocks} cannot back even one "
                    f"worst-case sequence ({mb} blocks)")
            self._alloc = BlockAllocator(
                num_blocks, self.kv_block_size,
                bytes_per_token=kv_bytes_per_token(
                    cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                    torch.empty((), dtype=cfg.dtype).element_size(),
                    kv_dtype, tp_shards=self.tp_shards))
            # Host mirror of the device block table; sentinel
            # ``num_blocks`` marks unallocated entries (writes through
            # them are dropped).
            self._table = np.full((slots, mb), num_blocks, np.int32)
            self._state = init_paged_state(cfg, slots, num_blocks,
                                           self.kv_block_size, mb, seed,
                                           kv_dtype=kv_dtype,
                                           device=self.device)
        else:
            self._alloc = None
            self._state = init_decode_state(cfg, slots, self.total_len, seed,
                                            device=self.device)
        self.prefix_cache = (
            PrefixCache(prefix_cache_slots, min_len=prefix_cache_min_len)
            if prefix_cache_slots > 0 else None)
        # Dense layout only: a device pool of prefix rows. A paged hit
        # shares the donor's pool blocks instead.
        self._prefix_pool = (
            init_prefix_pool(cfg, prefix_cache_slots, prefill_len,
                             device=self.device)
            if self.prefix_cache is not None and self._alloc is None
            else None)
        if self.tp_shards * self.pp_stages > 1:
            # The KV payload over the stages, by layer, and each stage's
            # over its shards, by KV head.
            devices = [d for stage in self._stage_devices for d in stage]
            self._state = shard_decode_state(self._state, devices,
                                             self.pp_stages)
            if self._prefix_pool is not None:
                self._prefix_pool = shard_decode_state(
                    self._prefix_pool, devices, self.pp_stages)
        if self.prefix_cache is not None and self._alloc is not None:
            # Trie evictions return the entry's refcounted blocks; remove()
            # fires this under the prefix lock.
            self.prefix_cache.on_evict = self._drop_entry_blocks
        # Guards the trie, the dense prefix pool's rows, the allocator and
        # the slots' block lists: prime_prefix() runs on caller threads
        # while the scheduler thread matches, reserves and publishes.
        self._prefix_lock = threading.Lock()
        self.kv_low_watermark = max(0, int(kv_low_watermark))
        # Multi-tenant QoS: token buckets at submit, fair-share/priority
        # ordering of the queue, deadline shedding, and suspension of
        # low-priority live streams under memory pressure (which needs
        # the host tier below to park their KV).
        self.qos = qos
        # Host-RAM KV tier: trie evictions demote their blocks here,
        # trie misses probe it before a cold prefill, and suspended
        # streams pin their KV here until resume. 0 disables.
        self._host_tier = (HostKvTier(int(host_kv_bytes))
                           if host_kv_bytes else None)
        # Host-global bytes one tiered token costs (the tier holds the
        # payload of every head, whatever the shards).
        self._host_bytes_per_token = (
            kv_bytes_per_token(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                               torch.empty((), dtype=cfg.dtype)
                               .element_size(), kv_dtype)
            if self._alloc is not None else 0)
        # The fleet KV economy (HBM -> host -> PEER -> COLD): the shared
        # prefix->holder directory, the content-addressed cold store and
        # the peer pull the fleet or the server wires in
        # (``peer_fetch(holder, tokens, version) -> {"envelope": packed,
        # "weights_version": v} | None``). A local trie and host miss
        # probes the directory on the caller's thread in submit(), never
        # under a decoder lock, and installs the imported prefix so the
        # pop-time plan sees an ordinary trie hit. An import pays only
        # when it beats the best local tier by at least
        # ``kv_import_crossover_tokens`` (0 = any deeper match).
        if (kv_directory is not None or cold_store is not None) \
                and kv_layout != "paged":
            raise ValueError(
                "the fleet KV economy (kv_directory/cold_store) "
                "requires kv_layout='paged'")
        self.kv_directory = kv_directory
        self.cold_store = cold_store
        self._peer_fetch = peer_fetch
        self.replica_name = str(replica_name or "")
        self.kv_import_crossover_tokens = max(
            0, int(kv_import_crossover_tokens))
        self.kv_affinity_tokens = (int(kv_affinity_tokens)
                                   or DEFAULT_AFFINITY_TOKENS)
        # Head-of-line bypass: how many memory-blocked candidates a round
        # may skip looking for a smaller request that fits, and how many
        # blocked rounds shield a head from further bypass.
        self.hol_bypass_limit = max(0, int(hol_bypass_limit))
        self.hol_shield_rounds = max(1, int(hol_shield_rounds))
        # Serializes device access to self._state.
        self._state_lock = threading.Lock()
        self._slot_req: list[_Request | None] = [None] * slots
        self._active_count = 0
        self._pending: deque[_Request] = deque()
        # In-flight chunked admissions, (req, slot) in arrival order; the
        # scheduler advances the oldest by one chunk a round.
        self._chunk_jobs: list[tuple[_Request, int]] = []
        self._cv = threading.Condition()
        self._stopped = False
        self.tokens_emitted = 0
        self.steps = 0       # device decode steps (incl. masked chunk tail)
        self.dispatches = 0  # decode rounds
        self.prefill_dispatches = 0
        self.admitted = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0      # interior chunk calls (long prompts)
        self.prompt_rejected_too_long = 0
        self.ramp_rounds = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        self.kv_defer_admissions = 0
        self.kv_cow_copies = 0       # tail-block copy-on-writes
        self.kv_shared_blocks = 0    # blocks mapped by refcount on hits
        self.hol_bypasses = 0
        self.kv_blocks_peak = 0
        self.peak_in_flight = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        self.prefix_suffix_tokens = 0
        self.prefix_inserts = 0
        self.spec_drafted_tokens = 0     # draft tokens submitted to verify
        self.spec_accepted_tokens = 0    # draft tokens the target kept
        self.spec_verify_dispatches = 0  # verify rounds
        self.kv_handoff_exports = 0   # prompts exported to a decode peer
        self.kv_handoff_imports = 0   # prompts imported from a prefill peer
        self.kv_handoff_tokens = 0    # prefix tokens that rode a handoff
        self.kv_suspends = 0          # live streams parked to the host tier
        self.kv_resumes = 0           # parked streams re-admitted
        self.kv_host_hits = 0         # trie misses served by the host tier
        # The fleet KV economy's counters (0 without a directory or a
        # cold store).
        self.kv_peer_hits = 0         # prefixes imported from a peer replica
        self.kv_peer_misses = 0       # probes that found nothing importable
        self.kv_peer_import_bytes = 0  # payload bytes pulled from peers
        self.kv_peer_fetch_failures = 0  # dead holder / refused pull
        self.kv_cold_hits = 0         # prefixes imported from the cold store
        self.kv_cold_demotions = 0    # host evictions packed into cold
        self.kv_cold_import_bytes = 0  # payload bytes promoted from cold
        self.kv_import_stale_refused = 0  # envelopes refused: stale epoch
        self.kv_import_skipped_crossover = 0  # gains under the threshold
        self.kv_directory_publishes = 0  # holder hints this replica wrote
        self.qos_deadline_shed = 0    # requests shed past their deadline
        # Decode service per tenant (tokens emitted): the fair-share
        # ordering's input.
        self._tenant_served: dict[str, float] = {}
        # Counter mutations and metrics() reads go through this leaf lock.
        self._mlock = threading.Lock()
        # Latency distributions and gauges, the JAX decoder's families
        # (rendered by the model server's /monitoring route).
        self.registry = MetricRegistry()
        self._h_ttft = self.registry.histogram(
            "serving_ttft_seconds", "Submit to first emitted token")
        self._h_itl = self.registry.histogram(
            "serving_inter_token_seconds",
            "Host-side gap between a stream's token arrivals")
        self._h_queue_wait = self.registry.histogram(
            "serving_queue_wait_seconds",
            "Submit to slot admission (includes memory deferrals)")
        self._h_tenant_wait = self.registry.histogram(
            "serving_tenant_queue_wait_seconds",
            "Submit to slot admission, by hash-bucketed tenant",
            labels=("tenant",))
        self._h_dispatch = self.registry.histogram(
            "serving_dispatch_seconds",
            "Device round-trip duration", labels=("kind",))
        occ_bounds, b = [], 1
        while b < slots:
            occ_bounds.append(b)
            b *= 2
        occ_bounds.append(slots)
        self._h_occupancy = self.registry.histogram(
            "serving_batch_occupancy",
            "Active slots per decode dispatch", buckets=occ_bounds)
        self.registry.gauge(
            "serving_role",
            "Replica role in a disaggregated fleet (1 = this role)",
            labels=("role",)).labels(self.role or "colocated").set(1)
        self.registry.gauge(
            "serving_tp_shards",
            "Tensor-parallel mesh width of this replica (1 = "
            "single-chip)").set(self.tp_shards)
        self.registry.gauge(
            "serving_cp_shards",
            "Context-parallel (sequence-axis) width of this replica's "
            "chunked-prefill ring (1 = no ring)").set(self.cp_shards)
        self.registry.gauge(
            "serving_pp_stages",
            "Pipeline-parallel stages sharding this replica's layer "
            "stack and KV pool (1 = unsplit)").set(self.pp_stages)
        self._c_prefill_chunks = self.registry.counter(
            "serving_prefill_chunks_total",
            "Chunked-prefill dispatches (interior chunks of long "
            "admissions; the final chunk counts as a prefill)")
        self._h_prefill_chunk = self.registry.histogram(
            "serving_prefill_chunk_seconds",
            "Chunked-prefill dispatch duration (one interior chunk)")
        # Live weight pushes: a monotonic weights epoch (a replica born
        # from a peer stamps its donor's, boot_weights_version), the push
        # counter and the push's end-to-end seconds.
        self.weights_version = max(0, int(boot_weights_version))
        self.weight_pushes = 0
        self.weight_stale_refused = 0  # stale trie hits refused
        self.last_swap_seconds = 0.0   # the last push's in-lock stall
        self._g_weights_version = self.registry.gauge(
            "serving_weights_version",
            "Weights epoch installed by live pushes (0 = boot weights)")
        if self.weights_version:
            self._g_weights_version.set(self.weights_version)
        self._c_weight_pushes = self.registry.counter(
            "serving_weight_pushes_total",
            "Live weight swaps installed by update_weights")
        self._h_weight_push = self.registry.histogram(
            "serving_weight_push_seconds",
            "update_weights duration: device placement, atomic swap, "
            "stale-KV flush")
        # Per-stream lifecycle timelines, served at /debug/requests.
        self.trace = TraceStore()
        self._ramp_streak = 0  # consecutive admission-only rounds
        if self._host_tier is not None:
            self._h_host_evict_age = self.registry.histogram(
                "serving_kv_host_eviction_age_seconds",
                "Idle time a demoted payload sat in the host tier "
                "before LRU pressure evicted it")
            self._host_tier.eviction_age_observe = \
                self._h_host_evict_age.observe
            if self.cold_store is not None:
                # The economy's demotion chain: a host-tier eviction packs
                # its payload into the cold store (and publishes the hint)
                # before the bytes drop.
                self._host_tier.on_evict = self._demote_to_cold
        # A birth path (a fleet's add_replica) sets this while a newborn
        # warms: the fleet then admits it by least-loaded spill only, with
        # no affine share of the keys.
        self.warming = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def _check_tokens(self, tokens: list[int]) -> None:
        # Out-of-range ids would fault the device's embedding gather
        # (JAX clamps them); reject them at the door.
        if any(t < 0 or t >= self.cfg.vocab_size for t in tokens):
            raise ValueError(
                f"token ids must lie in [0, {self.cfg.vocab_size})")

    def weights_snapshot(self):
        """A consistent (params, weights_version) pair for a peer's pull:
        reference reads under the state lock, the lock the swap takes, so
        a puller never pairs one epoch's version with another's tree. A
        sharded or staged replica's parts are joined whole (on its first
        device)."""
        with self._state_lock:
            params, version = self.params, self.weights_version
        if isinstance(params, (TensorShards, PipelineStages)):
            params = merge_replica(params, self._rules)
        return params, version

    def weights_template(self):
        """A tree with the serving tree's paths, shapes and dtypes, whole
        (a sharded replica's as meta tensors): what a push must cover."""
        return self.params if self._template is None else self._template

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float = 0.0, *,
               request_id: str | None = None, tenant: str = "",
               priority: int | None = None,
               deadline_ms: float = 0.0) -> StreamHandle:
        """Queue one generation. ``request_id`` (the propagated
        X-Request-ID; minted when absent) keys the stream's timeline.
        ``tenant``/``priority``/``deadline_ms`` are the QoS surface (the
        X-Tenant/X-Priority/X-Deadline-Ms headers): with a QoS policy the
        tenant's token bucket gates this call (raises ``QosRejected``,
        HTTP 429 with Retry-After), the queue is ordered by weighted fair
        share and aged priority, and a request still queued past its
        deadline is shed."""
        if self.qos is not None:
            # Before the request enters the queue: overload degrades to
            # fast 429s instead of queue collapse.
            self.qos.admit(tenant, time.perf_counter())
        if len(tokens) > self.max_prompt_len:
            # Terminal, not truncation: max_prompt_len is this replica's
            # ceiling (chunking already lifted it past prefill_len).
            with self._mlock:
                self.prompt_rejected_too_long += 1
            raise PromptTooLong(
                f"prompt is {len(tokens)} tokens but this replica "
                f"serves at most {self.max_prompt_len} "
                f"(max_prompt_len; prefill_chunk_tokens="
                f"{self.prefill_chunk_tokens})")
        self._check_tokens(tokens)
        req = _Request(tokens=list(tokens),
                       want=min(max_new_tokens, self.max_new_tokens),
                       temperature=float(temperature))
        req.tenant = tenant or DEFAULT_TENANT
        req.priority = (self.qos.base_priority(tenant, priority)
                        if self.qos is not None else int(priority or 0))
        if deadline_ms and deadline_ms > 0:
            req.deadline_t = req.submit_t + float(deadline_ms) / 1e3
        # Timeline: submit marks t=0, queued the entry to the deque.
        req.timeline = self.trace.start(request_id)
        req.timeline.event("submit", prompt_tokens=len(req.tokens),
                           want=req.want, tenant=req.tenant,
                           priority=req.priority)
        if self.kv_directory is not None or self.cold_store is not None:
            # The fleet miss path (trie -> host -> peer -> cold) on the
            # CALLER's thread, before the request enters the queue: the
            # pop loop plans prefixes under the scheduler condition, where
            # a blocking peer fetch would stall every submit. An import
            # lands in the trie, so the pop-time plan sees a local hit. A
            # failed probe never fails the submit it meant to speed up.
            try:
                self._maybe_import_remote(req.tokens, req.timeline)
            except Exception:
                pass
        with self._cv:
            if self._stopped:
                req.timeline.close(error=RuntimeError("decoder is stopped"))
                raise RuntimeError("decoder is stopped")
            self._pending.append(req)
            req.timeline.event("queued", depth=len(self._pending))
            self._cv.notify()
        return StreamHandle(req, self.stream_timeout_s)

    def generate(self, tokens: list[int], max_new_tokens: int,
                 temperature: float = 0.0,
                 timeout: float | None = None, **submit_kw) -> dict:
        return self.submit(tokens, max_new_tokens, temperature,
                           **submit_kw).result(timeout)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            queued = list(self._pending)
            self._cv.notify()
        self._thread.join(timeout=5)
        err = RuntimeError("decoder stopped")
        for req in queued + self._slot_req:
            if req is not None and not req.done.is_set():
                self._finish(req, error=err)

    # ------------------------------------------------------------------

    def _finish(self, req: _Request, *, reason: str = "length",
                error: Exception | None = None) -> None:
        # Idempotent: the crash path races stop() and the error handler.
        if req.done.is_set():
            return
        # A suspended request dying (shed, stopped, the loop's death)
        # drains its pinned host-tier payload: pinned bytes are exempt
        # from LRU pressure, so nothing else would reclaim them.
        if req.host_key is not None and self._host_tier is not None:
            with self._prefix_lock:
                self._host_tier.discard(req.host_key)
            req.host_key = None
        req.error = error
        req.finish_reason = reason if error is None else "error"
        if req.timeline is not None:
            # Every finish path funnels here, so no finished request
            # leaves an open timeline.
            req.timeline.close(req.finish_reason, error=error)
        req.stream.put(_DONE)
        req.done.set()

    # -- paged-KV bookkeeping (no-ops in the dense layout) -------------

    def _drop_entry_blocks(self, entry) -> None:
        """Prefix-trie eviction hook: DEMOTE the entry's blocks to the
        host tier (when there is one), then release the refcounted
        blocks. Called by PrefixCache.remove() with the prefix lock
        held."""
        if self._host_tier is not None and entry.blocks:
            self._demote_entry(entry)
        for b in (entry.blocks or ()):
            self._alloc.free(b)

    def _demote_entry(self, entry) -> None:
        """Export an evicted entry's blocks into the host tier, so a later
        miss gets a second chance instead of a cold prefill. Runs under
        the prefix lock (the eviction path); the export's device-to-host
        copy (``Tensor.cpu()``, synchronous) has finished before the
        blocks return to the free list, so no later write to a reused
        block reaches the payload."""
        if entry.version != self.weights_version:
            return  # stale epoch: destroying beats a poisoned second chance
        plen = min(len(entry.key), len(entry.blocks) * self.kv_block_size)
        key = tuple(entry.key[:plen])
        if plen < 1 or self._host_tier.has(key):
            return
        est = (self._alloc.blocks_for(plen) * self.kv_block_size
               * self._host_bytes_per_token)
        if not self._host_tier.can_fit(est):
            return  # pinned suspensions own the budget; skip the copy
        ids = list(entry.blocks[: self._alloc.blocks_for(plen)])
        try:
            payload = self._export_ids(ids)
        except Exception:
            # A dead device state must not wedge the eviction path (the
            # crash drain evicts the whole trie): losing the second
            # chance is fine, losing the free() below is a leak.
            return
        if self._host_tier.put(key, payload, plen, version=entry.version):
            self._publish_directory(key, plen, entry.version, tier="host")

    def _set_table_row(self, slot: int, blocks: list[int]) -> None:
        """Point ``slot``'s host block-table row at ``blocks`` (sentinel
        beyond them); uploaded to the device at its admission's call."""
        self._table[slot, :] = self._alloc.num_blocks
        self._table[slot, : len(blocks)] = blocks

    def _upload_table(self) -> None:
        """Copy the host table to the device (caller holds the state
        lock)."""
        self._state["block_table"].copy_(torch.from_numpy(self._table))

    def _free_slot_blocks(self, slot: int) -> None:
        """Return a retiring slot's block references to the allocator
        (paged). Idempotent."""
        if self._alloc is None:
            return
        with self._prefix_lock:
            blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
            for b in blocks:
                self._alloc.free(b)
            if blocks:
                self._table[slot, :] = self._alloc.num_blocks

    def _reclaim_blocks(self, need: int, timeline=None) -> None:
        """Evict unpinned prefix-cache entries (LRU first) until ``need``
        blocks are free: cache-held blocks are reclaimable memory, not
        reservations. Caller holds the prefix lock. Evictions forced by
        an admission land on its timeline."""
        if self.prefix_cache is None:
            return
        evicted = 0
        while self._alloc.free_blocks < need:
            if not self.prefix_cache.evict_lru():
                break
            evicted += 1
        if evicted and timeline is not None:
            timeline.event("kv_evict", entries=evicted)

    def _admit_batch(self, pending: list[tuple[_Request, int]]) -> None:
        """Admit a round's pending requests in ONE call that fuses
        prefill, state insert and one decode step (``admit_rows_and_step``
        or its paged twin). The batch is padded to
        a power-of-two bucket by repeating the last real admission
        verbatim (duplicate scatter indices then carry identical
        payloads), and with ``prefill_len_buckets`` the sequence dim to
        the smallest allowed power of two covering the longest prompt."""
        k = len(pending)
        bucket = pow2_bucket(k)
        t = self._seq_bucket(max(len(req.tokens) for req, _ in pending))
        toks = np.zeros((bucket, t), np.int32)
        lengths = np.ones((bucket,), np.int32)
        slots = np.zeros((bucket,), np.int32)
        temps = np.zeros((bucket,), np.float32)
        wants = np.zeros((bucket,), np.int32)
        for i in range(bucket):
            req, slot = pending[min(i, k - 1)]  # pad = repeat last real
            toks[i, : len(req.tokens)] = req.tokens
            lengths[i] = max(len(req.tokens), 1)
            slots[i] = slot
            temps[i] = req.temperature
            wants[i] = req.want_left
        dev = self.device
        inputs = tuple(torch.from_numpy(x).to(dev)
                       for x in (slots, toks, lengths, wants, temps))
        t_disp = time.perf_counter()
        with self._state_lock:
            # The params and the epoch stamped on the admissions are read
            # in the lock scope a weight swap takes, so they agree.
            for req, _slot in pending:
                req.weights_version = self.weights_version
            args = (self.params, self.cfg, *inputs, self.top_k, self.eos_id)
            if self._alloc is None:
                self._state, last, tok, emit = admit_rows_and_step(
                    self._state, *args)
            else:
                # Table rows go live only now, under this call, which
                # also sets the rows' device length/active.
                for req, slot in pending:
                    self._set_table_row(slot, self._slot_blocks[slot])
                self._upload_table()
                self._state, last, tok, emit = paged_admit_rows_and_step(
                    self._state, *args, self.kv_fused)
            tok_np, emit_np = tok.cpu().numpy(), emit.cpu().numpy()
        self._h_dispatch.labels("admit").observe(
            time.perf_counter() - t_disp)
        with self._mlock:
            self.prefill_dispatches += 1
            self.admitted += k
            self.prefill_tokens += sum(len(req.tokens) for req, _ in pending)
        for i, (req, slot) in enumerate(pending):
            req.prefill_src = (last, i)
            req.timeline.event("prefill", tokens=len(req.tokens), bucket=t)
            self._post_admit(req, slot)
        with self._mlock:
            self.steps += 1
        self._dispatch(tok_np, emit_np)

    def _seq_bucket(self, n: int) -> int:
        """Prefill length for an ``n``-token prompt."""
        if self.prefill_len_buckets <= 0:
            return self.prefill_len
        floor = max(1, self.prefill_len >> self.prefill_len_buckets)
        return pow2_bucket(max(n, floor), cap=self.prefill_len)

    def _suffix_bucket(self, n: int) -> int:
        """Prefill length of an ``n``-token suffix after a prefix hit, or
        of a chunk. Suffixes are bucketed even when full-prompt bucketing
        is off (padding a 3-token suffix to ``prefill_len`` would erase
        the reuse), with a floor bounding the number of shapes."""
        if self.prefill_len_buckets > 0:
            floor = max(1, self.prefill_len >> self.prefill_len_buckets)
        else:
            floor = min(8, self.prefill_len)
        return pow2_bucket(max(n, floor), cap=self.prefill_len)

    # -- prefix cache ----------------------------------------------------

    def _plan_prefix(self, req: _Request):
        """Probe the trie for ``req`` and fit the (prefix, suffix-bucket)
        split into the row: the suffix must end within ``total_len`` (the
        dense admission raises on a write past the row, where JAX's
        ``dynamic_update_slice`` would clamp it), so when the bucket runs
        past the prompt's tail the reused prefix shortens to ``prompt_len
        - bucket``. Returns (entry, prefix_len, bucket) with the entry
        pinned, or None (miss; any pin released).

        An entry cached under older weights is refused (and removed once
        unpinned) for a fresh request; a resumed (suspended) stream may
        read the epoch it was parked under, its payload being its state.
        A miss probes the host tier (second chance): a promoted payload
        lands in the trie and the match runs again."""
        allow_stale = bool(req.out or req.folded)
        with self._prefix_lock:
            m = self.prefix_cache.match(req.tokens)
            if (m is not None and not allow_stale
                    and m[0].version != self.weights_version):
                entry = m[0]
                self.prefix_cache.release(entry)
                if entry.refs == 0:
                    self.prefix_cache.remove(entry)
                with self._mlock:
                    self.weight_stale_refused += 1
                m = None
        if m is None and self._host_tier is not None:
            if self._promote_host_prefix(req.tokens, req.timeline,
                                         allow_stale=allow_stale):
                with self._prefix_lock:
                    m = self.prefix_cache.match(req.tokens)
        if m is None:
            return None
        entry, plen = m
        n = len(req.tokens)
        s = self._suffix_bucket(n - plen)
        if plen + s > self.total_len:
            plen = n - s
        if s >= n or plen < self.prefix_cache.min_len:
            # Too little left to reuse once bucketed: full prefill wins.
            with self._prefix_lock:
                self.prefix_cache.release(entry)
            return None
        return entry, plen, s

    def _admit_prefix(self, req: _Request, slot: int, entry,
                      prefix_len: int, s: int) -> None:
        """Prefix-hit admission: ONE call prefills only the suffix
        (padded to ``s``) and takes the fused decode step. Dense: the call
        first copies the pooled row into the request's row. Paged: the
        pop-time reservation already mapped the donor's full blocks into
        the slot by refcount (zero copies); only a partly filled tail
        block is copied here, before the suffix prefill reads it. ``entry``
        arrives pinned and stays pinned until the request finishes, so no
        store or eviction touches what it reads."""
        suffix = req.tokens[prefix_len:]
        toks = np.zeros((1, s), np.int32)
        toks[0, : len(suffix)] = suffix
        toks_t = torch.from_numpy(toks).to(self.device)
        t_disp = time.perf_counter()
        if self._alloc is not None:
            bs = self.kv_block_size
            n_full = prefix_len // bs
            with self._state_lock:
                req.weights_version = self.weights_version
                if prefix_len % bs:
                    # The slot's first owned block (table index n_full)
                    # takes the donor's partly shared tail.
                    copy_block(self._state["pool"],
                               self._slot_blocks[slot][n_full],
                               entry.blocks[n_full])
                # The row is mapped only under its own call: live before
                # it, an earlier decode step would write through it at
                # the slot's stale length into shared blocks.
                self._set_table_row(slot, self._slot_blocks[slot])
                self._upload_table()
                self._state, last, tok, emit = paged_admit_prefix_and_step(
                    self._state, self.params, self.cfg, slot, prefix_len,
                    toks_t, len(req.tokens), req.want_left, req.temperature,
                    self.top_k, self.eos_id, self.kv_fused)
                tok_np, emit_np = tok.cpu().numpy(), emit.cpu().numpy()
            with self._mlock:
                self.kv_shared_blocks += n_full
                if prefix_len % bs:
                    self.kv_cow_copies += 1
        else:
            with self._state_lock:
                req.weights_version = self.weights_version
                self._state, last, tok, emit = admit_prefix_and_step(
                    self._state, self.params, self.cfg, slot,
                    self._prefix_pool, entry.slot, prefix_len, toks_t,
                    len(req.tokens), req.want_left, req.temperature,
                    self.top_k, self.eos_id)
                tok_np, emit_np = tok.cpu().numpy(), emit.cpu().numpy()
        self._h_dispatch.labels("admit").observe(
            time.perf_counter() - t_disp)
        req.pinned_prefix = entry
        with self._mlock:
            self.prefill_dispatches += 1
            self.admitted += 1
            self.prefix_hits += 1
            self.prefix_tokens_reused += prefix_len
            self.prefix_suffix_tokens += len(suffix)
            self.prefill_tokens += len(suffix)
        req.prefill_src = (last, 0)
        req.timeline.event("prefill", tokens=len(suffix),
                           prefix_reused=prefix_len, bucket=s)
        self._post_admit(req, slot)
        with self._mlock:
            self.steps += 1
        self._dispatch(tok_np, emit_np)

    # -- chunked prefill --------------------------------------------------

    def _begin_chunked(self, req: _Request, slot: int) -> None:
        """Register a long admission as a chunk job. The slot and its
        blocks were taken at pop time (and a prefix plan pinned its
        entry); no device work runs here. The slot counts as occupied but
        not active: its row is parked until the final chunk."""
        plan = req.admit_plan
        plen = plan[1] if plan is not None else 0
        if plan is not None:
            req.pinned_prefix = plan[0]
            with self._mlock:
                self.prefix_hits += 1
                self.prefix_tokens_reused += plen
                self.prefix_suffix_tokens += len(req.tokens) - plen
                self.kv_shared_blocks += plen // self.kv_block_size
        elif self.prefix_cache is not None:
            with self._mlock:
                self.prefix_misses += 1
        req.chunk_pos = plen
        req.chunk_started = False
        self._slot_req[slot] = req
        self._chunk_jobs.append((req, slot))
        req.timeline.event("chunked_admission",
                           prompt_tokens=len(req.tokens),
                           prefix_reused=plen,
                           chunk_tokens=self.prefill_chunk_tokens)

    def _advance_chunked(self) -> None:
        """Run AT MOST ONE chunk call: the oldest job's next chunk. One
        chunk a round bounds a live stream's inter-token gap at one chunk
        of prefill.

        An interior chunk writes ``prefill_chunk_tokens`` prompt tokens
        into the row's blocks and re-parks the row (no sampling, no
        randomness consumed). The FINAL chunk is a prefix-style admission
        with ``prefix_len = chunk_pos``: it activates the row, samples the
        first token and takes the round's decode step. A weight push that
        lands mid-chain restarts the chain (:meth:`_restart_chunked`): one
        row never mixes two epochs' K/V."""
        if not self._chunk_jobs:
            return
        req, slot = self._chunk_jobs[0]
        n = len(req.tokens)
        pos = req.chunk_pos
        remaining = n - pos
        final = remaining <= self.prefill_chunk_tokens
        take = remaining if final else self.prefill_chunk_tokens
        s = self._suffix_bucket(take)
        toks = np.zeros((1, s), np.int32)
        toks[0, :take] = req.tokens[pos: pos + take]
        toks_t = torch.from_numpy(toks).to(self.device)
        first = not req.chunk_started
        plan = req.admit_plan
        bs = self.kv_block_size
        cow = first and plan is not None and plan[1] % bs
        restart = False
        t_disp = time.perf_counter()
        with self._state_lock:
            if first:
                # The epoch is stamped, the plan's partly shared tail is
                # copied and the row is mapped under the chain's first
                # call, as in _admit_prefix.
                req.chunk_started = True
                req.weights_version = self.weights_version
                if cow:
                    n_full = plan[1] // bs
                    copy_block(self._state["pool"],
                               self._slot_blocks[slot][n_full],
                               plan[0].blocks[n_full])
                self._set_table_row(slot, self._slot_blocks[slot])
                self._upload_table()
            elif req.weights_version != self.weights_version:
                # A push landed mid-chain: the blocks written so far are
                # the old epoch's. Restart below, outside the lock.
                restart = True
            if restart:
                pass  # nothing runs under the superseded epoch
            elif final:
                self._state, last, tok, emit = paged_admit_prefix_and_step(
                    self._state, self.params, self.cfg, slot, pos, toks_t,
                    n, req.want_left, req.temperature, self.top_k,
                    self.eos_id, self.kv_fused, ring=self._ring)
                tok_np, emit_np = tok.cpu().numpy(), emit.cpu().numpy()
            else:
                self._state = paged_prefill_chunk(
                    self._state, self.params, self.cfg, slot, pos, toks_t,
                    take, self.kv_fused, ring=self._ring)
                for dev in dict.fromkeys(self.tp_devices):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
        if restart:
            self._restart_chunked(req, slot)
            return
        if cow:
            with self._mlock:
                self.kv_cow_copies += 1
        dt = time.perf_counter() - t_disp
        if not final:
            req.chunk_pos = pos + take
            with self._mlock:
                self.prefill_chunks += 1
                self.prefill_tokens += take
            self._c_prefill_chunks.inc()
            self._h_prefill_chunk.observe(dt)
            self._h_dispatch.labels("prefill_chunk").observe(dt)
            req.timeline.event("prefill_chunk", pos=pos, tokens=take,
                               bucket=s)
            return
        # Final chunk: the chain is done; the row is an admitted stream.
        self._chunk_jobs.pop(0)
        with self._mlock:
            self.prefill_dispatches += 1
            self.admitted += 1
            self.prefill_tokens += take
        self._h_dispatch.labels("admit").observe(dt)
        req.prefill_src = (last, 0)
        req.timeline.event("prefill", tokens=take, prefix_reused=pos,
                           bucket=s, chunked=True)
        req.chunk_pos = -1
        self._post_admit(req, slot)
        with self._mlock:
            self.steps += 1
        self._dispatch(tok_np, emit_np)

    def _restart_chunked(self, req: _Request, slot: int) -> None:
        """Abort a mid-chain chunked admission and queue it again at the
        head: the whole chain reruns under the new weights epoch (the
        repop plans its prefix against the trie as it now is), so a
        chunked stream, like every other, sees exactly one epoch's K/V
        for its prompt. Only a weight push reaches this."""
        self._chunk_jobs.pop(0)
        self._slot_req[slot] = None
        self._release_pin(req)
        self._free_slot_blocks(slot)
        req.admit_plan = None
        req.chunk_pos = -1
        req.chunk_started = False
        req.timeline.event("chunk_restart", reason="weight_swap")
        with self._cv:
            if self._stopped:
                self._finish(req, error=RuntimeError("decoder stopped"))
                return
            self._pending.appendleft(req)
            self._cv.notify()

    def _publish_prefix(self, req: _Request, slot: int) -> None:
        """Publish a finishing request's prompt K/V (still intact in its
        row's positions 0..len-1) so later prompts sharing the prefix skip
        its prefill. Runs on the scheduler thread BEFORE the slot is
        freed. Dense: the row is copied into a pool row the trie hands out
        unpinned, so no admission reads the row written here. Paged:
        bookkeeping only — the entry takes a reference on the blocks
        covering the key, which outlive the slot's own release."""
        cache = self.prefix_cache
        if cache is None or req.error is not None:
            return
        if req.weights_version != self.weights_version:
            # The stream straddled a weight push: its prompt K/V belongs
            # to weights the decoder no longer serves.
            return
        ent = req.pinned_prefix
        if ent is not None and ent.version != req.weights_version:
            # A push landed between the plan and the admission: the row's
            # leading K/V is the old epoch's, its suffix the new one's.
            return
        key = tuple(req.tokens)
        if len(key) < cache.min_len:
            return
        with self._prefix_lock:
            if cache.has(key):
                cache.touch(key)
                return
            entry = cache.reserve(key)
            if entry is None:  # every pool row pinned by peers in flight
                return
            entry.version = req.weights_version
            if self._alloc is not None:
                n_pub = min(self._alloc.blocks_for(len(key)),
                            len(self._slot_blocks[slot]))
                blocks = tuple(self._slot_blocks[slot][:n_pub])
                for b in blocks:
                    self._alloc.share(b)
                entry.blocks = blocks
            else:
                store_prefix_row(self._prefix_pool, entry.slot, self._state,
                                 slot)
            plen = len(key)
            if entry.blocks:
                plen = min(plen, len(entry.blocks) * self.kv_block_size)
            self._publish_directory(key, plen, req.weights_version,
                                    tier="hbm")
        with self._mlock:
            self.prefix_inserts += 1

    def _release_pin(self, req: _Request) -> None:
        if req.pinned_prefix is not None and self.prefix_cache is not None:
            with self._prefix_lock:
                self.prefix_cache.release(req.pinned_prefix)
            req.pinned_prefix = None

    def prime_prefix(self, tokens: list[int]) -> bool:
        """Precompute and pool a prefix (e.g. the shared system prompt at
        server start) WITHOUT touching the decode state or its generator,
        so a primed decoder samples exactly as an unprimed one. Paged:
        the prefix is prefilled into freshly allocated blocks owned by the
        trie entry (released on eviction). Returns True when the prefix
        is pooled (already or now)."""
        if self.prefix_cache is None:
            return False
        toks = list(tokens)[: self.prefill_len]
        if len(toks) < self.prefix_cache.min_len:
            return False
        self._check_tokens(toks)
        key = tuple(toks)
        dev = self.device
        # One consistent (params, epoch) pair: the entry's epoch must be
        # that of the weights that computed its bytes.
        with self._state_lock:
            params, wver = self.params, self.weights_version
        with self._prefix_lock:
            if self.prefix_cache.has(key):
                self.prefix_cache.touch(key)
                return True
            entry = self.prefix_cache.reserve(key)
            if entry is None:
                return False
            if self._alloc is not None:
                nblk = self._alloc.blocks_for(len(toks))
                self._reclaim_blocks(nblk)
                if not self._alloc.can_alloc(nblk):
                    self.prefix_cache.remove(entry)
                    return False
                blocks = self._alloc.alloc(nblk)
                self.kv_blocks_peak = max(self.kv_blocks_peak,
                                          self._alloc.blocks_in_use)
                try:
                    w = nblk * self.kv_block_size
                    arr = np.zeros((1, w), np.int32)
                    arr[0, : len(toks)] = toks
                    cache, _last = prefill(
                        params, torch.from_numpy(arr).to(dev),
                        torch.tensor([len(toks)], device=dev), self.cfg,
                        total_len=w)
                    with self._state_lock:
                        store_blocks(self._state["pool"], blocks, cache)
                except Exception:
                    for b in blocks:
                        self._alloc.free(b)
                    self.prefix_cache.remove(entry)
                    raise
                entry.blocks = tuple(blocks)
            else:
                try:
                    arr = np.zeros((1, self._seq_bucket(len(toks))),
                                   np.int32)
                    arr[0, : len(toks)] = toks
                    cache, _last = prefill(
                        params, torch.from_numpy(arr).to(dev),
                        torch.tensor([len(toks)], device=dev), self.cfg,
                        total_len=self.prefill_len)
                    store_prefix_cache(self._prefix_pool, entry.slot, cache)
                except Exception:
                    self.prefix_cache.remove(entry)
                    raise
            entry.version = wver
        with self._mlock:
            self.prefix_inserts += 1
            self.prefill_tokens += len(toks)  # priming IS a prefill
        return True

    # -- prefill/decode handoff, host-tier promotion ---------------------

    @staticmethod
    def _payload_nblk(payload: dict) -> int:
        """Block count a payload carries (fp tensors and int8
        {"q","scale"} dicts share the [L, nblk, ...] leading layout)."""
        k = payload["k"]
        arr = k["q"] if isinstance(k, dict) else k
        return int(arr.shape[1])

    @staticmethod
    def _slice_payload(payload: dict, nblk: int) -> dict:
        """The leading ``nblk`` blocks of a payload (causality: they back
        any shorter depth), fp and int8 alike."""

        def _s(node):
            if isinstance(node, dict):
                return {k: _s(v) for k, v in node.items()}
            return node[:, :nblk]

        return {side: _s(payload[side]) for side in ("k", "v")}

    def _export_ids(self, ids: list[int]) -> dict:
        """Pool blocks ``ids`` as a host payload (torch CPU tensors). The
        gather runs under the state lock; the device-to-host copy after
        it, outside (the gathered tensors are this call's alone), so an
        export never holds the scheduler's dispatches for the copy.
        ``Tensor.cpu()`` returns once the copy is done, so the caller may
        free the blocks at once."""
        with self._state_lock:
            out = export_blocks(self._state["pool"], ids)

        def _host(node):
            if isinstance(node, dict):
                return {k: _host(v) for k, v in node.items()}
            return node.cpu()

        return {side: _host(out[side]) for side in ("k", "v")}

    def _export_cold(self, prefix_toks: list[int]) -> dict:
        """Cache-less export source: prefill the prefix into scratch
        blocks, export them, free them; nothing outlives the call."""
        nblk = self._alloc.blocks_for(len(prefix_toks))
        with self._prefix_lock:
            self._reclaim_blocks(nblk)
            if not self._alloc.can_alloc(nblk):
                raise ValueError(
                    f"prompt export needs {nblk} free KV blocks; "
                    f"{self._alloc.free_blocks} available")
            blocks = self._alloc.alloc(nblk)
            self.kv_blocks_peak = max(self.kv_blocks_peak,
                                      self._alloc.blocks_in_use)
        try:
            w = nblk * self.kv_block_size
            arr = np.zeros((1, w), np.int32)
            arr[0, : len(prefix_toks)] = prefix_toks
            with self._state_lock:
                params = self.params  # consistent with any live swap
            dev = self.device
            cache, _last = prefill(
                params, torch.from_numpy(arr).to(dev),
                torch.tensor([len(prefix_toks)], device=dev), self.cfg,
                total_len=w)
            with self._state_lock:
                store_blocks(self._state["pool"], blocks, cache)
            return self._export_ids(blocks)
        finally:
            with self._prefix_lock:
                for b in blocks:
                    self._alloc.free(b)

    def export_prompt(self, tokens: list[int],
                      timeout: float | None = None) -> dict:
        """Prefill-role handoff: compute the prompt's KV here and export
        the blocks backing its leading positions as a payload a decode
        replica can :meth:`import_prompt`.

        The exported prefix is the prompt minus its last token: the
        importer prefills that one token through the imported blocks (the
        suffix path of a colocated prefix hit), so its admission recovers
        the true last-position logits and greedy output equals a
        colocated replica's. Int8 pools export codes AND scales as they
        are, so a quantized handoff is exact.

        With the prefix cache on, the prefix rides the ordinary pure
        prefill admission (``want=0`` through the scheduler; suffix reuse
        against this replica's trie, publish on finish), and the
        published entry's blocks are the export source. Without it, the
        prefix is prefilled into scratch blocks freed after the export."""
        if self._alloc is None:
            raise ValueError("prompt handoff requires kv_layout='paged'")
        toks = [int(t) for t in tokens][: self.prefill_len]
        if len(toks) < 2:
            raise ValueError("prompt handoff needs a >=2-token prompt")
        self._check_tokens(toks)
        plen = len(toks) - 1
        key = tuple(toks[:plen])
        cache = self.prefix_cache
        entry = None
        if cache is not None and plen >= cache.min_len:
            with self._prefix_lock:
                known = cache.has(key)
            if not known:
                self.submit(list(key), 0).result(timeout)
            with self._prefix_lock:
                m = cache.match(toks)  # pins the entry against eviction
                if m is not None:
                    entry, depth = m
                    # Capped at the positions the entry's blocks back.
                    depth = min(depth, len(entry.blocks or ())
                                * self.kv_block_size)
                    if depth >= cache.min_len:
                        plen = depth
                    else:
                        cache.release(entry)
                        entry = None
        try:
            if entry is not None:
                ids = list(entry.blocks[: self._alloc.blocks_for(plen)])
                payload = self._export_ids(ids)
            else:
                payload = self._export_cold(toks[:plen])
        finally:
            if entry is not None:
                with self._prefix_lock:
                    cache.release(entry)
        with self._mlock:
            self.kv_handoff_exports += 1
            self.kv_handoff_tokens += plen
        return {"tokens": toks, "prefix_len": plen,
                "block_size": self.kv_block_size,
                "kv_dtype": self.kv_dtype, "tp_shards": self.tp_shards,
                "cp_shards": self.cp_shards, "pp_stages": self.pp_stages,
                "payload": payload}

    def import_prompt(self, handoff: dict) -> bool:
        """Decode-role handoff receive: allocate local blocks, scatter the
        exported payload in as it came (int8 codes and scales included)
        and register the prefix in this replica's trie; the ``submit()``
        of the full prompt then rides the ordinary prefix-hit admission.
        The payload may be host tensors (``handoff.unpack``) or numpy
        arrays (a JAX replica's export).

        Returns False when the import cannot be registered (no prefix
        cache, a prefix under ``min_len``, every entry pinned, no free
        blocks): the caller submits the prompt plainly and this replica
        prefills it itself. Raises ``ValueError`` on a payload whose block
        size, kv dtype or block count does not match this pool."""
        if self._alloc is None:
            raise ValueError("prompt handoff requires kv_layout='paged'")
        if int(handoff["block_size"]) != self.kv_block_size:
            raise ValueError(
                f"handoff block_size {handoff['block_size']} != "
                f"pool block_size {self.kv_block_size}")
        if str(handoff.get("kv_dtype", "fp")) != self.kv_dtype:
            raise ValueError(
                f"handoff kv_dtype {handoff.get('kv_dtype')!r} != "
                f"pool kv_dtype {self.kv_dtype!r}")
        toks = [int(t) for t in handoff["tokens"]]
        plen = int(handoff["prefix_len"])
        if not 0 < plen <= min(len(toks), self.prefill_len):
            raise ValueError(f"bad handoff prefix_len {plen}")
        self._check_tokens(toks[:plen])
        payload = {s: tree_to_torch(handoff["payload"][s])
                   for s in ("k", "v")}
        cache = self.prefix_cache
        if cache is None or plen < cache.min_len:
            return False
        nblk = self._alloc.blocks_for(plen)
        if self._payload_nblk(payload) != nblk:
            raise ValueError(
                f"handoff payload carries {self._payload_nblk(payload)} "
                f"blocks; prefix_len {plen} needs {nblk}")
        imported = self._install_prefix_payload(tuple(toks[:plen]),
                                                payload)
        if imported:
            with self._mlock:
                self.kv_handoff_imports += 1
                self.kv_handoff_tokens += plen
        return imported

    def _install_prefix_payload(self, key: tuple, payload: dict, *,
                                version: int | None = None) -> bool:
        """Allocate local blocks, scatter ``payload`` in as it came, and
        register ``key`` in the trie: the import shared by the handoff
        (:meth:`import_prompt`) and host-tier promotion
        (:meth:`_promote_host_prefix`). Returns False when it cannot land
        (no free blocks, every entry pinned). ``version`` stamps the
        entry's weights epoch (None = the live one)."""
        cache = self.prefix_cache
        nblk = self._alloc.blocks_for(len(key))
        if self._payload_nblk(payload) != nblk:
            raise ValueError(
                f"payload carries {self._payload_nblk(payload)} blocks; "
                f"prefix_len {len(key)} needs {nblk}")
        with self._prefix_lock:
            if cache.has(key):
                cache.touch(key)
                return True
            self._reclaim_blocks(nblk)
            if not self._alloc.can_alloc(nblk):
                return False
            blocks = self._alloc.alloc(nblk)
            self.kv_blocks_peak = max(self.kv_blocks_peak,
                                      self._alloc.blocks_in_use)
        # The scatter runs outside the prefix lock: it waits out any
        # dispatch in flight (state lock), and the prefix lock held
        # across that wait would stall the scheduler's pop path. The
        # blocks are this call's alone until registered.
        try:
            with self._state_lock:
                import_blocks(self._state["pool"], blocks, payload)
        except Exception:
            with self._prefix_lock:
                for b in blocks:
                    self._alloc.free(b)
            raise
        ver = self.weights_version if version is None else int(version)
        with self._prefix_lock:
            entry = cache.reserve(key)
            if entry is None:
                # Another import won the race (its blocks hold the same
                # content: the key IS the data), or every entry is
                # pinned. Either way these blocks are surplus.
                for b in blocks:
                    self._alloc.free(b)
                imported = cache.has(key)
            else:
                entry.blocks = tuple(blocks)
                entry.version = ver
                with self._mlock:
                    self.prefix_inserts += 1
                imported = True
        if imported:
            self._publish_directory(key, len(key), ver, tier="hbm")
        return imported

    def _promote_host_prefix(self, tokens: list[int], timeline=None, *,
                             allow_stale: bool = False) -> bool:
        """Second chance: a trie miss probes the host tier for the
        longest demoted prefix of ``tokens`` and imports it
        (:meth:`_install_prefix_payload`); the admission then rides the
        ordinary prefix-hit path. The payload stays in the tier (unpinned
        LRU). ``allow_stale`` (resumed streams only) accepts a payload of
        an older weights epoch."""
        with self._prefix_lock:
            m = self._host_tier.match(
                tokens, None if allow_stale else self.weights_version)
        if m is None:
            return False
        entry, depth = m
        if (self.prefix_cache is None
                or depth < self.prefix_cache.min_len):
            return False
        payload = self._slice_payload(entry.payload,
                                      self._alloc.blocks_for(depth))
        if not self._install_prefix_payload(tuple(entry.key[:depth]),
                                            payload,
                                            version=entry.version):
            return False
        with self._prefix_lock:
            self._host_tier.note_promotion()
        with self._mlock:
            self.kv_host_hits += 1
        if timeline is not None:
            timeline.event("promote", prefix_len=depth)
        return True

    # -- the fleet KV economy --------------------------------------------

    def _publish_directory(self, key_tokens, prefix_len: int,
                           version: int, *, tier: str) -> None:
        """Advertise a held prefix to the fleet directory, keyed by the
        affinity hash the gateway routes on. One leaf-locked dict write:
        the directory holds hints, and the pull validates them."""
        if self.kv_directory is None:
            return
        holder = COLD_HOLDER if tier == "cold" else self.replica_name
        if not holder:
            return  # an anonymous replica: nothing a peer could pull
        key = prefix_affinity_key(key_tokens, self.kv_affinity_tokens)
        self.kv_directory.publish(key, holder, prefix_len=int(prefix_len),
                                  version=int(version), tier=tier)
        with self._mlock:
            self.kv_directory_publishes += 1

    def _demote_to_cold(self, entry) -> None:
        """Host-tier eviction hook (``HostKvTier.on_evict``, fired under
        the prefix lock): pack the dying payload into the shared cold
        store and publish the hint before the bytes drop. The epoch rides
        the content key, so a pre-swap payload parked there is unreachable
        to post-swap lookups."""
        if entry.version != self.weights_version:
            return  # stale epoch: parking it would waste cold bytes
        if self.cold_store is None or entry.prefix_len < 1:
            return
        handoff = {"tokens": list(entry.key[: entry.prefix_len]),
                   "prefix_len": int(entry.prefix_len),
                   "block_size": self.kv_block_size,
                   "kv_dtype": self.kv_dtype,
                   "tp_shards": self.tp_shards,
                   "cp_shards": self.cp_shards,
                   "pp_stages": self.pp_stages,
                   "payload": entry.payload}
        if self.cold_store.put(handoff, version=entry.version) is None:
            return
        with self._mlock:
            self.kv_cold_demotions += 1
        self._publish_directory(entry.key, entry.prefix_len,
                                entry.version, tier="cold")

    def export_prefix(self, tokens: list[int]) -> dict:
        """Serve a peer's KV pull: the deepest cached prefix of ``tokens``
        this replica holds, from the trie (device blocks, one export) or
        the host tier (already on the host), as a handoff dict stamped
        with the live weights epoch (``weights_version``; the requester
        refuses it if its own epoch has moved on).

        Runs on the requester's thread while this replica's scheduler
        dispatches into the same pool. The trie entry is pinned
        (``cache.match``) across the export, so its blocks are not freed
        or reused under it; the gather and its device-to-host copy
        (:meth:`_export_ids`) are queued on the device's current stream
        after every write the scheduler queued there before, so on the one
        default stream the replicas of a card share the copy sees the
        holder's finished writes.

        Raises ``KeyError`` when nothing matches: the hint that sent the
        requester here was stale; it withdraws the hint and falls through
        to the cold store or a plain prefill."""
        if self._alloc is None:
            raise ValueError("prefix export requires kv_layout='paged'")
        toks = [int(t) for t in tokens]
        cache = self.prefix_cache
        entry, depth, host = None, 0, None
        with self._prefix_lock:
            live = self.weights_version
            if cache is not None:
                m = cache.match(toks)  # pins against eviction
                if m is not None:
                    entry, depth = m
                    depth = min(depth, len(entry.blocks or ())
                                * self.kv_block_size)
                    if depth < cache.min_len or entry.version != live:
                        cache.release(entry)
                        entry, depth = None, 0
            if self._host_tier is not None:
                hm = self._host_tier.match(toks, live)
                if hm is not None and hm[1] > depth:
                    host = hm
        try:
            if host is not None:
                hentry, plen = host
                payload = self._slice_payload(
                    hentry.payload, self._alloc.blocks_for(plen))
            elif entry is not None:
                plen = depth
                ids = list(entry.blocks[: self._alloc.blocks_for(plen)])
                payload = self._export_ids(ids)
            else:
                raise KeyError("no cached prefix to export")
        finally:
            if entry is not None:
                with self._prefix_lock:
                    cache.release(entry)
        with self._mlock:
            self.kv_handoff_exports += 1
            self.kv_handoff_tokens += plen
        return {"tokens": toks[:plen], "prefix_len": plen,
                "block_size": self.kv_block_size,
                "kv_dtype": self.kv_dtype, "tp_shards": self.tp_shards,
                "cp_shards": self.cp_shards, "pp_stages": self.pp_stages,
                "weights_version": live, "payload": payload}

    def _local_prefix_depth(self, toks: list[int]) -> tuple[int, int]:
        """(best local depth, live epoch): the deeper of the trie's and
        the host tier's match at the live weights epoch, what a remote
        import must beat to be worth its pull."""
        cache = self.prefix_cache
        with self._prefix_lock:
            live = self.weights_version
            local = 0
            m = cache.match(toks)
            if m is not None:
                ent, d = m
                cache.release(ent)
                if ent.version == live:
                    local = min(d, len(ent.blocks or ())
                                * self.kv_block_size)
            if self._host_tier is not None:
                hm = self._host_tier.match(toks, live)
                if hm is not None:
                    local = max(local, hm[1])
        return local, live

    def _maybe_import_remote(self, tokens: list[int],
                             timeline=None) -> bool:
        """The fleet miss path: trie -> host -> PEER -> COLD -> prefill,
        on the caller's thread in :meth:`submit` with no decoder lock held
        across a fetch. An import installs through
        :meth:`_install_prefix_payload`, so the pop-time plan sees an
        ordinary trie hit and prefills only the tail."""
        cache = self.prefix_cache
        if cache is None or self._alloc is None:
            return False
        if self.kv_directory is None and self.cold_store is None:
            return False
        toks = [int(t) for t in tokens]
        cap = min(len(toks) - 1, self.prefill_len)
        if cap < cache.min_len:
            return False
        local, live = self._local_prefix_depth(toks)
        # The pull's fixed cost (the fetch, the envelope codec, the
        # scatter) pays only when the import saves at least this many
        # prefill tokens over the best local tier.
        want = max(cache.min_len,
                   local + max(1, self.kv_import_crossover_tokens))
        if want > cap:
            return False
        key = prefix_affinity_key(toks, self.kv_affinity_tokens)
        best_remote = 0
        if self._import_from_peers(key, toks, cap, want, live, timeline):
            return True
        if self.kv_directory is not None:
            for hint in self.kv_directory.lookup(key, version=live):
                best_remote = max(best_remote, hint.prefix_len)
        if self._import_from_cold(toks, cap, want, live, timeline):
            return True
        if self.cold_store is not None:
            best_remote = max(best_remote,
                              self.cold_store.peek_depth(toks, live))
        with self._mlock:
            if local < best_remote < want:
                self.kv_import_skipped_crossover += 1
            else:
                self.kv_peer_misses += 1
        return False

    def _import_from_peers(self, key: str, toks: list[int], cap: int,
                           want: int, live: int, timeline) -> bool:
        """Probe the directory's holders deepest first; the fetch
        validates what the hint only promised. A dead or evicted holder
        costs one withdrawn hint, never a hang."""
        if self.kv_directory is None or self._peer_fetch is None:
            return False
        hints = [h for h in self.kv_directory.lookup(
                     key, exclude=(self.replica_name, COLD_HOLDER),
                     version=live)
                 if h.prefix_len >= want]
        for hint in hints:
            try:
                got = self._peer_fetch(hint.holder, toks, live)
            except Exception:
                got = None
            if got is None:
                with self._mlock:
                    self.kv_peer_fetch_failures += 1
                self.kv_directory.withdraw(key, hint.holder)
                continue
            try:
                h = unpack(got["envelope"])
                ver = int(got.get("weights_version", live))
            except (ValueError, KeyError, TypeError):
                with self._mlock:
                    self.kv_peer_fetch_failures += 1
                self.kv_directory.withdraw(key, hint.holder)
                continue
            if self._install_remote(h, ver, toks, cap, want, timeline,
                                    tier="peer"):
                return True
        return False

    def _import_from_cold(self, toks: list[int], cap: int, want: int,
                          live: int, timeline) -> bool:
        if self.cold_store is None:
            return False
        got = self.cold_store.match(toks, live)
        if got is None:
            return False
        h, depth = got
        return self._install_remote(h, live, toks, min(cap, depth), want,
                                    timeline, tier="cold")

    def _install_remote(self, h: dict, ver: int, toks: list[int],
                        cap: int, want: int, timeline, tier: str) -> bool:
        """Check a fetched envelope against this pool and the LIVE
        weights epoch, then install its covering slice. The epoch is read
        again here: a push that landed while the envelope was in flight
        makes ``ver`` stale, and the envelope is refused and counted,
        never installed."""
        if int(h["block_size"]) != self.kv_block_size or \
                str(h.get("kv_dtype", "fp")) != self.kv_dtype:
            with self._mlock:
                self.kv_peer_fetch_failures += 1
            return False
        with self._state_lock:
            now_live = self.weights_version
        if int(ver) != now_live:
            with self._mlock:
                self.kv_import_stale_refused += 1
            if timeline is not None:
                timeline.event("kv_import_refused", tier=tier,
                               stale_version=int(ver))
            return False
        # The depth that really matches (a hint, and even the envelope's
        # prefix_len, may promise more: another prompt family can share
        # an affinity key).
        ht = h["tokens"]
        lim = min(int(h["prefix_len"]), cap, len(ht))
        d = 0
        while d < lim and int(ht[d]) == toks[d]:
            d += 1
        if d < want:
            return False
        payload = self._slice_payload(
            {side: tree_to_torch(h["payload"][side]) for side in ("k", "v")},
            self._alloc.blocks_for(d))
        if not self._install_prefix_payload(tuple(toks[:d]), payload,
                                            version=now_live):
            return False
        nbytes = payload_nbytes(payload)
        with self._mlock:
            if tier == "cold":
                self.kv_cold_hits += 1
                self.kv_cold_import_bytes += nbytes
            else:
                self.kv_peer_hits += 1
                self.kv_peer_import_bytes += nbytes
        if timeline is not None:
            timeline.event("kv_import", tier=tier, prefix_len=d)
        return True

    # -- live weight pushes ----------------------------------------------

    def update_weights(self, params, *, version: int | None = None,
                       draft_params=None) -> int:
        """Swap in a new parameter tree between dispatches without
        dropping a live stream.

        Double-buffered: the new tree (the port's nested dict of tensors,
        or a numpy tree in the JAX layout; each leaf cast to the serving
        leaf's dtype) is placed on the device with no lock held, on a
        side CUDA stream that the swap waits for, while decode keeps
        dispatching on the old tensors. The install is a change of
        reference under the state lock, the dispatch boundary, never a
        copy into tensors a step reads, so no step sees a torn tree. Live
        streams keep their slots and KV across the boundary; prompt K/V
        cached under the old weights is flushed or refused, so admissions
        after the swap equal a decoder cold-started on the new weights.

        ``version`` stamps the push (monotonic: a stale or duplicate
        version is a no-op returning the installed epoch); None
        increments. ``draft_params`` swaps a draft-model proposer's
        weights in the SAME lock epoch. Returns the installed epoch."""
        t0 = time.perf_counter()
        with self._state_lock:
            cur_params, cur_version = self.params, self.weights_version
        if version is not None and int(version) <= cur_version:
            return cur_version
        spec = self._spec
        if draft_params is not None and (spec is None
                                         or not hasattr(spec, "params")):
            raise ValueError(
                "draft_params given but no draft-model proposer is "
                "configured (draft_mode='model:<name>')")
        new_params = self._place_params(params, cur_params)
        draft_new = (self._place(draft_params, spec.params)
                     if draft_params is not None else None)
        t_swap = time.perf_counter()
        with self._state_lock:
            # A concurrent higher-versioned push may have won meanwhile.
            if version is not None and int(version) <= \
                    self.weights_version:
                return self.weights_version
            self.params = new_params
            if draft_new is not None:
                spec.install_weights(draft_new)
            self.weights_version = (int(version) if version is not None
                                    else self.weights_version + 1)
            new_version = self.weights_version
        swap_s = time.perf_counter() - t_swap
        trie_flushed, tier_flushed = self._flush_stale_kv(new_version)
        total_s = time.perf_counter() - t0
        self._g_weights_version.set(new_version)
        self._c_weight_pushes.inc()
        self._h_weight_push.observe(total_s)
        with self._mlock:
            self.weight_pushes += 1
            # The stall decode pays: the wait for the dispatch in flight
            # plus the reference swap.
            self.last_swap_seconds = swap_s
        tl = self.trace.start(f"weights-v{new_version}")
        tl.event("push", version=new_version,
                 place_ms=round(1e3 * (t_swap - t0), 3),
                 draft=draft_new is not None)
        tl.event("swap", swap_ms=round(1e3 * swap_s, 3))
        if trie_flushed or tier_flushed:
            tl.event("flush", trie_entries=trie_flushed,
                     tier_entries=tier_flushed)
        tl.close()
        return new_version

    def _place_params(self, tree, reference):
        """:meth:`_place` of a pushed tree; a sharded or staged replica
        checks it whole against the serving tree's template, cuts it into
        its parts (``weights.replica_shards``: the stages' layers, the
        partition rules' shards) and places each like the part it
        replaces."""
        if not isinstance(reference, (TensorShards, PipelineStages)):
            return self._place(tree, reference)
        new = self._check_tree(tree, self._template)
        whole = _unflatten({p: tree_to_torch(t) for p, t in new.items()})
        return self._place_parts(
            replica_shards(whole, self.cfg, self.tp_shards, self.pp_stages),
            reference)

    def _place_parts(self, parts, reference):
        """The (stage, shard) trees of ``parts`` placed each like its
        part of ``reference``, or, with no reference, moved to its shard's
        device; the structure kept."""
        stages = parts if isinstance(parts, PipelineStages) else [parts]
        refs = (reference if isinstance(reference, PipelineStages)
                else [reference]) if reference is not None else None
        out = []
        for st, stage in enumerate(stages):
            shards = stage if isinstance(stage, TensorShards) else [stage]
            placed = []
            for t, part in enumerate(shards):
                if refs is None:
                    dev = self._stage_devices[st][t]
                    placed.append(_unflatten({p: v.to(dev) for p, v in
                                              flatten(part).items()}))
                else:
                    ref = refs[st]
                    placed.append(self._place(
                        part, ref[t] if isinstance(ref, TensorShards)
                        else ref))
            out.append(TensorShards(placed)
                       if isinstance(stage, TensorShards) else placed[0])
        return PipelineStages(out) if isinstance(parts, PipelineStages) \
            else out[0]

    @staticmethod
    def _check_tree(tree, reference) -> dict:
        """``tree`` flattened, once its paths and shapes are exactly
        ``reference``'s (``ValueError`` otherwise)."""
        ref = flatten(reference)
        new = flatten(tree) if isinstance(tree, dict) else None
        if new is None or set(new) != set(ref):
            missing = sorted(set(ref) - set(new or {}))
            extra = sorted(set(new or {}) - set(ref))
            raise ValueError(
                f"pushed tree does not match the serving tree: "
                f"missing={missing[:3]} extra={extra[:3]}")
        for path, o in ref.items():
            if tuple(np.shape(new[path])) != tuple(o.shape):
                raise ValueError(
                    f"pushed leaf {path} shape {tuple(np.shape(new[path]))}"
                    f" != serving shape {tuple(o.shape)}")
        return new

    @staticmethod
    def _place(tree, reference) -> dict:
        """``tree`` rebuilt on ``reference``'s structure, device and leaf
        dtypes, always as new tensors (never aliasing the caller's):
        shapes and paths must match exactly (``ValueError`` otherwise).
        On a CUDA device the copies run on a side stream; the current
        stream is made to wait for it, and each new tensor is recorded as
        used there, before the tree is handed back."""
        new = ContinuousDecoder._check_tree(tree, reference)
        ref = flatten(reference)
        dev = next(iter(ref.values())).device
        src = {p: tree_to_torch(new[p]) for p in ref}
        if dev.type != "cuda":
            return _unflatten({p: src[p].to(dev, ref[p].dtype, copy=True)
                               for p in ref})
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(current)  # device sources come from this stream
        with torch.cuda.stream(side):
            placed = {p: src[p].to(dev, ref[p].dtype, non_blocking=True,
                                   copy=True) for p in ref}
        current.wait_stream(side)
        side.synchronize()
        for t in placed.values():
            t.record_stream(current)
        return _unflatten(placed)

    def _flush_stale_kv(self, version: int) -> tuple[int, int]:
        """Drop K/V cached under an older weights epoch: unpinned stale
        trie entries are removed (their blocks freed; demotion skips
        them) and unpinned stale host-tier payloads discarded. Entries
        pinned by admissions in flight survive and are refused at their
        next match; PINNED tier payloads are suspended streams' state
        and straddle the swap by design."""
        trie_flushed = tier_flushed = 0
        with self._prefix_lock:
            if self.prefix_cache is not None:
                for entry in self.prefix_cache.entries():
                    if entry.version != version and entry.refs == 0:
                        self.prefix_cache.remove(entry)
                        trie_flushed += 1
            if self._host_tier is not None:
                for e in self._host_tier.entries():
                    if e.version != version and not e.pinned:
                        self._host_tier.discard(e.key)
                        tier_flushed += 1
        return trie_flushed, tier_flushed

    # -- QoS: ordering, deadline shedding, stream suspension -------------

    def _order_pending_locked(self, now: float) -> None:
        """Re-order the queue by the QoS policy (under the cv): weighted
        fair share across tenants (tokens served over weight, lowest
        first), then priority with starvation aging, then FIFO. The sort
        is stable."""
        qos = self.qos
        with self._mlock:
            served = dict(self._tenant_served)
        self._pending = deque(sorted(
            self._pending,
            key=lambda r: order_key(
                served=served.get(r.tenant, 0.0),
                weight=qos.spec(r.tenant).weight,
                priority=r.priority,
                waited_seconds=now - r.submit_t,
                aging_seconds=qos.aging_seconds,
                submit_t=r.submit_t)))

    def _shed_expired_locked(self, now: float) -> None:
        """Shed queued requests whose deadline has passed (under the
        cv): decode spent on an answer nobody waits for only starves the
        requests that still have time."""
        expired = [r for r in self._pending
                   if r.deadline_t is not None and now > r.deadline_t]
        if not expired:
            return
        dead = {id(r) for r in expired}
        self._pending = deque(r for r in self._pending
                              if id(r) not in dead)
        with self._mlock:
            self.qos_deadline_shed += len(expired)
        for r in expired:
            r.timeline.event("deadline_shed",
                             waited_ms=round(1e3 * (now - r.submit_t), 3))
            self._finish(r, error=DeadlineExceeded(
                f"deadline passed after {now - r.submit_t:.3f}s in queue"))

    def _pick_suspend_victim_locked(self, cand: _Request,
                                    need: int) -> int:
        """A live stream to SUSPEND so the memory-blocked ``cand`` can
        enter: the lowest-base-priority stream STRICTLY below the
        candidate's base priority, whose exported KV fits the host tier
        and whose blocks clear the candidate's watermark. Base priorities
        on both sides: aging orders the queue but never drives
        preemption (an aged equal-priority candidate would ping-pong one
        tenant's streams through the tier). Called with the cv and the
        prefix lock held. -1 when nothing qualifies: the round defers as
        without QoS."""
        if self.qos is None or self._host_tier is None:
            return -1
        victim, victim_p = -1, None
        for slot in range(self.slots):
            r = self._slot_req[slot]
            if r is None or r.want_left <= 0:
                continue
            if r.chunk_pos >= 0:
                # Mid-chain: a partial prompt that never decoded a
                # token; nothing to export, only work to throw away.
                continue
            if len(r.tokens) + len(r.out) - r.folded < 2:
                continue  # a 1-token sequence has no exportable prefix
            if r.priority >= cand.priority:
                continue
            if victim_p is None or r.priority < victim_p:
                victim, victim_p = slot, r.priority
        if victim < 0:
            return -1
        r = self._slot_req[victim]
        plen = len(r.tokens) + len(r.out) - r.folded - 1
        est = (self._alloc.blocks_for(plen) * self.kv_block_size
               * self._host_bytes_per_token)
        if not self._host_tier.can_fit(est):
            return -1  # never strand an unresumable stream
        freed = len(self._slot_blocks[victim])
        if self._alloc.free_blocks + freed - need < self.kv_low_watermark:
            return -1  # even suspending would not admit the candidate
        return victim

    def _suspend_stream(self, slot: int) -> None:
        """Park the live stream in ``slot``: retire its device row, export
        the KV of its sequence so far into the host tier (PINNED: the
        resume reads exactly those bytes), free the slot and its blocks,
        and queue the request again. The resume is an ordinary admission:
        the parked request's tokens now include what it emitted, so it
        prefix-hits the promoted payload and continues where it stopped.
        Runs on the scheduler thread with no lock held."""
        req = self._slot_req[slot]
        if req is None:
            return
        seq = req.tokens + req.out[req.folded:]
        plen = len(seq) - 1
        ids = self._slot_blocks[slot][: self._alloc.blocks_for(plen)]
        # Retire the row FIRST: the state is written in place, and a row
        # still active would scatter the next step's K/V through blocks
        # that go back to the pool below and may be handed on.
        with self._state_lock:
            retire_row(self._state, slot)
        payload = self._export_ids(ids)
        key = tuple(seq[:plen])
        with self._prefix_lock:
            parked = self._host_tier.put(key, payload, plen, pinned=True,
                                         version=req.weights_version)
        self._slot_req[slot] = None
        self._active_count -= 1
        self._release_pin(req)
        self._free_slot_blocks(slot)
        if parked:
            req.host_key = key
        elif len(seq) > self.prefill_len:
            # No host copy and too long to prefill again: it cannot
            # resume. (The victim pick checks can_fit; never park such a
            # request.)
            self._finish(req, error=MemoryError(
                "suspended stream lost its KV payload"))
            return
        req.tokens = seq
        req.folded = len(req.out)
        req.admit_plan = None
        req.submit_t = time.perf_counter()  # queue wait re-anchors here
        req.timeline.event("suspend", emitted=len(req.out), prefix_len=plen)
        with self._mlock:
            self.kv_suspends += 1
        with self._cv:
            if self._stopped:
                self._finish(req, error=RuntimeError("decoder stopped"))
                return
            self._pending.append(req)
            self._cv.notify()

    def _retire(self, req: _Request, slot: int) -> None:
        """A request's row is done: publish its prefix while the row is
        intact, release its pin and its blocks, free the slot."""
        self._publish_prefix(req, slot)
        self._release_pin(req)
        self._free_slot_blocks(slot)
        self._slot_req[slot] = None

    def _mark_admitted(self, req: _Request, slot: int) -> None:
        """The pop→slot transition: queue-wait histograms and the
        timeline's admitted event (memory deferrals stretch the wait). A
        resumed (suspended) request re-anchored its wait at the park, and
        its pinned host-tier payload becomes ordinary cache again."""
        wait = time.perf_counter() - req.submit_t
        self._h_queue_wait.observe(wait)
        self._h_tenant_wait.labels(tenant_bucket(req.tenant)).observe(wait)
        if req.out:
            if req.host_key is not None and self._host_tier is not None:
                with self._prefix_lock:
                    self._host_tier.unpin(req.host_key)
                req.host_key = None
            with self._mlock:
                self.kv_resumes += 1
            req.timeline.event("resume", emitted=len(req.out),
                               want_left=req.want_left)
        req.timeline.event("admitted", slot=slot,
                           wait_ms=round(1e3 * wait, 3))

    def _post_admit(self, req: _Request, slot: int) -> None:
        if req.want_left == 0:
            # Pure prefill (last-position logits only): the row went in
            # inactive; hand the result back now.
            self._retire(req, slot)
            self._finish(req)
        else:
            self._slot_req[slot] = req
            self._active_count += 1
            self.peak_in_flight = max(self.peak_in_flight,
                                      self._active_count)
            if self._spec is not None:
                self._spec.reset(slot)
                self._slot_k[slot] = self.speculative_k

    def _dispatch(self, toks: np.ndarray, emitted: np.ndarray) -> None:
        """Route one step's sampled tokens ([slots]) to their requests.
        EOS parking already happened on the device; the host finishes the
        request and frees the slot."""
        now = time.perf_counter()
        emitted_n, ttft_sum, ttft_n = 0, 0.0, 0
        tenant_tok: dict[str, int] = {}
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None or not emitted[slot]:
                continue
            tok = int(toks[slot])
            req.out.append(tok)
            tenant_tok[req.tenant] = tenant_tok.get(req.tenant, 0) + 1
            if req.ttft_s is None:
                req.ttft_s = now - req.submit_t
                ttft_sum += req.ttft_s
                ttft_n += 1
                self._h_ttft.observe(req.ttft_s)
                req.timeline.event("first_token")
            else:
                if req.last_emit_t is not None:
                    self._h_itl.observe(now - req.last_emit_t)
                req.timeline.event("dispatch", tokens=1)
            req.last_emit_t = now
            req.stream.put(tok)
            emitted_n += 1
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(req.out) >= req.want:
                self._retire(req, slot)
                self._active_count -= 1
                self._finish(req, reason="eos" if hit_eos else "length")
        with self._mlock:
            self.tokens_emitted += emitted_n
            self.ttft_sum += ttft_sum
            self.ttft_count += ttft_n
            for t, n in tenant_tok.items():
                self._tenant_served[t] = self._tenant_served.get(t, 0.0) + n

    def _loop(self) -> None:
        """Scheduler-thread entry: on ANY exit, fail every stream still
        live so no StreamHandle hangs out its timeout on a dead loop."""
        err: Exception = RuntimeError("decoder stopped")
        try:
            self._run()
        except Exception as e:
            err = e
        finally:
            self._fail_all(err)

    def _fail_all(self, err: Exception) -> None:
        with self._cv:
            self._stopped = True
            queued = list(self._pending)
            self._pending.clear()
        self._chunk_jobs.clear()
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is not None:
                self._slot_req[slot] = None
                # A mid-chain chunked admission holds a slot without
                # counting as active (its row is parked).
                if req.chunk_pos < 0:
                    self._active_count -= 1
                self._finish(req, error=err)
            self._free_slot_blocks(slot)
        for req in queued:
            self._finish(req, error=err)

    def _pop_admissions(self) -> tuple[list[tuple[_Request, int]], bool,
                                       int]:
        """Pop this round's admissions (caller holds the cv). Paged
        admission is memory-aware: a request enters only when its
        WORST-CASE block count fits the pool, so a stream can never run
        out of blocks mid-decode; its blocks are reserved here. The
        prefix plan runs first: a hit pins its entry (so reclaim cannot
        evict it) and shrinks the reservation to the unshared blocks,
        whose shared part is taken by refcount. A memory-blocked head may
        be bypassed by up to ``hol_bypass_limit`` later candidates that
        fit, until it has aged ``hol_shield_rounds`` blocked rounds; when
        the first blocked candidate outranks a live stream, that stream
        is chosen for SUSPENSION (with QoS and the host tier on).
        Returns (admissions, deferred, the slot to suspend or -1)."""
        pending: list[tuple[_Request, int]] = []
        deferred = False
        suspend_slot = -1
        free_slots = [s for s in range(self.slots)
                      if self._slot_req[s] is None]
        if self._alloc is None:
            # Dense: every slot owns a full row, so a free slot is enough.
            while free_slots and self._pending:
                req, slot = self._pending.popleft(), free_slots.pop(0)
                self._mark_admitted(req, slot)
                pending.append((req, slot))
            return pending, deferred, suspend_slot
        idx = 0
        bypassed = 0
        while free_slots and idx < len(self._pending):
            req = self._pending[idx]
            worst = self._alloc.blocks_for(
                max(len(req.tokens), 1) + req.want_left)
            if (worst > self._alloc.num_blocks
                    or len(req.tokens) + req.want_left > self.total_len):
                del self._pending[idx]
                with self._mlock:
                    self.prompt_rejected_too_long += 1
                self._finish(req, error=PromptTooLong(
                    f"request needs {worst} KV blocks ({len(req.tokens)} "
                    f"prompt + {req.want_left} new tokens) but the pool "
                    f"holds {self._alloc.num_blocks} blocks / "
                    f"{self.total_len} tokens"))
                continue
            plan = (self._plan_prefix(req)
                    if self.prefix_cache is not None else None)
            n_shared = (plan[1] // self.kv_block_size
                        if plan is not None else 0)
            need = worst - n_shared
            # A parked stream longer than the prefill width resumes only
            # through its exported prefix: without a plan it waits for
            # the promotion to find memory (chunked prefill lifts that
            # ceiling: any sequence within the row can prefill again).
            resumable = (plan is not None or self.prefill_chunk_tokens > 0
                         or len(req.tokens) <= self.prefill_len)
            with self._prefix_lock:
                self._reclaim_blocks(need, req.timeline)
                headroom = self._alloc.free_blocks - need
                busy = self._active_count > 0 or pending
                fits = resumable and headroom >= (
                    self.kv_low_watermark if busy else 0)
                if fits:
                    own = self._alloc.alloc(need)
                    shared = (list(plan[0].blocks[:n_shared])
                              if plan is not None else [])
                    for b in shared:
                        self._alloc.share(b)
                    self.kv_blocks_peak = max(self.kv_blocks_peak,
                                              self._alloc.blocks_in_use)
                else:
                    if plan is not None:
                        self.prefix_cache.release(plan[0])
                    if not deferred:
                        suspend_slot = self._pick_suspend_victim_locked(
                            req, need)
            if fits:
                req.admit_plan = plan
                req.defer_rounds = 0
                slot = free_slots.pop(0)
                # The TABLE row stays sentinel until this request's own
                # admission call uploads it: pointing it at the blocks now
                # would let an earlier fused decode step in the same round
                # write through it at the slot's stale length, into
                # refcount-shared prefix blocks among others.
                self._slot_blocks[slot] = shared + own
                del self._pending[idx]
                if bypassed:
                    with self._mlock:
                        self.hol_bypasses += 1
                self._mark_admitted(req, slot)
                pending.append((req, slot))
                continue
            deferred = True
            req.defer_rounds += 1
            req.timeline.event("deferred", need=need,
                               free=self._alloc.free_blocks)
            if req.defer_rounds >= self.hol_shield_rounds:
                break
            bypassed += 1
            if bypassed > self.hol_bypass_limit:
                break
            idx += 1
        return pending, deferred, suspend_slot

    def _run(self) -> None:
        while True:
            idled = False
            with self._cv:
                while (not self._stopped and not self._pending
                       and self._active_count == 0
                       and not self._chunk_jobs):
                    idled = True
                    self._cv.wait(timeout=0.5)
                if self._stopped:
                    return
                now = time.perf_counter()
                self._shed_expired_locked(now)
                if self.qos is not None and len(self._pending) > 1:
                    self._order_pending_locked(now)
                pending, deferred, suspend_slot = self._pop_admissions()
                if deferred:
                    with self._mlock:
                        self.kv_defer_admissions += 1
            if idled:
                # The ramp-streak cap must not outlive the burst that set
                # it: the next admission deserves its ramp round.
                self._ramp_streak = 0
            try:
                if suspend_slot >= 0:
                    # Preempt to the host: the victim was chosen under the
                    # cv; its export, a device round trip, runs here,
                    # outside it. The freed blocks admit the blocked
                    # candidate next round.
                    self._suspend_stream(suspend_slot)
                if pending:
                    # Admission fuses prefill + insert + one decode step,
                    # so a new request's first token ships with it. An
                    # admission round normally ends here; under sustained
                    # arrivals at most one consecutive admission-only
                    # round runs before a chunk runs in the same round.
                    if self.prefill_chunk_tokens:
                        # A suffix wider than one chunk leaves the
                        # one-call paths: it registers as a chunk job fed
                        # one chunk a round below.
                        short = []
                        for req, slot in pending:
                            plan = req.admit_plan
                            plen = plan[1] if plan is not None else 0
                            if (len(req.tokens) - plen
                                    > self.prefill_chunk_tokens):
                                self._begin_chunked(req, slot)
                            else:
                                short.append((req, slot))
                        pending = short
                    # With the prefix cache on, hits take suffix-only
                    # admissions (one call each), misses batch as before.
                    # Paged admissions were planned at pop time (the plan
                    # sized the reservation); dense ones probe the trie
                    # here.
                    misses = pending
                    if self.prefix_cache is not None:
                        hits, misses = [], []
                        for req, slot in pending:
                            plan = (req.admit_plan
                                    if self._alloc is not None
                                    else self._plan_prefix(req))
                            if plan is None:
                                with self._mlock:
                                    self.prefix_misses += 1
                                misses.append((req, slot))
                            else:
                                hits.append((req, slot, plan))
                        for req, slot, plan in hits:
                            self._admit_prefix(req, slot, *plan)
                    if misses:
                        self._admit_batch(misses)
                    ramp = (any(req.want_left for req, _ in pending)
                            and (self.chunk_size == 1
                                 or self._ramp_streak < 1))
                    if ramp:
                        self.ramp_rounds += 1
                        if self.chunk_size > 1:
                            self._ramp_streak += 1
                        # A ramp round still owes the oldest chunked
                        # admission its chunk.
                        self._advance_chunked()
                        continue
                self._advance_chunked()
                if self._active_count == 0:
                    continue
                if self._spec is not None and self._spec_round():
                    continue
                self._decode_round()
            except Exception as e:
                # A failed call may have left self._state half-written;
                # fail this round's unregistered admissions (returning
                # their blocks) and let _loop fail everything else.
                for req, slot in pending:
                    self._finish(req, error=e)
                    self._free_slot_blocks(slot)
                raise

    def _decode_round(self) -> None:
        steps = self.chunk_size
        self._h_occupancy.observe(self._active_count)
        t_disp = time.perf_counter()
        with self._state_lock:
            if steps > 1:
                self._state, toks, emitted = decode_chunk(
                    self._state, self.params, self.cfg, steps, self.top_k,
                    self.eos_id, self.kv_fused)
            else:
                self._state, tok, emit = decode_step(
                    self._state, self.params, self.cfg, self.top_k,
                    self.eos_id, self.kv_fused)
                toks, emitted = tok[None], emit[None]
            toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
        self._h_dispatch.labels("decode").observe(
            time.perf_counter() - t_disp)
        with self._mlock:
            self.steps += steps
            self.dispatches += 1
        self._ramp_streak = 0
        for k in range(steps):
            self._dispatch(toks[k], emitted[k])

    def _dispatch_block(self, toks: np.ndarray, emitted: np.ndarray) -> None:
        """Route one verify step's tokens ([slots, K+1], ``emitted`` a
        per-row prefix mask) to their requests: the multi-token sibling
        of :meth:`_dispatch`. The device already capped each row at its
        budget and cut it at EOS, so the mask is trusted as it is."""
        now = time.perf_counter()
        emitted_n, ttft_sum, ttft_n = 0, 0.0, 0
        tenant_tok: dict[str, int] = {}
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None or not emitted[slot, 0]:
                continue
            last_tok = None
            row_emitted = 0
            first_here = req.ttft_s is None
            for j in range(toks.shape[1]):
                if not emitted[slot, j]:
                    break
                last_tok = int(toks[slot, j])
                req.out.append(last_tok)
                if req.ttft_s is None:
                    req.ttft_s = now - req.submit_t
                    ttft_sum += req.ttft_s
                    ttft_n += 1
                    self._h_ttft.observe(req.ttft_s)
                    req.timeline.event("first_token")
                req.stream.put(last_tok)
                row_emitted += 1
            emitted_n += row_emitted
            tenant_tok[req.tenant] = (tenant_tok.get(req.tenant, 0)
                                      + row_emitted)
            if req.last_emit_t is not None:
                self._h_itl.observe(now - req.last_emit_t)
            req.last_emit_t = now
            if not first_here:
                req.timeline.event("dispatch", tokens=row_emitted)
            hit_eos = self.eos_id is not None and last_tok == self.eos_id
            if hit_eos or len(req.out) >= req.want:
                self._retire(req, slot)
                self._active_count -= 1
                self._finish(req, reason="eos" if hit_eos else "length")
        with self._mlock:
            self.tokens_emitted += emitted_n
            self.ttft_sum += ttft_sum
            self.ttft_count += ttft_n
            for t, n in tenant_tok.items():
                self._tenant_served[t] = self._tenant_served.get(t, 0.0) + n

    def _tune_slot(self, slot: int, accepted: int, drafted: int) -> None:
        """Shrink a slot's draft length while verification throws most of
        its drafts away (under half kept), grow it back one step per clean
        sweep."""
        if drafted <= 0:
            return
        if accepted * 2 < drafted:
            self._slot_k[slot] = max(1, self._slot_k[slot] - 1)
        elif accepted == drafted:
            self._slot_k[slot] = min(self.speculative_k,
                                     self._slot_k[slot] + 1)

    def _spec_round(self) -> bool:
        """One speculative round: proposals for every occupied slot,
        verified in ONE call (``chunk_size`` verify steps), the accepted
        tokens routed. Returns False, and the plain decode round runs,
        when no row has a draft (a verify without drafts pays two
        forwards for one token)."""
        steps, k_w = self.chunk_size, self.speculative_k
        asks = []
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is not None:
                # steps - 1 extra chain tokens: each verify step's commit
                # takes one, so the next step's slice starts after it.
                asks.append((slot, req.tokens + req.out,
                             steps * self._slot_k[slot] + steps - 1))
        props = self._spec.propose(asks)
        drafts = np.zeros((steps, self.slots, k_w), np.int32)
        dlens = np.zeros((steps, self.slots), np.int32)
        for slot, _ctx, _n in asks:
            prop = props.get(slot) or []
            req = self._slot_req[slot]
            budget = req.want - len(req.out)  # tokens the row may still emit
            off = 0
            for s in range(steps):
                if budget <= 0:
                    break
                # A step emits dlen accepted drafts + 1 commit: no more
                # drafts than the budget could emit.
                k_use = min(self._slot_k[slot], budget - 1)
                seg = prop[off: off + k_use]
                # Skip the token the commit emits between slices: under
                # full acceptance it IS the next chain token.
                off += len(seg) + 1
                budget -= len(seg) + 1
                if not seg:
                    break
                drafts[s, slot, : len(seg)] = seg
                dlens[s, slot] = len(seg)
        if not dlens.any():
            return False
        self._h_occupancy.observe(self._active_count)
        dev = self.device
        t_disp = time.perf_counter()
        with self._state_lock:
            self._state, outs, emits = verify_chunk(
                self._state, self.params, self.cfg,
                torch.from_numpy(drafts).to(dev),
                torch.from_numpy(dlens).to(dev), self.top_k, self.eos_id,
                self.kv_fused)
            outs, emits = outs.cpu().numpy(), emits.cpu().numpy()
        self._h_dispatch.labels("verify").observe(
            time.perf_counter() - t_disp)
        with self._mlock:
            self.dispatches += 1
            self.spec_verify_dispatches += 1
            self.steps += 2 * steps  # scoring + commit forward per verify
        self._ramp_streak = 0
        for s in range(steps):
            # Accounting before routing: routing may free the slot.
            drafted, accepted = 0, 0
            for slot in range(self.slots):
                d = int(dlens[s, slot])
                if d == 0 or self._slot_req[slot] is None:
                    continue
                m = int(emits[s, slot].sum())
                acc = min(max(m - 1, 0), d)
                drafted += d
                accepted += acc
                if m:
                    self._tune_slot(slot, acc, d)
            with self._mlock:
                self.spec_drafted_tokens += drafted
                self.spec_accepted_tokens += accepted
            self._dispatch_block(outs[s], emits[s])
        return True

    # ------------------------------------------------------------------

    def metrics(self) -> dict:
        """Every key of the JAX decoder's metrics() (the compile cache's
        read as JAX's do with the cache off), plus ``kv_layout``."""
        cache = self.prefix_cache
        with self._cv:
            queued = len(self._pending)
        with self._mlock:
            snap = {
                "decode_steps": self.steps,
                "decode_dispatches": self.dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "prefill_tokens": self.prefill_tokens,
                "prefill_chunks": self.prefill_chunks,
                "prompt_rejected_too_long": self.prompt_rejected_too_long,
                "max_prompt_len": self.max_prompt_len,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "requests_admitted": self.admitted,
                "ramp_rounds": self.ramp_rounds,
                "tokens_emitted": self.tokens_emitted,
                "ttft_avg_s": (self.ttft_sum / self.ttft_count
                               if self.ttft_count else 0.0),
                "trace_open": self.trace.open_count,
                "in_flight": self._active_count,
                "peak_in_flight": self.peak_in_flight,
                "queued": queued,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "prefix_suffix_tokens": self.prefix_suffix_tokens,
                "prefix_inserts": self.prefix_inserts,
                "kv_cow_copies": self.kv_cow_copies,
                "kv_shared_blocks": self.kv_shared_blocks,
                "kv_defer_admissions": self.kv_defer_admissions,
                "kv_handoff_exports": self.kv_handoff_exports,
                "kv_handoff_imports": self.kv_handoff_imports,
                "kv_handoff_tokens": self.kv_handoff_tokens,
                "kv_suspends": self.kv_suspends,
                "kv_resumes": self.kv_resumes,
                "kv_host_hits": self.kv_host_hits,
                "qos_deadline_shed": self.qos_deadline_shed,
                "hol_bypasses": self.hol_bypasses,
                "qos_enabled": self.qos is not None,
                "role": self.role,
                "weight_pushes": self.weight_pushes,
                "weights_stale_refused": self.weight_stale_refused,
                "weight_swap_seconds_last": self.last_swap_seconds,
                "tenant_served": dict(self._tenant_served),
                "spec_drafted_tokens": self.spec_drafted_tokens,
                "spec_accepted_tokens": self.spec_accepted_tokens,
                "spec_verify_dispatches": self.spec_verify_dispatches,
                "spec_draft_dispatches": (self._spec.dispatches
                                          if self._spec is not None else 0),
                "spec_acceptance_rate": (
                    self.spec_accepted_tokens / self.spec_drafted_tokens
                    if self.spec_drafted_tokens else 0.0),
                "spec_draft_k": (sum(self._slot_k) / len(self._slot_k)
                                 if self._slot_k else 0.0),
                "tp_shards": self.tp_shards,
                "cp_shards": self.cp_shards,
                "pp_stages": self.pp_stages,
                "kv_peer_hits": self.kv_peer_hits,
                "kv_peer_misses": self.kv_peer_misses,
                "kv_peer_import_bytes": self.kv_peer_import_bytes,
                "kv_peer_fetch_failures": self.kv_peer_fetch_failures,
                "kv_cold_hits": self.kv_cold_hits,
                "kv_cold_demotions": self.kv_cold_demotions,
                "kv_cold_import_bytes": self.kv_cold_import_bytes,
                "kv_import_stale_refused": self.kv_import_stale_refused,
                "kv_import_skipped_crossover":
                    self.kv_import_skipped_crossover,
                "kv_directory_publishes": self.kv_directory_publishes,
                "warming": self.warming,
                **_UNPORTED_METRICS,
            }
        with self._state_lock:
            snap["weights_version"] = self.weights_version
        # The dense layout has no block pool: its block and byte gauges
        # read 0, as in JAX.
        alloc = self._alloc
        tier = self._host_tier
        with self._prefix_lock:
            snap["prefix_evictions"] = cache.evictions if cache else 0
            snap["prefix_entries"] = len(cache) if cache else 0
            snap.update({
                "kv_layout": self.kv_layout,
                "kv_blocks_total": alloc.num_blocks if alloc else 0,
                "kv_blocks_in_use": alloc.blocks_in_use if alloc else 0,
                "kv_blocks_peak": self.kv_blocks_peak,
                "kv_block_size": self.kv_block_size if alloc else 0,
                "kv_dtype": self.kv_dtype if alloc else "fp",
                "kv_fused": self.kv_fused,
                "kv_bytes_per_token": alloc.bytes_per_token if alloc else 0,
                "kv_bytes_in_use": alloc.bytes_in_use if alloc else 0,
                "kv_bytes_total": alloc.bytes_total if alloc else 0,
                # The host tier: its second-chance cache plus the pinned
                # payloads of suspended streams.
                "kv_host_tier_bytes": tier.bytes_in_use if tier else 0,
                "kv_host_tier_bytes_total": (tier.capacity_bytes
                                             if tier else 0),
                "kv_host_tier_pinned_bytes": (tier.pinned_bytes
                                              if tier else 0),
                "kv_host_tier_entries": len(tier) if tier else 0,
                "kv_host_demotions": tier.demotions if tier else 0,
                "kv_host_evictions": tier.evictions if tier else 0,
                "kv_host_promotions": tier.promotions if tier else 0,
                "kv_host_tier_high_water_bytes": (tier.high_water_bytes
                                                  if tier else 0),
            })
        # The shared tiers carry their own leaf locks (other replicas'
        # probes touch them while this snapshot runs).
        if self.cold_store is not None:
            cold = self.cold_store.stats()
            snap["kv_cold_store_bytes"] = cold["bytes_in_use"]
            snap["kv_cold_store_bytes_total"] = cold["capacity_bytes"]
            snap["kv_cold_store_entries"] = cold["entries"]
            snap["kv_cold_store_evictions"] = cold["evictions"]
        if self.kv_directory is not None:
            snap["kv_directory_keys"] = self.kv_directory.stats()["keys"]
        for key, hist in (("ttft", self._h_ttft),
                          ("inter_token", self._h_itl),
                          ("queue_wait", self._h_queue_wait)):
            for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                snap[f"{key}_{tag}_s"] = hist.quantile(q)
        return snap
