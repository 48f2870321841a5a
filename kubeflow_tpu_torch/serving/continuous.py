"""Continuous-batching decode service with per-token streaming.

Counterpart of ``kubeflow_tpu/serving/continuous.py`` for the paged KV
layout: a persistent decode state holds up to ``slots`` in-flight
sequences over a shared block pool, a round's admissions are prefilled
together in one power-of-two-bucketed batch fused with one decode step
(``paged_admit_rows_and_step``), and every later round runs one decode
step (``decode_step``) or ``chunk_size`` of them (``decode_chunk``) for all
slots. Admission is memory-aware: a request enters only when its
worst-case block count fits the pool, and a finished row frees its slot
and blocks at once. Tokens surface through per-request queues as each
step's sample lands.

Options of features not yet ported (prefix cache, speculation, QoS, host
KV tier, chunked prefill, tensor/context/pipeline parallelism, fleet
roles, the KV directory and cold store, the dense layout) raise
``ValueError`` at construction; none falls through to another behaviour.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeflow_tpu_torch.models.decode import (
    decode_chunk,
    decode_step,
    init_paged_state,
    paged_admit_rows_and_step,
)
from kubeflow_tpu_torch.serving.engine import pow2_bucket
from kubeflow_tpu_torch.serving.kv_allocator import (
    BlockAllocator,
    kv_bytes_per_token,
)

_DONE = object()


class PromptTooLong(ValueError):
    """Terminal admission error: the request cannot be served by this
    replica at all (more KV blocks than the pool holds, or tokens plus
    budget beyond the virtual row), so deferring would wait forever. The
    model server maps this to HTTP 413."""


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


def _reject_unported(**options) -> None:
    for name, on in options.items():
        if on:
            raise ValueError(f"{name} is not yet ported to the PyTorch "
                             "package")


class ContinuousDecoder:
    """Owns the device decode state and the scheduler thread.

    ``prefill_len`` fixes the prompt shape (prompts are right-padded to
    it); ``slots`` is the decode concurrency; the virtual row is
    ``prefill_len + max_new_tokens`` positions. The device is the
    parameters' device."""

    def __init__(self, params, cfg, *, slots: int, prefill_len: int,
                 max_new_tokens: int, top_k: int = 0,
                 eos_id: int | None = None, seed: int = 0,
                 chunk_size: int = 1, prefix_cache_slots: int = 0,
                 prefill_len_buckets: int = 0, speculative_k: int = 0,
                 kv_layout: str = "dense", kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, kv_low_watermark: int = 0,
                 kv_dtype: str = "fp", kv_fused: bool = False,
                 stream_timeout_s: float = 60.0, role: str = "",
                 tp_shards: int = 1, qos=None, host_kv_bytes: int = 0,
                 hol_bypass_limit: int = 4, hol_shield_rounds: int = 8,
                 prefill_chunk_tokens: int = 0, max_prompt_len: int = 0,
                 cp_shards: int = 1, pp_stages: int = 1,
                 kv_directory=None, cold_store=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        _reject_unported(
            kv_layout_dense=kv_layout == "dense",
            prefix_cache_slots=prefix_cache_slots > 0,
            speculative_k=speculative_k > 0,
            qos=qos is not None,
            host_kv_bytes=host_kv_bytes > 0,
            prefill_chunk_tokens=prefill_chunk_tokens > 0,
            tp_shards=tp_shards > 1,
            cp_shards=cp_shards > 1,
            pp_stages=pp_stages > 1,
            role=bool(role),
            kv_directory=kv_directory is not None,
            cold_store=cold_store is not None,
        )
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.max_prompt_len = int(max_prompt_len) or prefill_len
        if self.max_prompt_len != prefill_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} must equal "
                f"prefill_len {prefill_len} (longer prompts need chunked "
                "prefill, which is not yet ported)")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["kernel"].device
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
        self.kv_block_size = max(1, int(kv_block_size))
        if self.total_len % self.kv_block_size:
            raise ValueError(
                f"kv_block_size {self.kv_block_size} must divide "
                f"max_prompt_len + max_new_tokens = {self.total_len}")
        mb = self.total_len // self.kv_block_size
        # 0 = worst-case parity with a dense reservation: the pool can back
        # every slot at full length.
        num_blocks = int(kv_pool_blocks) or slots * mb
        if num_blocks < mb:
            raise ValueError(
                f"kv_pool_blocks {num_blocks} cannot back even one "
                f"worst-case sequence ({mb} blocks)")
        self._alloc = BlockAllocator(
            num_blocks, self.kv_block_size,
            bytes_per_token=kv_bytes_per_token(
                cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                torch.empty((), dtype=cfg.dtype).element_size(), kv_dtype))
        self._max_blocks_per_seq = mb
        # Host mirror of the device block table; sentinel ``num_blocks``
        # marks unallocated entries (writes through them are dropped).
        self._table = np.full((slots, mb), num_blocks, np.int32)
        self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        self._state = init_paged_state(cfg, slots, num_blocks,
                                       self.kv_block_size, mb, seed,
                                       kv_dtype=kv_dtype, device=self.device)
        self.kv_low_watermark = max(0, int(kv_low_watermark))
        # Head-of-line bypass: how many memory-blocked candidates a round
        # may skip looking for a smaller request that fits, and how many
        # blocked rounds shield a head from further bypass.
        self.hol_bypass_limit = max(0, int(hol_bypass_limit))
        self.hol_shield_rounds = max(1, int(hol_shield_rounds))
        # Serializes device access to self._state.
        self._state_lock = threading.Lock()
        # Guards the allocator and the slots' block lists.
        self._alloc_lock = threading.Lock()
        self._slot_req: list[_Request | None] = [None] * slots
        self._active_count = 0
        self._pending: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self.tokens_emitted = 0
        self.steps = 0       # device decode steps (incl. masked chunk tail)
        self.dispatches = 0  # decode rounds
        self.prefill_dispatches = 0
        self.admitted = 0
        self.prefill_tokens = 0
        self.prompt_rejected_too_long = 0
        self.ramp_rounds = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        self.kv_defer_admissions = 0
        self.hol_bypasses = 0
        self.kv_blocks_peak = 0
        self.peak_in_flight = 0
        # Counter mutations and metrics() reads go through this leaf lock.
        self._mlock = threading.Lock()
        self._ramp_streak = 0  # consecutive admission-only rounds
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float = 0.0) -> StreamHandle:
        if len(tokens) > self.max_prompt_len:
            with self._mlock:
                self.prompt_rejected_too_long += 1
            raise PromptTooLong(
                f"prompt is {len(tokens)} tokens but this replica serves "
                f"at most {self.max_prompt_len} (max_prompt_len)")
        # Out-of-range ids would fault the device's embedding gather
        # (JAX clamps them); reject them at the door.
        if any(t < 0 or t >= self.cfg.vocab_size for t in tokens):
            raise ValueError(
                f"token ids must lie in [0, {self.cfg.vocab_size})")
        req = _Request(tokens=list(tokens),
                       want=min(max_new_tokens, self.max_new_tokens),
                       temperature=float(temperature))
        with self._cv:
            if self._stopped:
                raise RuntimeError("decoder is stopped")
            self._pending.append(req)
            self._cv.notify()
        return StreamHandle(req, self.stream_timeout_s)

    def generate(self, tokens: list[int], max_new_tokens: int,
                 temperature: float = 0.0,
                 timeout: float | None = None) -> dict:
        return self.submit(tokens, max_new_tokens,
                           temperature).result(timeout)

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
        req.error = error
        req.finish_reason = reason if error is None else "error"
        req.stream.put(_DONE)
        req.done.set()

    def _set_table_row(self, slot: int, blocks: list[int]) -> None:
        """Point ``slot``'s host block-table row at ``blocks`` (sentinel
        beyond them); uploaded to the device at the next admission."""
        self._table[slot, :] = self._alloc.num_blocks
        self._table[slot, : len(blocks)] = blocks

    def _free_slot_blocks(self, slot: int) -> None:
        """Return a retiring slot's blocks to the allocator. Idempotent."""
        with self._alloc_lock:
            blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
            for b in blocks:
                self._alloc.free(b)
            if blocks:
                self._table[slot, :] = self._alloc.num_blocks

    def _admit_batch(self, pending: list[tuple[_Request, int]]) -> None:
        """Admit a round's pending requests in ONE call that fuses
        prefill, state insert and one decode step. The batch is padded to
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
        with self._state_lock:
            # Table rows go live only now, under this call, which also
            # sets the rows' device length/active.
            for req, slot in pending:
                self._set_table_row(slot, self._slot_blocks[slot])
            self._state["block_table"].copy_(torch.from_numpy(self._table))
            self._state, last, tok, emit = paged_admit_rows_and_step(
                self._state, self.params, self.cfg,
                torch.from_numpy(slots).to(dev),
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(wants).to(dev),
                torch.from_numpy(temps).to(dev), self.top_k, self.eos_id,
                self.kv_fused)
            tok_np, emit_np = tok.cpu().numpy(), emit.cpu().numpy()
        with self._mlock:
            self.prefill_dispatches += 1
            self.admitted += k
            self.prefill_tokens += sum(len(req.tokens) for req, _ in pending)
        for i, (req, slot) in enumerate(pending):
            req.prefill_src = (last, i)
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

    def _post_admit(self, req: _Request, slot: int) -> None:
        if req.want_left == 0:
            # Pure prefill (last-position logits only): the row went in
            # inactive; hand the result back now.
            self._free_slot_blocks(slot)
            self._slot_req[slot] = None
            self._finish(req)
        else:
            self._slot_req[slot] = req
            self._active_count += 1
            self.peak_in_flight = max(self.peak_in_flight,
                                      self._active_count)

    def _dispatch(self, toks: np.ndarray, emitted: np.ndarray) -> None:
        """Route one step's sampled tokens ([slots]) to their requests.
        EOS parking already happened on the device; the host finishes the
        request and frees the slot."""
        now = time.perf_counter()
        emitted_n, ttft_sum, ttft_n = 0, 0.0, 0
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None or not emitted[slot]:
                continue
            tok = int(toks[slot])
            req.out.append(tok)
            if req.ttft_s is None:
                req.ttft_s = now - req.submit_t
                ttft_sum += req.ttft_s
                ttft_n += 1
            req.stream.put(tok)
            emitted_n += 1
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(req.out) >= req.want:
                self._free_slot_blocks(slot)
                self._slot_req[slot] = None
                self._active_count -= 1
                self._finish(req, reason="eos" if hit_eos else "length")
        with self._mlock:
            self.tokens_emitted += emitted_n
            self.ttft_sum += ttft_sum
            self.ttft_count += ttft_n

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
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is not None:
                self._slot_req[slot] = None
                self._active_count -= 1
                self._finish(req, error=err)
            self._free_slot_blocks(slot)
        for req in queued:
            self._finish(req, error=err)

    def _pop_admissions(self) -> tuple[list[tuple[_Request, int]], bool]:
        """Memory-aware admission (caller holds the cv): a request enters
        only when its WORST-CASE block count fits the pool, so a stream
        can never run out of blocks mid-decode; its blocks are reserved
        here. A memory-blocked head may be bypassed by up to
        ``hol_bypass_limit`` later candidates that fit, until it has aged
        ``hol_shield_rounds`` blocked rounds. Returns (admissions,
        deferred)."""
        pending: list[tuple[_Request, int]] = []
        deferred = False
        free_slots = [s for s in range(self.slots)
                      if self._slot_req[s] is None]
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
            with self._alloc_lock:
                headroom = self._alloc.free_blocks - worst
                busy = self._active_count > 0 or pending
                fits = headroom >= (self.kv_low_watermark if busy else 0)
                if fits:
                    own = self._alloc.alloc(worst)
                    self.kv_blocks_peak = max(self.kv_blocks_peak,
                                              self._alloc.blocks_in_use)
            if fits:
                req.defer_rounds = 0
                slot = free_slots.pop(0)
                # The TABLE row stays sentinel until this request's own
                # admission call uploads it: pointing it at the blocks now
                # would let an earlier fused decode step in the same round
                # write through it at the slot's stale length.
                self._slot_blocks[slot] = own
                del self._pending[idx]
                if bypassed:
                    with self._mlock:
                        self.hol_bypasses += 1
                pending.append((req, slot))
                continue
            deferred = True
            req.defer_rounds += 1
            if req.defer_rounds >= self.hol_shield_rounds:
                break
            bypassed += 1
            if bypassed > self.hol_bypass_limit:
                break
            idx += 1
        return pending, deferred

    def _run(self) -> None:
        while True:
            idled = False
            with self._cv:
                while (not self._stopped and not self._pending
                       and self._active_count == 0):
                    idled = True
                    self._cv.wait(timeout=0.5)
                if self._stopped:
                    return
                pending, deferred = self._pop_admissions()
                if deferred:
                    with self._mlock:
                        self.kv_defer_admissions += 1
            if idled:
                # The ramp-streak cap must not outlive the burst that set
                # it: the next admission deserves its ramp round.
                self._ramp_streak = 0
            try:
                if pending:
                    # Admission fuses prefill + insert + one decode step,
                    # so a new request's first token ships with it. An
                    # admission round normally ends here; under sustained
                    # arrivals at most one consecutive admission-only
                    # round runs before a chunk runs in the same round.
                    self._admit_batch(pending)
                    ramp = (any(req.want_left for req, _ in pending)
                            and (self.chunk_size == 1
                                 or self._ramp_streak < 1))
                    if ramp:
                        self.ramp_rounds += 1
                        if self.chunk_size > 1:
                            self._ramp_streak += 1
                        continue
                if self._active_count == 0:
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
        with self._mlock:
            self.steps += steps
            self.dispatches += 1
        self._ramp_streak = 0
        for k in range(steps):
            self._dispatch(toks[k], emitted[k])

    # ------------------------------------------------------------------

    def metrics(self) -> dict:
        with self._cv:
            queued = len(self._pending)
        with self._mlock:
            snap = {
                "decode_steps": self.steps,
                "decode_dispatches": self.dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "prefill_tokens": self.prefill_tokens,
                "prompt_rejected_too_long": self.prompt_rejected_too_long,
                "requests_admitted": self.admitted,
                "ramp_rounds": self.ramp_rounds,
                "tokens_emitted": self.tokens_emitted,
                "ttft_avg_s": (self.ttft_sum / self.ttft_count
                               if self.ttft_count else 0.0),
                "in_flight": self._active_count,
                "peak_in_flight": self.peak_in_flight,
                "queued": queued,
                "kv_defer_admissions": self.kv_defer_admissions,
                "hol_bypasses": self.hol_bypasses,
            }
        with self._alloc_lock:
            snap.update({
                "kv_blocks_total": self._alloc.num_blocks,
                "kv_blocks_in_use": self._alloc.blocks_in_use,
                "kv_blocks_peak": self.kv_blocks_peak,
                "kv_block_size": self.kv_block_size,
                "kv_dtype": self.kv_dtype,
                "kv_fused": self.kv_fused,
                "kv_bytes_per_token": self._alloc.bytes_per_token,
                "kv_bytes_in_use": self._alloc.bytes_in_use,
                "kv_bytes_total": self._alloc.bytes_total,
            })
        return snap
