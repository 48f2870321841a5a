"""Dynamic batcher.

A copy of ``kubeflow_tpu/serving/batcher.py`` (pure host logic, no JAX),
kept in this package so the port imports nothing of the JAX one.
Requests queue up to ``batch_timeout_ms`` or until the server batch
fills, then run as one device call (``InferenceEngine.predict_batch``).

``batch_timeout_ms`` is a batch-START deadline, not a per-get wait: the
window runs from the moment the batch's oldest member was SUBMITTED, so
time an item spent queued behind a previous batch's predict counts
against it — an already-expired deadline flushes whatever is queued right
now instead of holding the line another full window. ``stop()`` drains:
the loop keeps predicting until the queue is empty, and anything still
queued after the join fails fast with an error rather than leaving its
waiter to hit the collect timeout.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class _Pending:
    instance: dict
    submitted: float = field(default_factory=time.monotonic)
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Exception | None = None


class DynamicBatcher:
    def __init__(
        self,
        predict_batch: Callable[[list[dict]], list[dict]],
        batch_size: int,
        batch_timeout_ms: float = 5.0,
    ):
        self._predict = predict_batch
        self._batch_size = batch_size
        self._timeout = batch_timeout_ms / 1000.0
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return  # queue drained: stop() can join
                continue
            batch = [first]
            # Deadline anchored at the oldest member's SUBMIT time: an
            # item that already waited out the window behind a previous
            # batch flushes immediately (with whatever else is queued).
            deadline = first.submitted + self._timeout
            while len(batch) < self._batch_size and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                try:
                    # Cap each wait so a stop() mid-window is honored
                    # promptly; remaining <= 0 degrades to a non-blocking
                    # drain of what's already queued.
                    batch.append(
                        self._queue.get(timeout=min(max(remaining, 0.0),
                                                    0.05))
                    )
                except queue.Empty:
                    if remaining <= 0:
                        break
            try:
                results = self._predict([p.instance for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # surfaced to every waiter in the batch
                for p in batch:
                    p.error = e
            for p in batch:
                p.event.set()

    def submit_async(self, instance: dict) -> _Pending:
        """Enqueue without waiting — lets a caller enqueue a whole request's
        instances first so they coalesce into full batches, then collect."""
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        p = _Pending(instance)
        self._queue.put(p)
        return p

    @staticmethod
    def collect(p: _Pending, timeout: float = 30.0) -> dict:
        if not p.event.wait(timeout):
            raise TimeoutError("predict timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def submit(self, instance: dict, timeout: float = 30.0) -> dict:
        return self.collect(self.submit_async(instance), timeout)

    def stop(self) -> None:
        """Stop accepting work, drain the queue (the loop predicts what it
        can; the backstop below errors the rest), and join the thread."""
        self._stop.set()
        self._thread.join(timeout=5)
        err = RuntimeError("batcher stopped")
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = err
            p.event.set()
