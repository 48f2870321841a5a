"""Overlapped training input pipeline; a copy of the JAX-free
``kubeflow_tpu/train/prefetch.py``.

The synchronous loop pays host batch synthesis AND the host→device copy
(``place_batch``) between every step — input stall that "Exploring the
limits of Concurrency in ML Training on Google TPUs" identifies as a
dominant non-compute loss. :class:`Prefetcher`
moves that work onto a producer thread: while step N's dispatched
computation runs, the producer synthesizes batch N+k and places it on
device, so the consumer's ``next()`` usually finds a device-resident
batch already waiting.

Contracts the overlap must not break (all pinned in tests):

- **Order/byte identity.** A single producer pulls the wrapped stream
  in order; the consumer sees exactly the synchronous sequence —
  data-exact resume stays stateless in ``(seed, step)``.
- **No collectives.** The producer thread only synthesizes and copies;
  it never enters a cross-process collective.
- **Clean shutdown.** ``close()`` stops the producer even when it is
  blocked on a full queue (loop exit, preemption, exception); a
  producer-side exception surfaces on the consumer's next ``next()``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

_DONE = object()  # stream exhausted


class Prefetcher:
    """Bounded background producer over a host-batch iterator.

    ``depth`` bounds host+device memory: at most ``depth`` placed
    batches wait in the queue (plus one in the producer's hands).
    ``host_wait_s`` accumulates consumer time blocked on the queue —
    the residual input stall the overlap could not hide.
    """

    def __init__(self, stream: Iterator, place: Callable | None, *,
                 depth: int = 2, name: str = "prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.host_wait_s = 0.0
        self.batches = 0
        self._stream = stream
        self._place = place
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, name=name, daemon=True)
        self._thread.start()

    # -- producer side --------------------------------------------------

    def _produce(self) -> None:
        try:
            for batch in self._stream:
                if self._place is not None:
                    batch = self._place(batch)
                if not self._put(batch):
                    return  # closed while we were blocked on a full queue
            self._put(_DONE)
        except BaseException as e:  # re-raised on the consumer side
            self._put(e)

    def _put(self, item) -> bool:
        """Enqueue, polling the stop flag so close() always unblocks."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side --------------------------------------------------

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        t0 = time.perf_counter()
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "prefetch producer died without a result")
        self.host_wait_s += time.perf_counter() - t0
        if item is _DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        self.batches += 1
        return item

    def qsize(self) -> int:
        """Batches ready right now (observability; racy by nature)."""
        return self._queue.qsize()

    # -- lifecycle ------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the producer and join it. Idempotent; safe mid-stream
        (preemption), after exhaustion, and after a consumer exception."""
        self._stop.set()
        # Drain so a producer blocked on put() observes the stop promptly.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
