"""Observability instruments; a copy of the ``Histogram`` of the JAX-free
``kubeflow_tpu/observability/metrics.py``, cut to what the training loop's
step-time distribution reads (``observe`` and ``quantile``). The registry,
the exposition and the histogram's snapshot come with the serving metrics.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable

# Log-spaced latency bounds, 100 microseconds to 100 seconds, four per
# decade — wide enough for a sub-ms decode dispatch and a minute-long
# straggler request to land in *interior* buckets of the same family.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = tuple(
    round(1e-4 * 10 ** (i / 4), 10) for i in range(25)
)


class Histogram:
    """Fixed-bucket histogram with in-process quantile estimation.

    Buckets are *upper bounds* (strictly increasing); an implicit +Inf
    bucket catches the overflow. ``observe`` is a lock + bisect — cheap
    enough for per-step hot paths.
    """

    def __init__(self, buckets: Iterable[float] | None = None) -> None:
        bounds = tuple(sorted(set(buckets if buckets is not None
                                  else DEFAULT_LATENCY_BUCKETS)))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf overflow
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by linear interpolation within
        the bucket holding the target rank — the promql
        ``histogram_quantile`` estimate, computed in-process."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        lower = 0.0
        for bound, c in zip(self._bounds, counts[:-1]):
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lower + (bound - lower) * frac
            cum += c
            lower = bound
        # Rank falls in the +Inf bucket: the top finite bound is the best
        # (under-)estimate available.
        return self._bounds[-1]
