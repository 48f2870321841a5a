"""Unified metrics: one registry, one Prometheus exposition renderer.

A copy of ``kubeflow_tpu/observability/metrics.py`` (standard library
only), kept in this package so the port imports nothing of the JAX one;
only this docstring differs. The model server's
``/monitoring/prometheus/metrics`` renders through it, and the training
loop's step-time distribution is its :class:`Histogram`.

Three instrument kinds, all thread-safe and optionally labeled:

- :class:`Counter` — monotone float/int, ``inc()``;
- :class:`Gauge` — settable value or a ``set_function`` sampled at
  render time;
- :class:`Histogram` — fixed log-spaced latency buckets by default,
  ``_bucket``/``_sum``/``_count`` exposition, and in-process quantile
  estimation (``quantile(0.99)``).

``render_prometheus(dict)`` (names ending ``_total`` typed counter,
everything else gauge) renders the decoder's counter snapshot.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Iterable

# Log-spaced latency bounds, 100 microseconds to 100 seconds, four per
# decade — wide enough for a sub-ms decode dispatch and a minute-long
# straggler request to land in *interior* buckets of the same family.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = tuple(
    round(1e-4 * 10 ** (i / 4), 10) for i in range(25)
)


def escape_label_value(value) -> str:
    """Escape a label value per the exposition format (backslash, quote,
    newline) — the reason free-form strings (model names, error text) are
    safe to use as labels."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def type_line(name: str, kind: str) -> str:
    """The ``# TYPE`` header for a family. Exported so tests and tools can
    assert on exposition output without duplicating the literal — keeping
    this module the only place in the tree that spells the text format."""
    return f"# TYPE {name} {kind}\n"


def _fmt(value) -> str:
    if isinstance(value, float):
        return f"{value:.6f}"
    return str(value)


def _fmt_bound(bound: float) -> str:
    return format(bound, ".6g")


def _label_str(names: tuple[str, ...], values: tuple[str, ...],
               extra: str = "") -> str:
    pairs = [f'{n}="{escape_label_value(v)}"'
             for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(metrics: dict) -> str:
    """Render name→value pairs in Prometheus exposition format.

    Names ending in ``_total`` are typed ``counter``, everything else
    ``gauge`` — the shared rendering rule for every dict-shaped exporter
    in the platform, so there is exactly one place that knows the text
    format."""
    out = []
    for name, value in metrics.items():
        kind = "counter" if name.endswith("_total") else "gauge"
        out.append(f"{type_line(name, kind)}{name} {_fmt(value)}\n")
    return "".join(out)


class Counter:
    """Monotonically increasing value. ``inc`` with a negative amount
    raises — a counter that goes down is a gauge wearing a disguise."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: float = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Settable value, or a callback sampled at render time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: float = 0
        self._fn: Callable[[], float] | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._fn = None

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Sample ``fn`` at every read — the render-time source for values
        that already live somewhere (queue lengths, pool occupancy)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        return fn()


class Histogram:
    """Fixed-bucket histogram with cumulative exposition and in-process
    quantile estimation.

    Buckets are *upper bounds* (strictly increasing); an implicit +Inf
    bucket catches the overflow. ``observe`` is a lock + bisect — cheap
    enough for per-token hot paths. Usable standalone (the train loop's
    step-time histogram) or through a :class:`MetricRegistry` family.
    """

    def __init__(self, buckets: Iterable[float] | None = None) -> None:
        bounds = tuple(sorted(set(buckets if buckets is not None
                                  else DEFAULT_LATENCY_BUCKETS)))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    @property
    def bounds(self) -> tuple[float, ...]:
        return self._bounds

    def observe(self, value: float) -> None:
        idx = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """(cumulative counts per bound + the +Inf total, sum, count) —
        one consistent view, the render/lint unit."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total = self._sum, self._count
        cumulative = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return cumulative, total_sum, total

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

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


class _Family:
    """One named metric family: kind + label names + children per label
    tuple. Unlabeled families proxy the instrument methods directly, so
    ``registry.counter("x_total").inc()`` needs no ``.labels()`` hop."""

    def __init__(self, name: str, kind: str, help_text: str,
                 labelnames: tuple[str, ...], factory: Callable) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = labelnames
        self._factory = factory
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(key)} label values for "
                f"{len(self.labelnames)} label names {self.labelnames}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._factory()
                self._children[key] = child
            return child

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # Unlabeled conveniences (delegate to the single anonymous child).
    def inc(self, amount: float = 1) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self.labels().set_function(fn)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def quantile(self, q: float) -> float:
        return self.labels().quantile(q)

    @property
    def value(self):
        return self.labels().value


class MetricRegistry:
    """Thread-safe family registry + the exposition renderer.

    Re-registering a name returns the existing family (so any module can
    say ``registry.counter("x_total")`` without ordering constraints);
    re-registering with a different kind or label set raises — the scrape
    contract for a name must be stable."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help_text: str,
                labels: Iterable[str], factory: Callable) -> _Family:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{labelnames}, but exists as {fam.kind}"
                        f"{fam.labelnames}")
                return fam
            fam = _Family(name, kind, help_text, labelnames, factory)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = "",
                labels: Iterable[str] = ()) -> _Family:
        return self._family(name, "counter", help_text, labels, Counter)

    def gauge(self, name: str, help_text: str = "",
              labels: Iterable[str] = ()) -> _Family:
        return self._family(name, "gauge", help_text, labels, Gauge)

    def histogram(self, name: str, help_text: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] | None = None) -> _Family:
        bounds = (tuple(buckets) if buckets is not None
                  else DEFAULT_LATENCY_BUCKETS)
        return self._family(name, "histogram", help_text, labels,
                            lambda: Histogram(bounds))

    def render(self) -> str:
        """Full exposition for every family: ``# HELP``/``# TYPE`` once
        per family, then every child's samples, label values escaped."""
        with self._lock:
            families = list(self._families.values())
        out: list[str] = []
        for fam in families:
            if fam.help:
                out.append(f"# HELP {fam.name} "
                           f"{escape_label_value(fam.help)}\n")
            out.append(type_line(fam.name, fam.kind))
            for key, child in fam.children():
                labels = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    cumulative, total_sum, total = child.snapshot()
                    bounds = [*map(_fmt_bound, child.bounds), "+Inf"]
                    for le, cum in zip(bounds, cumulative):
                        lstr = _label_str(fam.labelnames, key,
                                          extra=f'le="{le}"')
                        out.append(f"{fam.name}_bucket{lstr} {cum}\n")
                    out.append(f"{fam.name}_sum{labels} "
                               f"{_fmt(total_sum)}\n")
                    out.append(f"{fam.name}_count{labels} {total}\n")
                else:
                    out.append(f"{fam.name}{labels} "
                               f"{_fmt(child.value)}\n")
        return "".join(out)
