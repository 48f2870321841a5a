"""Request-scoped tracing: ``X-Request-ID`` propagation + stream timelines.

A copy of ``kubeflow_tpu/observability/tracing.py`` (standard library
only), kept in this package so the port imports nothing of the JAX one;
only this docstring differs. The model server echoes (or mints) the
request id and threads it into the continuous decoder, which records
each stream's lifecycle as a :class:`Timeline` — submit → queued →
admitted → prefill (or a chunked admission's chunks) → first token →
per-dispatch emissions → finish/error. Timelines land in a bounded
:class:`TraceStore` served at ``/debug/requests`` (JSON, or
``?format=chrome`` for a trace-event file); the span durations of a
closed timeline sum to its submit→finish wall time.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque

REQUEST_ID_HEADER = "X-Request-ID"


def gen_request_id() -> str:
    """A fresh request id (uuid4, 16 hex chars — log-greppable, collision
    odds irrelevant at ring-buffer lifetimes)."""
    return uuid.uuid4().hex[:16]


class Timeline:
    """Ordered (name, t, attrs) events for one request, t relative to
    creation. Closed timelines are immutable; ``close`` is idempotent and
    always lands the terminal event (the event cap never blocks it), so a
    closed timeline's span sum equals its duration by construction."""

    def __init__(self, request_id: str, *, max_events: int = 96,
                 on_close=None) -> None:
        self.request_id = request_id
        self.start_wall = time.time()
        self.start = time.perf_counter()
        self.status: str | None = None  # None = still open
        self.error: str | None = None
        self._events: list[tuple[str, float, dict]] = []
        self._dropped = 0
        self._max_events = max_events
        self._lock = threading.Lock()
        self._on_close = on_close

    @property
    def open(self) -> bool:
        with self._lock:
            return self.status is None

    def event(self, name: str, **attrs) -> None:
        t = time.perf_counter() - self.start
        with self._lock:
            if self.status is not None:
                return
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append((name, t, attrs))

    def close(self, status: str = "ok",
              error: BaseException | str | None = None) -> None:
        t = time.perf_counter() - self.start
        with self._lock:
            if self.status is not None:
                return
            attrs = {"error": str(error)} if error is not None else {}
            self._events.append(
                ("error" if error is not None else "finish", t, attrs))
            self.status = "error" if error is not None else status
            self.error = str(error) if error is not None else None
        if self._on_close is not None:
            self._on_close(self)

    def events(self) -> list[tuple[str, float, dict]]:
        with self._lock:
            return list(self._events)

    def spans(self) -> list[dict]:
        """Phase spans between consecutive events: span *i* is named by
        the event that ends it. Their durations tile first→last event, so
        ``sum(durations) == duration_s`` for a closed timeline."""
        events = self.events()
        out = []
        for (_, t0, _a), (name, t1, attrs) in zip(events, events[1:]):
            out.append({"name": name, "start_s": t0,
                        "duration_s": t1 - t0, **attrs})
        return out

    @property
    def duration_s(self) -> float:
        events = self.events()
        if len(events) < 2:
            return 0.0
        return events[-1][1] - events[0][1]

    def to_dict(self) -> dict:
        # One consistent snapshot: /debug/requests renders on an HTTP
        # thread while the decoder closes the timeline — status, error
        # and the drop count must come from the same moment.
        with self._lock:
            status = self.status
            error = self.error
            dropped = self._dropped
        events = self.events()
        return {
            "request_id": self.request_id,
            "start_unix": self.start_wall,
            "status": status or "open",
            "error": error,
            "duration_ms": round(1e3 * self.duration_s, 3),
            "dropped_events": dropped,
            "events": [
                {"name": name, "t_ms": round(1e3 * t, 3), **attrs}
                for name, t, attrs in events
            ],
            "spans": [
                {**s, "start_ms": round(1e3 * s.pop("start_s"), 3),
                 "duration_ms": round(1e3 * s.pop("duration_s"), 3)}
                for s in self.spans()
            ],
        }


class TraceStore:
    """Bounded in-memory timeline store: open timelines indexed live,
    closed ones kept in a fixed-size ring (oldest evicted first) — memory
    is bounded no matter the traffic."""

    def __init__(self, capacity: int = 256, max_events: int = 96) -> None:
        self.capacity = capacity
        self.max_events = max_events
        self._lock = threading.Lock()
        self._live: dict[int, Timeline] = {}
        self._done: deque[Timeline] = deque(maxlen=capacity)

    def start(self, request_id: str | None = None) -> Timeline:
        tl = Timeline(request_id or gen_request_id(),
                      max_events=self.max_events, on_close=self._retire)
        with self._lock:
            self._live[id(tl)] = tl
        return tl

    def _retire(self, tl: Timeline) -> None:
        with self._lock:
            self._live.pop(id(tl), None)
            self._done.append(tl)

    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._live)

    def open_timelines(self) -> list[Timeline]:
        with self._lock:
            return list(self._live.values())

    def find(self, request_id: str) -> list[dict]:
        with self._lock:
            timelines = list(self._live.values()) + list(self._done)
        return [t.to_dict() for t in timelines
                if t.request_id == request_id]

    def snapshot(self) -> dict:
        with self._lock:
            live = list(self._live.values())
            done = list(self._done)
        return {
            "open": [t.to_dict() for t in live],
            "finished": [t.to_dict() for t in done],
        }

    def chrome_trace(self) -> dict:
        """Trace-event-format export (chrome://tracing, Perfetto): one
        complete ('X') event per span, one track per request."""
        with self._lock:
            timelines = list(self._done) + list(self._live.values())
        events = []
        for tid, tl in enumerate(timelines, start=1):
            base_us = tl.start_wall * 1e6
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"request {tl.request_id}"},
            })
            for span in tl.spans():
                args = {k: v for k, v in span.items()
                        if k not in ("name", "start_s", "duration_s")}
                events.append({
                    "name": span["name"], "ph": "X", "pid": 1, "tid": tid,
                    "ts": base_us + span["start_s"] * 1e6,
                    "dur": span["duration_s"] * 1e6,
                    "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_debug(store: TraceStore, query: str = "") -> tuple[bytes, str]:
    """Shared ``/debug/requests`` responder: ``(body, content_type)``.
    Plain JSON snapshot by default; ``format=chrome`` in the query string
    selects the trace-event export; ``id=<request_id>`` filters."""
    import json
    from urllib.parse import parse_qs

    params = parse_qs(query)
    if params.get("format", [""])[0] == "chrome":
        payload = store.chrome_trace()
    elif params.get("id", [""])[0]:
        payload = {"requests": store.find(params["id"][0])}
    else:
        payload = store.snapshot()
    return json.dumps(payload, indent=1).encode(), "application/json"
