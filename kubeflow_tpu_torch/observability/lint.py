"""Promtool-style Prometheus exposition checker (pure python); a copy of
``lint()`` and ``lint_url()`` from ``kubeflow_tpu/observability/lint.py``,
kept in this package so the port imports nothing of the JAX one.

``lint(text)`` validates a scraped ``/metrics`` body against the
exposition format the renderer (:mod:`kubeflow_tpu_torch.observability.
metrics`) is supposed to emit:

- TYPE header lines well-formed, known kinds, at most one per family;
- every sample belongs to a family declared BEFORE it;
- counter families named ``*_total``;
- metric/label names legal, label values quoted with only legal escapes;
- histogram series: ``le`` bounds strictly increasing, cumulative counts
  non-decreasing, a ``+Inf`` bucket present and equal to ``_count``,
  ``_sum``/``_count`` present.

``python -m kubeflow_tpu_torch.observability.lint --self-check [--device
cpu]`` boots what the port exposes, in process: the model server (REST,
with one request over gRPC :9000 when grpcio is importable, whose
counters land in the same exposition), the gateway's admin port (after
a predict relayed through it), and a HealthServer over the operator
families (after a real Experiment round) and the elastic
training families (``train/elastic.py``); it scrapes each over real HTTP
and exits 1 on any violation. The model server runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import re
import sys
import urllib.request

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_KINDS = {"counter", "gauge", "histogram", "summary", "untyped"}
# Histogram/summary component suffixes resolve to their base family.
_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_value(token: str) -> float:
    if token in ("+Inf", "Inf"):
        return float("inf")
    if token == "-Inf":
        return float("-inf")
    return float(token)  # NaN parses natively


def _parse_sample(line: str) -> tuple[str, dict, float]:
    """Parse ``name{label="v",...} value`` → (name, labels, value).
    Raises ValueError on any malformation (bad name, bad escape,
    unterminated quote, missing value)."""
    m = _NAME_RE.match(line)
    if m is None:
        raise ValueError("sample does not start with a metric name")
    name = m.group(0)
    rest = line[m.end():]
    labels: dict[str, str] = {}
    if rest.startswith("{"):
        i = 1
        while True:
            if i >= len(rest):
                raise ValueError("unterminated label set")
            if rest[i] == "}":
                i += 1
                break
            lm = _LABEL_RE.match(rest, i)
            if lm is None:
                raise ValueError(f"bad label name at {rest[i:]!r}")
            key = lm.group(0)
            i = lm.end()
            if i >= len(rest) or rest[i] != "=":
                raise ValueError(f"label {key!r} missing '='")
            i += 1
            if i >= len(rest) or rest[i] != '"':
                raise ValueError(f"label {key!r} value not quoted")
            i += 1
            out = []
            while True:
                if i >= len(rest):
                    raise ValueError(f"label {key!r} unterminated quote")
                ch = rest[i]
                if ch == "\\":
                    if i + 1 >= len(rest) or rest[i + 1] not in '\\"n':
                        raise ValueError(
                            f"label {key!r} has an illegal escape")
                    out.append({"n": "\n"}.get(rest[i + 1], rest[i + 1]))
                    i += 2
                elif ch == '"':
                    i += 1
                    break
                else:
                    out.append(ch)
                    i += 1
            labels[key] = "".join(out)
            if i < len(rest) and rest[i] == ",":
                i += 1
        rest = rest[i:]
    parts = rest.split()
    if not parts:
        raise ValueError("sample has no value")
    return name, labels, _parse_value(parts[0])


def lint(text: str) -> list[str]:
    """Validate one exposition body; returns a list of violations
    (empty = clean)."""
    errors: list[str] = []
    declared: dict[str, str] = {}
    # (family, labelkey) → list of (le, cumulative count), plus the
    # matching _sum/_count samples for cross-checks.
    buckets: dict[tuple, list[tuple[float, float]]] = {}
    counts: dict[tuple, float] = {}
    sums: dict[tuple, float] = {}

    def family_of(name: str) -> str | None:
        if name in declared:
            return name
        for suffix in _SUFFIXES:
            base = name.removesuffix(suffix)
            if (base != name and base in declared
                    and declared[base] in ("histogram", "summary")):
                return base
        return None

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) < 4:
                    errors.append(f"line {lineno}: malformed TYPE line")
                    continue
                name, kind = parts[2], parts[3].strip()
                if _NAME_RE.fullmatch(name) is None:
                    errors.append(
                        f"line {lineno}: bad metric name {name!r}")
                if kind not in _KINDS:
                    errors.append(
                        f"line {lineno}: unknown type {kind!r}")
                if name in declared:
                    errors.append(
                        f"line {lineno}: duplicate TYPE for {name}")
                if kind == "counter" and not name.endswith("_total"):
                    errors.append(
                        f"line {lineno}: counter {name} must end _total")
                declared[name] = kind
            continue
        try:
            name, labels, value = _parse_sample(line)
        except ValueError as e:
            errors.append(f"line {lineno}: {e}")
            continue
        fam = family_of(name)
        if fam is None:
            errors.append(
                f"line {lineno}: sample {name} has no preceding TYPE")
            continue
        kind = declared[fam]
        if kind in ("counter", "gauge") and name != fam:
            errors.append(
                f"line {lineno}: {kind} sample {name} != family {fam}")
        if kind == "counter" and value < 0:
            errors.append(f"line {lineno}: counter {name} is negative")
        if kind == "histogram":
            key = (fam, tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le")))
            if name == f"{fam}_bucket":
                if "le" not in labels:
                    errors.append(
                        f"line {lineno}: {name} sample missing le")
                    continue
                try:
                    le = _parse_value(labels["le"])
                except ValueError:
                    errors.append(
                        f"line {lineno}: unparseable le "
                        f"{labels['le']!r}")
                    continue
                buckets.setdefault(key, []).append((le, value))
            elif name == f"{fam}_count":
                counts[key] = value
            elif name == f"{fam}_sum":
                sums[key] = value

    for (fam, labelkey), series in buckets.items():
        where = f"{fam}{dict(labelkey) if labelkey else ''}"
        les = [le for le, _ in series]
        if les != sorted(les) or len(set(les)) != len(les):
            errors.append(f"{where}: le bounds not strictly increasing")
        cum = [c for _, c in series]
        if any(b < a for a, b in zip(cum, cum[1:])):
            errors.append(f"{where}: bucket counts not cumulative")
        if not les or les[-1] != float("inf"):
            errors.append(f"{where}: missing +Inf bucket")
        elif (fam, labelkey) in counts and cum[-1] != counts[
                (fam, labelkey)]:
            errors.append(f"{where}: +Inf bucket != _count")
        if (fam, labelkey) not in counts:
            errors.append(f"{where}: missing _count")
        if (fam, labelkey) not in sums:
            errors.append(f"{where}: missing _sum")
    return errors


def lint_url(url: str, timeout: float = 10.0) -> list[str]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        text = resp.read().decode()
    if not text.strip():
        return [f"{url}: empty exposition body"]
    return [f"{url}: {e}" for e in lint(text)]


def _self_check(device: str = "cuda") -> int:
    """Boot each /metrics surface of the port in process and lint a real
    scrape of it: the model server (a decoder driven once, over REST and
    over gRPC when grpcio is importable), the gateway's admin port (after
    one predict relayed through it to that server), and a HealthServer
    over the operator families (one real Experiment round) and the
    elastic training families."""
    import json
    import socket

    from kubeflow_tpu_torch.gateway import Gateway, Route, RouteTable
    from kubeflow_tpu_torch.apis.experiment import (
        experiment as experiment_cr,
        experiment_crd,
    )
    from kubeflow_tpu_torch.k8s_fake import FakeApiServer
    from kubeflow_tpu_torch.observability.metrics import type_line
    from kubeflow_tpu_torch.operators.base import (
        OPERATOR_METRICS,
        HealthServer,
    )
    from kubeflow_tpu_torch.operators.experiment import ExperimentController
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.train.elastic import ELASTIC_METRICS

    model = "lm-test-tiny" if device == "cpu" else "llama-1b"
    failures: list[str] = []
    stops = []
    surfaces = ["model-server"]
    try:
        # 1. The model server: one generation so the decoder's
        # histograms, counters and timelines carry real samples.
        try:
            import grpc
        except ImportError:
            grpc = None
        server = ModelServer(
            EngineConfig(model=model, batch_size=2, max_seq_len=32,
                         max_new_tokens=4, device=device),
            port=0, grpc_port=0 if grpc else None, batch_timeout_ms=2)
        server.start()
        stops.append(server.stop)
        base = f"http://127.0.0.1:{server.port}"
        body = {"instances": [{"tokens": [1, 2, 3], "max_new_tokens": 4}]}
        req = urllib.request.Request(
            f"{base}/v1/models/{model}:predict", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            resp.read()
        if grpc is not None:
            from kubeflow_tpu_torch.serving.grpc_server import client_stubs

            with grpc.insecure_channel(
                    f"127.0.0.1:{server.grpc_port}") as channel:
                client_stubs(channel)[0](model, body["instances"],
                                         timeout=300)
            surfaces[0] = "model-server (REST + gRPC)"
        failures += lint_url(f"{base}/monitoring/prometheus/metrics")

        # 2. The gateway's admin port, after one predict relayed through
        # it to the model server, so its latency histogram has a sample.
        table = RouteTable()
        table.set_routes([Route(name="lint", prefix="/v1/",
                                service=f"127.0.0.1:{server.port}",
                                rewrite="/v1/")])
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            admin_port = sock.getsockname()[1]
        gw = Gateway(table, port=0, admin_port=admin_port,
                     probe_interval=0)
        gw.start()
        stops.append(gw.stop)
        surfaces.append("gateway")
        req = urllib.request.Request(
            f"http://127.0.0.1:{gw.port}/v1/models/{model}:predict",
            method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            resp.read()
        gateway_url = f"http://127.0.0.1:{admin_port}/metrics"
        failures += lint_url(gateway_url)
        with urllib.request.urlopen(gateway_url, timeout=10) as resp:
            gateway_body = resp.read().decode()
        for family, kind in (
                ("gateway_requests_total", "counter"),
                ("gateway_upstream_latency_seconds", "histogram")):
            if type_line(family, kind) not in gateway_body:
                failures.append(f"{gateway_url}: family {family} missing")

        # 3. The operator families after one real Experiment round (the
        # closed-form scenario, two trials) and the elastic families.
        fake = FakeApiServer()
        fake.ensure_namespace("kubeflow")
        fake.apply(experiment_crd())
        fake.create(experiment_cr(
            "lint-exp", "kubeflow", "synthetic-knobs",
            algorithm="random", max_trials=2, parallel_trials=2))
        exp_ctrl = ExperimentController(fake)
        exp_ctrl.reconcile_all()
        exp_ctrl.reconcile_all()
        health = HealthServer(
            0, lambda: {"kubeflow_tpu_controllers_running": 1},
            registries=(OPERATOR_METRICS, ELASTIC_METRICS))
        health.start()
        stops.append(health.stop)
        surfaces.append("operator + elastic")
        operator_url = f"http://127.0.0.1:{health.port}/metrics"
        failures += lint_url(operator_url)
        with urllib.request.urlopen(operator_url, timeout=10) as resp:
            operator_body = resp.read().decode()
        for family, kind in (
                ("operator_reconcile_seconds", "histogram"),
                ("operator_reconcile_conflicts_total", "counter"),
                ("train_reshards_total", "counter"),
                ("train_reshard_seconds", "histogram"),
                ("experiment_trials_total", "counter"),
                ("experiment_best_objective", "gauge"),
                ("tuning_suggestions_total", "counter")):
            if type_line(family, kind) not in operator_body:
                failures.append(f"{operator_url}: family {family} missing")
    finally:
        for stop in reversed(stops):
            stop()
    for failure in failures:
        print(f"FAIL {failure}")
    names = ", ".join(surfaces)
    if failures:
        print(f"metrics lint: {len(failures)} violation(s) across {names}")
        return 1
    print(f"metrics lint ok ({names})")
    return 0


def main(argv=None) -> int:
    """``python -m kubeflow_tpu_torch.observability.lint [--self-check
    [--device cpu]] [url...]``: lint live endpoints by URL, and/or the
    in-process self-check."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for flag in [a for a in argv if a.startswith("--device")]:
        i = argv.index(flag)
        if flag == "--device" and i + 1 < len(argv):
            device = argv.pop(i + 1)
        else:
            device = flag.partition("=")[2]
        argv.remove(flag)
    rc = 0
    if "--self-check" in argv:
        argv.remove("--self-check")
        rc = _self_check(device)
    for url in argv:
        failures = lint_url(url)
        for failure in failures:
            print(f"FAIL {failure}")
        if failures:
            rc = 1
        else:
            print(f"ok {url}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
