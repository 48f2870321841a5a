"""InferenceService controller: replicated decoder pool + autoscaler; the
port's counterpart of ``kubeflow_tpu/operators/inference.py``.

A copy of JAX's controller with one difference: each replica is rendered
from the port's ``gpu-serving`` prototype (``manifests/serving.py``), so
it runs ``python -m kubeflow_tpu_torch.serving`` on the port's image with
``nvidia.com/gpu`` resources, where JAX's renders ``tpu-serving``. The
GPU count is ``spec.tpuChipsPerReplica`` when set (the CRD's field name is
JAX's), else tp x cp x pp, as JAX counts chips. A parameter the port
refuses (``warmup.compileCacheDir`` renders ``compile_cache_dir``) raises
its ``ValueError`` out of the reconcile, never vanishes from the
rendering. The CR, the scaling decisions, the router annotation and the
status are JAX's.

Reconciles one :mod:`kubeflow_tpu_torch.apis.inference` CR into

- N single-replica model-server Deployments (``<name>-r<i>``) with their
  Services — each replica individually addressable so the gateway's
  rendezvous hash has stable members to place prefix keys on (a plain
  scaled Deployment behind one ClusterIP would round-robin the pool and
  shatter every replica's prefix trie);
- one selector-less **router Service** (``<name>``) carrying the
  ``prefix-affine`` gateway-route annotation over the live replica set —
  membership changes rewrite the annotation, the gateway refresh picks
  it up, and the rendezvous hash remaps only the affected keys;
- a **metric-driven autoscaler**: each reconcile scrapes every replica's
  ``/monitoring/prometheus/metrics``, estimates queue-wait/TTFT p99 from
  the histogram buckets and KV fill from the real-byte gauges, and
  scales within [minReplicas, maxReplicas] — up immediately on any
  breach, down only when every signal sits under ``target *
  scaleDownRatio`` (hysteresis band) AND ``cooldownSeconds`` have passed
  since the last scale event (flap damping). The reconcile returns
  ``scrapePeriodSeconds`` as its requeue-after, which the port's polling
  manager honours, so the loop IS the scrape cadence.

Runs on the port's :class:`~kubeflow_tpu_torch.operators.base.Controller`
(a polled reconciler: the port's client has no watch).
"""

from __future__ import annotations

import copy
import logging
import math
import time
import urllib.request

from kubeflow_tpu_torch.apis.inference import (
    DEFAULT_AUTOSCALE,
    DEFAULT_WARMUP,
    INFERENCE_API_VERSION,
    INFERENCE_KIND,
    INFERENCE_ROLES,
)
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import gateway_route, generate
from kubeflow_tpu_torch.operators.base import OPERATOR_METRICS, Controller

log = logging.getLogger(__name__)

_M_PREDICTIVE = OPERATOR_METRICS.counter(
    "inference_predictive_scaleups_total",
    "Scale-ups taken on a projected (not yet observed) SLO breach",
    labels=("service",))

# Scrape rounds of pool-max signals kept per pool for the trend fit.
# The slope only needs enough points to reject one-round noise; a flash
# crowd shows a clean ramp within 3-4 rounds, so a dozen is plenty and
# keeps the per-pool state O(1).
HISTORY_ROUNDS = 12

# Signal-dict field and scoped-name pairs shared by the breach test,
# the trend fit and the capacity ratio, with the per-unit target key.
_SIGNAL_FIELDS = (
    ("queue_wait_p99", "queue_wait_p99_s", "queueWaitP99Ms", 1e3),
    ("ttft_p99", "ttft_p99_s", "ttftP99Ms", 1e3),
    ("inter_token_p99", "inter_token_p99_s", "interTokenP99Ms", 1e3),
    ("kv_bytes", "kv_utilization", "kvBytesUtilization", 1.0),
)

REST_PORT = 8500
REPLICA_LABEL = "kubeflow-tpu.org/inference-replica"
SERVICE_LABEL = "kubeflow-tpu.org/inference-service"
ROLE_LABEL = "kubeflow-tpu.org/inference-role"

# Which autoscale signals bind which pool: a colocated service scales
# on everything; a prefill pool is compute-bound on prompt admission
# (queue wait, TTFT) and holds no long-lived KV; a decode pool is
# memory-bound on resident KV bytes and its user-visible latency is the
# inter-token cadence. Scoping breaches this way is what makes a
# prefill-side burst scale ONLY the prefill pool and a KV-fill breach
# scale ONLY the decode pool.
ROLE_SIGNALS = {
    "": ("queue_wait_p99", "ttft_p99", "kv_bytes"),
    "prefill": ("queue_wait_p99", "ttft_p99"),
    "decode": ("kv_bytes", "inter_token_p99"),
}

# CRD engine keys that differ from their gpu-serving param spelling:
# the CRD surface is camelCase (tpShards), the prototype params are the
# CLI flag names (tp_shards). Normalized once at pool-spec time so the
# role-override merge and the replica render both see one spelling.
_ENGINE_KEY_ALIASES = {"tpShards": "tp_shards",
                       "cpShards": "cp_shards",
                       "ppStages": "pp_stages",
                       "prefillChunkTokens": "prefill_chunk_tokens",
                       "maxPromptLen": "max_prompt_len",
                       "hostKvBytes": "host_kv_bytes",
                       "kvDirectorySize": "kv_directory_size",
                       "coldStoreRef": "cold_store_ref",
                       "importCrossoverTokens":
                           "kv_import_crossover_tokens"}


def _qos_params(spec: dict) -> dict:
    """spec.qos -> gpu-serving params: the structured per-tenant
    weights/rates serialize to the flat --qos-tenants string every
    replica's pop loop parses (one policy, N replicas)."""
    qos = spec.get("qos") or {}
    tenants = dict(qos.get("tenants") or {})
    if qos.get("default"):
        tenants.setdefault("default", qos["default"])
    if not tenants:
        return {}
    from kubeflow_tpu_torch.serving.qos import render_tenants

    params = {"qos_tenants": render_tenants(tenants)}
    if qos.get("agingSeconds") is not None:
        params["qos_aging_s"] = float(qos["agingSeconds"])
    return params


def _normalize_engine(engine: dict | None) -> dict:
    return {_ENGINE_KEY_ALIASES.get(k, k): v
            for k, v in (engine or {}).items()}


# ---------------------------------------------------------------------------
# Exposition scraping (the autoscaler's input)
# ---------------------------------------------------------------------------


def _parse_exposition(text: str) -> dict:
    """Minimal Prometheus text parse: ``samples[name] -> value`` for
    plain series and ``buckets[name] -> [(le, cum_count), ...]`` for
    ``_bucket`` series. Labels other than ``le`` are ignored (the
    serving histograms the autoscaler reads are unlabeled)."""
    samples: dict[str, float] = {}
    buckets: dict[str, list[tuple[float, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value_s = line.rsplit(None, 1)
            value = float(value_s)
        except ValueError:
            continue
        name, _, labels = series.partition("{")
        if name.endswith("_bucket"):
            le = ""
            for part in labels.rstrip("}").split(","):
                k, _, v = part.partition("=")
                if k.strip() == "le":
                    le = v.strip().strip('"')
            try:
                bound = float("inf") if le == "+Inf" else float(le)
            except ValueError:
                continue
            buckets.setdefault(name[: -len("_bucket")], []).append(
                (bound, value))
        else:
            samples[name] = value
    for blist in buckets.values():
        blist.sort(key=lambda b: b[0])
    return {"samples": samples, "buckets": buckets}


def _bucket_quantile(blist: list[tuple[float, float]], q: float) -> float:
    """promql histogram_quantile over cumulative buckets — the same
    linear-in-bucket interpolation observability/metrics.py uses, so an
    operator-side estimate matches the in-process one."""
    if not blist:
        return 0.0
    total = blist[-1][1]
    if total <= 0:
        return 0.0
    target = q * total
    lower = 0.0
    prev_cum = 0.0
    for bound, cum in blist:
        in_bucket = cum - prev_cum
        if cum >= target and in_bucket > 0:
            if bound == float("inf"):
                return lower  # top finite bound is the best estimate
            frac = (target - prev_cum) / in_bucket
            return lower + (bound - lower) * frac
        prev_cum = cum
        if bound != float("inf"):
            lower = bound
    return lower


def scrape_signals(text: str) -> dict:
    """The autoscaler's per-replica signal vector out of one exposition
    page: latency p99s from the serving histograms, KV fill from the
    real-byte gauges, plus raw queue depth."""
    parsed = _parse_exposition(text)
    samples, buckets = parsed["samples"], parsed["buckets"]
    kv_total = samples.get("serving_kv_bytes_total", 0.0)
    requests = samples.get("serving_requests_total", 0.0)
    return {
        "queue_wait_p99_s": _bucket_quantile(
            buckets.get("serving_queue_wait_seconds", []), 0.99),
        "ttft_p99_s": _bucket_quantile(
            buckets.get("serving_ttft_seconds", []), 0.99),
        "inter_token_p99_s": _bucket_quantile(
            buckets.get("serving_inter_token_seconds", []), 0.99),
        "kv_utilization": (samples.get("serving_kv_bytes_in_use", 0.0)
                           / kv_total if kv_total else 0.0),
        "queued": samples.get("serving_queued", 0.0),
        # Lifetime error fraction — the rollout gate's third signal (a
        # candidate that 500s at 2x the incumbent's rate fails the walk
        # even if its latency looks fine).
        "error_rate": (samples.get("serving_errors_total", 0.0)
                       / requests if requests else 0.0),
    }


def _http_fetch_signals(addr: str, timeout: float = 2.0) -> dict | None:
    """Default replica scrape: GET the model server's exposition and
    reduce it to the signal vector. None on any failure — a replica
    that cannot be scraped must not stall the reconcile."""
    try:
        with urllib.request.urlopen(
                f"http://{addr}/monitoring/prometheus/metrics",
                timeout=timeout) as resp:
            return scrape_signals(resp.read().decode("utf-8", "replace"))
    except (OSError, ValueError):
        return None


class SignalCache:
    """Failure-tolerant scrape front: one transient ``fetch`` timeout
    must not manufacture an empty signal vector that a controller then
    reads as a breach (or as calm, equally wrong). A failed scrape
    returns the replica's LAST-GOOD sample while it is younger than the
    staleness window — flagged stale, so callers can HOLD decisions
    (never scale, never rollback, never promote on substituted data) —
    and nothing once the window expires (the replica is then genuinely
    unobservable and counts against scrape quorum)."""

    def __init__(self, fetch, clock=time.monotonic):
        self.fetch = fetch
        self.clock = clock
        self._last_good: dict[str, tuple[float, dict]] = {}

    def scrape(self, addr: str, staleness_s: float) -> tuple[dict | None,
                                                             bool]:
        """(signals, fresh): fresh samples update the cache; a failure
        inside the window yields (last_good, False); outside it,
        (None, False)."""
        sig = self.fetch(addr)
        now = self.clock()
        if sig is not None:
            self._last_good[addr] = (now, sig)
            return sig, True
        held = self._last_good.get(addr)
        if held is not None and (now - held[0]) <= float(staleness_s):
            return held[1], False
        return None, False

    def forget(self, addr: str) -> None:
        self._last_good.pop(addr, None)


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------


class InferenceServiceController(Controller):
    """InferenceService CR → replica Deployments/Services + router route
    + autoscaler. ``fetch_metrics(addr) -> signal dict | None`` and
    ``clock`` are injectable (tests drive synthetic breaches and
    cooldown time)."""

    api_version = INFERENCE_API_VERSION
    kind = INFERENCE_KIND

    def __init__(self, client, *, fetch_metrics=None, clock=time.monotonic):
        super().__init__(client)
        self.fetch_metrics = fetch_metrics or _http_fetch_signals
        self.clock = clock
        # Late-bound fetch so tests (and wrappers) swapping
        # ``fetch_metrics`` on a live controller take effect.
        self.signal_cache = SignalCache(
            lambda addr: self.fetch_metrics(addr), clock)
        # (ns, name) -> {"last_scale": monotonic | None}
        self._scale_state: dict[tuple[str, str], dict] = {}

    def reconcile_deleted(self, obj: dict) -> None:
        ns = obj["metadata"].get("namespace", "")
        name = obj["metadata"].get("name", "")
        for key in [k for k in self._scale_state
                    if k[0] == ns and k[1] == name]:
            self._scale_state.pop(key, None)

    # -- replica addressing -------------------------------------------

    @staticmethod
    def replica_name(name: str, i: int, role: str = "") -> str:
        return f"{name}-{role}-r{i}" if role else f"{name}-r{i}"

    @staticmethod
    def replica_addr(name: str, ns: str, i: int, role: str = "") -> str:
        return (f"{InferenceServiceController.replica_name(name, i, role)}"
                f".{ns}:{REST_PORT}")

    # -- pool shaping -------------------------------------------------

    @staticmethod
    def _pools(spec: dict) -> list[str]:
        """The service's replica pools: [""] colocated, or the role
        split when ``spec.roles`` is present."""
        return list(INFERENCE_ROLES) if spec.get("roles") else [""]

    @staticmethod
    def _pool_spec(spec: dict, role: str) -> dict:
        """One pool's effective (replicas, min, max, engine). Role pools
        inherit the top-level range unless overridden, merge their
        engine over the top-level engine, and are pinned to their
        serving role on the paged KV layout the handoff requires."""
        base = {
            "replicas": int(spec.get("replicas", 1) or 1),
            "minReplicas": max(1, int(spec.get("minReplicas", 1))),
            "maxReplicas": int(spec.get("maxReplicas", 1) or 1),
            "engine": _normalize_engine(spec.get("engine")),
        }
        if not role:
            return base
        r = (spec.get("roles") or {}).get(role) or {}
        # Role engine merges over the top level AFTER normalization, so
        # a role-level tpShards override (big prefill mesh, small
        # decode meshes) wins regardless of spelling.
        engine = {**base["engine"], **_normalize_engine(r.get("engine"))}
        engine.setdefault("kv_layout", "paged")
        engine["serving_role"] = role
        return {
            "replicas": int(r.get("replicas", base["replicas"])),
            "minReplicas": max(1, int(r.get("minReplicas",
                                            base["minReplicas"]))),
            "maxReplicas": int(r.get("maxReplicas",
                                     base["maxReplicas"])),
            "engine": engine,
        }

    # -- reconcile ----------------------------------------------------

    def reconcile(self, svc: dict) -> float:
        svc = copy.deepcopy(svc)
        name = svc["metadata"]["name"]
        ns = svc["metadata"]["namespace"]
        spec = svc.get("spec", {})
        cfg = {**DEFAULT_AUTOSCALE, **(spec.get("autoscale") or {})}
        warm = {**DEFAULT_WARMUP, **(spec.get("warmup") or {})}
        ramp_s = float(warm.get("rampSeconds") or 0.0)
        status = svc.get("status") or {}
        desired_by: dict[str, int] = {}
        signals_by: dict[str, list[dict]] = {}
        reasons: list[str] = []
        for role in self._pools(spec):
            pool = self._pool_spec(spec, role)
            lo = pool["minReplicas"]
            hi = max(lo, pool["maxReplicas"])
            prev = ((status.get("roles") or {}).get(role, {})
                    .get("replicas") if role else status.get("replicas"))
            current = int(prev or 0)
            if current <= 0:  # first reconcile: the spec seeds the pool
                current = int(pool["replicas"] or lo)
            current = min(max(current, lo), hi)

            # Replicas younger than warmup.rampSeconds are RAMPING: a
            # newborn is compiling/pulling weights and either cannot be
            # scraped at all or reports cold-start latencies that look
            # like a breach. Its samples must neither anchor the stale-
            # HOLD, vote "calm" for scale-down, nor trigger a reactive
            # cascade — only SEASONED replicas drive the decision.
            young = set()
            if ramp_s > 0:
                born = (self._scale_state.get((ns, name, role))
                        or {}).get("born") or {}
                now = self.clock()
                young = {j for j, t in born.items() if now - t < ramp_s}

            signals = []
            seasoned = []
            stale = False
            for i in range(current):
                sig, fresh = self.signal_cache.scrape(
                    self.replica_addr(name, ns, i, role),
                    float(cfg["signalStalenessSeconds"]))
                if sig is None:
                    continue
                signals.append(sig)
                if i in young:
                    continue
                seasoned.append(sig)
                stale = stale or not fresh
            if stale:
                # A substituted (last-good) sample in the vector: HOLD.
                # Scaling on held data acts on the past — a transient
                # scrape timeout must never move the pool.
                desired, reason = current, "hold: stale scrape signals"
            else:
                desired, reason = self._decide(
                    (ns, name, role), current, lo, hi, seasoned, cfg,
                    role, ramp_s=ramp_s, ramping=bool(young))
            self._ensure_replicas(svc, desired, role, pool["engine"])
            self._prune_replicas(svc, desired, role)
            desired_by[role] = desired
            signals_by[role] = signals
            if reason:
                reasons.append(f"{role}: {reason}" if role else reason)

        self._ensure_router(svc, desired_by)
        self._update_status(svc, desired_by, signals_by,
                            "; ".join(reasons), cfg)
        return float(cfg["scrapePeriodSeconds"])

    # -- autoscale policy ---------------------------------------------

    @staticmethod
    def _breaches(sig: dict, cfg: dict, ratio: float = 1.0,
                  role: str = "") -> list[str]:
        """Signal names at or over ``target * ratio`` — ratio 1.0 is the
        breach test, ``scaleDownRatio`` the low-water test. Only the
        signals that bind ``role``'s pool count (ROLE_SIGNALS): a
        prefill-side queue-wait burst must never scale the decode pool
        and a decode-side KV-fill breach must never scale prefill."""
        over = []
        if sig["queue_wait_p99_s"] * 1e3 > cfg["queueWaitP99Ms"] * ratio:
            over.append("queue_wait_p99")
        if sig["ttft_p99_s"] * 1e3 > cfg["ttftP99Ms"] * ratio:
            over.append("ttft_p99")
        if sig.get("inter_token_p99_s", 0.0) * 1e3 > \
                cfg["interTokenP99Ms"] * ratio:
            over.append("inter_token_p99")
        if sig["kv_utilization"] > cfg["kvBytesUtilization"] * ratio:
            over.append("kv_bytes")
        scoped = ROLE_SIGNALS[role]
        return [b for b in over if b in scoped]

    @staticmethod
    def _pool_max(signals: list[dict]) -> dict:
        """Pool-worst sample per signal field — the vector the trend
        fit and the capacity ratio both run on (scaling serves the
        worst replica, not the average one)."""
        return {f: max(s.get(f, 0.0) for s in signals)
                for _, f, _, _ in _SIGNAL_FIELDS}

    @staticmethod
    def _trend_projection(history: list[tuple[float, dict]],
                          at: float) -> dict:
        """Least-squares projection of each pool-max signal at time
        ``at``. Clamped below at the latest observation: a projection
        is only allowed to warn EARLIER than reality, never to erase a
        breach that is already visible."""
        ts = [t for t, _ in history]
        t_mean = sum(ts) / len(ts)
        var = sum((t - t_mean) ** 2 for t in ts)
        out = {}
        for _, field, _, _ in _SIGNAL_FIELDS:
            vs = [s.get(field, 0.0) for _, s in history]
            v_mean = sum(vs) / len(vs)
            slope = (sum((t - t_mean) * (v - v_mean)
                         for t, v in zip(ts, vs)) / var) if var > 0 else 0.0
            out[field] = max(vs[-1], v_mean + slope * (at - t_mean))
        return out

    @staticmethod
    def _worst_ratio(sig: dict, cfg: dict, role: str = "") -> float:
        """How far over capacity the pool runs, as max(signal/target)
        over the signals that bind ``role``. Queue wait and latency
        tails grow roughly linearly with per-replica load near
        saturation and KV fill is exactly linear in resident bytes, so
        this ratio IS the throughput profile's per-replica capacity
        estimate read off the signal plane: a pool at ratio r needs
        ~ceil(current * r) replicas to sit back at target."""
        scoped = ROLE_SIGNALS[role]
        ratios = [1.0]
        for name, field, target_key, unit in _SIGNAL_FIELDS:
            target = float(cfg[target_key])
            if name in scoped and target > 0:
                ratios.append(sig.get(field, 0.0) * unit / target)
        return max(ratios)

    @staticmethod
    def _scale_step(current: int, ratio: float, max_step: int) -> int:
        """Replicas to ADD this round: scale-to-N from the capacity
        ratio, clamped to ``maxStepUp`` — one round closes the whole
        projected gap when it is large instead of walking +1 per scrape
        period behind a flash crowd."""
        need = int(math.ceil(current * ratio)) - current
        return max(1, min(max(1, int(max_step)), need))

    def _decide(self, key: tuple[str, str, str], current: int, lo: int,
                hi: int, signals: list[dict], cfg: dict,
                role: str = "", *, ramp_s: float = 0.0,
                ramping: bool = False) -> tuple[int, str]:
        """One pool's scaling decision. Up is immediate (a breach is
        user-visible latency, the urgent direction); down needs the
        whole pool inside the hysteresis band AND the cooldown elapsed,
        so a breach → scale-up → relief sequence cannot flap back within
        the window. Cooldown state is PER POOL: scaling prefill never
        resets decode's clock.

        With ``autoscale.predictive`` the pool also keeps the last
        HISTORY_ROUNDS pool-max samples, fits a slope, and scales when
        the projection at ``now + horizonSeconds`` breaches — the
        replicas are BORN before the SLO is, so their ramp (weight pull
        + compile-cache warm) overlaps the load climb instead of
        following the breach. ``ramping`` (a replica younger than
        ``warmup.rampSeconds`` exists) vetoes scale-down outright: a
        newborn that cannot be scraped yet must never read as calm."""
        now = self.clock()
        # First sight anchors the cooldown: a freshly declared pool gets
        # a full cooldown of observation before any scale-down (spec
        # .replicas is the operator's intent, not a transient to erase).
        state = self._scale_state.setdefault(key, {"last_scale": now})
        born = state.setdefault("born", {})
        for j in [j for j, t in born.items()
                  if ramp_s <= 0 or now - t >= ramp_s]:
            born.pop(j)  # seasoned: out of every future young set
        predictive = bool(cfg.get("predictive"))
        max_step = int(cfg.get("maxStepUp", 1) or 1)
        agg = self._pool_max(signals) if signals else None
        hist = state.setdefault("history", [])
        if agg is not None:
            hist.append((now, agg))
            del hist[:-HISTORY_ROUNDS]

        def scale_to(new: int) -> int:
            state["last_scale"] = now
            for j in range(current, new):
                born[j] = now
            return new

        breached = sorted({b for s in signals
                           for b in self._breaches(s, cfg, role=role)})
        if breached and current < hi:
            step = (self._scale_step(current,
                                     self._worst_ratio(agg, cfg, role),
                                     max_step) if predictive else 1)
            return (scale_to(min(hi, current + step)),
                    f"scale-up: {','.join(breached)} over target")
        if predictive and current < hi and len(hist) >= 3:
            horizon = float(cfg.get("horizonSeconds", 0.0))
            proj = self._trend_projection(hist, now + horizon)
            ahead = self._breaches(proj, cfg, role=role)
            if ahead:
                step = self._scale_step(
                    current, self._worst_ratio(proj, cfg, role), max_step)
                new = scale_to(min(hi, current + step))
                _M_PREDICTIVE.labels(key[1]).inc()
                return new, (f"predictive scale-up: {','.join(ahead)} "
                             f"projected over target within "
                             f"{horizon:g}s")
        low = bool(signals) and not any(
            self._breaches(s, cfg, float(cfg["scaleDownRatio"]), role)
            for s in signals)
        last = state["last_scale"]
        cooled = last is None or (now - last) >= float(
            cfg["cooldownSeconds"])
        if low and not ramping and current > lo and cooled:
            state["last_scale"] = now
            born.pop(current - 1, None)  # its stamp leaves with it
            return current - 1, "scale-down: all signals under low water"
        if low and ramping:
            return current, "hold: newborn replica still ramping"
        return current, ""

    # -- children -----------------------------------------------------

    def _replica_objects(self, svc: dict, i: int, role: str = "",
                         engine: dict | None = None) -> list[dict]:
        """One replica's Deployment + Service, rendered through the
        gpu-serving prototype (same args/probes/scrape annotations a
        hand-deployed model server gets) and labeled for pruning —
        role pools additionally carry the role label so each pool
        prunes and scales independently."""
        name = svc["metadata"]["name"]
        ns = svc["metadata"]["namespace"]
        spec = svc.get("spec", {})
        eng = (engine if engine is not None
               else _normalize_engine(spec.get("engine")))
        # A model-parallel replica is a tp*cp*pp-GPU pod: the mesh axes
        # multiply into the GPU request unless the spec pins it
        # explicitly (0 = CPU stays 0: the pod's command adds
        # --device=cpu). The CRD keeps JAX's field name.
        chips_spec = spec.get("tpuChipsPerReplica")
        gpus = (max(1, int(eng.get("tp_shards", 1) or 1))
                * max(1, int(eng.get("cp_shards", 1) or 1))
                * max(1, int(eng.get("pp_stages", 1) or 1))
                if chips_spec is None else int(chips_spec))
        params = {
            "name": self.replica_name(name, i, role),
            "namespace": ns,
            "model_path": spec.get("modelPath", ""),
            "model_name": spec.get("model", name),
            "replicas": 1,
            "num_gpus": gpus,
            # spec.qos reaches every pool's replicas (an engine-level
            # qos_tenants override still wins via **eng below).
            **_qos_params(spec),
            **eng,
        }
        if spec.get("image"):
            params["image"] = spec["image"]
        # spec.warmup → the flash-crowd birth path: every replica in
        # every pool shares one persistent compile cache dir (which
        # gpu-serving refuses by name: the ValueError leaves the
        # reconcile), and a scaled-up replica (i > 0) lists its
        # lower-indexed siblings as weight donors — replica 0 is the
        # pool's checkpoint-booted root, so the donor chain always
        # terminates. setdefault keeps an explicit engine-level
        # override authoritative.
        warm = {**DEFAULT_WARMUP, **(spec.get("warmup") or {})}
        if warm.get("compileCacheDir"):
            params.setdefault("compile_cache_dir",
                              str(warm["compileCacheDir"]))
        if warm.get("peerWeights") and i > 0:
            params.setdefault("weight_peers", ",".join(
                self.replica_addr(name, ns, j, role) for j in range(i)))
        objs = generate("gpu-serving", params)
        ref = k8s.object_ref(svc)
        for o in objs:
            labels = o["metadata"].setdefault("labels", {})
            labels[SERVICE_LABEL] = name
            labels[REPLICA_LABEL] = str(i)
            if role:
                labels[ROLE_LABEL] = role
            o["metadata"]["ownerReferences"] = [ref]
        return objs

    def _ensure_replicas(self, svc: dict, desired: int, role: str = "",
                         engine: dict | None = None) -> None:
        for i in range(desired):
            for obj in self._replica_objects(svc, i, role, engine):
                existing = self.client.get_or_none(
                    obj["apiVersion"], obj["kind"],
                    obj["metadata"]["name"],
                    obj["metadata"]["namespace"])
                if existing is None:
                    self.client.create(obj)
                elif existing.get("spec") != obj["spec"]:
                    existing["spec"] = obj["spec"]
                    self.client.update(existing)

    def _prune_replicas(self, svc: dict, desired: int,
                        role: str = "") -> None:
        """Delete the POOL's replica children at or past the desired
        count — the scale-down path. Highest indices go first so the
        rendezvous ring loses members from one stable end; the role
        label scopes the prune, so shrinking one pool never touches
        the other."""
        name = svc["metadata"]["name"]
        ns = svc["metadata"]["namespace"]
        for api_version, kind in (("apps/v1", "Deployment"),
                                  ("v1", "Service")):
            for obj in self.client.list(
                    api_version, kind, ns,
                    label_selector={SERVICE_LABEL: name}):
                labels = obj["metadata"].get("labels", {})
                if labels.get(ROLE_LABEL, "") != role:
                    continue
                idx = labels.get(REPLICA_LABEL)
                if idx is not None and int(idx) >= desired:
                    self.client.delete(api_version, kind,
                                       obj["metadata"]["name"], ns)

    def _ensure_router(self, svc: dict, desired_by: dict) -> None:
        """The selector-less router Service carrying the prefix-affine
        route over the CURRENT membership — rewriting the annotation on
        scale events is how the hash ring rebalances (the gateway's
        route refresh replaces the member set; rendezvous then moves
        only the changed members' keys). A role-split service routes
        decode replicas as the predict backends and prefill replicas as
        the two-hop relay's prefill pool."""
        name = svc["metadata"]["name"]
        ns = svc["metadata"]["namespace"]
        router_cfg = svc.get("spec", {}).get("router") or {}
        decode_role = "decode" if "decode" in desired_by else ""
        backends = [
            {"service": self.replica_addr(name, ns, i, decode_role),
             "weight": 1}
            for i in range(desired_by.get(decode_role, 0))
        ]
        prefill_backends = [
            {"service": self.replica_addr(name, ns, i, "prefill"),
             "weight": 1}
            for i in range(desired_by.get("prefill", 0))
        ] if "prefill" in desired_by else None
        kv_pressure = router_cfg.get("kvPressure")
        # spec.qos also arms the GATEWAY's per-tenant shedding buckets
        # on this route (rate/burst only — fair-share weights live in
        # the replicas' pop loops).
        qos_spec = svc.get("spec", {}).get("qos") or {}
        route_qos = None
        if qos_spec.get("tenants") or qos_spec.get("default"):
            route_qos = {}
            if qos_spec.get("tenants"):
                route_qos["tenants"] = {
                    str(t): {"rate": float((v or {}).get("rate", 0)),
                             "burst": float((v or {}).get("burst", 0))}
                    for t, v in qos_spec["tenants"].items()}
            if qos_spec.get("default"):
                d = qos_spec["default"]
                route_qos["default"] = {
                    "rate": float(d.get("rate", 0)),
                    "burst": float(d.get("burst", 0))}
        # Progressive delivery: while a rollout is live (Shadow or
        # Walking, per status.rollout — the RolloutController is the
        # single writer of that block, this controller the single
        # writer of the annotation) the route becomes a hash-split over
        # two version groups. The canary subset is addressed by member
        # NAME so the split survives scale events verbatim; members no
        # longer in the pool simply drop out of the group.
        strategy = "prefix-affine"
        splits = None
        shadow = ""
        shadow_fraction = None
        ro = (svc.get("status") or {}).get("rollout") or {}
        if ro.get("phase") in ("Shadow", "Walking") and not decode_role:
            all_addrs = [b["service"] for b in backends]
            canary = [a for a in (
                f"{m}.{ns}:{REST_PORT}" for m in ro.get(
                    "canaryMembers", []))
                if a in all_addrs]
            stable = [a for a in all_addrs if a not in canary]
            if canary and stable:
                traffic = float(ro.get("trafficPercent", 0.0))
                strategy = "hash-split"
                splits = [
                    {"version": ro.get("incumbent", {}).get(
                        "name", "incumbent"),
                     "weight": 100.0 - traffic, "backends": stable},
                    {"version": ro.get("candidate", {}).get(
                        "name", "candidate"),
                     "weight": traffic, "backends": canary},
                ]
                if ro["phase"] == "Shadow":
                    shadow = canary[0]
                    shadow_fraction = float(ro.get("shadowFraction", 0.1))
        annotations = gateway_route(
            f"{name}-pool", f"/models/{name}/", backends[0]["service"],
            backends=backends, strategy=strategy,
            affinity_tokens=int(router_cfg.get("affinityTokens", 32)),
            pressure=int(router_cfg.get("pressure", 8)),
            kv_pressure=(float(kv_pressure)
                         if kv_pressure is not None else None),
            prefill_backends=prefill_backends,
            qos=route_qos,
            splits=splits,
            shadow=shadow,
            shadow_fraction=shadow_fraction,
        )
        router = k8s.service(
            name, ns, selector={},
            ports=[{"name": "rest", "port": REST_PORT}],
            labels={"app": name, SERVICE_LABEL: name},
            annotations=annotations,
        )
        router["metadata"]["ownerReferences"] = [k8s.object_ref(svc)]
        existing = self.client.get_or_none("v1", "Service", name, ns)
        if existing is None:
            self.client.create(router)
        elif (existing["metadata"].get("annotations")
              != router["metadata"]["annotations"]):
            existing["metadata"]["annotations"] = \
                router["metadata"]["annotations"]
            self.client.update(existing)

    def _update_status(self, svc: dict, desired_by: dict,
                       signals_by: dict, reason: str, cfg: dict) -> None:
        name = svc["metadata"]["name"]
        ns = svc["metadata"]["namespace"]
        ready_by: dict[str, int] = {}
        for role, desired in desired_by.items():
            ready = 0
            for i in range(desired):
                dep = self.client.get_or_none(
                    "apps/v1", "Deployment",
                    self.replica_name(name, i, role), ns)
                ready += int((dep or {}).get("status", {})
                             .get("readyReplicas") or 0)
            ready_by[role] = ready
        total = sum(desired_by.values())
        ready_total = sum(ready_by.values())
        signals = [s for sigs in signals_by.values() for s in sigs]
        status: dict = {
            "replicas": total,
            "readyReplicas": ready_total,
            "phase": "Ready" if ready_total >= total else "Scaling",
            "scrapedReplicas": len(signals),
        }
        if "" not in desired_by:
            status["roles"] = {
                role: {"replicas": desired_by[role],
                       "readyReplicas": ready_by[role],
                       "scrapedReplicas": len(signals_by[role])}
                for role in desired_by
            }
        if signals:
            status["signals"] = {
                "queueWaitP99Ms": round(max(
                    s["queue_wait_p99_s"] for s in signals) * 1e3, 3),
                "ttftP99Ms": round(max(
                    s["ttft_p99_s"] for s in signals) * 1e3, 3),
                "interTokenP99Ms": round(max(
                    s.get("inter_token_p99_s", 0.0)
                    for s in signals) * 1e3, 3),
                "kvBytesUtilization": round(max(
                    s["kv_utilization"] for s in signals), 4),
            }
        if reason:
            status["lastScaleReason"] = reason
        svc = copy.deepcopy(svc)
        svc["status"] = {**(svc.get("status") or {}), **status}
        self._push_status(svc)
