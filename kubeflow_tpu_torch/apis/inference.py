"""InferenceService CRD API — the fleet-serving control surface.

A copy of ``kubeflow_tpu/apis/inference.py`` (standard library only), kept in
this package so the port imports nothing of the JAX one; the CRs it
builds are JAX's.

The reference serves models as a hand-sized tf-serving Deployment behind
an http-proxy (kubeflow/tf-serving/tf-serving-template.libsonnet:29-49);
this CRD is that stack at production shape: ONE object declares a model,
a replica range, the engine knobs, and the autoscaling targets, and the
InferenceService operator (operators/inference.py) reconciles N
model-server replicas, a prefix-affine gateway route over them, and a
metric-driven autoscaler consuming the serving latency histograms.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s

INFERENCE_KIND = "InferenceService"
INFERENCE_PLURAL = "inferenceservices"
INFERENCE_API_VERSION = f"{API_GROUP}/v1"

# Autoscale policy defaults: targets are BREACH thresholds (p99s over the
# serving histograms, KV fill over the real-byte gauges); scale-down needs
# every signal under target * scale_down_ratio (hysteresis band) AND
# cooldown_seconds since the last scale event (flap damping). In a
# role-split service each pool is judged ONLY on the signals that bind
# it: prefill on queue-wait/TTFT p99, decode on KV-byte fill and
# inter-token p99.
DEFAULT_AUTOSCALE = {
    "queueWaitP99Ms": 500.0,
    "ttftP99Ms": 2000.0,
    "interTokenP99Ms": 500.0,
    "kvBytesUtilization": 0.85,
    "scaleDownRatio": 0.5,
    "cooldownSeconds": 60.0,
    "scrapePeriodSeconds": 10.0,
    # How long a replica's last-good scrape may stand in for a failed
    # one. Within the window the operator HOLDS (no scale, no rollout
    # gate verdict on substituted data); past it the replica counts as
    # unobservable.
    "signalStalenessSeconds": 30.0,
    # Predictive scale-up (flash-crowd elasticity): fit the per-pool
    # queue-wait/TTFT trend over the kept scrape rounds and scale when
    # the projection at now + horizonSeconds breaches — ahead of the
    # breach itself — jumping straight to the projected replica count
    # (capped at maxStepUp added per round) instead of +1-per-period.
    # Off by default: reactive-only behavior is unchanged.
    "predictive": False,
    "horizonSeconds": 30.0,
    "maxStepUp": 4,
}

# Newborn warm-up defaults (spec.warmup): peer weight birth off, no
# shared compile-cache volume, and a zero ramp window — each knob is
# opt-in so an unconfigured service keeps the checkpoint-boot behavior.
# rampSeconds additionally bounds how long the autoscaler treats a
# just-born (possibly unscrapeable) replica as warming: such replicas
# neither anchor the scale-down cooldown nor count as calm signals.
DEFAULT_WARMUP = {
    "peerWeights": False,
    "compileCacheDir": "",
    "rampSeconds": 0.0,
}

# Roles a disaggregated InferenceService splits its replicas into.
INFERENCE_ROLES = ("prefill", "decode")

# Rollout policy defaults: the canary walk schedule (percent of traffic
# at each step), the dwell per step, and the SLO gates. ``gateRatio``
# bounds the candidate's TTFT/inter-token p99 at a multiple of the
# incumbent's; ``errorRateRatio`` does the same for the error rate (with
# an absolute floor so a 0-error incumbent doesn't make any candidate
# error infinite); ``quorum`` is the fraction of canary replicas that
# must stay scrapeable — losing it is a rollback, not a wait.
DEFAULT_ROLLOUT = {
    "steps": [1, 10, 50, 100],
    "stepSeconds": 60.0,
    "gateRatio": 1.5,
    "errorRateRatio": 2.0,
    "errorRateFloor": 0.01,
    "shadowFraction": 0.1,
    "shadowSeconds": 30.0,
    "quorum": 0.5,
}


def validate_versions(versions: list[dict]) -> list[dict]:
    """Validate a ``spec.versions`` list: unique names, every entry a
    ``{name, weightsRef, traffic}``, traffic weights summing to 100.
    Returns a normalized copy (ints/floats coerced) or raises
    ValueError — shared by the builder, the CRD tests, and the rollout
    controller's admission path."""
    if not versions:
        raise ValueError("spec.versions must be a non-empty list")
    seen: set[str] = set()
    out: list[dict] = []
    total = 0.0
    for v in versions:
        name = str(v.get("name", "")).strip()
        if not name:
            raise ValueError("spec.versions entry missing name")
        if name in seen:
            raise ValueError(f"duplicate version name {name!r}")
        seen.add(name)
        if not str(v.get("weightsRef", "")).strip():
            raise ValueError(f"version {name!r} missing weightsRef")
        traffic = float(v.get("traffic", 0))
        if traffic < 0 or traffic > 100:
            raise ValueError(
                f"version {name!r} traffic {traffic} outside [0, 100]")
        total += traffic
        entry = {"name": name, "weightsRef": str(v["weightsRef"]),
                 "traffic": traffic}
        # Optional per-version engine knob overrides (an Experiment's
        # winning config rides its candidate version through the walk).
        engine = v.get("engine")
        if engine is not None:
            if not isinstance(engine, dict):
                raise ValueError(
                    f"version {name!r} engine must be an object")
            entry["engine"] = dict(engine)
        out.append(entry)
    if abs(total - 100.0) > 1e-6:
        raise ValueError(
            f"spec.versions traffic weights sum to {total}, want 100")
    return out


def inference_service_crd() -> dict:
    autoscale_props = {
        "queueWaitP99Ms": {"type": "number", "minimum": 0},
        "ttftP99Ms": {"type": "number", "minimum": 0},
        "interTokenP99Ms": {"type": "number", "minimum": 0},
        "kvBytesUtilization": {"type": "number", "minimum": 0,
                               "maximum": 1},
        "scaleDownRatio": {"type": "number", "minimum": 0, "maximum": 1},
        "cooldownSeconds": {"type": "number", "minimum": 0},
        "scrapePeriodSeconds": {"type": "number", "minimum": 0},
        "signalStalenessSeconds": {"type": "number", "minimum": 0},
        "predictive": {"type": "boolean"},
        "horizonSeconds": {"type": "number", "minimum": 0},
        "maxStepUp": {"type": "integer", "minimum": 1},
    }
    # Newborn warm-up: peer weight birth, the shared compile-cache
    # volume, and the ramp window the autoscaler/gateway honor.
    warmup_schema = {
        "type": "object",
        "properties": {
            "peerWeights": {"type": "boolean"},
            "compileCacheDir": {"type": "string"},
            "rampSeconds": {"type": "number", "minimum": 0},
        },
    }
    # Engine knobs pass through to the model-server args verbatim, but
    # tpShards is declared explicitly: the operator reads it to size
    # each replica's chip request (a tp=4 replica is a 4-chip pod), and
    # a role-level override lets a disaggregated service run a big
    # prefill mesh next to small decode meshes.
    engine_schema = {
        "type": "object",
        "properties": {
            "tpShards": {"type": "integer", "minimum": 1},
            # Long-context knobs, declared explicitly: cpShards and
            # ppStages multiply into the replica chip request
            # (tp*cp*pp chips per pod), and role-level overrides let a
            # disaggregated service run a wide-cp prefill pool feeding
            # tp-only decode pools over the existing handoff.
            "cpShards": {"type": "integer", "minimum": 1},
            "ppStages": {"type": "integer", "minimum": 1},
            "prefillChunkTokens": {"type": "integer", "minimum": 0},
            "maxPromptLen": {"type": "integer", "minimum": 0},
            # Host-RAM KV tier budget (bytes): declared explicitly so
            # operators sizing pod memory see it in the schema — the
            # tier's bytes come out of the pod's RAM, not HBM.
            "hostKvBytes": {"type": "integer", "minimum": 0},
            # Fleet KV economy: the prefix->holder directory's key
            # capacity (0 = economy off), the shared cold store ref
            # ("mem://<name>[?bytes=n]"), and the recompute-vs-import
            # crossover threshold in prefill tokens. Declared so the
            # operator can validate them and so colocated replicas of
            # one service share the same cold store name by default.
            "kvDirectorySize": {"type": "integer", "minimum": 0},
            "coldStoreRef": {"type": "string"},
            "importCrossoverTokens": {"type": "integer", "minimum": 0},
        },
        "x-kubernetes-preserve-unknown-fields": True,
    }
    # Multi-tenant QoS: per-tenant weights/rates threaded to the model
    # server's fair-share pop loop AND to the gateway route's shedding
    # buckets.
    tenant_schema = {
        "type": "object",
        "properties": {
            "weight": {"type": "number", "minimum": 0},
            "rate": {"type": "number", "minimum": 0},
            "burst": {"type": "number", "minimum": 0},
            "priority": {"type": "integer"},
        },
    }
    qos_schema = {
        "type": "object",
        "properties": {
            "agingSeconds": {"type": "number", "minimum": 0},
            "tenants": {"type": "object",
                        "additionalProperties": tenant_schema},
            "default": tenant_schema,
        },
    }
    # Per-role pool overrides for disaggregated prefill/decode serving:
    # each role gets its own replica range and engine overrides (merged
    # over the top-level engine; the operator pins serving_role and the
    # paged KV layout the handoff needs).
    role_props = {
        "replicas": {"type": "integer", "minimum": 0},
        "minReplicas": {"type": "integer", "minimum": 1},
        "maxReplicas": {"type": "integer", "minimum": 1},
        "engine": engine_schema,
    }
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["model"],
                "properties": {
                    "model": {"type": "string"},
                    "modelPath": {"type": "string"},
                    "image": {"type": "string"},
                    "replicas": {"type": "integer", "minimum": 0},
                    "minReplicas": {"type": "integer", "minimum": 1},
                    "maxReplicas": {"type": "integer", "minimum": 1},
                    "tpuChipsPerReplica": {"type": "integer",
                                           "minimum": 0},
                    # Engine knobs passed verbatim to the model-server
                    # args (the tpu-serving param surface); tpShards
                    # additionally sizes the replica's chip request.
                    "engine": engine_schema,
                    "router": {
                        "type": "object",
                        "properties": {
                            "affinityTokens": {"type": "integer",
                                               "minimum": 1},
                            "pressure": {"type": "integer",
                                         "minimum": 0},
                            "kvPressure": {"type": "number",
                                           "minimum": 0, "maximum": 1},
                        },
                    },
                    "roles": {
                        "type": "object",
                        "properties": {
                            role: {"type": "object",
                                   "properties": role_props}
                            for role in INFERENCE_ROLES
                        },
                    },
                    "qos": qos_schema,
                    "autoscale": {"type": "object",
                                  "properties": autoscale_props},
                    "warmup": warmup_schema,
                    # Progressive delivery: the declared model versions
                    # (traffic is the steady-state split the rollout
                    # walks toward) and the canary policy knobs.
                    "versions": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["name", "weightsRef"],
                            "properties": {
                                "name": {"type": "string"},
                                "weightsRef": {"type": "string"},
                                "traffic": {"type": "number",
                                            "minimum": 0,
                                            "maximum": 100},
                                # Engine knob overrides the candidate
                                # carries (Experiment promotion).
                                "engine": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields":
                                        True,
                                },
                            },
                        },
                    },
                    "rollout": {
                        "type": "object",
                        "properties": {
                            "steps": {
                                "type": "array",
                                "items": {"type": "number",
                                          "minimum": 0,
                                          "maximum": 100},
                            },
                            "stepSeconds": {"type": "number",
                                            "minimum": 0},
                            "gateRatio": {"type": "number",
                                          "minimum": 1},
                            "errorRateRatio": {"type": "number",
                                               "minimum": 1},
                            "errorRateFloor": {"type": "number",
                                               "minimum": 0},
                            "shadowFraction": {"type": "number",
                                               "minimum": 0,
                                               "maximum": 1},
                            "shadowSeconds": {"type": "number",
                                              "minimum": 0},
                            "quorum": {"type": "number",
                                       "minimum": 0, "maximum": 1},
                        },
                    },
                },
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    return k8s.crd(
        group=API_GROUP,
        kind=INFERENCE_KIND,
        plural=INFERENCE_PLURAL,
        short_names=["isvc"],
        categories=["all", "kubeflow-tpu"],
        versions=[
            k8s.crd_version(
                "v1",
                schema=schema,
                storage=True,
                printer_columns=[
                    k8s.printer_column("Model", ".spec.model"),
                    k8s.printer_column("Replicas", ".status.replicas",
                                       "integer"),
                    k8s.printer_column("Ready", ".status.readyReplicas",
                                       "integer"),
                    k8s.printer_column("Phase", ".status.phase"),
                    k8s.printer_column("Age", ".metadata.creationTimestamp",
                                       "date"),
                ],
            )
        ],
    )


def inference_service(
    name: str,
    namespace: str,
    model: str,
    *,
    model_path: str = "",
    image: str = "",
    replicas: int = 1,
    min_replicas: int = 1,
    max_replicas: int = 4,
    tpu_chips_per_replica: int = 0,
    engine: dict | None = None,
    affinity_tokens: int = 32,
    pressure: int = 8,
    kv_pressure: float = 0.0,
    roles: dict | None = None,
    qos: dict | None = None,
    autoscale: dict | None = None,
    warmup: dict | None = None,
    versions: list[dict] | None = None,
    rollout: dict | None = None,
) -> dict:
    """Build an InferenceService CR. ``engine`` maps tpu-serving param
    names (batch_size, kv_layout, ...) to values; ``autoscale`` overrides
    DEFAULT_AUTOSCALE keys. ``roles`` splits the service into
    disaggregated prefill/decode pools: ``{"prefill": {"replicas": 2,
    "engine": {...}}, "decode": {...}}`` — each pool autoscaled on the
    signal that binds it. ``kv_pressure`` (0 disables) lets the gateway
    spill affine picks off a backend whose KV pool fill crosses it.
    ``qos`` ({tenants: {name: {weight, rate, burst, priority}},
    agingSeconds, default}) turns on multi-tenant fair-share admission
    in every replica and 429 shedding at the gateway route.

    ``versions`` ([{name, weightsRef, traffic}, ...], weights summing
    to 100) declares the model versions the service serves; when more
    than one is present the RolloutController canaries the newest in
    via the walk declared by ``rollout`` (DEFAULT_ROLLOUT overridden
    key-wise). Single-version specs (the default) are unchanged —
    omitting ``versions`` produces the exact legacy manifest."""
    if roles:
        bad = set(roles) - set(INFERENCE_ROLES)
        if bad:
            raise ValueError(f"unknown inference roles {sorted(bad)}")
    if versions is not None:
        versions = validate_versions(versions)
        if roles:
            # Scope bound: a versioned rollout pushes one param tree
            # into one homogeneous pool; disaggregated prefill/decode
            # pools version independently is future work.
            raise ValueError(
                "spec.versions is not supported on a role-split "
                "(disaggregated) service")
    if rollout is not None:
        bad = set(rollout) - set(DEFAULT_ROLLOUT)
        if bad:
            raise ValueError(f"unknown rollout keys {sorted(bad)}")
    if warmup is not None:
        bad = set(warmup) - set(DEFAULT_WARMUP)
        if bad:
            raise ValueError(f"unknown warmup keys {sorted(bad)}")
    router: dict = {"affinityTokens": int(affinity_tokens),
                    "pressure": int(pressure)}
    if kv_pressure:
        router["kvPressure"] = float(kv_pressure)
    spec: dict = {
        "model": model,
        "replicas": int(replicas),
        "minReplicas": int(min_replicas),
        "maxReplicas": int(max_replicas),
        "router": router,
        "autoscale": {**DEFAULT_AUTOSCALE, **(autoscale or {})},
    }
    if roles:
        spec["roles"] = {r: dict(v) for r, v in roles.items()}
    if qos:
        spec["qos"] = dict(qos)
    if warmup is not None:
        # Present only when asked for: an unconfigured service renders
        # the exact legacy manifest (no spec.warmup key at all).
        spec["warmup"] = {**DEFAULT_WARMUP, **warmup}
    if model_path:
        spec["modelPath"] = model_path
    if image:
        spec["image"] = image
    if tpu_chips_per_replica:
        spec["tpuChipsPerReplica"] = int(tpu_chips_per_replica)
    if engine:
        spec["engine"] = dict(engine)
    if versions is not None:
        spec["versions"] = versions
        spec["rollout"] = {**DEFAULT_ROLLOUT, **(rollout or {})}
    return {
        "apiVersion": INFERENCE_API_VERSION,
        "kind": INFERENCE_KIND,
        "metadata": k8s.metadata(name, namespace, {"app": name}),
        "spec": spec,
    }
