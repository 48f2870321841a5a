"""RolloutController: SLO-gated canary rollouts over the weight-push path;
the port's counterpart of ``kubeflow_tpu/operators/rollout.py``.

A copy of JAX's controller over the port's fleet
(``kubeflow_tpu_torch/serving/fleet.py:DecoderFleet``: ``members``,
``live_members``, ``broadcast_weights(version=, members=)``,
``weights_versions``) and the port's signal scrape; its state machine
and the ``status.rollout`` it writes are JAX's.

The reference platform ships model upgrades as tf-serving version
policies behind ambassador's weighted routing — a new version gets a
slice of traffic, dashboards get watched, a human flips the weight. This
controller is that loop closed and made safe: an InferenceService whose
``spec.versions`` declares a second version is canaried by **pushing**
the candidate's weights into a named replica subset via
``DecoderFleet.broadcast_weights(version=..., members=[...])`` — no new
pods, the swap is the decoders' zero-drain epoch install — and then
walking the candidate's traffic share 1% → 10% → 50% → 100%, each step
gated on the candidate cohort's TTFT/inter-token p99 and error rate
(scraped through the same ``scrape_signals`` exposition path the
autoscaler reads) staying within a configured ratio of the incumbent
cohort's.

Division of labor: this controller owns ``status.rollout`` (phase, step,
canary membership, epochs, breach evidence) and the weight pushes; the
InferenceServiceController stays the single writer of the router
Service annotation and *renders* ``status.rollout`` into the gateway's
hash-split route. Neither writes the other's surface, so the two
reconcile loops never fight.

The state machine is deliberately storage-less: everything a fresh
controller needs mid-walk is in the CR status plus the fleet's
``weights_versions()`` — an operator restart re-reads both and
continues the walk (or re-converges a half-landed rollback) without a
step of history.

Rollback is just a push: the incumbent's params go out at a FRESH
monotonic epoch (re-pushing the old epoch number would be refused by
canary replicas already holding the higher candidate epoch — stale
pushes are idempotent no-ops by design). A rollback racing a concurrent
``broadcast_weights`` therefore converges like any other epoch race:
the reconcile loop re-pushes at latest+1 until ``weights_versions()``
reports one uniform epoch across the live fleet.
"""

from __future__ import annotations

import logging
import math
import time

from kubeflow_tpu_torch.apis.inference import (
    DEFAULT_AUTOSCALE,
    DEFAULT_ROLLOUT,
    INFERENCE_API_VERSION,
    INFERENCE_KIND,
    validate_versions,
)
from kubeflow_tpu_torch.k8s_client import retry_on_conflict
from kubeflow_tpu_torch.operators.base import Controller
from kubeflow_tpu_torch.operators.inference import (
    REST_PORT,
    SignalCache,
    _http_fetch_signals,
)

log = logging.getLogger(__name__)

# Rollout phases. Shadow and Walking are live (the gateway splits /
# mirrors); Promoted, RolledBack, and Invalid are terminal for the
# current candidate — a new candidate (spec change) starts a new walk.
LIVE_PHASES = ("Shadow", "Walking")

# Latency floor for the incumbent baseline: a cold incumbent cohort
# whose p99 reads 0.0 must not make every candidate ratio infinite.
_BASELINE_FLOOR_S = 1e-3

# In-process fleet registry: the serving runtime (bench, tests, an
# embedded deployment) registers the DecoderFleet that backs an
# InferenceService so the controller can push weights into it.
_FLEETS: dict[tuple[str, str], object] = {}


def register_fleet(namespace: str, name: str, fleet) -> None:
    _FLEETS[(namespace, name)] = fleet


def unregister_fleet(namespace: str, name: str) -> None:
    _FLEETS.pop((namespace, name), None)


def _registry_fleet(namespace: str, name: str):
    return _FLEETS.get((namespace, name))


class RolloutController(Controller):
    """spec.versions → canary walk → Promoted | RolledBack.

    Injectables (tests and the bench drive all four):

    - ``fleet_for(ns, name)`` → the fleet handle (default: the
      in-process registry);
    - ``weights_for(ref)`` → a param pytree for a ``weightsRef``
      (default: None — without a resolver the controller parks the
      rollout in Pending rather than guessing);
    - ``fetch_metrics(addr)`` → signal dict | None (default: the HTTP
      exposition scrape), staleness-cached like the autoscaler's;
    - ``clock`` → monotonic seconds.
    """

    api_version = INFERENCE_API_VERSION
    kind = INFERENCE_KIND

    def __init__(self, client, *, fleet_for=None, weights_for=None,
                 fetch_metrics=None, clock=time.monotonic):
        super().__init__(client)
        self.fleet_for = fleet_for or _registry_fleet
        self.weights_for = weights_for or (lambda ref: None)
        self.fetch_metrics = fetch_metrics or _http_fetch_signals
        self.clock = clock
        self.signal_cache = SignalCache(
            lambda addr: self.fetch_metrics(addr), clock)

    # -- reconcile ----------------------------------------------------

    def reconcile(self, svc: dict) -> float | None:
        spec = svc.get("spec", {})
        versions = spec.get("versions")
        if not versions or len(versions) < 2:
            return None  # single-version service: nothing to roll out
        try:
            versions = validate_versions(versions)
            if spec.get("roles"):
                raise ValueError("spec.versions is not supported on a "
                                 "role-split service")
        except ValueError as e:
            self._set_rollout(svc, {"phase": "Invalid",
                                    "reason": str(e)})
            return None
        cfg = {**DEFAULT_ROLLOUT, **(spec.get("rollout") or {})}
        auto = {**DEFAULT_AUTOSCALE, **(spec.get("autoscale") or {})}
        incumbent, candidate = versions[0], versions[-1]

        ns = svc["metadata"]["namespace"]
        name = svc["metadata"]["name"]
        ro = dict((svc.get("status") or {}).get("rollout") or {})
        if (ro.get("candidate", {}).get("name") != candidate["name"]
                or ro.get("candidate", {}).get("weightsRef")
                != candidate["weightsRef"]
                or ro.get("incumbent", {}).get("name")
                != incumbent["name"]):
            ro = {}  # a different candidate: a new rollout starts

        fleet = self.fleet_for(ns, name)
        if fleet is None:
            self._set_rollout(svc, {"phase": "Pending",
                                    "reason": "no fleet handle",
                                    "candidate": dict(candidate),
                                    "incumbent": dict(incumbent)})
            return float(auto["scrapePeriodSeconds"])

        phase = ro.get("phase")
        if phase in ("Promoted", "RolledBack"):
            # Terminal for this candidate — but a half-landed final
            # push (rollback racing a concurrent broadcast, operator
            # killed mid-fan-out) may have left the fleet on mixed
            # epochs: keep converging until one uniform version.
            which = candidate if phase == "Promoted" else incumbent
            target = float(candidate["traffic"])
            if phase == "Promoted" and target < 100.0:
                return None  # steady-state A/B split: mixed on purpose
            if self._converged(fleet):
                return None
            params = self.weights_for(which["weightsRef"])
            if params is None:
                return None
            res = fleet.broadcast_weights(params)
            ro[("promotedEpoch" if phase == "Promoted"
                else "rolledBackEpoch")] = res["version"]
            self._set_rollout(svc, ro)
            return float(auto["scrapePeriodSeconds"])
        if phase == "Invalid":
            return None

        params = self.weights_for(candidate["weightsRef"])
        if params is None:
            self._set_rollout(svc, {"phase": "Pending",
                                    "reason": "weightsRef "
                                    f"{candidate['weightsRef']!r} "
                                    "unresolvable",
                                    "candidate": dict(candidate),
                                    "incumbent": dict(incumbent)})
            return float(auto["scrapePeriodSeconds"])

        steps = self._walk_steps(cfg, float(candidate["traffic"]))
        now = self.clock()
        if phase not in LIVE_PHASES:
            # Start: anchor the incumbent at whatever the fleet serves
            # NOW, claim the next epoch for the candidate.
            wv = fleet.weights_versions()
            ro = {
                "phase": "Shadow",
                "step": -1,
                "trafficPercent": 0.0,
                "shadowFraction": float(cfg["shadowFraction"]),
                "steps": steps,
                "candidate": {**candidate, "epoch": wv["latest"] + 1},
                "incumbent": {**incumbent, "epoch": wv["latest"]},
                "canaryMembers": [],
                "phaseStartedAt": now,
            }
        if float(ro.get("phaseStartedAt", now)) > now:
            # Monotonic clock restarted under us (operator restart):
            # re-anchor the dwell rather than waiting forever.
            ro["phaseStartedAt"] = now

        members = fleet.members()
        live = (fleet.live_members() if hasattr(fleet, "live_members")
                else members)
        step = int(ro.get("step", -1))
        traffic = steps[step] if 0 <= step < len(steps) else 0.0
        canary = self._canary_subset(
            ro.get("canaryMembers", []), members, live,
            steps[0] if step < 0 else traffic)
        ro["canaryMembers"] = canary
        ro["trafficPercent"] = traffic
        ro["phase"] = "Shadow" if step < 0 else "Walking"

        # Converge the canary onto the candidate epoch (idempotent:
        # already-installed members no-op; a replica that died and came
        # back, or just joined the subset at this step, installs now).
        res = fleet.broadcast_weights(
            params, version=int(ro["candidate"]["epoch"]), members=canary)
        if res["installed"]:
            ro["candidate"]["epoch"] = max(res["installed"].values())

        verdict = self._judge(svc, ro, cfg, auto, canary,
                              [m for m in members if m not in canary])
        if verdict["outcome"] == "breach":
            return self._rollback(svc, fleet, ro, auto, verdict["evidence"])
        if verdict["outcome"] == "hold":
            ro["gate"] = verdict.get("gate", {})
            self._set_rollout(svc, ro)
            return float(auto["scrapePeriodSeconds"])

        ro["gate"] = verdict.get("gate", {})
        dwell = float(cfg["shadowSeconds"] if step < 0
                      else cfg["stepSeconds"])
        if now - float(ro.get("phaseStartedAt", now)) >= dwell:
            if step + 1 < len(steps):
                ro["step"] = step + 1
                ro["trafficPercent"] = steps[step + 1]
                ro["phase"] = "Walking"
                ro["phaseStartedAt"] = now
                # Widen the subset to the new share NOW — the status
                # this reconcile writes is what the router renders, and
                # N% of traffic must never land on a subset sized for
                # the previous step.
                canary = self._canary_subset(
                    canary, members, live, ro["trafficPercent"])
                ro["canaryMembers"] = canary
                res = fleet.broadcast_weights(
                    params, version=int(ro["candidate"]["epoch"]),
                    members=canary)
                if res["installed"]:
                    ro["candidate"]["epoch"] = max(
                        res["installed"].values())
            else:
                return self._promote(svc, fleet, ro, auto, params)
        self._set_rollout(svc, ro)
        return float(auto["scrapePeriodSeconds"])

    # -- walk mechanics -----------------------------------------------

    @staticmethod
    def _walk_steps(cfg: dict, target: float) -> list[float]:
        """The traffic schedule, clipped to the candidate's declared
        steady-state share and always ending exactly on it."""
        steps = [float(s) for s in cfg["steps"] if 0 < float(s) < target]
        return steps + [target] if target > 0 else steps

    @staticmethod
    def _canary_subset(prev: list[str], members: list[str],
                       live: list[str], traffic: float) -> list[str]:
        """The named replicas holding the candidate epoch at this step:
        ceil(traffic% of the fleet), at least one. Sticky — members
        already canaried stay (their weights are already swapped);
        growth tops up from the TAIL of the sorted member list, the
        same stable end the autoscaler prunes from, so subset identity
        is deterministic and reconstructible."""
        members = sorted(members)
        if not members:
            return []
        want = max(1, math.ceil(len(members) * traffic / 100.0))
        keep = [m for m in members if m in set(prev)][:want]
        pool = [m for m in reversed(members)
                if m not in set(keep) and m in set(live)]
        for m in pool:
            if len(keep) >= want:
                break
            keep.append(m)
        return sorted(keep)

    def _scrape_cohort(self, ns: str, cohort: list[str],
                       staleness_s: float) -> tuple[list[dict], int, bool]:
        """(usable signals, scraped count, any_stale) for a member-name
        cohort. A held (stale) sample is usable for display but poisons
        the verdict — the caller holds instead of judging."""
        signals, scraped, any_stale = [], 0, False
        for m in cohort:
            sig, fresh = self.signal_cache.scrape(
                f"{m}.{ns}:{REST_PORT}", staleness_s)
            if sig is not None:
                signals.append(sig)
                scraped += 1
                any_stale = any_stale or not fresh
        return signals, scraped, any_stale

    def _judge(self, svc: dict, ro: dict, cfg: dict, auto: dict,
               canary: list[str], stable: list[str]) -> dict:
        """Gate verdict for this round: ``pass`` (advance on dwell),
        ``hold`` (stale or incomparable data — never decide on it), or
        ``breach`` (rollback, with evidence). Quorum is judged on
        SCRAPEABLE canary replicas — a dead/unobservable canary is a
        breach class of its own, not a metrics verdict."""
        ns = svc["metadata"]["namespace"]
        staleness = float(auto["signalStalenessSeconds"])
        cand_sigs, cand_n, cand_stale = self._scrape_cohort(
            ns, canary, staleness)
        if canary and cand_n / len(canary) < float(cfg["quorum"]):
            return {"outcome": "breach", "evidence": {
                "reason": "quorum-loss",
                "scrapedCanaries": cand_n,
                "canaryMembers": list(canary),
                "quorum": float(cfg["quorum"]),
            }}
        inc_sigs, _inc_n, inc_stale = self._scrape_cohort(
            ns, stable, staleness)
        if cand_stale or inc_stale:
            return {"outcome": "hold",
                    "gate": {"held": "stale scrape signals"}}
        if not stable or not inc_sigs or not cand_sigs:
            # Nothing to compare against (100% step, incumbent cohort
            # unobservable, or canary not yet emitting): no verdict.
            return {"outcome": "pass", "gate": {}}

        def _p99(sigs, key):
            return max(s.get(key, 0.0) for s in sigs)

        gate: dict = {}
        ratio = float(cfg["gateRatio"])
        for key, label in (("ttft_p99_s", "ttftP99"),
                           ("inter_token_p99_s", "interTokenP99")):
            cand = _p99(cand_sigs, key)
            inc = max(_p99(inc_sigs, key), _BASELINE_FLOOR_S)
            gate[label] = {"candidate": round(cand, 6),
                           "incumbent": round(inc, 6),
                           "limit": round(inc * ratio, 6)}
            if cand > inc * ratio:
                return {"outcome": "breach", "evidence": {
                    "reason": "gate-breach", "signal": label,
                    "candidate": round(cand, 6),
                    "incumbent": round(inc, 6),
                    "gateRatio": ratio,
                    "step": int(ro.get("step", -1)),
                    "trafficPercent": float(ro.get("trafficPercent", 0)),
                }}
        cand_err = _p99(cand_sigs, "error_rate")
        inc_err = _p99(inc_sigs, "error_rate")
        limit = max(inc_err * float(cfg["errorRateRatio"]),
                    float(cfg["errorRateFloor"]))
        gate["errorRate"] = {"candidate": round(cand_err, 6),
                             "incumbent": round(inc_err, 6),
                             "limit": round(limit, 6)}
        if cand_err > limit:
            return {"outcome": "breach", "evidence": {
                "reason": "gate-breach", "signal": "errorRate",
                "candidate": round(cand_err, 6),
                "incumbent": round(inc_err, 6),
                "limit": round(limit, 6),
                "step": int(ro.get("step", -1)),
                "trafficPercent": float(ro.get("trafficPercent", 0)),
            }}
        return {"outcome": "pass", "gate": gate}

    # -- terminal transitions -----------------------------------------

    def _rollback(self, svc: dict, fleet, ro: dict, auto: dict,
                  evidence: dict) -> float:
        """Rollback IS a push: the incumbent's params at a FRESH epoch,
        fleet-wide (the canary subset holds the higher candidate epoch,
        which refuses any replay of the old number — and pushing
        everyone makes the race with a concurrent broadcast converge by
        epoch monotonicity). The routing reset is the phase flip: the
        InferenceServiceController re-renders a plain route the moment
        status.rollout leaves the live phases."""
        evidence["at"] = round(self.clock(), 3)
        ro["phase"] = "RolledBack"
        ro["evidence"] = evidence
        params = self.weights_for(ro["incumbent"]["weightsRef"])
        if params is not None:
            res = fleet.broadcast_weights(params)
            ro["rolledBackEpoch"] = res["version"]
        self._set_rollout(svc, ro)
        log.warning("rollout %s/%s rolled back: %s",
                    svc["metadata"]["namespace"],
                    svc["metadata"]["name"], evidence)
        return float(auto["scrapePeriodSeconds"])

    def _promote(self, svc: dict, fleet, ro: dict, auto: dict,
                 params) -> float | None:
        """The walk completed every gated step: at a 100% target the
        candidate epoch goes fleet-wide (stragglers and revived
        replicas converge on this push); a <100% target leaves the
        declared steady-state split in place."""
        ro["phase"] = "Promoted"
        ro["trafficPercent"] = float(ro["candidate"]["traffic"])
        if float(ro["candidate"]["traffic"]) >= 100.0:
            res = fleet.broadcast_weights(
                params, version=int(ro["candidate"]["epoch"]))
            ro["promotedEpoch"] = res["version"]
        self._set_rollout(svc, ro)
        return float(auto["scrapePeriodSeconds"])

    @staticmethod
    def _converged(fleet) -> bool:
        """One uniform installed epoch across the live fleet."""
        wv = fleet.weights_versions()
        live = (fleet.live_members() if hasattr(fleet, "live_members")
                else fleet.members())
        epochs = {wv["installed"].get(m, 0) for m in live}
        return len(epochs) <= 1

    # -- status plumbing ----------------------------------------------

    def _set_rollout(self, svc: dict, ro: dict) -> None:
        """Write ONLY status.rollout on the live object (refetch +
        reapply on conflict) — the InferenceServiceController owns
        every other status key, and clobbering its fresh replica counts
        with our stale copy would ping-pong the two loops forever."""
        meta = svc["metadata"]

        def _write(client):
            current = client.get_or_none(
                svc["apiVersion"], svc["kind"], meta["name"],
                meta.get("namespace"))
            if current is None:
                return None
            status = dict(current.get("status") or {})
            if status.get("rollout") == ro:
                return current
            status["rollout"] = ro
            current["status"] = status
            return client.update_status(current)

        retry_on_conflict(self.client, _write)
        # Keep the in-memory copy coherent for callers inspecting svc.
        svc.setdefault("status", {})["rollout"] = ro
