"""The port's RolloutController beside the JAX package's.

On stubs: both rollout controllers (with both InferenceService
controllers rendering ``status.rollout`` into the router annotation) run
the same CR sequence, each against its own fake apiserver and its own
copy of JAX's ``StubFleet`` (``tests/test_rollout.py``), with one
injected ``fetch_metrics`` and one clock. After every round
``status.rollout`` (the whole status), the parsed router annotation and
each stub's installed epochs and pushes must be equal. The cases are
those of ``tests/test_rollout.py``'s controller tests plus an invalid
``spec.versions``, a role-split service, an unresolvable ``weightsRef``,
a steady-state A/B split and the re-convergence of a half-landed
rollback.

End to end: a walk over a port ``DecoderFleet`` of two ``lm-test-tiny``
replicas beside a JAX one, float32 on the CPU, the incumbent and the
candidate JAX's ``PRNGKey(0)`` and ``PRNGKey(1)`` weights carried into
the port by ``kubeflow_tpu_torch/weights.py``, the judge reading each
member's own exposition: the same ``status.rollout`` sequence (the gate's
measured latencies aside) and, after the promotion, greedy tokens equal
to JAX's fleet's and to a decoder cold-started on the candidate.
"""

import copy

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.apis.inference import inference_service as jservice  # noqa: E402
from kubeflow_tpu.apis.inference import inference_service_crd as jcrd  # noqa: E402
from kubeflow_tpu.k8s.fake import FakeApiServer as JFakeApiServer  # noqa: E402
from kubeflow_tpu.manifests.core import GATEWAY_ROUTE_ANNOTATION  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.operators import inference as jinf  # noqa: E402
from kubeflow_tpu.operators import rollout as jrollout  # noqa: E402
from kubeflow_tpu.serving import fleet as jfleet  # noqa: E402
from kubeflow_tpu.serving import scenarios as jscenarios  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.apis.inference import (  # noqa: E402
    inference_service,
    inference_service_crd,
)
from kubeflow_tpu_torch.k8s_fake import FakeApiServer  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402
from kubeflow_tpu_torch.operators import inference as tinf  # noqa: E402
from kubeflow_tpu_torch.operators import rollout as trollout  # noqa: E402
from kubeflow_tpu_torch.serving import fleet as tfleet  # noqa: E402
from kubeflow_tpu_torch.serving import scenarios as tscenarios  # noqa: E402
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402
from test_rollout import StubFleet  # noqa: E402

NS = "kubeflow"
API = "kubeflow-tpu.org/v1"
CALM = {"queue_wait_p99_s": 0.05, "ttft_p99_s": 0.1,
        "inter_token_p99_s": 0.02, "kv_utilization": 0.2,
        "queued": 0.0, "error_rate": 0.0}
SLOW = {**CALM, "ttft_p99_s": 1.0}  # > 0.1 * gateRatio(1.5)
ERRORING = {**CALM, "error_rate": 0.5}
CANARY = f"llm-r3.{NS}:8500"
VERSIONS = [{"name": "v1", "weightsRef": "ckpt/v1", "traffic": 0},
            {"name": "v2", "weightsRef": "ckpt/v2", "traffic": 100}]
SIDES = ("jax", "torch")


def _cr(**kw):
    kw.setdefault("replicas", 4)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("versions", copy.deepcopy(VERSIONS))
    kw.setdefault("rollout", {"stepSeconds": 1.0, "shadowSeconds": 1.0})
    kw.setdefault("autoscale", {"scrapePeriodSeconds": 5,
                                "signalStalenessSeconds": 20})
    return kw


def _route(api):
    svc = api.get("v1", "Service", "llm", NS)
    return yaml.safe_load(
        svc["metadata"]["annotations"][GATEWAY_ROUTE_ANNOTATION])


class Twins:
    """Both packages' rollout and InferenceService controllers, each
    side on its own apiserver and stub fleet, one clock, one scrape."""

    def __init__(self, fleet: bool = True,
                 weights=(("ckpt/v1", "W-INCUMBENT"),
                          ("ckpt/v2", "W-CANDIDATE"))):
        self.t = 0.0
        self.by_addr: dict = {}
        self.apis = {"jax": JFakeApiServer(), "torch": FakeApiServer()}
        self.apis["jax"].apply(jcrd())
        self.apis["torch"].apply(inference_service_crd())
        self.fleets = {s: StubFleet([f"llm-r{i}" for i in range(4)])
                       for s in SIDES}
        weights = dict(weights)
        self.rc, self.ic = {}, {}
        for side, rmod, imod in (("jax", jrollout, jinf),
                                 ("torch", trollout, tinf)):
            self.apis[side].ensure_namespace(NS)
            self.rc[side] = rmod.RolloutController(
                self.apis[side], fleet_for=(
                    lambda ns, n, s=side: self.fleets[s] if fleet else None),
                weights_for=weights.get, fetch_metrics=self.fetch,
                clock=lambda: self.t)
            self.ic[side] = imod.InferenceServiceController(
                self.apis[side], fetch_metrics=self.fetch,
                clock=lambda: self.t)

    def fetch(self, addr):
        v = self.by_addr.get(addr, CALM)
        return dict(v) if v is not None else None

    def create(self, name="llm", **kw):
        jcr = jservice(name, NS, "lm-test-tiny", **kw)
        tcr = inference_service(name, NS, "lm-test-tiny", **kw)
        assert tcr == jcr
        for side, cr in (("jax", jcr), ("torch", tcr)):
            self.apis[side].create(cr)

    def status(self, side="torch", name="llm"):
        return self.apis[side].get(API, "InferenceService", name,
                                   NS).get("status", {})

    def rollout(self, side="torch", name="llm"):
        return self.status(side, name).get("rollout", {})

    def round(self, dt: float = 2.0, router: bool = False) -> dict:
        """The clock on by ``dt``, one rollout pass a side (then the
        InferenceService controller's with ``router``); asserts the two
        sides agree; the port's status.rollout."""
        self.t += dt
        for side in SIDES:
            self.rc[side].reconcile_all()
            if router:
                self.ic[side].reconcile_all()
        assert self.status("torch") == self.status("jax")
        jf, tf = self.fleets["jax"], self.fleets["torch"]
        assert (tf.installed, tf.pushes, tf.params_of, tf.latest) == \
            (jf.installed, jf.pushes, jf.params_of, jf.latest)
        if router:
            assert _route(self.apis["torch"]) == _route(self.apis["jax"])
        return self.rollout()


def case_good_candidate_promotes(tw):
    tw.create(**_cr())
    ro = tw.round(0)
    assert ro["phase"] == "Shadow" and ro["canaryMembers"] == ["llm-r3"]
    assert (ro["candidate"]["epoch"], ro["incumbent"]["epoch"]) == (2, 1)
    assert tw.round()["trafficPercent"] == 1.0
    tw.round()
    assert tw.round()["trafficPercent"] == 50.0
    tw.round()
    ro = tw.round()
    assert (ro["phase"], ro["promotedEpoch"]) == ("Promoted", 2)
    assert set(tw.fleets["torch"].installed.values()) == {2}
    n = len(tw.fleets["torch"].pushes)
    tw.round()
    assert len(tw.fleets["torch"].pushes) == n  # terminal


def case_regressed_candidate_rolls_back(tw):
    tw.create(**_cr())
    tw.round(0)
    tw.by_addr[CANARY] = dict(SLOW)
    ro = tw.round()
    assert ro["phase"] == "RolledBack" and ro["rolledBackEpoch"] == 3
    assert (ro["evidence"]["reason"], ro["evidence"]["signal"]) == \
        ("gate-breach", "ttftP99")
    assert set(tw.fleets["torch"].params_of.values()) == {"W-INCUMBENT"}
    tw.round()
    assert tw.round()["phase"] == "RolledBack"  # no auto-retry


def case_error_rate_gate(tw):
    tw.create(**_cr())
    tw.round(0)
    tw.by_addr[CANARY] = dict(ERRORING)
    ro = tw.round()
    assert ro["evidence"]["signal"] == "errorRate"


def case_stale_scrape_holds(tw):
    tw.create(**_cr())
    traffic = tw.round(0)["trafficPercent"]
    tw.by_addr[CANARY] = None
    for _ in range(3):
        ro = tw.round()
    assert ro["trafficPercent"] == traffic
    assert ro["gate"]["held"] == "stale scrape signals"
    tw.by_addr.pop(CANARY)
    for _ in range(5):
        ro = tw.round()
    assert ro["phase"] == "Promoted"


def case_quorum_loss(tw):
    tw.create(**_cr())
    tw.round(0)
    tw.by_addr[CANARY] = None
    ro = tw.round(25.0)
    assert ro["evidence"]["reason"] == "quorum-loss"
    assert ro["evidence"]["scrapedCanaries"] == 0


def case_single_version_ignored(tw):
    tw.create(**_cr(versions=None))
    assert tw.round(0) == {} and tw.fleets["torch"].pushes == []


def case_missing_fleet_pending(tw):
    tw.create(**_cr())
    ro = tw.round(0)
    assert (ro["phase"], ro["reason"]) == ("Pending", "no fleet handle")


def case_unresolvable_weights_pending(tw):
    tw.create(**_cr(versions=[
        {"name": "v1", "weightsRef": "ckpt/v1", "traffic": 0},
        {"name": "v3", "weightsRef": "ckpt/missing", "traffic": 100}]))
    ro = tw.round(0)
    assert ro["phase"] == "Pending" and "unresolvable" in ro["reason"]


def case_invalid_versions(tw):
    tw.create(**_cr())
    for side in SIDES:
        cr = tw.apis[side].get(API, "InferenceService", "llm", NS)
        cr["spec"]["versions"][1]["traffic"] = 70
        tw.apis[side].update(cr)
    ro = tw.round(0)
    assert ro["phase"] == "Invalid" and "sum to 70" in ro["reason"]


def case_role_split_invalid(tw):
    tw.create(**_cr(versions=None))
    for side in SIDES:
        cr = tw.apis[side].get(API, "InferenceService", "llm", NS)
        cr["spec"]["versions"] = copy.deepcopy(VERSIONS)
        cr["spec"]["roles"] = {"prefill": {}, "decode": {}}
        tw.apis[side].update(cr)
    ro = tw.round(0)
    assert ro["phase"] == "Invalid" and "role-split" in ro["reason"]


def case_steady_state_split(tw):
    tw.create(**_cr(versions=[
        {"name": "v1", "weightsRef": "ckpt/v1", "traffic": 50},
        {"name": "v2", "weightsRef": "ckpt/v2", "traffic": 50}]))
    for _ in range(6):
        ro = tw.round()
    assert (ro["phase"], ro["trafficPercent"]) == ("Promoted", 50.0)
    assert "promotedEpoch" not in ro
    assert sorted(set(tw.fleets["torch"].installed.values())) == [1, 2]


def case_half_landed_rollback_reconverges(tw):
    tw.create(**_cr())
    tw.round(0)
    tw.by_addr[CANARY] = dict(SLOW)
    assert tw.round()["phase"] == "RolledBack"
    for side in SIDES:  # a racing push landed on one replica only
        tw.fleets[side].broadcast_weights("W-OTHER", members=["llm-r0"])
    ro = tw.round()
    assert ro["rolledBackEpoch"] == 5
    assert set(tw.fleets["torch"].installed.values()) == {5}
    assert set(tw.fleets["torch"].params_of.values()) == {"W-INCUMBENT"}


def case_router_hash_split_during_walk(tw):
    tw.create(**_cr())
    for side in SIDES:
        tw.ic[side].reconcile_all()
    assert _route(tw.apis["torch"])["strategy"] == "prefix-affine"
    tw.round(0, router=True)
    route = _route(tw.apis["torch"])
    assert route["strategy"] == "hash-split" and route["shadow"] == CANARY
    tw.round(router=True)
    tw.round(router=True)
    splits = {s["version"]: s for s in _route(tw.apis["torch"])["splits"]}
    assert splits["v2"]["weight"] == 10.0
    for _ in range(3):
        tw.round(router=True)
    assert _route(tw.apis["torch"])["strategy"] == "prefix-affine"


def case_router_resets_after_rollback(tw):
    tw.create(**_cr())
    tw.round(0, router=True)
    assert _route(tw.apis["torch"])["strategy"] == "hash-split"
    tw.by_addr[CANARY] = dict(SLOW)
    tw.round(router=True)
    route = _route(tw.apis["torch"])
    assert route["strategy"] == "prefix-affine" and "splits" not in route


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_equals_jax(case):
    tw = Twins(fleet=case != "missing_fleet_pending")
    CASES[case](tw)


def test_fleet_registry():
    fleet = object()
    trollout.register_fleet(NS, "llm", fleet)
    try:
        assert trollout._registry_fleet(NS, "llm") is fleet
    finally:
        trollout.unregister_fleet(NS, "llm")
    assert trollout._registry_fleet(NS, "llm") is None


# ---------------------------------------------------------------------------
# End to end: real fleets of both packages
# ---------------------------------------------------------------------------

SPEC = get_model("lm-test-tiny", dtype=jnp.float32)
J1 = SPEC.init(jax.random.PRNGKey(0), SPEC.config)
J2 = SPEC.init(jax.random.PRNGKey(1), SPEC.config)
TCFG = ttransformer.config("lm-test-tiny", dtype=torch.float32)
PROMPTS = [[3 + (j * 7 + i) % 50 for j in range(5 + 3 * i)]
           for i in range(3)]
KW = dict(slots=4, prefill_len=16, max_new_tokens=16, kv_layout="paged",
          kv_block_size=8, stream_timeout_s=60.0)


def _strip_gate(ro: dict) -> dict:
    """status.rollout with only the names of the gate's measured
    latencies (each side times its own decoders)."""
    ro = copy.deepcopy(ro)
    ro["gate"] = sorted(ro.get("gate", {}))
    return ro


def test_walk_over_real_fleets_equals_jax():
    members = ("llm-r0", "llm-r1")
    p1 = jax.tree.map(np.asarray, J1)
    p2 = jax.tree.map(np.asarray, J2)
    fleets = {
        "jax": jfleet.DecoderFleet({m: JaxDecoder(J1, SPEC.config, **KW)
                                    for m in members}),
        "torch": tfleet.DecoderFleet({m: ContinuousDecoder(
            params_from_numpy(p1, TCFG, "cpu"), TCFG, **KW)
            for m in members})}
    weights = {"jax": {"ckpt/v1": J1, "ckpt/v2": J2},
               "torch": {"ckpt/v1": params_from_numpy(p1, TCFG, "cpu"),
                         "ckpt/v2": params_from_numpy(p2, TCFG, "cpu")}}
    expo = {"jax": jscenarios.decoder_exposition,
            "torch": tscenarios.decoder_exposition}
    scrape = {"jax": jinf.scrape_signals, "torch": tinf.scrape_signals}
    apis = {"jax": JFakeApiServer(), "torch": FakeApiServer()}
    apis["jax"].apply(jcrd())
    apis["torch"].apply(inference_service_crd())
    clock = [0.0]
    kw = _cr(replicas=2, max_replicas=2,
             rollout={"stepSeconds": 1.0, "shadowSeconds": 1.0,
                      "gateRatio": 50.0})
    ctrls, seq = {}, {s: [] for s in SIDES}
    try:
        for side, mod, build in (("jax", jrollout, jservice),
                                 ("torch", trollout, inference_service)):
            apis[side].ensure_namespace(NS)
            apis[side].create(build("llm", NS, "lm-test-tiny", **kw))
            fl = fleets[side]

            def fetch(addr, fl=fl, side=side):
                dec = fl._replicas[addr.split(".")[0]]
                return scrape[side](expo[side](dec))

            ctrls[side] = mod.RolloutController(
                apis[side], fleet_for=lambda ns, n, fl=fl: fl,
                weights_for=weights[side].get, fetch_metrics=fetch,
                clock=lambda: clock[0])
        for _ in range(8):
            for side in SIDES:
                for p in PROMPTS[:2]:  # traffic for the judge to read
                    fleets[side].generate(p, 4, timeout=120)
                ctrls[side].reconcile_all()
                seq[side].append(_strip_gate(apis[side].get(
                    API, "InferenceService", "llm", NS)["status"][
                        "rollout"]))
            clock[0] += 2.0
            if seq["torch"][-1]["phase"] == "Promoted":
                break
        assert seq["torch"] == seq["jax"]
        assert [r["phase"] for r in seq["torch"]] == \
            ["Shadow"] + ["Walking"] * 4 + ["Promoted"]
        assert seq["torch"][-1]["promotedEpoch"] == 1
        got = {side: {m: [fleets[side]._replicas[m].generate(
            p, 8, timeout=120)["tokens"] for p in PROMPTS]
            for m in members} for side in SIDES}
        assert got["torch"] == got["jax"]
        cold = ContinuousDecoder(params_from_numpy(p2, TCFG, "cpu"), TCFG,
                                 **KW)
        try:
            want = [cold.generate(p, 8, timeout=120)["tokens"]
                    for p in PROMPTS]
        finally:
            cold.stop()
        assert got["torch"]["llm-r0"] == got["torch"]["llm-r1"] == want
    finally:
        for fl in fleets.values():
            fl.stop()
