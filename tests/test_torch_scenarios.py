"""The port's serving scenario registry (``kubeflow_tpu_torch/serving/
scenarios.py``) against the JAX package's, on the CPU at ``lm-test-tiny``.

- The five registrations: names, descriptions, parameter spaces,
  defaults, objectives and directions; the registry's error messages.
- ``percentile`` on seeded lists, ``decode_burst_tps`` over the port's
  decoder, and the private copy of the
  autoscaler's ``scrape_signals`` on the exposition of the port's decoder
  and of JAX's (each taken at the end of a ``decode-tps`` trial).
- ``synthetic-knobs`` (pure numpy) exactly, over a grid of assignments
  and seeds.
- ``decode-tps`` at ``device="cpu"``: JAX's request trace (the same
  seeded requests, the warm pass and the timed pass), its ``config`` and
  objective keys, both drains at 0 blocks.
- The bench entries with JAX's weights carried across (the port
  registry's ``init`` patched to return them): the fields that two JAX
  runs give alike and that follow from counts, not from the threads'
  timing or from the bf16 tokens. Compared: ``tokens_identical``,
  ``regression``, the prefill token volumes and their ratio, the prefix
  hits and tokens reused, the draft model's acceptance rate (its draft is
  the target itself), ``pool_bytes``, the dense KV peak, the drain, and
  every ``config`` string. Not compared: latencies and tokens/s
  (timing); the dispatch counts, in-flight peaks, paged KV peak and
  deferrals (they follow how the threads' submits fall into the
  decoder's rounds; the drafted and accepted counts and the deferrals
  moved between two JAX runs); n-gram acceptance (the greedy bf16
  tokens differ between the frameworks).
- The tuning trial over the port: an in-process Experiment over
  ``synthetic-knobs`` through JAX's ``ExperimentController`` with the
  port's runner records JAX's runner's trials; one over ``decode-tps``
  reaches ``Succeeded`` with the defaults as its baseline trial.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402

import kubeflow_tpu.serving.continuous as jcontinuous  # noqa: E402
from kubeflow_tpu.apis import jobs as jobs_api  # noqa: E402
from kubeflow_tpu.apis.experiment import experiment, experiment_crd  # noqa: E402,E501
from kubeflow_tpu.k8s.fake import FakeApiServer  # noqa: E402
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.operators import inference as jinference  # noqa: E402
from kubeflow_tpu.operators.experiment import ExperimentController  # noqa: E402,E501
from kubeflow_tpu.serving import scenarios as js  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving import scenarios as ts  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

MODEL = "lm-test-tiny"
NAMES = ["decode-tps", "synthetic-knobs", "prefix-reuse", "speculative",
         "concurrency-sweep"]
NS = "kubeflow"


def test_registry_matches_jax():
    jall, tall = js.all_scenarios(), ts.all_scenarios()
    assert list(tall) == list(jall) == NAMES
    for name in NAMES:
        j, t = jall[name], tall[name]
        for key in ("name", "description", "parameters", "defaults",
                    "objective", "optimization"):
            assert getattr(t, key) == getattr(j, key), (name, key)
        assert (t.bench is None) == (j.bench is None), name
        assert (t.trial is None) == (j.trial is None), name
    for module in (js, ts):
        with pytest.raises(ValueError) as e:
            module.register(module.get_scenario("decode-tps"))
        assert str(e.value) == "scenario 'decode-tps' already registered"
    msgs = []
    for module in (js, ts):
        for call in (lambda: module.get_scenario("nope"),
                     lambda: module.run_trial("speculative")):
            with pytest.raises(ValueError) as e:
                call()
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_trials_need_cuda_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.run_trial("decode-tps")


def test_percentile_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 10, 17, 100):
        vals = sorted(rng.normal(size=n).tolist())
        for p in (0, 1, 25, 50, 90, 99, 100):
            assert ts.percentile(vals, p) == js.percentile(vals, p)


def test_synthetic_knobs_is_jax_exactly():
    for seed in (0, 1, 7, 500_015):
        for slots in (2, 4, 9, 16):
            for block in (4, 16, 23, 32):
                a = {"slots": slots, "kv_block_size": block}
                assert ts.run_trial("synthetic-knobs", a, seed=seed,
                                    device="cpu") == \
                    js.run_trial("synthetic-knobs", a, seed=seed)
    assert ts.run_trial("synthetic-knobs", device="cpu") == \
        js.run_trial("synthetic-knobs")


@pytest.fixture(scope="module")
def decode_tps():
    """One decode-tps trial a framework at seed 3: the trial dict, the
    (tokens, max_new_tokens) of every submit, and the exposition page the
    objectives were read from."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, module, owner, kw in (
                ("jax", js, jcontinuous, {}),
                ("torch", ts, ts, {"device": "cpu"})):
            submits, pages = [], []
            base = owner.ContinuousDecoder

            class Recording(base):
                def submit(self, tokens, max_new_tokens, *a, **k):
                    submits.append((list(tokens), int(max_new_tokens)))
                    return super().submit(tokens, max_new_tokens, *a, **k)

            def objectives(d, emitted, wall, _module=module,
                           _orig=module.trial_objectives, _pages=pages):
                _pages.append(_module.decoder_exposition(d))
                return _orig(d, emitted, wall)

            mp.setattr(owner, "ContinuousDecoder", Recording)
            mp.setattr(module, "trial_objectives", objectives)
            res = module.run_trial("decode-tps", {}, seed=3, model=MODEL,
                                   **kw)
            out[tag] = dict(result=res, submits=submits, page=pages[0])
    return out


def test_decode_tps_matches_jax_trace_config_and_keys(decode_tps):
    j, t = decode_tps["jax"], decode_tps["torch"]
    # 24 seeded requests, each submitted by the warm and the timed pass;
    # the threads' order differs, the multiset does not.
    assert len(t["submits"]) == len(j["submits"]) == 48
    assert sorted(t["submits"]) == sorted(j["submits"])
    jr, tr = j["result"], t["result"]
    assert set(tr) == set(jr)
    assert tr["config"] == jr["config"] == \
        "decode-tps slots4 block16 buckets0 pool48 n24 seed3"
    assert set(tr["objectives"]) == set(jr["objectives"])
    assert tr["objectives"]["kv_blocks_in_use_after_drain"] == 0
    assert jr["objectives"]["kv_blocks_in_use_after_drain"] == 0
    assert tr["tokens_per_sec_per_chip"] == tr["objectives"][
        "tokens_per_sec"] > 0
    assert (tr["seed"], tr["assignments"], tr["scenario"]) == \
        (3, {}, "decode-tps")


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_scrape_signals_copy_matches_jax(decode_tps, source):
    page = decode_tps[source]["page"]
    assert "serving_ttft_seconds_bucket" in page
    got = ts.scrape_signals(page)
    assert got == jinference.scrape_signals(page)
    assert got["ttft_p99_s"] > 0
    assert ts._parse_exposition(page) == jinference._parse_exposition(page)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port registry's transformer init returns JAX's PRNGKey(0)
    weights, so both frameworks' bench entries decode with one tree."""
    jm = jget_model(MODEL)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                            jm.config))
    monkeypatch.setattr(
        ttransformer, "init",
        lambda cfg, *, generator, device="cuda", param_dtype=None:
        params_from_numpy(tree, cfg, device))


ARGS = dict(quick=True, requests=200, seq_len=128, concurrency=16,
            max_new_tokens=64, prefix_len=96, speculative_k=4, seed=0)
COMPARED = {
    "prefix-reuse": ("prefill_tokens_off", "prefill_tokens_on",
                     "prefill_volume_ratio", "prefix_hits",
                     "prefix_tokens_reused"),
    "speculative": ("acceptance_rate",),
    "concurrency-sweep": ("pool_bytes", "kv_peak_bytes_dense",
                          "kv_blocks_in_use_after_drain"),
}


@pytest.mark.parametrize("name", list(COMPARED))
def test_bench_entries_match_jax(jax_weights, name):
    jres = js.get_scenario(name).bench(types.SimpleNamespace(**ARGS), MODEL)
    tres = ts.get_scenario(name).bench(
        types.SimpleNamespace(**ARGS, device="cpu"), MODEL)
    assert set(tres) == set(jres)
    for key in ("metric", "unit", "config", "tokens_identical",
                "regression", *COMPARED[name]):
        assert tres[key] == jres[key], key
    assert tres["tokens_identical"] and not tres["regression"]


def _experiment_run(scenario, run_trial, **kw):
    api = FakeApiServer()
    api.ensure_namespace(NS)
    api.apply(experiment_crd())
    for crd in jobs_api.all_job_crds():
        api.apply(crd)
    api.create(experiment("exp", NS, scenario, **kw))
    ctrl = ExperimentController(api, run_trial=run_trial)
    for _ in range(20):
        ctrl.reconcile_all()
        got = api.get("kubeflow-tpu.org/v1", "Experiment", "exp", NS)
        if got["status"].get("state") in ("Succeeded", "Failed"):
            break
    return got["status"]


PORT_RUNNER = functools.partial(ts.run_trial, device="cpu")


def test_experiment_over_synthetic_knobs_records_jax_runners_trials():
    kw = dict(algorithm="random", max_trials=6, parallel_trials=2, seed=5)
    port = _experiment_run("synthetic-knobs", PORT_RUNNER, **kw)
    jax_ = _experiment_run("synthetic-knobs", js.run_trial, **kw)
    assert port["state"] == jax_["state"] == "Succeeded"

    def trials(status):
        return [(t["index"], t["assignments"], t["seed"], t["objectives"],
                 t["objectiveValue"]) for t in status["trials"]]
    assert trials(port) == trials(jax_)
    assert len(port["trials"]) == 6
    for key in ("bestTrialIndex", "bestAssignments", "bestObjectiveValue",
                "baselineObjectiveValue"):
        assert port[key] == jax_[key], key


def test_experiment_over_decode_tps_succeeds_with_a_baseline():
    status = _experiment_run("decode-tps", PORT_RUNNER, algorithm="random",
                             max_trials=2, parallel_trials=1, seed=2)
    assert status["state"] == "Succeeded", status
    trials = status["trials"]
    assert len(trials) == 2
    assert trials[0]["assignments"] == ts.DECODE_TPS_DEFAULTS
    assert status["baselineObjectiveValue"] == trials[0]["objectiveValue"] > 0
    for t in trials:
        assert t["state"] == "Succeeded"
        assert t["objectives"]["kv_blocks_in_use_after_drain"] == 0


def test_decode_burst_tps_drives_the_port_decoder():
    spec = ts.get_model(MODEL)
    d = ts.ContinuousDecoder(ts._init_params(spec, "cpu"), spec.config,
                             slots=4, prefill_len=16, max_new_tokens=4)
    try:
        assert ts.decode_burst_tps(d, 4, n_thr=4, rounds=2) > 0
        assert d.metrics()["tokens_emitted"] == 3 * 4 * 4
    finally:
        d.stop()
