"""The port's RL learner loop (``train/rl.py``) and remote actor fleet
(``serving/remote_fleet.py``) against the JAX package's.

The same weights (the JAX init, handed across as numpy arrays) at
``dtype=float32`` on the CPU: a port actor fleet's rollout batches equal
JAX's (greedy streams, prompt positions masked to -1), and one learner
step on such a batch equals JAX's ``build_train_step`` within the train
tests' tolerance (losses and metrics 1e-5 relative, parameters 1e-4
relative and 1e-5 absolute). The loop pushes live and converges, survives
an actor's death, runs the restart-per-update baseline, and drives model
servers over HTTP with a dead target among them.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402,E501
from kubeflow_tpu.serving.server import ModelServer as JaxServer  # noqa: E402,E501
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import rl as jrl  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.serving.affinity import prefix_affinity_key  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.kv_directory import KvDirectory  # noqa: E402,E501
from kubeflow_tpu_torch.serving.remote_fleet import RemoteActorFleet  # noqa: E402,E501
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train import rl as trl  # noqa: E402
from kubeflow_tpu_torch.train import trainer as ttrainer  # noqa: E402

JSPEC = get_model("lm-test-tiny", dtype=jnp.float32)
TSPEC = tregistry.get_model("lm-test-tiny", dtype=torch.float32)
J1 = JSPEC.init(jax.random.PRNGKey(0), JSPEC.config)
P1 = jax.tree.map(np.asarray, J1)
J2 = JSPEC.init(jax.random.PRNGKey(1), JSPEC.config)
P2 = jax.tree.map(np.asarray, J2)
F32 = {"dtype": "float32"}
SHAPE = dict(batch_size=2, prompt_len=8, max_new_tokens=8, actors=2,
             push_every_steps=2)


def _masters(tree=P1):
    return weights.params_from_numpy(tree, TSPEC, "cpu",
                                     dtype=torch.float32)


def _batches(fleet, cfg, n):
    counters = {"rollout_tokens": 0, "rollouts": 0}
    stream = (trl if isinstance(cfg, trl.RLConfig) else jrl).rollout_stream(
        fleet, cfg, counters)
    return [next(stream) for _ in range(n)], counters


@pytest.fixture(scope="module")
def rollouts():
    """Two rollout batches from a port fleet (its actors on the fused
    read, the paged kernel's plain version here) and from JAX's (the
    gathered read), on the same weights."""
    tcfg = trl.RLConfig(model_overrides=F32, device="cpu", kv_fused=True,
                        **SHAPE)
    jcfg = jrl.RLConfig(model_overrides={"dtype": jnp.float32}, **SHAPE)
    tfleet = trl.build_actor_fleet(_masters(), tcfg, TSPEC)
    jfleet = jrl.build_actor_fleet(J1, jcfg, JSPEC)
    try:
        return _batches(tfleet, tcfg, 2), _batches(jfleet, jcfg, 2)
    finally:
        tfleet.stop()
        jfleet.stop()


def test_rollout_batches_equal_jax(rollouts):
    """Prompts, greedy continuations and the -1 mask over the prompt
    positions: every batch equals JAX's, and the counters too."""
    (tb, tc), (jb, jc) = rollouts
    assert tc == jc == {"rollout_tokens": 32, "rollouts": 4}
    for t, j in zip(tb, jb):
        for key in ("inputs", "targets"):
            assert t[key].dtype == np.int32
            np.testing.assert_array_equal(t[key], np.asarray(j[key]))
        assert (t["targets"][:, : SHAPE["prompt_len"] - 1] == -1).all()
        assert (t["targets"][:, SHAPE["prompt_len"] - 1:] >= 0).all()
    assert [trl._prompt(trl.RLConfig(), i) for i in range(5)] == \
        [jrl._prompt(jrl.RLConfig(), i) for i in range(5)]


def test_learner_step_on_rollouts_equals_jax(rollouts):
    """One learner step (adafactor, the masked loss) on a rollout batch:
    loss, metrics and parameters equal JAX's ``build_train_step``."""
    batch = rollouts[0][0][0]
    jopt = joptim.OptimizerConfig(name="adafactor", learning_rate=1e-2,
                                  warmup_steps=1, total_steps=10)
    topt = toptim.OptimizerConfig(name="adafactor", learning_rate=1e-2,
                                  warmup_steps=1, total_steps=10)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=J1,
        opt_state=joptim.build(jopt).init(P1))
    params = _masters()
    tstate = ttrainer.TrainState(
        step=0, params=params,
        opt_state=toptim.build(topt).init(weights.flatten(params)))
    jstate, jmet = jtrainer.build_train_step(JSPEC, jopt)(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate, tmet = ttrainer.build_train_step(TSPEC, topt)(
        tstate, tdata.place_batch(batch, torch.device("cpu")))
    for key in ("loss", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    # Only the emitted tokens count (the prompt's are masked).
    assert float(tmet["tokens"]) == SHAPE["batch_size"] * (
        SHAPE["max_new_tokens"])
    got = weights.flatten(weights.params_to_numpy(tstate.params))
    for path, ref in weights.flatten(
            jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_serving_params_never_alias_the_masters():
    masters = _masters()
    tree = trl.serving_params(masters, TSPEC)
    for path, t in weights.flatten(tree).items():
        m = weights.flatten(masters)[path]
        assert t.data_ptr() != m.data_ptr() and torch.equal(t, m)
    bf16 = trl.serving_params(masters, tregistry.get_model("lm-test-tiny"))
    assert weights.flatten(bf16)["embed/kernel"].dtype == torch.bfloat16


def test_run_rl_pushes_and_converges():
    cfg = trl.RLConfig(steps=4, batch_size=1, push_every_steps=2,
                       actors=2, prompt_len=8, max_new_tokens=4,
                       prefetch=2, device="cpu")
    res = trl.run_rl(cfg, log=lambda *_: None)
    assert set(res) == {
        "step", "loss", "pushes", "weights_version", "rollouts",
        "rollout_tokens", "rollout_tokens_per_sec", "push_ms_avg",
        "restart_ms_avg", "elapsed_s", "weights_installed"}
    assert res["step"] == 4
    assert res["pushes"] == 1 and res["weights_version"] == 1
    # The producer runs ahead of the consumed steps (the overlap).
    assert res["rollouts"] >= 4
    assert res["rollout_tokens"] == 4 * res["rollouts"]
    assert set(res["weights_installed"].values()) == {1}
    assert np.isfinite(res["loss"]) and res["push_ms_avg"] > 0


def test_run_rl_survives_actor_death():
    """Kill one actor: rollouts remap to the survivor, the push converges
    what remains, the loop completes; a handed fleet is not stopped."""
    cfg = trl.RLConfig(steps=4, batch_size=1, push_every_steps=2,
                       actors=2, prompt_len=8, max_new_tokens=4,
                       prefetch=0, device="cpu")
    fleet = trl.build_actor_fleet(_masters(), cfg, TSPEC)
    try:
        fleet._replicas["actor0"].stop()
        res = trl.run_rl(cfg, fleet=fleet, log=lambda *_: None)
        assert res["step"] == 4 and res["pushes"] == 1
        assert res["rollouts"] == 4
        assert res["weights_installed"].get("actor1") == 1
        # The stopped actor swaps its params too, but a push never
        # revives a stopped scheduler into routing.
        assert fleet.metrics()["dead"] == ["actor0"]
        assert not fleet._replicas["actor1"]._stopped
    finally:
        fleet.stop()


def test_restart_per_update_rebuilds_the_fleet():
    cfg = trl.RLConfig(steps=4, batch_size=1, push_every_steps=2,
                       actors=2, prompt_len=8, max_new_tokens=4,
                       prefetch=1, device="cpu", restart_per_update=True)
    res = trl.run_rl(cfg, log=lambda *_: None)
    assert res["pushes"] == 1 and res["weights_version"] == 1
    assert res["restart_ms_avg"] > 0 and res["push_ms_avg"] == 0.0


def test_rl_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trl.run_rl(trl.RLConfig(steps=1))


def _port_server(**kw):
    server = ModelServer(
        EngineConfig(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                     max_new_tokens=8, kv_layout="paged", kv_block_size=4,
                     dtype="float32", device="cpu", **kw),
        port=0, params=P1, batch_timeout_ms=2)
    server.start()
    return server


def test_remote_actor_fleet_over_http():
    """Rollouts over ``:predict`` with a dead target first (it fails over
    and leaves the rotation), a broadcast over ``:weights`` (the server
    then streams as JAX's server after the same push), directory-aware
    placement, and the metrics."""
    server = _port_server(prefix_cache_slots=4, prefix_cache_min_len=4)
    jserver = JaxServer(JaxEngineConfig(
        model="lm-test-tiny", batch_size=4, max_seq_len=32,
        max_new_tokens=8, kv_layout="paged", kv_block_size=4,
        dtype="float32"), port=0, grpc_port=None, batch_timeout_ms=2)
    jserver.start()
    try:
        live = f"127.0.0.1:{server.port}"
        dead = "127.0.0.1:1"  # nothing listens: dies on first use
        fleet = RemoteActorFleet([dead, live], "lm-test-tiny",
                                 weights_max_lag=1, timeout=30.0,
                                 chunk_bytes=1024)
        prompt = [3, 4, 5, 6, 7, 8]
        for _ in range(2):  # the round robin reaches the dead target
            out = fleet.generate(prompt, 8)
            assert len(out["tokens"]) == 8 and out["finish_reason"]
        assert fleet.metrics()["dead"] == [dead]
        res = fleet.broadcast_weights(_masters(P2))
        assert res["installed"] == {live: 1} and dead in res["failed"]
        assert server.decoder.metrics()["weights_version"] == 1
        m = fleet.metrics()
        assert m["weights_latest"] == 1 and m["rollouts"] == 2
        assert m["weight_push_failures"] == 1
        # Directory-aware placement: a served prompt advertises its
        # target, and the next rollout sharing it lands there.
        directory = KvDirectory()
        routed = RemoteActorFleet([live, "127.0.0.1:3"], "lm-test-tiny",
                                  timeout=30.0, kv_directory=directory)
        routed.generate(prompt, 8)
        assert directory.holders(prefix_affinity_key(prompt)) == [live]
        routed.generate(prompt, 8)
        assert routed.metrics()["directory_routed"] == 1
        jfleet = RemoteActorFleet([f"127.0.0.1:{jserver.port}"],
                                  "lm-test-tiny", timeout=30.0,
                                  chunk_bytes=1024)
        jfleet.broadcast_weights(_masters(P2))
        assert fleet.generate(prompt, 8) == jfleet.generate(prompt, 8)
        assert fleet.donors() == [live]
        fleet.add_target("127.0.0.1:2")
        assert "127.0.0.1:2" in fleet.targets
    finally:
        server.stop()
        jserver.stop()


def test_main_drives_remote_actors(monkeypatch, capsys):
    """``main`` with ``KUBEFLOW_TPU_RL_ACTORS``: rollouts and pushes go to
    the named model servers, the result is printed as JSON."""
    server = _port_server()
    try:
        monkeypatch.setenv("KUBEFLOW_TPU_RL_ACTORS",
                           f"127.0.0.1:{server.port}")
        monkeypatch.delenv("KUBEFLOW_TPU_JOB_NAME", raising=False)
        rc = trl.main([json.dumps({
            "steps": 2, "batch_size": 1, "push_every_steps": 1,
            "prompt_len": 8, "max_new_tokens": 4, "prefetch": 0,
            "device": "cpu", "model_overrides": F32})])
        assert rc == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["pushes"] == 1 and res["rollouts"] == 2
        assert server.decoder.metrics()["weights_version"] == 1
    finally:
        server.stop()
