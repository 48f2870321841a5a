"""Checkpoints, data-exact resume, preemption, the profiler hook and train
states carried across frameworks, on the CPU.

The checkpoint files hold the JAX ``TrainState``'s flat layout; a resumed
run must equal a straight one bit for bit (the same float32 operations on
the same values in the same order), on synthetic tokens and on a token
file. A JAX train state after two steps, carried across through numpy,
continues for two steps equal to JAX's own next two, and the port's state
carried back continues in JAX equal to the port's. Tolerances of the
cross-framework steps, as ``tests/test_torch_train.py``: metrics to 1e-5
relative, parameters to 1e-4 relative and 1e-5 absolute.
"""

import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import loop as tloop  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train import trainer as ttrainer  # noqa: E402
from kubeflow_tpu_torch.train.tokenstore import write_token_file  # noqa: E402,E501

CPU = torch.device("cpu")
COMMON = dict(model="lm-test-tiny", batch_size=4, seq_len=16, log_every=1,
              device="cpu", prefetch=2,
              optimizer=toptim.OptimizerConfig(name="adafactor",
                                               warmup_steps=2,
                                               total_steps=20))


def _state(opt_cfg, seed=0):
    tm = tregistry.get_model("lm-test-tiny")
    return tm, ttrainer.init_state(torch.Generator().manual_seed(seed), tm,
                                   opt_cfg, device="cpu")


def _stepped(opt_cfg, steps=2):
    tm, state = _state(opt_cfg)
    step = ttrainer.build_train_step(tm, opt_cfg)
    stream = tdata.synthetic_stream(tm, 2, 8, seed=3)
    for _ in range(steps):
        state, _ = step(state, tdata.place_batch(next(stream), CPU))
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.opt_state["count"] == b.opt_state["count"]
    fa, fb = weights.flatten(a.params), weights.flatten(b.params)
    assert list(fa) == list(fb)  # the leaf order the gradient norm sums in
    for k in fa:
        torch.testing.assert_close(fa[k], fb[k], rtol=0, atol=0)
    for slot, leaves in a.opt_state.items():
        if slot == "count":
            continue
        assert list(leaves) == list(b.opt_state[slot])
        for k, t in leaves.items():
            assert t.dtype == b.opt_state[slot][k].dtype
            torch.testing.assert_close(t, b.opt_state[slot][k], rtol=0,
                                       atol=0)


@pytest.mark.parametrize("opt_cfg", [
    toptim.OptimizerConfig(name="adafactor"),
    toptim.OptimizerConfig(name="adamw", mu_dtype="bfloat16"),
    toptim.OptimizerConfig(name="sgd", grad_clip_norm=0.0),
], ids=["adafactor", "adamw-mu-bf16", "sgd-noclip"])
def test_round_trip_is_exact(tmp_path, opt_cfg):
    state = _stepped(opt_cfg)
    tckpt.save(str(tmp_path), 2, state, opt_cfg)
    assert tckpt.latest_step(str(tmp_path)) == 2
    _, like = _state(opt_cfg, seed=1)
    restored, step = tckpt.restore_latest(str(tmp_path), like, opt_cfg)
    assert step == 2
    _assert_states_equal(restored, state)
    # One .npy per leaf of the JAX layout, at the leaf's path.
    assert os.path.isfile(tmp_path / "2" / "params" / "layers" / "attn" /
                          "wq.npy")
    assert os.path.isfile(tmp_path / "2" / "step.npy")


def test_max_to_keep_async_wait_and_empty_dirs(tmp_path):
    opt_cfg = toptim.OptimizerConfig(name="adafactor")
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    ckpt = tckpt.Checkpointer(str(tmp_path / "c"), opt_cfg, max_to_keep=3,
                              async_saves=True)
    _, like = _state(opt_cfg)
    assert ckpt.latest_step() is None
    assert ckpt.restore_latest(like) is None
    state = _stepped(opt_cfg, steps=1)
    for step in range(1, 6):
        state.step = step
        ckpt.save(step, state)
    assert ckpt.latest_step() == 5  # pending saves count
    ckpt.wait()
    assert sorted(os.listdir(tmp_path / "c")) == ["3", "4", "5"]
    with pytest.raises(ValueError, match="exists"):
        ckpt.save(5, state)
    state.step = 7
    ckpt.save(5, state, force=True)
    ckpt.close()
    restored, step = ckpt.restore_latest(like)
    assert step == 5 and restored.step == 7
    assert not [n for n in os.listdir(tmp_path / "c") if n.startswith(".")]


def _losses(lines):
    return [line.split()[1] for line in lines if line.startswith("step=")]


@pytest.mark.parametrize("data", ["synthetic", "token_file"])
def test_resume_equals_a_straight_run_bitwise(tmp_path, data):
    common = dict(COMMON)
    if data == "token_file":
        path = str(tmp_path / "corpus.ktpu")
        write_token_file(path, np.random.default_rng(0).integers(
            0, 256, 5000))
        common["data_path"] = path
    straight, first, second = [], [], []
    ref = tloop.run(tloop.RunConfig(steps=8, **common), log=straight.append)
    tloop.run(tloop.RunConfig(steps=4, checkpoint_dir=str(tmp_path / "c"),
                              **common), log=first.append)
    res = tloop.run(tloop.RunConfig(steps=8, checkpoint_dir=str(
        tmp_path / "c"), **common), log=second.append)
    assert second[0] == "resumed from checkpoint step 4"
    assert _losses(first) + _losses(second) == _losses(straight)
    assert res["loss"] == ref["loss"] and res["step"] == 8
    # The final save, and the parameters equal bit for bit.
    opt_cfg = COMMON["optimizer"]
    _, like = _state(opt_cfg)
    resumed, step = tckpt.restore_latest(str(tmp_path / "c"), like, opt_cfg)
    assert step == 8
    tloop.run(tloop.RunConfig(steps=8, checkpoint_dir=str(tmp_path / "s"),
                              **common), log=lambda *a: None)
    direct, _ = tckpt.restore_latest(str(tmp_path / "s"), like, opt_cfg)
    _assert_states_equal(resumed, direct)


def test_preemption_saves_the_preemption_step(tmp_path):
    """Calling the SIGTERM handler the loop installed stops the run after
    the step in flight and saves that step; the resumed run finishes."""
    lines = []

    def log(line):
        lines.append(line)
        if line.startswith("step=2 "):
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    before = signal.getsignal(signal.SIGTERM)
    cfg = tloop.RunConfig(steps=6, checkpoint_dir=str(tmp_path), **COMMON)
    res = tloop.run(cfg, log=log)
    assert res["preempted"] and res["step"] == 2
    assert "preempted: checkpoint saved at step 2" in lines
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert signal.getsignal(signal.SIGTERM) is before
    after = []
    res = tloop.run(cfg, log=after.append)
    assert after[0] == "resumed from checkpoint step 2"
    assert not res["preempted"] and res["step"] == 6
    assert sorted(os.listdir(tmp_path)) == ["2", "6"]


def test_periodic_saves_keep_the_newest(tmp_path):
    cfg = tloop.RunConfig(steps=7, checkpoint_dir=str(tmp_path),
                          checkpoint_every=2, **COMMON)
    tloop.run(cfg, log=lambda *a: None)
    assert sorted(os.listdir(tmp_path), key=int) == ["4", "6", "7"]


def test_profile_dir_writes_a_trace(tmp_path):
    lines = []
    cfg = tloop.RunConfig(steps=4, profile_dir=str(tmp_path / "prof"),
                          profile_start_step=1, profile_steps=2, **COMMON)
    tloop.run(cfg, log=lines.append)
    assert f"profiler trace written to {tmp_path / 'prof'}" in lines
    (name,) = os.listdir(tmp_path / "prof")
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_main_expands_environment_variables_in_paths(tmp_path, monkeypatch,
                                                     capsys):
    write_token_file(str(tmp_path / "corpus.ktpu"), np.arange(3000) % 256)
    monkeypatch.setenv("KFT_TEST_DIR", str(tmp_path))
    assert tloop.main([json.dumps({
        "model": "lm-test-tiny", "steps": 2, "seq_len": 8, "batch_size": 2,
        "device": "cpu", "data_path": "$KFT_TEST_DIR/corpus.ktpu",
        "checkpoint_dir": "${KFT_TEST_DIR}/ckpt"})]) == 0
    assert '"step": 2' in capsys.readouterr().out.splitlines()[-1]
    assert os.listdir(tmp_path / "ckpt") == ["2"]


# ---------------------------------------------------------------------------
# Train states across frameworks
# ---------------------------------------------------------------------------


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _jax_state_from_flat(flat, template):
    leaves = [jnp.asarray(np.asarray(flat[path_str(p)]), dtype=leaf.dtype)
              for p, leaf in jax.tree_util.tree_flatten_with_path(
                  template)[0]]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def _steps_both(opt_name, extra):
    kw = dict(name=opt_name, learning_rate=1e-2, warmup_steps=1,
              total_steps=10, **extra)
    jcfg, tcfg = joptim.OptimizerConfig(**kw), toptim.OptimizerConfig(**kw)
    jm = jregistry.get_model("lm-test-tiny", dtype=jnp.float32)
    tm = tregistry.get_model("lm-test-tiny", dtype=torch.float32)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg)
    return (jm, tm, jcfg, tcfg, jstate,
            jtrainer.build_train_step(jm, jcfg),
            ttrainer.build_train_step(tm, tcfg),
            tdata.synthetic_stream(tm, 4, 16, seed=3))


def _assert_close(tstate, tmet, jstate, jmet, atol):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    assert tstate.step == int(jstate.step)
    got = weights.flatten(weights.params_to_numpy(tstate.params))
    for path, ref in weights.flatten(jax.tree.map(
            np.asarray, jstate.params)).items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("opt_name,extra", [
    ("adafactor", {}), ("adamw", {}), ("adam", {"mu_dtype": "bfloat16"}),
    ("sgd", {"grad_clip_norm": 0.0}),
], ids=["adafactor", "adamw", "adam-mu-bf16", "sgd-noclip"])
def test_train_state_crosses_both_ways(opt_name, extra):
    """JAX's state after two steps continues in the port for two steps
    equal to JAX's own; the port's state then continues in JAX for two
    more, equal to the port's. With a bf16 first moment a sum on a
    rounding boundary may round the other way on one side: one bf16 ulp
    of mu (2^-8 relative) moves a parameter by up to lr * 2^-8 = 3.9e-5 an
    update, so parameters there agree to 1e-4 absolute."""
    atol = 1e-4 if extra.get("mu_dtype") else 1e-5
    jm, tm, jcfg, tcfg, jstate, jstep, tstep, stream = _steps_both(
        opt_name, extra)
    for _ in range(2):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, next(stream)))
    tstate = weights.state_from_numpy(_jax_flat(jstate), tcfg, device="cpu")
    assert tstate.step == 2 and tstate.opt_state["count"] == 2
    for _ in range(2):
        batch = next(stream)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, tdata.place_batch(batch, CPU))
        _assert_close(tstate, tmet, jstate, jmet, atol)
    flat = weights.state_to_numpy(tstate, tcfg)
    assert set(flat) == set(_jax_flat(jstate))
    jstate = _jax_state_from_flat(flat, jstate)
    for _ in range(2):
        batch = next(stream)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, tdata.place_batch(batch, CPU))
        _assert_close(tstate, tmet, jstate, jmet, atol)
    assert tstate.step == int(jstate.step) == 6


def test_state_from_numpy_refuses_another_optimizers_layout():
    jm = jregistry.get_model("lm-test-tiny", dtype=jnp.float32)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm,
                                 joptim.OptimizerConfig(name="adamw"))
    with pytest.raises(ValueError, match="not the state of optimizer"):
        weights.state_from_numpy(_jax_flat(jstate), toptim.OptimizerConfig(
            name="adafactor"), device="cpu")
    with pytest.raises(ValueError, match="not the state of optimizer"):
        weights.state_from_numpy(_jax_flat(jstate), toptim.OptimizerConfig(
            name="adamw", grad_clip_norm=0.0), device="cpu")
