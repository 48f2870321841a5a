"""The port's leader election against the JAX package's.

``kubeflow_tpu_torch/operators/leader.py`` runs the same acquire, renew,
release, expiry and renew-deadline sequences as
``kubeflow_tpu/operators/leader.py``, each on its own package's fake
apiserver with one injected clock, and every step gives the same result,
the same ``is_leader`` on both candidates and the same Lease spec. A
leader whose renewTimes look stale by the local wall clock (skew) keeps
its lease while it renews. The managers take ``--leader-elect``: of two
scheduler processes one leads, a SIGTERM hands the Lease to the other,
and a leader whose Lease is taken exits 1. ``gpu-scheduler`` and
``gpu-training-operator`` render ``--leader-elect`` only for
``replicas`` above 1 (their renderings against JAX's are in
``test_torch_manifests.py``).
"""

import datetime
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

import kubeflow_tpu.operators.leader as jleader
import kubeflow_tpu_torch.operators.leader as tleader
from kubeflow_tpu.k8s.client import ApiError as JApiError
from kubeflow_tpu.k8s.fake import FakeApiServer as JFake
from kubeflow_tpu_torch.k8s_client import ApiError as TApiError
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TFake
from kubeflow_tpu_torch.k8s_fake import serve
from kubeflow_tpu_torch.manifests import generate

ROOT = Path(__file__).resolve().parent.parent
LEASE_AV = "coordination.k8s.io/v1"
EPOCH = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)


class Clock:
    """One monotonic clock and the wall clock it implies."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self) -> float:
        return self.t

    def now(self) -> datetime.datetime:
        return EPOCH + datetime.timedelta(seconds=self.t)


class Flaky:
    """A client whose reads fail with a 500 while ``down`` is set."""

    def __init__(self, inner, error):
        self.inner, self.error, self.down = inner, error, False

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name == "get_or_none" and self.down:
            def fail(*a, **kw):
                raise self.error(500, "InternalError", "apiserver away")
            return fail
        return attr


def _package(kind: str, clock: Clock, monkeypatch):
    mod, fake, err = ((jleader, JFake(), JApiError) if kind == "jax"
                      else (tleader, TFake(), TApiError))
    fake.ensure_namespace("kubeflow")
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    monkeypatch.setattr(mod, "_now", clock.now)
    return mod, fake, err


def _lease(fake, name: str):
    lease = fake.get_or_none(LEASE_AV, "Lease", name, "kubeflow")
    return None if lease is None else lease["spec"]


def _sequence(kind: str, monkeypatch) -> list:
    """Acquire, a refused standby, renewals that reset the standby's
    observation, expiry, a takeover, a release and a re-acquire; then a
    leader riding out failed renewals until its renew deadline (2/3 of
    the lease) and abdicating after it."""
    clock = Clock()
    mod, fake, err = _package(kind, clock, monkeypatch)
    client = Flaky(fake, err)
    a = mod.LeaderElector(client, name="op", identity="a", lease_seconds=1)
    b = mod.LeaderElector(fake, name="op", identity="b", lease_seconds=1)
    steps = []

    def step(label, result):
        steps.append((label, result, a.is_leader, b.is_leader,
                      _lease(fake, "op")))

    step("a acquires", a.try_acquire())
    step("b refused", b.try_acquire())
    step("a renews", a.try_acquire())
    clock.t += 0.6
    step("a renews later", a.try_acquire())
    clock.t += 0.6
    step("b still refused", b.try_acquire())
    clock.t += 1.1
    step("b takes over", b.try_acquire())
    step("a deposed", a.try_acquire())
    b.release()
    step("b released", b.is_leader)
    step("a re-acquires", a.try_acquire())
    client.down = True
    clock.t += 0.5
    step("a rides out a failure", a.try_acquire())
    clock.t += 0.3
    step("a abdicates past the deadline", a.try_acquire())
    client.down = False
    step("a back", a.try_acquire())
    assert a.renew_deadline_seconds == pytest.approx(2 / 3)
    defaults = mod.LeaderElector(fake, name="x")
    steps.append(("defaults", defaults.lease_seconds,
                  defaults.renew_seconds, defaults.renew_deadline_seconds,
                  defaults.identity.startswith("x-")))
    return steps


def test_lease_sequence_equals_jax(monkeypatch):
    want = _sequence("jax", monkeypatch)
    got = _sequence("torch", monkeypatch)
    assert got == want
    leaders = [(s[0], s[1]) for s in got[:-1]]
    assert leaders == [
        ("a acquires", True), ("b refused", False), ("a renews", True),
        ("a renews later", True), ("b still refused", False),
        ("b takes over", True), ("a deposed", False),
        ("b released", False), ("a re-acquires", True),
        ("a rides out a failure", True),
        ("a abdicates past the deadline", False), ("a back", True)]
    assert got[-1] == ("defaults", 15.0, 5.0, 10.0, True)


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_clock_skew_never_seizes_a_healthy_leader(kind, monkeypatch):
    """A leader whose clock runs ten minutes behind writes renewTimes that
    look expired, but it renews: the standby judges expiry from the
    transitions it observes, never from the wall clock."""
    clock = Clock()
    mod, fake, _err = _package(kind, clock, monkeypatch)

    def stamp(seconds_ago):
        return (clock.now() - datetime.timedelta(seconds=seconds_ago)
                ).strftime("%Y-%m-%dT%H:%M:%S.%fZ")

    fake.create({
        "apiVersion": LEASE_AV, "kind": "Lease",
        "metadata": {"name": "skew", "namespace": "kubeflow"},
        "spec": {"holderIdentity": "remote-leader",
                 "leaseDurationSeconds": 0.3, "renewTime": stamp(600)}})
    b = mod.LeaderElector(fake, name="skew", identity="b",
                          lease_seconds=0.3)
    assert b.try_acquire() is False
    for seconds_ago in (599, 598):
        clock.t += 0.2
        lease = fake.get(LEASE_AV, "Lease", "skew", "kubeflow")
        lease["spec"]["renewTime"] = stamp(seconds_ago)
        fake.update(lease)
        assert b.try_acquire() is False
    clock.t += 0.4  # renewals stop: a whole lease unobserved
    assert b.try_acquire() is True


def _scheduler(port: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("KUBEFLOW_TPU_APISERVER", None)
    return subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.scheduler",
         "--leader-elect", "--leader-elect-name", "smoke-lease",
         "--metrics-port", "0", "--apiserver", f"http://127.0.0.1:{port}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_holder(fake, not_in=(), timeout=20.0) -> str:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        spec = _lease(fake, "smoke-lease")
        holder = (spec or {}).get("holderIdentity")
        if holder and holder not in not_in:
            return holder
        time.sleep(0.05)
    raise AssertionError(f"no new holder of the lease: {spec}")


def _drain(proc: subprocess.Popen) -> str:
    """What ``proc`` has written to its (non-blocking) stdout so far,
    read from the descriptor: a text stream's ``read`` can raise when
    its non-blocking pipe holds nothing."""
    out = b""
    while True:
        try:
            chunk = os.read(proc.stdout.fileno(), 1 << 16)
        except BlockingIOError:
            break
        if not chunk:
            break
        out += chunk
    return out.decode(errors="replace")


def _identity(log: str) -> str:
    line = next(ln for ln in log.splitlines()
                if "waiting for leadership" in ln)
    return line.rsplit(" as ", 1)[1].strip()


def test_manager_fails_over_and_exits_1_on_lost_leadership():
    """Two ``python -m kubeflow_tpu_torch.scheduler --leader-elect``: one
    holds the Lease; SIGTERM releases it and the other takes it within a
    renew period; a leader whose Lease another identity takes exits 1
    (a deposed leader must not reconcile beside the new one)."""
    fake = TFake()
    fake.ensure_namespace("kubeflow")
    httpd, port = serve(fake)
    procs = [_scheduler(port), _scheduler(port)]
    try:
        first = _wait_holder(fake)
        time.sleep(0.3)
        spec = _lease(fake, "smoke-lease")
        assert spec["holderIdentity"] == first
        assert spec["leaseDurationSeconds"] == 15
        leader = None
        for proc in procs:
            os.set_blocking(proc.stdout.fileno(), False)
        logs = ["", ""]
        end = time.monotonic() + 10
        while leader is None and time.monotonic() < end:
            for i, proc in enumerate(procs):
                logs[i] += _drain(proc)
                if f"as {first}" in logs[i] and "acquired" in logs[i]:
                    leader = i
            time.sleep(0.05)
        assert leader is not None, logs
        standby = procs[1 - leader]
        procs[leader].send_signal(signal.SIGTERM)
        assert procs[leader].wait(timeout=20) == 0
        second = _wait_holder(fake, not_in=(first,), timeout=15)
        logs[1 - leader] += _drain(standby)
        assert second == _identity(logs[1 - leader])

        lease = fake.get(LEASE_AV, "Lease", "smoke-lease", "kubeflow")
        lease["spec"]["holderIdentity"] = "other"
        lease["spec"]["renewTime"] = "2099-01-01T00:00:00.000000Z"
        fake.update(lease)
        assert standby.wait(timeout=30) == 1
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        httpd.shutdown()


@pytest.mark.parametrize("proto", ["gpu-scheduler", "gpu-training-operator"])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_prototypes_render_leader_election_above_one_replica(proto,
                                                             replicas):
    (dep,) = [o for o in generate(proto, {"replicas": replicas})
              if o["kind"] == "Deployment"]
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    name = dep["metadata"]["name"]
    assert dep["spec"]["replicas"] == replicas
    elected = ["--leader-elect", "--leader-elect-name", name]
    args = c["args"]
    if replicas > 1:
        i = args.index("--leader-elect")
        assert args[i:i + 3] == elected
    else:
        assert "--leader-elect" not in args


@pytest.mark.parametrize("module,lease", [
    ("kubeflow_tpu_torch.scheduler.__main__", "kubeflow-tpu-cluster"),
    ("kubeflow_tpu_torch.operators.__main__",
     "kubeflow-tpu-training-operator"),
    ("kubeflow_tpu_torch.operators.notebook", "kubeflow-tpu-notebook")])
def test_managers_take_the_flags_and_default_to_jax_lease_names(
        module, lease, monkeypatch):
    """Each manager parses ``--leader-elect`` and defaults its lease to
    the name JAX's manager derives, so the port's and JAX's managers of
    one role (which must never both run) exclude each other."""
    import importlib

    from kubeflow_tpu_torch import runtime

    seen = {}

    def fake_run(controllers, args, client):
        seen["args"], seen["controllers"] = args, controllers
        return 0

    monkeypatch.setattr(runtime, "run_manager", fake_run)
    mod = importlib.import_module(module)
    assert mod.main(["--leader-elect", "--apiserver", "http://127.0.0.1:1",
                     "--metrics-port", "0", "--alsologtostderr"]) == 0
    assert seen["args"].leader_elect is True
    assert seen["args"].leader_elect_name == lease
    assert seen["controllers"]
