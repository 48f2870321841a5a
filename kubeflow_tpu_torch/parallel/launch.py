"""Start a gang on one host: N processes of one command, each with the
JaxJob controller's environment (the role the controller plays across
pods, on one machine: one process per GPU, or per CPU process group).

    python -m kubeflow_tpu_torch.parallel.launch -n 2 -- \\
        python -m kubeflow_tpu_torch.train.loop '{"mesh": {"data": 2}}'

Process ``i`` gets ``JAX_COORDINATOR_ADDRESS=127.0.0.1:<a free port>``,
``JAX_NUM_PROCESSES=N`` and ``JAX_PROCESS_ID=i``; rank 0 listens there.
Every process is stopped before :func:`launch` returns, a timeout
included. A :class:`Gang` keeps its processes up across many jobs.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from kubeflow_tpu_torch.parallel.distributed import (
    ENV_COORDINATOR_ADDRESS,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
)


def free_port() -> int:
    """A TCP port no process listens on now (the OS picks it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_env(n: int, i: int, port: int, base=None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update({ENV_COORDINATOR_ADDRESS: f"127.0.0.1:{port}",
                ENV_NUM_PROCESSES: str(n), ENV_PROCESS_ID: str(i)})
    return env


def start(cmd: list[str], n: int, *, env=None, cwd=None,
          **popen_kw) -> list[subprocess.Popen]:
    """The gang's processes, started (the caller stops them)."""
    port = free_port()
    return [subprocess.Popen(cmd, env=gang_env(n, i, port, env), cwd=cwd,
                             **popen_kw) for i in range(n)]


def stop(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def serve_jobs(run) -> None:
    """A :class:`Gang` rank's loop: ``run(job)`` for each JSON line on
    stdin, then ``<job["out"]>.<rank>.done`` holding ``ok`` or the
    traceback. The first failure ends the loop; the process group, where
    ``run`` joined one, is left at the end."""
    import traceback

    from kubeflow_tpu_torch.parallel.distributed import shutdown

    rank = os.environ[ENV_PROCESS_ID]
    for line in sys.stdin:
        job = json.loads(line)
        try:
            run(job)
            status = "ok"
        except Exception:
            status = traceback.format_exc()
        with open(f"{job['out']}.{rank}.done", "w") as f:
            f.write(status)
        if status != "ok":
            break
    shutdown()


class Gang:
    """``n`` processes of ``python -c code`` kept up across jobs, so each
    pays its start (the interpreter, torch, a CUDA context, the process
    group) once. ``code`` ends in :func:`serve_jobs`. A job is a dict with
    an ``out`` path, written as one JSON line to every rank's stdin. A job
    that fails on any rank, a rank that exits and a wait that overruns
    each close the gang (:meth:`alive` is then false) and raise
    ``RuntimeError`` with every rank's log tail. :meth:`close` gives the
    ranks ``grace`` seconds to leave the process group, then kills them."""

    def __init__(self, n: int, code: str, *, env=None, cwd=None,
                 grace: float = 10.0):
        self.n, self.grace = n, grace
        self._logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code], env=gang_env(n, i, port, env),
            cwd=cwd, stdin=subprocess.PIPE, stdout=log, stderr=log,
            text=True) for i, log in enumerate(self._logs)]

    def alive(self) -> bool:
        return bool(self.procs) and all(p.poll() is None for p in self.procs)

    def submit(self, job: dict) -> None:
        for i in range(self.n):
            done = f"{job['out']}.{i}.done"
            if os.path.exists(done):
                os.remove(done)
        line = json.dumps(job) + "\n"
        for p in self.procs:
            p.stdin.write(line)
            p.stdin.flush()

    def wait(self, job: dict, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        done = [f"{job['out']}.{i}.done" for i in range(self.n)]
        while not all(os.path.exists(d) for d in done):
            dead = [i for i, p in enumerate(self.procs)
                    if p.poll() is not None]
            failed = {i: open(d).read() for i, d in enumerate(done)
                      if os.path.exists(d) and open(d).read() != "ok"}
            if dead or failed or time.monotonic() > deadline:
                self._fail(f"ranks {dead} exited, {sorted(failed)} failed, "
                           f"timeout {timeout} s\n"
                           + "\n".join(failed.values()))
            time.sleep(0.02)
        status = [open(d).read() for d in done]
        if any(s != "ok" for s in status):
            self._fail("\n".join(status))

    def run(self, job: dict, timeout: float) -> None:
        self.submit(job)
        self.wait(job, timeout)

    def logs(self) -> str:
        out = []
        for i, log in enumerate(self._logs):
            log.seek(0)
            out.append(f"--- rank {i}\n{log.read()[-3000:]}")
        return "\n".join(out)

    def _fail(self, why: str) -> None:
        logs = self.logs()
        self.close()
        raise RuntimeError(f"gang of {self.n}: {why}\n{logs}")

    def close(self) -> None:
        for p in self.procs:
            if p.stdin and not p.stdin.closed:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace
        for p in self.procs:
            try:
                p.wait(max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                pass
        stop(self.procs)
        for log in self._logs:
            log.close()
        self.procs, self._logs = [], []


def launch(cmd: list[str], n: int, *, env=None, cwd=None,
           timeout: float | None = None) -> list[subprocess.CompletedProcess]:
    """Run ``cmd`` as a gang of ``n`` and return each process's exit code,
    stdout and stderr, in rank order. On ``timeout`` (seconds, for the
    whole gang) every process is killed and ``TimeoutExpired`` raised.
    Output goes through files, so no process blocks on a full pipe while
    its peers wait for it in a collective."""
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in range(n)]
    port = free_port()
    procs = [subprocess.Popen(cmd, env=gang_env(n, i, port, env), cwd=cwd,
                              stdout=out, stderr=err, text=True)
             for i, (out, err) in enumerate(files)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
    finally:
        stop(procs)
    done = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        done.append(subprocess.CompletedProcess(cmd, p.returncode,
                                                out.read(), err.read()))
        out.close()
        err.close()
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", "--nprocs", type=int, required=True)
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    procs = start(cmd, args.nprocs)
    try:
        return max(p.wait() for p in procs)
    finally:
        stop(procs)


if __name__ == "__main__":
    sys.exit(main())
