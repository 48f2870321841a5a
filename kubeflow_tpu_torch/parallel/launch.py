"""Start a gang on one host: N processes of one command, each with the
JaxJob controller's environment (the role the controller plays across
pods, on one machine: one process per GPU, or per CPU process group).

    python -m kubeflow_tpu_torch.parallel.launch -n 2 -- \\
        python -m kubeflow_tpu_torch.train.loop '{"mesh": {"data": 2}}'

Process ``i`` gets ``JAX_COORDINATOR_ADDRESS=127.0.0.1:<a free port>``,
``JAX_NUM_PROCESSES=N`` and ``JAX_PROCESS_ID=i``; rank 0 listens there.
Every process is stopped before :func:`launch` returns, a timeout
included.
"""

from __future__ import annotations

import argparse
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
