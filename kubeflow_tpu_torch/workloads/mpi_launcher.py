"""MPIJob launcher: what the Launcher replica of ``gpu-mpi-job`` runs,
``python -m kubeflow_tpu_torch.workloads.mpi_launcher -- <command...>``;
a copy of ``kubeflow_tpu/workloads/mpi_launcher.py`` (standard library
only, so the port's image needs no JAX package).

The port's job controller ships the hostfile content in
``MPI_HOSTFILE_CONTENT`` (one slot a worker) and this launcher completes
the contract:

1. write the hostfile to ``OMPI_MCA_orte_default_hostfile``;
2. wait until every worker hostname resolves (pods Running behind the
   headless Service — the kubectl-delivery readiness wait);
3. exec ``mpirun --hostfile <f> -np <slots> <command>`` (or the command
   directly when mpirun is absent / no workers — single-process mode, so
   the same image works without an MPI runtime; the port's image has
   none).

One option is the port's own: ``--single-process-arg`` (repeatable)
appends its value to the command in single-process mode only. The
Launcher holds no GPU, so ``gpu-mpi-job`` passes
``--single-process-arg=--device=cpu`` with its default command: mpirun
runs that command on the GPU workers as given, and without mpirun it runs
here on the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import time

from kubeflow_tpu_torch.runtime import strip_glog_args

DEFAULT_HOSTFILE = "/etc/mpi/hostfile"
ENV_HOSTFILE = "OMPI_MCA_orte_default_hostfile"
ENV_HOSTFILE_CONTENT = "MPI_HOSTFILE_CONTENT"


def parse_hostfile(content: str) -> list[tuple[str, int]]:
    """[(host, slots)] from 'host slots=N' lines."""
    entries = []
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        slots = 1
        for p in parts[1:]:
            if p.startswith("slots="):
                slots = int(p.split("=", 1)[1])
        entries.append((parts[0], slots))
    return entries


def write_hostfile(content: str, path: str) -> list[tuple[str, int]]:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content if content.endswith("\n") else content + "\n")
    return parse_hostfile(content)


def wait_for_workers(hosts: list[str], *, timeout: float = 300.0,
                     poll: float = 2.0, resolve=socket.gethostbyname,
                     log=print) -> None:
    """Block until every worker resolves (headless-Service DNS appears when
    its pod is Running) — the kubectl-delivery wait loop."""
    deadline = time.monotonic() + timeout
    pending = list(hosts)
    while pending:
        still = []
        for host in pending:
            try:
                resolve(host)
            except OSError:
                still.append(host)
        pending = still
        if not pending:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"workers never became resolvable: {pending}")
        log(f"waiting for workers: {pending}")
        time.sleep(poll)


def build_command(command: list[str], hostfile: str,
                  entries: list[tuple[str, int]], *,
                  mpirun=None) -> list[str]:
    mpirun = shutil.which("mpirun") if mpirun is None else mpirun
    if not entries or not mpirun:
        return command  # single-process mode
    np = sum(slots for _h, slots in entries)
    return [
        mpirun, "--hostfile", hostfile, "-np", str(np),
        "--allow-run-as-root",
        # One worker process a host, env forwarded.
        "--map-by", "node", "--bind-to", "none",
        "-x", "PATH", "-x", "PYTHONPATH",
        *command,
    ]


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(
        description="MPIJob launcher (hostfile + worker wait + mpirun)"
    )
    p.add_argument("--hostfile", default=os.environ.get(ENV_HOSTFILE,
                                                        DEFAULT_HOSTFILE))
    p.add_argument("--wait-timeout", type=float, default=300.0)
    p.add_argument("--dry-run", action="store_true",
                   help="print the command instead of executing")
    p.add_argument("--single-process-arg", action="append", default=[],
                   help="appended to the command when it runs here, "
                        "without mpirun (repeatable)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- <program args...>")
    args = p.parse_args(argv)
    command = [c for c in args.command if c != "--"]
    if not command:
        p.error("no command given (use: mpi_launcher -- prog args)")

    content = os.environ.get(ENV_HOSTFILE_CONTENT, "")
    entries = write_hostfile(content, args.hostfile) if content else []
    if entries:
        wait_for_workers([h for h, _s in entries],
                         timeout=args.wait_timeout)
    full = build_command(command, args.hostfile, entries)
    if full == command:  # single-process mode
        full = command + args.single_process_arg
    if args.dry_run:
        print(" ".join(full))
        return 0
    return subprocess.call(full)


if __name__ == "__main__":
    raise SystemExit(main())
