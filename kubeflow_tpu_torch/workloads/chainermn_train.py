"""Synchronous data-parallel training over the CHAINERMN env contract; a
copy of ``kubeflow_tpu/workloads/chainermn_train.py`` (numpy only).

Proves the ChainerJob kind end-to-end: master + workers rendezvous using
ONLY the operator-injected CHAINERMN_MASTER_ADDR/PORT/NUM_PROCESSES/
PROCESS_ID environment (operators/jobs.py ChainerJob branch — the
chainer-operator's MPI-style contract) and run synchronous SGD with a
star allreduce: every process computes a local gradient on its own data
shard, the master averages and broadcasts, all ranks apply the same
update. Chainer itself is not in the image; the contract is exercised by
the training protocol it exists to bootstrap, same as
:mod:`kubeflow_tpu_torch.workloads.mxnet_ps` for DMLC.

Every rank prints one JSON line with first/final loss and the process
count, as JAX's does, plus ``model_digest`` (the final weights' SHA-256,
16 hex digits), which is equal on every rank when the ranks end on one
model.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import struct
import time

import numpy as np

_TIMEOUT = 120.0


def _send(sock: socket.socket, arr: np.ndarray) -> None:
    data = arr.astype("<f8").tobytes()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv(sock: socket.socket) -> np.ndarray:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            raise ConnectionError("peer closed")
        head += chunk
    (n,) = struct.unpack("<I", head)
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            raise ConnectionError("peer closed")
        data += chunk
    return np.frombuffer(data, "<f8").copy()


def _star_allreduce_master(conns, local: np.ndarray) -> np.ndarray:
    total = local.copy()
    for sock in conns:
        total += _recv(sock)
    mean = total / (len(conns) + 1)
    for sock in conns:
        _send(sock, mean)
    return mean


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    args = ap.parse_args(argv)

    addr = os.environ["CHAINERMN_MASTER_ADDR"]
    port = int(os.environ["CHAINERMN_MASTER_PORT"])
    nproc = int(os.environ["CHAINERMN_NUM_PROCESSES"])
    rank = int(os.environ["CHAINERMN_PROCESS_ID"])

    conns: list[socket.socket] = []
    if rank == 0:
        from kubeflow_tpu_torch.workloads.mxnet_ps import _bind_listener

        srv = _bind_listener(port, nproc)
        while len(conns) < nproc - 1:
            sock, _ = srv.accept()
            sock.settimeout(_TIMEOUT)
            conns.append(sock)
    else:
        # Retry: the gang's pods start in arbitrary order, so the master
        # may not be listening yet.
        deadline = time.monotonic() + _TIMEOUT
        while True:
            try:
                master = socket.create_connection((addr, port),
                                                  timeout=_TIMEOUT)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        master.settimeout(_TIMEOUT)

    rng = np.random.default_rng(7 + rank)  # distinct shard per rank
    w_true = np.linspace(-1.0, 1.0, args.dim)
    w = np.zeros(args.dim)
    losses = []
    for _ in range(args.steps):
        x = rng.standard_normal((args.batch, args.dim))
        y = x @ w_true
        err = x @ w - y
        losses.append(float(np.mean(err ** 2)))
        grad = 2.0 * x.T @ err / args.batch
        if rank == 0:
            grad = _star_allreduce_master(conns, grad)
        else:
            _send(master, grad)
            grad = _recv(master)
        w -= args.lr * grad  # every rank applies the SAME averaged update

    if rank == 0:
        for sock in conns:
            sock.close()
    else:
        master.close()
    print(json.dumps({
        "rank": rank, "num_processes": nproc, "steps": args.steps,
        "first_loss": losses[0], "final_loss": losses[-1],
        "converged": losses[-1] < losses[0] * 0.5,
        "model_digest": hashlib.sha256(
            w.astype("<f8").tobytes()).hexdigest()[:16],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
