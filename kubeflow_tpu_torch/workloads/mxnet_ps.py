"""Parameter-server training workload speaking the DMLC wire format; a
copy of ``kubeflow_tpu/workloads/mxnet_ps.py`` (numpy only: the
scheduler's and servers' pods need no GPU and no torch).

Proves the MXNetJob kind end-to-end: the THREE DMLC roles the reference's
mxnet-operator schedules (scheduler / server / worker, DMLC_* env contract
— kubeflow/mxnet-job surface) rendezvous using ONLY the operator-injected
environment and train a model through a real push/pull parameter-server
protocol. MXNet itself is not in the image (and would bring its own CUDA
assumptions); the PS architecture is implemented directly — length-prefixed
JSON over TCP, weights sharded across servers — which is exactly what the
env contract exists to bootstrap.

Roles:
- scheduler: rendezvous hub on DMLC_PS_ROOT_PORT; collects every node's
  (role, id, addr), broadcasts the server address table, then waits for
  worker FINALIZE messages before releasing the servers.
- server: holds a contiguous shard of the weight vector; PUSH applies an
  SGD update to the shard, PULL returns it.
- worker: synthetic linear-regression batches; each step pulls the full
  weight vector, computes the MSE gradient, pushes shard-wise.

Every role prints one JSON line; workers report first/final loss so the
E2E test can assert training actually converged.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import threading
import time

import numpy as np

_TIMEOUT = 120.0


def _send(sock: socket.socket, msg: dict) -> None:
    data = json.dumps(msg).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv(sock: socket.socket) -> dict:
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
    return json.loads(data)


def _connect(addr: str, port: int) -> socket.socket:
    """Connect with retry — gang pods start in arbitrary order, so the
    peer may not be listening yet (the kubectl-delivery wait analogue)."""
    deadline = time.monotonic() + _TIMEOUT
    while True:
        try:
            sock = socket.create_connection((addr, port), timeout=_TIMEOUT)
            sock.settimeout(_TIMEOUT)
            return sock
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


def _bind_listener(port: int, backlog: int) -> socket.socket:
    """Bind with retry: a restarted gang can race the previous incarnation
    still holding the fixed coordinator port."""
    deadline = time.monotonic() + _TIMEOUT
    while True:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind(("0.0.0.0", port))
            break
        except OSError:
            srv.close()
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)
    srv.listen(backlog)
    srv.settimeout(_TIMEOUT)
    return srv


def run_scheduler(port: int, n_servers: int, n_workers: int) -> dict:
    srv = _bind_listener(port, n_servers + n_workers)

    conns: list[socket.socket] = []
    worker_conns: list[socket.socket] = []
    servers: dict[int, list] = {}
    while len(servers) < n_servers or len(worker_conns) < n_workers:
        sock, addr = srv.accept()
        sock.settimeout(_TIMEOUT)
        reg = _recv(sock)
        if reg["role"] == "server":
            servers[reg["id"]] = [addr[0], reg["port"]]
        else:
            worker_conns.append(sock)
        conns.append(sock)
    table = {"servers": [servers[i] for i in range(n_servers)]}
    for sock in conns:
        _send(sock, table)
    # Barrier: every worker reports FINALIZE when its steps are done, then
    # the servers are released (they block on a scheduler message).
    done = 0
    for sock in worker_conns:
        try:
            if _recv(sock).get("finalize"):
                done += 1
        except (ConnectionError, TimeoutError):
            pass
    for sock in conns:
        try:
            _send(sock, {"shutdown": True})
        except OSError:
            pass
        sock.close()
    srv.close()
    return {"role": "scheduler", "servers": n_servers,
            "workers_finalized": done}


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


def run_server(root_uri: str, root_port: int, server_id: int,
               n_servers: int, dim: int, lr: float) -> dict:
    shard = np.zeros(_shard_slice(server_id, n_servers, dim).stop
                     - _shard_slice(server_id, n_servers, dim).start,
                     np.float64)
    lsock = socket.socket()
    lsock.bind(("0.0.0.0", 0))
    lsock.listen(16)
    lsock.settimeout(_TIMEOUT)
    lport = lsock.getsockname()[1]

    pushes = 0
    stop = threading.Event()
    # One thread serves each worker connection; pushes and pulls from
    # different workers interleave, so shard updates and snapshots share a
    # lock (without it a pull could read a half-applied update and the
    # pushes counter could drop increments).
    shard_lock = threading.Lock()

    def serve_conn(sock: socket.socket) -> None:
        nonlocal pushes, shard
        sock.settimeout(_TIMEOUT)
        try:
            while True:
                msg = _recv(sock)
                if msg["op"] == "pull":
                    with shard_lock:
                        snapshot = shard.tolist()
                    _send(sock, {"shard": snapshot})
                elif msg["op"] == "push":
                    grad = np.asarray(msg["grad"], np.float64)
                    with shard_lock:
                        shard -= lr * grad  # in-place SGD on the shard
                        pushes += 1
                    _send(sock, {"ok": True})
                elif msg["op"] == "done":
                    _send(sock, {"ok": True})
                    return
        except (ConnectionError, TimeoutError, OSError):
            return

    def acceptor() -> None:
        while not stop.is_set():
            try:
                sock, _ = lsock.accept()
            except (TimeoutError, OSError):
                return
            threading.Thread(target=serve_conn, args=(sock,),
                             daemon=True).start()

    threading.Thread(target=acceptor, daemon=True).start()

    sched = _connect(root_uri, root_port)
    _send(sched, {"role": "server", "id": server_id, "port": lport})
    _recv(sched)  # address table (servers don't need it)
    _recv(sched)  # blocks until the scheduler's shutdown broadcast
    stop.set()
    lsock.close()
    sched.close()
    return {"role": "server", "id": server_id, "pushes": pushes}


def _shard_slice(server_id: int, n_servers: int, dim: int) -> slice:
    per = dim // n_servers
    start = server_id * per
    stop = dim if server_id == n_servers - 1 else start + per
    return slice(start, stop)


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def run_worker(root_uri: str, root_port: int, worker_id: int,
               n_servers: int, dim: int, steps: int,
               batch: int) -> dict:
    sched = _connect(root_uri, root_port)
    _send(sched, {"role": "worker", "id": worker_id})
    table = _recv(sched)
    server_socks = [_connect(a, p) for a, p in table["servers"]]

    rng = np.random.default_rng(42 + worker_id)
    w_true = np.linspace(-1.0, 1.0, dim)
    losses = []
    for _ in range(steps):
        # Pull the sharded weight vector.
        w = np.empty(dim, np.float64)
        for sid, sock in enumerate(server_socks):
            _send(sock, {"op": "pull"})
            w[_shard_slice(sid, n_servers, dim)] = _recv(sock)["shard"]
        x = rng.standard_normal((batch, dim))
        y = x @ w_true
        err = x @ w - y
        losses.append(float(np.mean(err ** 2)))
        grad = 2.0 * x.T @ err / batch
        for sid, sock in enumerate(server_socks):
            _send(sock, {"op": "push",
                         "grad": grad[_shard_slice(sid, n_servers,
                                                   dim)].tolist()})
            _recv(sock)
    for sock in server_socks:
        _send(sock, {"op": "done"})
        _recv(sock)
        sock.close()
    _send(sched, {"finalize": True})
    sched.close()
    return {"role": "worker", "id": worker_id, "steps": steps,
            "first_loss": losses[0], "final_loss": losses[-1],
            "converged": losses[-1] < losses[0] * 0.5}


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    args = ap.parse_args(argv)

    role = os.environ["DMLC_ROLE"]
    root_uri = os.environ["DMLC_PS_ROOT_URI"]
    root_port = int(os.environ["DMLC_PS_ROOT_PORT"])
    n_servers = int(os.environ["DMLC_NUM_SERVER"])
    n_workers = int(os.environ["DMLC_NUM_WORKER"])

    if role == "scheduler":
        report = run_scheduler(root_port, n_servers, n_workers)
    elif role == "server":
        report = run_server(root_uri, root_port,
                            int(os.environ["DMLC_SERVER_ID"]),
                            n_servers, args.dim, args.lr)
    elif role == "worker":
        report = run_worker(root_uri, root_port,
                            int(os.environ["DMLC_WORKER_ID"]),
                            n_servers, args.dim, args.steps, args.batch)
    else:
        raise SystemExit(f"unknown DMLC_ROLE {role!r}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
