"""A gang of CPU processes over gloo that stays up across test cases.

The mesh tests (``test_torch_distributed_train.py``,
``test_torch_moe_parallel.py``) run many cases on gangs of the same size.
Starting a gang costs each rank a torch import and a process-group
rendezvous, several seconds a case; the port's
:class:`~kubeflow_tpu_torch.parallel.launch.Gang` pays it once per size
and runs each case as a job: each rank calls the test file's
``run(a, info)``, which builds its mesh, trains, writes its result and
frees the mesh's groups. A gang that failed is replaced by a fresh one
for the next case.

:func:`single_process` runs the port's trainer in the test's process over
the global batches, once per distinct inputs: cases that share a model,
an optimizer, an initial state and batches share its result. It runs in
a thread beside JAX's steps (:func:`in_background`). :func:`jax_initial_state`
runs JAX's jitted init once per model and optimizer and places that state
on each later case's mesh with the init's own shardings, so every case
starts JAX and the port from the same values.
"""

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kubeflow_tpu_torch import weights
from kubeflow_tpu_torch.parallel.launch import Gang
from kubeflow_tpu_torch.train import data as tdata
from kubeflow_tpu_torch.train import trainer as ttrainer

LOOP = """
from kubeflow_tpu_torch.parallel.distributed import initialize_from_env
from kubeflow_tpu_torch.parallel.launch import serve_jobs
info = initialize_from_env(device="cpu", timeout_s=120)
serve_jobs(lambda a: run(a, info))
"""


class GangPool:
    """One live :class:`~kubeflow_tpu_torch.parallel.launch.Gang` per
    size, started at first use and replaced after a failure."""

    def __init__(self, job_code: str, cwd: str):
        self._job_code = job_code
        self._cwd = cwd
        self._gangs: dict[int, Gang] = {}

    def get(self, n: int) -> Gang:
        gang = self._gangs.get(n)
        if gang is None or not gang.alive():
            if gang is not None:
                gang.close()
            gang = self._gangs[n] = Gang(
                n, self._job_code + LOOP, cwd=self._cwd,
                env=dict(os.environ, OMP_NUM_THREADS="1"))
        return gang

    def close(self) -> None:
        for gang in self._gangs.values():
            gang.close()
        self._gangs.clear()


# The port's single process's (metrics, final state), by its inputs.
_SINGLE: dict = {}


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for tree in trees:
        for k in sorted(tree):
            h.update(k.encode())
            h.update(np.ascontiguousarray(tree[k]).tobytes())
    return h.hexdigest()


def single_process(tm, tcfg, start, batches, accum, key):
    """The port's single process over the global batches, run once per
    distinct inputs."""
    key = (key, _digest(start, *batches))
    if key not in _SINGLE:
        tstate = weights.state_from_numpy(start, tcfg, device="cpu")
        tstep = ttrainer.build_train_step(tm, tcfg, accum_steps=accum)
        tmets = []
        for b in batches:
            tstate, tmet = tstep(tstate, tdata.place_batch(
                b, torch.device("cpu")))
            tmets.append({k: float(v) for k, v in tmet.items()})
        _SINGLE[key] = (tmets, weights.state_to_numpy(tstate, tcfg))
    return _SINGLE[key]


_POOL = ThreadPoolExecutor(1)


def in_background(fn, *args):
    """``fn(*args)`` in a thread; ``.result()`` waits for it."""
    return _POOL.submit(fn, *args)


# JAX's initial state on the host, by model, optimizer and whether a mesh
# holds it.
_JAX_INIT: dict = {}


def jax_initial_state(jax, jtrainer, jm, jcfg, jmesh, key):
    """``jtrainer.init_state(PRNGKey(0), jm, jcfg, jmesh)``: the jitted init
    runs for the first case of ``key``; a later case gets those values
    placed with the init's shardings on its own mesh."""
    key = (key, jmesh is None)
    if key not in _JAX_INIT:
        state = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg, jmesh)
        _JAX_INIT[key] = jax.tree.map(np.array, state)
        return state
    host = _JAX_INIT[key]
    if jmesh is None:
        return jax.tree.map(jax.numpy.asarray, host)
    return jax.device_put(host, jtrainer.state_shardings(host, jmesh, jm))
