"""Checkpoint / resume; counterpart of ``kubeflow_tpu/train/checkpoint.py``.

The same API as the JAX package's (:class:`Checkpointer` with ``save``,
``wait``, ``latest_step``, ``restore_latest`` and ``close``; module-level
``save``, ``latest_step``, ``restore`` and ``restore_latest``), on files
of numpy's own format instead of orbax's:

- ``<ckpt_dir>/<step>/`` holds one ``.npy`` file per leaf of the JAX
  ``TrainState``'s flat layout (``weights.state_to_numpy``), at the leaf's
  path (``params/layers/attn/wq.npy``, ``opt_state/1/0/v_row/...``), so
  either framework can read it. bf16 leaves are stored widened to float32.
- A step is written under a temporary name in ``<ckpt_dir>`` and committed
  with ``os.replace``: a directory named by a step is always whole.
- The newest ``max_to_keep`` steps are kept.

``save`` first snapshots the state into host memory (the device finishes
the copy before ``save`` returns, so training may update the state in
place at once); with ``async_saves`` a writer thread then writes and
commits it, and ``wait`` blocks until every commit is on disk.

Over a mesh (a state with a ``layout``) the files are the same: the WHOLE
state, so a checkpoint written by W ranks resumes at any other W, and
JAX reads it. ``save`` is a collective that gathers the state to rank 0
alone, one sharded leaf at a time, along every dim fsdp or tensor shards
(``StateLayout.gather_state``: no device holds more than its shards and
one whole leaf), rank 0 writes it, and ``wait`` ends at a barrier of the gang once
rank 0's commits are on disk; every rank keeps the same record of the
steps saved, so they all take the same decisions. ``restore`` reads the
whole state on every rank and keeps each rank's shards.

The package imports neither orbax nor safetensors.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading

import numpy as np

import torch

from kubeflow_tpu_torch.parallel.distributed import barrier, global_any, rank
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.weights import (
    _unflatten,
    flatten,
    state_from_numpy,
    state_to_numpy,
)


def _steps(ckpt_dir: str) -> list[int]:
    """Committed steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n)))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit(ckpt_dir: str, step: int, flat: dict, max_to_keep: int) -> None:
    """Write ``flat`` as step ``step`` and commit it atomically; then drop
    all but the newest ``max_to_keep`` steps."""
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}-"
                                 f"{threading.get_ident()}")
    for path, arr in flat.items():
        name = os.path.join(tmp, *path.split("/")) + ".npy"
        os.makedirs(os.path.dirname(name), exist_ok=True)
        with open(name, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
    final = os.path.join(ckpt_dir, str(step))
    old = None
    if os.path.isdir(final):  # a forced save over a committed step
        old = f"{tmp}.old"
        os.replace(final, old)
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    if old is not None:
        shutil.rmtree(old)
    for s in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)))


def _load(ckpt_dir: str, step: int) -> dict:
    root = os.path.join(ckpt_dir, str(step))
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no checkpoint at step {step} in {ckpt_dir}")
    flat = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".npy"):
                rel = os.path.relpath(os.path.join(dirpath, name[:-4]), root)
                flat[rel.replace(os.sep, "/")] = np.load(
                    os.path.join(dirpath, name))
    return flat


class Checkpointer:
    """One checkpoint directory for a training run, for train states of the
    optimizer ``opt_cfg`` builds (it fixes the state's JAX layout).

    ``save`` returns once the state is snapshotted to host memory; with
    ``async_saves`` a writer thread commits it in the background. ``wait``
    blocks until every pending save is durable: call it before exiting and
    on the preemption path, where the final save must land inside the
    grace window."""

    def __init__(self, ckpt_dir: str, opt_cfg: OptimizerConfig, *,
                 max_to_keep: int = 3, async_saves: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.opt_cfg = opt_cfg
        self.max_to_keep = max_to_keep
        self.async_saves = async_saves
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        # Steps this run saved, pending or committed: the same on every
        # rank of a gang (rank 0's writes may not be on disk yet when
        # another rank looks).
        self._issued: set[int] = set()
        self._lock = threading.Lock()
        self._error: Exception | None = None
        self._writer: threading.Thread | None = None

    def _raise_writer_error(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("an asynchronous checkpoint save failed") \
                from err

    def _write_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, flat = item
                try:
                    _commit(self.ckpt_dir, step, flat, self.max_to_keep)
                except Exception as e:  # re-raised on the caller's side
                    with self._lock:
                        self._error = e
            finally:
                self._queue.task_done()

    def save(self, step: int, state, *, force: bool = False) -> None:
        """Save ``state`` (a port ``TrainState``) as ``step``. A step that
        exists already is replaced only with ``force``. Over a mesh every
        rank calls it, at the same step; the ranks agree on whether the
        step exists before any of them goes on, so rank 0's commit never
        races another rank's look at the directory. A rank outside a mesh
        that holds only some ranks of the gang passes ``state`` None: it
        takes part in the agreement and the commit's barrier only."""
        self._raise_writer_error()
        if not force and global_any(step in self._issued
                                    or step in _steps(self.ckpt_dir)):
            raise ValueError(f"checkpoint step {step} exists in "
                             f"{self.ckpt_dir}; pass force=True")
        self._issued.add(step)
        if getattr(state, "layout", None) is not None:
            state = state.layout.gather_state(state)
        if rank() != 0:
            return
        if state is None:
            raise ValueError("rank 0 holds no state to save")
        flat = state_to_numpy(state, self.opt_cfg)  # the host snapshot
        if not self.async_saves:
            _commit(self.ckpt_dir, step, flat, self.max_to_keep)
            return
        if self._writer is None:
            self._writer = threading.Thread(
                target=self._write_loop, name="checkpoint-writer",
                daemon=True)
            self._writer.start()
        self._queue.put((step, flat))

    def wait(self) -> None:
        """Until every pending save is on disk; in a gang every rank then
        waits at a barrier for rank 0's commits."""
        self._queue.join()
        barrier("checkpoint-commit")
        self._raise_writer_error()

    def latest_step(self) -> int | None:
        """The newest step, committed or pending."""
        steps = set(_steps(self.ckpt_dir)) | self._issued
        return max(steps) if steps else None

    def restore_latest(self, like) -> tuple[object, int] | None:
        """(state, step) of the newest committed step, on ``like``'s device
        and in its leaf order, or None when there is none. ``like`` None
        (a rank outside the mesh) reads only the step: (None, step)."""
        self.wait()
        steps = _steps(self.ckpt_dir)
        if not steps:
            return None
        if like is None:
            return None, steps[-1]
        return restore(self.ckpt_dir, steps[-1], like, self.opt_cfg), \
            steps[-1]

    def close(self) -> None:
        """Wait for pending saves and stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._queue.put(None)
                self._writer.join()
                self._writer = None


def save(ckpt_dir: str, step: int, state, opt_cfg: OptimizerConfig, *,
         force: bool = False) -> None:
    """Save synchronously."""
    Checkpointer(ckpt_dir, opt_cfg, async_saves=False).save(
        step, state, force=force)


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, opt_cfg: OptimizerConfig):
    """The state saved at ``step``, on the device of ``like`` (a port
    ``TrainState`` of the same model and optimizer, as JAX restores into
    an abstract state) and in its leaf order; over a mesh (``like`` has a
    layout) this rank's shards of it, whatever mesh wrote it."""
    device = next(iter(flatten(like.params).values())).device
    layout = getattr(like, "layout", None)
    if layout is not None:  # the whole shapes, for the checks and order
        like = type(like)(like.step, _unflatten(
            {k: torch.empty(s, device="meta")
             for k, s in layout.shapes.items()}), {})
    state = state_from_numpy(_load(ckpt_dir, step), opt_cfg, device=device,
                             like=like)
    return state if layout is None else layout.shard_state(state)


def restore_latest(ckpt_dir: str, like, opt_cfg: OptimizerConfig
                   ) -> tuple[object, int] | None:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, like, opt_cfg), step
