"""Token-corpus store: the real-data input pipeline; a copy of
``kubeflow_tpu/train/tokenstore.py``.

A binary token file (format documented in native/tokenstore.cc, a copy of
the JAX package's source) is memory-mapped and sliced into training
windows by the C++ library — batch assembly is memcpy-speed with zero
Python work per row. The library is built with ``g++`` at first use into
``build/kubeflow_tpu_torch/`` at the root of the checkout, named by a
digest of its source. When no toolchain is available, a numpy fallback
implements the *identical* sampling arithmetic (same splitmix64 stream), so
batches are bit-identical across backends — asserted in tests.

Sampling is stateless in (seed, step): any step's batch can be recomputed
without replaying the stream, which is what makes checkpoint resume exact
(the train loop restarts at step N and the data stream follows).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Iterator

import numpy as np

_MAGIC = 0x4B545055
_HEADER = np.dtype([
    ("magic", "<u4"), ("version", "<u4"), ("dtype", "<u4"), ("pad", "<u4"),
    ("n_tokens", "<u8"),
])

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PACKAGE_DIR, "native", "tokenstore.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build",
                          "kubeflow_tpu_torch")

_lib = None
_lib_tried = False


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write an int32 token corpus in the KTPU binary format."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32).ravel()
    header = np.zeros((), _HEADER)
    header["magic"] = _MAGIC
    header["version"] = 1
    header["dtype"] = 4
    header["n_tokens"] = tokens.size
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(tokens.tobytes())


def _build_library() -> str | None:
    """Compile the C++ library into the build directory (g++ is in the base
    toolchain); None when no compiler is available (numpy fallback takes
    over)."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    lib_path = os.path.join(_BUILD_DIR, f"libtokenstore_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    # Compile to a per-process temp name and rename atomically: multi-host
    # launchers start every worker at once, and a CDLL of a half-written
    # .so from a sibling's in-flight g++ would kill that worker.
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared",
             _SOURCE, "-o", tmp],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(tmp, lib_path)
        return lib_path
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _load_library():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.ts_open.restype = ctypes.c_void_p
    lib.ts_open.argtypes = [ctypes.c_char_p]
    lib.ts_n_tokens.restype = ctypes.c_uint64
    lib.ts_n_tokens.argtypes = [ctypes.c_void_p]
    lib.ts_close.argtypes = [ctypes.c_void_p]
    lib.ts_fill_shuffled.restype = ctypes.c_int
    lib.ts_fill_shuffled.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.ts_fill_sequential.restype = ctypes.c_int
    lib.ts_fill_sequential.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    _lib = lib
    return _lib


def _splitmix64(x: int) -> int:
    mask = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return x ^ (x >> 31)


class TokenStore:
    """Reader over a KTPU token file; native-backed when possible."""

    def __init__(self, path: str, *, native: bool | None = None):
        self.path = path
        lib = _load_library() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native tokenstore requested but unavailable")
        self._lib = lib
        self._handle = None
        if lib is not None:
            handle = lib.ts_open(path.encode())
            if not handle:
                raise ValueError(f"not a KTPU token file: {path}")
            self._handle = ctypes.c_void_p(handle)
            self.n_tokens = int(lib.ts_n_tokens(self._handle))
            self._tokens = None
        else:
            header = np.fromfile(path, dtype=_HEADER, count=1)
            if header.size != 1 or header["magic"][0] != _MAGIC:
                raise ValueError(f"not a KTPU token file: {path}")
            self.n_tokens = int(header["n_tokens"][0])
            self._tokens = np.memmap(path, dtype=np.int32, mode="r",
                                     offset=_HEADER.itemsize,
                                     shape=(self.n_tokens,))

    @property
    def native(self) -> bool:
        return self._handle is not None

    def close(self) -> None:
        """Idempotent; the train loop closes the store when the input
        pipeline shuts down (prefetcher exit, preemption, exception)."""
        if self._handle is not None:
            self._lib.ts_close(self._handle)
            self._handle = None

    def __enter__(self) -> "TokenStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------

    def sample_batch(self, batch: int, width: int, *, seed: int = 0,
                     step: int = 0) -> np.ndarray:
        """[batch, width] int32 shuffled windows, stateless in (seed, step)."""
        out = np.empty((batch, width), np.int32)
        if self._handle is not None:
            rc = self._lib.ts_fill_shuffled(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                batch, width, seed, step,
            )
            if rc != 0:
                raise ValueError(f"corpus shorter than window {width}")
            return out
        if self.n_tokens < width:
            raise ValueError(f"corpus shorter than window {width}")
        span = self.n_tokens - width + 1
        for r in range(batch):
            off = _splitmix64(seed ^ (step * batch + r)) % span
            out[r] = self._tokens[off:off + width]
        return out

    def sequential_batch(self, batch: int, width: int, *, start_row: int,
                         shard: int = 0, num_shards: int = 1) -> np.ndarray:
        """Contiguous windows, rows strided across shards (epoch reads)."""
        out = np.empty((batch, width), np.int32)
        if self._handle is not None:
            rc = self._lib.ts_fill_sequential(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                batch, width, start_row, shard, num_shards,
            )
            if rc != 0:
                raise ValueError("bad sequential read args")
            return out
        n_windows = self.n_tokens // width
        if n_windows == 0 or num_shards <= 0:
            raise ValueError("bad sequential read args")
        for r in range(batch):
            row = (start_row + r) * num_shards + shard
            off = (row % n_windows) * width
            out[r] = self._tokens[off:off + width]
        return out

    def stream(self, batch: int, seq_len: int, *, seed: int = 0,
               start_step: int = 0, shard: int = 0,
               num_shards: int = 1) -> Iterator[dict]:
        """Training batches {"tokens": [batch, seq_len+1]}; each process
        perturbs the seed by its shard id so shards draw disjoint streams.

        Reads are stateless over a read-only mmap (native and numpy
        backends alike), so the iterator is safe to drive from the
        prefetcher's producer thread while the main thread steps."""
        step = start_step
        shard_seed = seed ^ _splitmix64(shard * 0x1000 + num_shards)
        while True:
            yield {"tokens": self.sample_batch(
                batch, seq_len + 1, seed=shard_seed, step=step)}
            step += 1
