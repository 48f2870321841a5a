"""Build, load and launch the port's CUDA kernels; launch counters.

``csrc/paged_decode.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kubeflow_tpu_torch/`` at the root of the checkout (git-ignored),
named by a digest of the source so an edited kernel is rebuilt, and loaded
with ``ctypes``. Nothing is compiled when the module is imported.

``LAUNCHES`` counts each wrapper's kernel launches (one per launch, and
nowhere else), so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "kubeflow_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"paged_decode_attention": 0, "rms_norm": 0}

# Type codes of the C interface.
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib = None
# What the last build printed: nvcc's -Xptxas -v report of registers,
# shared memory and spills, which chip_smoke.py shows.
build_log = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build() -> Path:
    """Compile ``csrc/paged_decode.cu`` unless this source's library is
    already built; returns the library's path."""
    global build_log
    src = CSRC / "paged_decode.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libkft_paged_decode_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    tmp.replace(lib)
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.kft_paged_decode
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(t: torch.Tensor, name: str, device, dtypes, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_decode(qg, k_pool, v_pool, table, pos, sm_scale: float):
    """Launch the paged decode kernel. qg [B, Hkv, G, hd] bf16/f32; pools
    [N, Bs, Hkv, hd] bf16/f32 tensors or ``{"q": int8, "scale": f32
    [N, Bs, Hkv]}`` dicts; table [B, MB] int32; pos [B] int32. Returns
    f32 [B, Hkv, G, hd]. Raises for any input the kernel does not take."""
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"the paged decode kernel needs CUDA tensors, "
                         f"got {dev}")
    _check(qg, "qg", dev, _Q_CODES, 4)
    b, hkv, g, hd = qg.shape
    quant = isinstance(k_pool, dict)
    if quant != isinstance(v_pool, dict):
        raise ValueError("k_pool and v_pool must both be quantized or not")
    kq = k_pool["q"] if quant else k_pool
    vq = v_pool["q"] if quant else v_pool
    kv_types = {torch.int8} if quant else {torch.float32, torch.bfloat16}
    _check(kq, "k_pool", dev, kv_types, 4)
    _check(vq, "v_pool", dev, kv_types, 4)
    n, bs = kq.shape[0], kq.shape[1]
    if kq.shape != (n, bs, hkv, hd) or vq.shape != kq.shape:
        raise ValueError(f"pools {tuple(kq.shape)}/{tuple(vq.shape)} do not "
                         f"match [N, Bs, {hkv}, {hd}]")
    if vq.dtype != kq.dtype:
        raise ValueError("k_pool and v_pool dtypes differ")
    scales = (None, None)
    if quant:
        for name, s in (("k scale", k_pool["scale"]),
                        ("v scale", v_pool["scale"])):
            _check(s, name, dev, {torch.float32}, 3)
            if s.shape != (n, bs, hkv):
                raise ValueError(f"{name} {tuple(s.shape)} != {(n, bs, hkv)}")
        scales = (k_pool["scale"].data_ptr(), v_pool["scale"].data_ptr())
    _check(table, "table", dev, {torch.int32}, 2)
    _check(pos, "pos", dev, {torch.int32}, 1)
    mb = table.shape[1]
    if table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} unsupported (64 or 128)")
    if bs not in (8, 16):
        raise ValueError(f"block size {bs} unsupported (8 or 16)")
    if not 1 <= g <= 8:
        raise ValueError(f"query group {g} unsupported (1..8)")
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=dev)
    if b == 0 or mb == 0:
        return out.zero_()
    fn = library().kft_paged_decode
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qg.data_ptr(), kq.data_ptr(), vq.data_ptr(), scales[0],
                 scales[1], table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 b, hkv, g, hd, n, bs, mb, float(sm_scale),
                 _Q_CODES[qg.dtype], _KV_CODES[kq.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["paged_decode_attention"] += 1
    return out
