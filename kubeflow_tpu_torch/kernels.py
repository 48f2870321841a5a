"""Build, load and launch the port's CUDA kernels; launch counters.

Every ``csrc/*.cu`` has a plain C interface. At first use each source is
compiled with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kubeflow_tpu_torch/`` at the root of the checkout (git-ignored),
named by a digest of the source so an edited kernel is rebuilt, and loaded
with ``ctypes``. The sources are compiled side by side, one ``nvcc`` each,
all started together. Nothing is compiled when the module is imported.

``LAUNCHES`` counts each wrapper's kernel launches (one per call that
launches its kernel or kernels, and nowhere else), so a run can show that
its main path went through the kernels.
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

LAUNCHES = {"paged_decode_attention": 0, "rms_norm": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}

# Type codes of the C interface.
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each exported function, by the source that defines it.
_EXPORTS = {
    "paged_decode": {
        "kft_paged_decode": [_P] * 10 + [_I] * 9 + [_F, _I, _I, _P],
    },
    "flash_attention": {
        "kft_flash_fwd": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
        "kft_flash_bwd": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
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


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libkft_{src.stem}_{digest}.so"


def build() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is not built yet, one
    ``nvcc`` per source, all running at once; returns {source stem:
    library path}."""
    global build_log
    libs = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    todo = [(CSRC / f"{stem}.cu", lib) for stem, lib in libs.items()
            if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
        else:
            tmp.replace(lib)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           f"{build_log}")
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (every source is built on
    the first call)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()[name]))
            for fn_name, argtypes in _EXPORTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


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


# The paged kernel's limits (csrc/paged_decode.cu): table columns one
# split may cover, and splits of one (row, kv head).
PAGED_MAX_COLS, PAGED_MAX_SPLITS = 512, 256
# Per device: the int32 arrival counters of the split-KV combine, one per
# (row, kv head), zeroed once; every launch leaves them 0.
_counters: dict[int, torch.Tensor] = {}
_sm_count: dict[int, int] = {}


def paged_splits(batch: int, hkv: int, mb: int, sms: int) -> tuple[int, int]:
    """(splits, columns per split) of the paged kernel's grid (splits, Hkv,
    B): about two CTAs per SM, at least two table columns per split where
    MB allows, at most ``PAGED_MAX_COLS`` columns per split, and splits x
    columns covering MB with no split wholly past it."""
    want = -(-2 * sms // max(1, batch * hkv))
    splits = max(1, min(want, mb // 2, PAGED_MAX_SPLITS),
                 -(-mb // PAGED_MAX_COLS))
    cps = -(-mb // splits)
    return -(-mb // cps), cps


def _paged_counters(dev: torch.device, pairs: int) -> torch.Tensor:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _counters.get(idx)
    if buf is None or buf.numel() < pairs:
        buf = torch.zeros(max(pairs, 1024), dtype=torch.int32, device=dev)
        _counters[idx] = buf
    return buf


def paged_decode(qg, k_pool, v_pool, table, pos, sm_scale: float):
    """Launch the paged decode kernel. qg [B, Hkv, G, hd] bf16/f32; pools
    [N, Bs, Hkv, hd] bf16/f32 tensors or ``{"q": int8, "scale": f32
    [N, Bs, Hkv]}`` dicts; table [B, MB] int32; pos [B] int32. hd 64 or
    128, Bs a multiple of 8 up to 64, 1 <= G <= 8. Returns f32 [B, Hkv, G,
    hd]. Raises for any input the kernel does not take. The split count
    comes from the shapes alone (``paged_splits``): ``pos`` stays on the
    card."""
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
    if bs % 8 or not 8 <= bs <= 64:
        raise ValueError(f"block size {bs} unsupported (a multiple of 8 up "
                         f"to 64)")
    if not 1 <= g <= 8:
        raise ValueError(f"query group {g} unsupported (1..8)")
    if b > 65535 or hkv > 65535 or n == 0:
        raise ValueError(f"batch {b} / kv heads {hkv} / pool blocks {n} "
                         f"unsupported (1..65535 rows and heads, N >= 1)")
    if mb > PAGED_MAX_COLS * PAGED_MAX_SPLITS:
        raise ValueError(f"table of {mb} columns unsupported (at most "
                         f"{PAGED_MAX_COLS * PAGED_MAX_SPLITS})")
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=dev)
    if b == 0 or mb == 0:
        return out.zero_()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    splits, cps = paged_splits(b, hkv, mb, _sm_count[idx])
    ws = counters = None
    if splits > 1:  # partials (acc, m, l) and the arrival counters
        ws = torch.empty(b * hkv * splits * g * (hd + 2),
                         dtype=torch.float32, device=dev)
        counters = _paged_counters(dev, b * hkv)
    fn = library("paged_decode").kft_paged_decode
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qg.data_ptr(), kq.data_ptr(), vq.data_ptr(), scales[0],
                 scales[1], table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 b, hkv, g, hd, n, bs, mb, splits, cps,
                 float(sm_scale), _Q_CODES[qg.dtype], _KV_CODES[kq.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["paged_decode_attention"] += 1
    return out


_FLASH_HINT = ("; implementation='xla' runs the plain blockwise path for "
               "any shape")


def _flash_checks(q, k, v, kv_mask):
    """Shared checks of the flash launchers; returns (B, T, S, Hq, Hkv,
    D, type code)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernels need CUDA tensors, "
                         f"got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, dev, _Q_CODES, 4)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k and v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, t, hq, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, s_len, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match [{b}, S, Hkv, {hd}]")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads "
                         f"{hkv}")
    if hd not in (64, 128):
        raise ValueError(f"the flash kernel takes head_dim 64 or 128, got "
                         f"{hd}{_FLASH_HINT}")
    if min(b, t, s_len) == 0 or max(b, hq) > 65535:
        raise ValueError(f"the flash kernel takes 1 <= B, Hq <= 65535 and "
                         f"T, S >= 1, got B={b}, Hq={hq}, T={t}, "
                         f"S={s_len}{_FLASH_HINT}")
    if kv_mask is not None:
        _check(kv_mask, "kv_mask", dev, {torch.float32}, 2)
        if kv_mask.shape != (b, s_len):
            raise ValueError(f"kv_mask {tuple(kv_mask.shape)} != "
                             f"{(b, s_len)}")
    return b, t, s_len, hq, hkv, hd, _Q_CODES[q.dtype]


def flash_fwd(q, k, v, kv_mask, causal: bool, scale: float):
    """Launch the flash forward kernel. q [B, T, Hq, D], k/v [B, S, Hkv,
    D] in one of bf16/f32, D 64 or 128, contiguous; kv_mask None or f32
    [B, S]. bf16 runs on the tensor cores (wgmma, TMA), f32 on the CUDA
    cores. Returns (out [B, T, Hq, D] in q's dtype, lse f32 [B, Hq, T]).
    Raises for any input the kernel does not take."""
    b, t, s_len, hq, hkv, hd, code = _flash_checks(q, k, v, kv_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    fn = library("flash_attention").kft_flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_mask is None else kv_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b, t, s_len, hq, hkv, hd,
                 int(causal), float(scale), code, stream)
    if err != 0:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_bwd(q, k, v, kv_mask, out, lse, dout, causal: bool, scale: float):
    """Launch the flash backward kernels (delta, dk/dv, dq; bf16 on the
    tensor cores, f32 on the CUDA cores) on the forward's residuals and
    the output cotangent ``dout`` (q's shape and dtype).
    Returns (dq, dk, dv) in the inputs' dtype. Raises for any input the
    kernels do not take."""
    b, t, s_len, hq, hkv, hd, code = _flash_checks(q, k, v, kv_mask)
    for name, x in (("out", out), ("dout", dout)):
        _check(x, name, q.device, {q.dtype}, 4)
        if x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != q "
                             f"{tuple(q.shape)}")
    _check(lse, "lse", q.device, {torch.float32}, 3)
    if lse.shape != (b, hq, t):
        raise ValueError(f"lse {tuple(lse.shape)} != {(b, hq, t)}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    fn = library("flash_attention").kft_flash_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_mask is None else kv_mask.data_ptr(),
                 out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, t, s_len, hq, hkv, hd, int(causal),
                 float(scale), code, stream)
    if err != 0:
        raise RuntimeError(f"flash backward kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
