#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card.
It builds the port's kernels from the checkout's sources, holds each
against its plain PyTorch version at the serving shapes, serves
``llama-1b`` at full width through the port's REST ``ModelServer`` with
the paged KV cache read by the paged decode kernel, and checks the
output. Phases, each printed as one JSON line:

(a) the card and the kernels' build times;
(b) the paged decode kernel against ``_paged_decode_plain`` (bf16, f32
    and int8 pools; sentinel table entries, a parked row, a row with
    pos < 0), tolerance 2e-3: both compute in float32 and differ only
    in the order of the sums;
(c) the RMSNorm Triton kernel against ``_rms_norm_plain``, bf16, within
    one bf16 ulp;
(d) the main path: HTTP requests of mixed lengths, one streamed; every
    request gets its token count and the paged decode kernel launches
    exactly ``n_layers`` times per decode forward;
(e) the same requests at float32 with the fused read on and off: the
    greedy tokens must be identical;
(f) the kernel table: each kernel's launches on the main path, its
    error, its time, its plain version's time and its bound.

TF32 is off throughout, so float32 products are full float32. Any
failure exits non-zero; the last line, printed only on success, is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the checkout beside it, it fails before printing any result.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

# H100 SXM, NVIDIA's data sheet (dense rates, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PAGED_TOL = 2e-3

MODEL = "llama-1b"
SLOTS, MAX_SEQ, MAX_NEW, BLOCK = 8, 256, 32, 16
# (prompt length, max_new_tokens) of the main path's requests; the third
# one is streamed.
REQUESTS = [(5, 32), (40, 16), (128, 32), (200, 24), (256, 32), (17, 8)]
STREAMED = 2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after a write
    of ``flush`` (larger than L2) so every call finds its inputs in HBM,
    as a decode step finds the next layer's pool."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# (b) paged decode attention
# ---------------------------------------------------------------------------


def paged_inputs(kv: str, dev, quantize):
    """llama-1b decode shapes: B=8 slots, Hkv=8, G=2, hd=128, Bs=16 and
    MB=(256+32)/16=18 table columns over a pool of B*MB blocks."""
    b, hkv, g, hd, bs = SLOTS, 8, 2, 128, BLOCK
    mb = (MAX_SEQ + MAX_NEW) // bs
    n = b * mb
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.float32 if kv == "f32" else torch.bfloat16
    q = torch.randn(b, hkv, g, hd, generator=gen, device=dev).to(dt)

    def pool():
        p = torch.randn(n, bs, hkv, hd, generator=gen, device=dev)
        return quantize(p) if kv == "int8" else p.to(dt)

    kp, vp = pool(), pool()
    table = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32).reshape(b, mb)
    pos = torch.tensor([7, 40, 100, 150, 200, 287, mb * bs, -1],
                       dtype=torch.int32, device=dev)
    for row in range(b):  # unallocated tails are sentinel (== N)
        p = int(pos[row])
        table[row, (p // bs + 1) if p >= 0 else 0:] = n
    table[3, 0] = n  # a sentinel inside the live span clamps to N-1
    return q, kp, vp, table, pos


def paged_bound(q, kp, table, pos, kv: str) -> tuple[float, str]:
    b, hkv, g, hd = q.shape
    mb, bs = table.shape[1], (kp["q"] if kv == "int8" else kp).shape[1]
    live = sum(0 if p < 0 else min(p + 1, mb * bs) for p in pos.tolist())
    elem = {"bf16": 2, "f32": 4, "int8": 1}[kv]
    kv_bytes = 2 * live * hkv * (hd * elem + (4 if kv == "int8" else 0))
    other = (q.numel() * q.element_size() + q.numel() * 4
             + table.numel() * 4 + pos.numel() * 4)
    ops = live * hkv * g * (4 * hd + 5)  # q·k, p·v, max, exp, sum
    return bound(kv_bytes + other, ops, kv)


def phase_paged(dev, flush) -> dict:
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.decode import _quantize_kv
    from kubeflow_tpu_torch.ops.attention import _paged_decode_plain

    results = {}
    for kv in ("bf16", "f32", "int8"):
        q, kp, vp, table, pos = paged_inputs(kv, dev, _quantize_kv)
        scale = q.shape[-1] ** -0.5
        ref = _paged_decode_plain(q, kp, vp, table, pos, scale)
        out = kernels.paged_decode(q, kp, vp, table, pos, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"paged decode ({kv}): non-finite output")
        err = (out - ref).abs().max().item()
        if err > PAGED_TOL:
            raise AssertionError(f"paged decode ({kv}): max abs error {err}"
                                 f" > {PAGED_TOL}")
        if out[-1].any():
            raise AssertionError(f"paged decode ({kv}): pos < 0 row not 0")
        bound_ms, bound_by = paged_bound(q, kp, table, pos, kv)
        results[kv] = {
            "max_abs_err": err, "tolerance": PAGED_TOL,
            "ms": time_ms(lambda: kernels.paged_decode(
                q, kp, vp, table, pos, scale), flush, 50),
            "plain_ms": time_ms(lambda: _paged_decode_plain(
                q, kp, vp, table, pos, scale), flush, 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"B": q.shape[0], "Hkv": q.shape[1], "G": q.shape[2],
                      "hd": q.shape[3], "Bs": BLOCK, "MB": table.shape[1],
                      "pos": pos.tolist()},
        }
    emit("b_paged_decode", results=results)
    return results


# ---------------------------------------------------------------------------
# (c) RMSNorm
# ---------------------------------------------------------------------------


def phase_rms(dev, flush) -> dict:
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.norms import _rms_norm_plain
    from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

    d, eps = 2048, 1e-5
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.randn(d, generator=gen, device=dev)
    results = {}
    for rows in (SLOTS, SLOTS * MAX_SEQ):
        x = (3 * torch.randn(rows, d, generator=gen, device=dev)).bfloat16()
        out = rms_norm_triton(x, w, eps)
        ref = _rms_norm_plain(x, w, eps)
        ulp = (out.view(torch.int16).int()
               - ref.view(torch.int16).int()).abs().max().item()
        if ulp > 1:
            raise AssertionError(f"rms_norm [{rows}, {d}]: {ulp} bf16 ulp")
        bound_ms, bound_by = bound(2 * x.numel() * 2 + d * 4, 4 * x.numel(),
                                   "bf16")
        with warnings.catch_warnings():
            # The f32 weight keeps F.rms_norm off its fused path; it is
            # timed as it comes, on the kernel's own inputs.
            warnings.simplefilter("ignore")
            library_ms = time_ms(lambda: F.rms_norm(x, (d,), w, eps),
                                 flush, 50)
        results[f"{rows}x{d}"] = {
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "max_ulp": ulp,
            "ms": time_ms(lambda: rms_norm_triton(x, w, eps), flush, 50),
            "plain_ms": time_ms(lambda: _rms_norm_plain(x, w, eps), flush,
                                50),
            "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit("c_rms_norm", results=results)
    return results


# ---------------------------------------------------------------------------
# (d) the main path, (e) f32 fused vs gather
# ---------------------------------------------------------------------------


def request_bodies(vocab: int) -> list[dict]:
    rng = np.random.RandomState(0)
    return [{"tokens": rng.randint(0, vocab, size=n).tolist(),
             "max_new_tokens": want} for n, want in REQUESTS]


def post(port: int, body: dict, stream: bool = False):
    """One predict; returns (tokens, seconds to the first token line or
    to the response)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", f"/v1/models/{MODEL}:predict",
                     body=json.dumps({**({"stream": True} if stream else {}),
                                      "instances": [body]}))
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()!r}")
        if not stream:
            pred = json.loads(resp.read())["predictions"][0]
            return pred["tokens"], time.perf_counter() - t0
        first, recs = None, []
        for line in resp:
            if line.strip():
                recs.append(json.loads(line))
                if first is None:
                    first = time.perf_counter() - t0
        if "error" in recs[-1]:
            raise AssertionError(f"stream failed: {recs[-1]}")
        toks = [r["token"] for r in recs[:-1]]
        if toks != recs[-1]["tokens"]:
            raise AssertionError("streamed tokens disagree with the summary")
        return toks, first
    finally:
        conn.close()


def engine_cfg(**kw):
    from kubeflow_tpu_torch.serving.engine import EngineConfig

    return EngineConfig(model=MODEL, batch_size=SLOTS, max_seq_len=MAX_SEQ,
                        max_new_tokens=MAX_NEW, kv_layout="paged",
                        kv_block_size=BLOCK, device="cuda", **kw)


def phase_main_path() -> dict:
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer(engine_cfg(kv_fused=True), port=0)
    server.start()
    try:
        cfg = server.engine.model.config
        bodies = request_bodies(cfg.vocab_size)
        post(server.port, {"tokens": [1, 2, 3], "max_new_tokens": 2})  # warm
        dec = server.decoder
        steps0, emitted0 = dec.steps, dec.tokens_emitted
        results: list = [None] * len(bodies)

        def run(i):
            results[i] = post(server.port, bodies[i], stream=i == STREAMED)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        kernels.reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        forwards = dec.steps - steps0
        tokens = dec.tokens_emitted - emitted0
    finally:
        server.stop()
    for (n, want), res in zip(REQUESTS, results):
        if res is None:
            raise AssertionError(f"request ({n} prompt tokens) did not finish")
        if len(res[0]) != want:
            raise AssertionError(f"request ({n} prompt tokens) got "
                                 f"{len(res[0])} tokens, wanted {want}")
        if not all(0 <= t < cfg.vocab_size for t in res[0]):
            raise AssertionError("token id outside the vocabulary")
    want_launches = cfg.n_layers * forwards
    if forwards <= 0 or launches["paged_decode_attention"] != want_launches:
        raise AssertionError(
            f"paged decode kernel launched "
            f"{launches['paged_decode_attention']} times, expected "
            f"{cfg.n_layers} layers x {forwards} decode forwards")
    out = {
        "model": MODEL, "dtype": str(cfg.dtype), "slots": SLOTS,
        "max_seq_len": MAX_SEQ, "max_new_tokens": MAX_NEW,
        "requests": [{"prompt": n, "max_new_tokens": w} for n, w in REQUESTS],
        "decode_forwards": forwards, "tokens": tokens, "wall_s": wall,
        "decode_tokens_per_s": tokens / wall,
        "ttft_streamed_ms": 1e3 * results[STREAMED][1],
        "launches": launches,
    }
    emit("d_main_path", **out)
    return out


def phase_f32_parity() -> dict:
    """Greedy tokens at float32 with the fused read (the kernel) and the
    gathered read (plain PyTorch) must be identical. Requests run one at
    a time, so both runs batch alike."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.server import ModelServer

    streams = {}
    for fused in (True, False):
        server = ModelServer(engine_cfg(kv_fused=fused, dtype="float32"),
                             port=0)
        try:
            bodies = request_bodies(server.engine.model.config.vocab_size)
            kernels.reset_launches()
            streams[fused] = [server.handle_predict(
                MODEL, {"instances": [b]})["predictions"][0]["tokens"]
                for b in bodies]
            launched = kernels.LAUNCHES["paged_decode_attention"]
        finally:
            server.stop()
            del server
            torch.cuda.empty_cache()
        if (launched > 0) != fused:
            raise AssertionError(f"fused={fused}: {launched} kernel launches")
    same = sum(a == b for x, y in zip(streams[True], streams[False])
               for a, b in zip(x, y))
    total = sum(len(x) for x in streams[True])
    out = {"identical": streams[True] == streams[False],
           "tokens_equal": same, "tokens": total}
    emit("e_f32_fused_vs_gather", **out)
    if not out["identical"]:
        raise AssertionError("f32 greedy tokens differ between the fused "
                             "and the gathered read")
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch import kernels  # fails without the checkout
    from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # (a) the card, and both kernels built side by side: nvcc in a thread
    # while Triton compiles at its first launch.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built: dict = {}

    def build_cuda():
        try:
            kernels.library()
            built["cuda_s"] = time.perf_counter() - t0
        except Exception as e:  # re-raised below, in the main thread
            built["error"] = e

    nvcc = threading.Thread(target=build_cuda)
    nvcc.start()
    rms_norm_triton(torch.ones(8, 2048, device=dev, dtype=torch.bfloat16),
                    torch.ones(2048, device=dev), 1e-5)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    nvcc.join()
    if "error" in built:
        raise built["error"]
    print(kernels.build_log, file=sys.stderr)
    emit("a_device", gpu=smi, kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         cuda_build_s=built["cuda_s"], triton_build_s=triton_s,
         build_wall_s=time.perf_counter() - t0)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    paged = phase_paged(dev, flush)
    rms = phase_rms(dev, flush)
    del flush
    main_path = phase_main_path()
    phase_f32_parity()

    p, r = paged["bf16"], rms[f"{SLOTS}x2048"]
    print(json.dumps({"kernels": [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "kubeflow_tpu_torch/csrc/paged_decode.cu",
         "replaces": "kubeflow_tpu/ops/attention.py:392",
         "launches": main_path["launches"]["paged_decode_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in paged.values()),
         "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
         "bound_by": p["bound_by"], "library_ms": None},
        {"name": "rms_norm", "route": "triton",
         "source": "kubeflow_tpu_torch/ops/rms_norm_triton.py",
         "replaces": "kubeflow_tpu/ops/norms.py:67",
         "launches": main_path["launches"]["rms_norm"],
         "max_abs_err": max(v["max_abs_err"] for v in rms.values()),
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
