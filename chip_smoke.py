#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card.
It builds the port's kernels from the checkout's sources (one ``nvcc``
per CUDA source, all at once, beside Triton's first compile), holds each
against its plain PyTorch version at the shapes its main path gives it,
serves ``llama-1b`` at full width through the port's REST ``ModelServer``
with the paged KV cache read by the paged decode kernel, trains
``flagship-1b`` at full width through the port's training loop with
attention in the flash kernels, and checks the output. Phases, each
printed as one JSON line:

(a) the card and the kernels' build times;
(b) the paged decode kernel against ``_paged_decode_plain`` at the main
    path's shape (bf16, f32 and int8 pools; sentinel table entries, a
    parked row, a row with pos < 0) and at two kernel-only bf16 shapes
    (one row of 4096 positions; 32 rows of 2048), tolerance 2e-3: both
    compute in float32 and differ only in the order of the sums. ``ms``
    is the kernel's device time (``torch.profiler`` durations, L2
    flushed before each launch), ``call_ms`` the time of the Python call
    around it, beside the bound and its share;
(c) the RMSNorm Triton kernel against ``_rms_norm_plain``, bf16, within
    one bf16 ulp; ``ms`` device time, ``call_ms`` the call's;
(d) the main path: HTTP requests of mixed lengths, one streamed; every
    request gets its token count and the paged decode kernel launches
    exactly ``n_layers`` times per decode forward;
(e) the same requests at float32 with the fused read on and off: the
    greedy tokens must be identical;
(g) the flash attention kernels (forward; backward from one output
    cotangent) against ``_flash_fwd_plain`` / ``_flash_bwd_plain`` on the
    same inputs: the training shape (B=4, T=S=2048, Hq=32, Hkv=4, D=128,
    causal) in bf16 and f32, non-causal with a kv mask that masks a whole
    batch row, a ragged T=S=1000, D=64, G=1, and the ``"pallas"`` name
    beside ``"splash"``. f32 runs the CUDA-core route, which differs from
    the plain versions only in the order of its f32 sums: out and lse
    1e-4, gradients 1e-4 of the largest reference gradient and a
    difference whose norm is within 1e-5 of the reference's. bf16 runs
    the tensor-core route, which rounds P (before P.V and dV) and dS
    (before dQ and dK) to bf16, as SDPA's flash kernels do, where the
    plain versions keep them in f32; so its limits stand on SDPA's own
    error against the same reference on the same inputs, printed beside
    the kernels': out max(1e-2, 2 x SDPA's), lse 1e-4, gradients 2e-2 of
    the largest reference gradient and a difference whose norm is within
    max(2^-8, 2 x SDPA's) of the reference's, so an error of a few
    percent on typical gradients fails even where the largest one hides
    it. Times at the training shape beside the plain versions, the
    bound, ``F.scaled_dot_product_attention`` (forward, and backward
    alone), a yardstick the port never calls, and the f32 CUDA-core
    route on the same values;
(h) the training main path: ``train.loop.run`` at ``flagship-1b``, batch
    4 x seq 2048, adafactor with a 2-step warmup, bf16, 8 steps; losses
    and gradient norms finite, the first loss near ln(vocab), and each
    flash kernel launched exactly n_layers times a step; tokens/s and
    MFU (``bench.py``'s formula against 989 TFLOP/s) over the whole
    window of steps 2-8, and the median step time beside them;
(i) float32 parity: ``flagship-1b`` at full width in f32, batch 1 x seq
    1024, 3 train steps with ``attn_impl="splash"`` (the kernels) and
    ``"xla"`` (plain): losses and gradient norms within 1e-5 relative,
    parameters within 1e-5 of each leaf's largest magnitude;
(f) the kernel table: each kernel's launches on the main path, its
    error, its time, its plain version's time and its bound; the paged
    and RMSNorm rows give device time as ``ms`` and the call's as
    ``call_ms`` (the paged row also its device time at the long and busy
    shapes), the flash rows the call's (hundreds of microseconds, where
    host time is noise) and the f32 CUDA-core route's (``f32_ms``).

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
# Flash kernels against their plain versions: {dtype: (out, lse, grads as
# a fraction of the largest reference gradient, the norm of the gradients'
# difference as a fraction of the reference's norm)}; in bf16 the out and
# norm limits are floors under twice SDPA's error (see the docstring).
FLASH_TOL = {torch.float32: (1e-4, 1e-4, 1e-4, 1e-5),
             torch.bfloat16: (1e-2, 1e-4, 2e-2, 2.0 ** -8)}
# The training shape of flagship-1b at batch 4 x seq 2048.
FLASH_MAIN = dict(b=4, t=2048, s=2048, hq=32, hkv=4, hd=128, causal=True)
PLAIN_BLOCK_K = 1024  # flagship-1b's attn_block_k, for the plain path
TRAIN_MODEL, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "flagship-1b", 4, 2048, 8

MODEL = "llama-1b"
SLOTS, MAX_SEQ, MAX_NEW, BLOCK = 8, 256, 32, 16
# (prompt length, max_new_tokens) of the main path's requests; the third
# one is streamed.
REQUESTS = [(5, 32), (40, 16), (128, 32), (200, 24), (256, 32), (17, 8)]
STREAMED = 2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Mean time of one call of ``fn`` over ``iters`` calls, between CUDA
    events around the call, each after a write of ``flush`` (larger than
    L2) so every call finds its inputs in HBM, as a decode step finds the
    next layer's pool. For a kernel of microseconds this includes the
    host work of the call while the card waits; ``device_ms`` does not."""
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


def device_ms(fn, flush: torch.Tensor, iters: int,
              kernel: str | None = None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after a write
    of ``flush``, from the kernel durations ``torch.profiler`` records:
    the card's time alone, without the host time of the Python call
    (which ``time_ms`` includes). ``kernel`` names the one kernel a call
    must launch; None sums every kernel but the flush's."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernel is None:
        us = [e.device_time_total for e in events
              if "FillFunctor" not in e.name and "Memset" not in e.name]
    else:
        us = [e.device_time_total for e in events if kernel in e.name]
        if len(us) != iters:
            raise AssertionError(f"profiler saw {len(us)} launches of "
                                 f"{kernel} in {iters} calls")
    if not us:
        raise AssertionError("profiler saw no kernel")
    return sum(us) / iters / 1e3


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# (b) paged decode attention
# ---------------------------------------------------------------------------


# Kernel-only shapes of the paged kernel beside the main path's (bf16,
# llama-1b's Hkv=8, G=2, hd=128, Bs=16): one row of 4096 positions, and
# 32 rows of 2048.
PAGED_LONG = dict(b=1, mb=256, pos=[4095])
PAGED_BUSY = dict(b=32, mb=128, pos=[2047] * 32)


def paged_inputs(kv: str, dev, quantize, b=SLOTS,
                 mb=(MAX_SEQ + MAX_NEW) // BLOCK, pos=None):
    """llama-1b decode shapes: Hkv=8, G=2, hd=128, Bs=16, a pool of B*MB
    blocks behind a permuted table. By default the main path's B=8 slots
    and MB=(256+32)/16=18 columns, with a sentinel inside a live span, a
    parked row and a row with pos < 0."""
    hkv, g, hd, bs = 8, 2, 128, BLOCK
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
    smoke = pos is None
    if smoke:
        pos = [7, 40, 100, 150, 200, 287, mb * bs, -1]
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    for row in range(b):  # unallocated tails are sentinel (== N)
        p = int(pos[row])
        table[row, (p // bs + 1) if p >= 0 else 0:] = n
    if smoke:
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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    cases = [(kv, kv, {}) for kv in ("bf16", "f32", "int8")]
    cases += [("long_bf16", "bf16", PAGED_LONG), ("busy_bf16", "bf16",
                                                   PAGED_BUSY)]
    for name, kv, shape in cases:
        q, kp, vp, table, pos = paged_inputs(kv, dev, _quantize_kv, **shape)
        scale = q.shape[-1] ** -0.5
        ref = _paged_decode_plain(q, kp, vp, table, pos, scale)
        out = kernels.paged_decode(q, kp, vp, table, pos, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"paged decode ({name}): non-finite output")
        err = (out - ref).abs().max().item()
        if err > PAGED_TOL:
            raise AssertionError(f"paged decode ({name}): max abs error "
                                 f"{err} > {PAGED_TOL}")
        if (pos < 0).any() and out[pos < 0].any():
            raise AssertionError(f"paged decode ({name}): pos < 0 row not 0")
        del ref

        def call():
            return kernels.paged_decode(q, kp, vp, table, pos, scale)

        bound_ms, bound_by = paged_bound(q, kp, table, pos, kv)
        ms = device_ms(call, flush, 50, "paged_decode_kernel")
        row = {
            "max_abs_err": err, "tolerance": PAGED_TOL, "ms": ms,
            "call_ms": time_ms(call, flush, 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
            "splits_cols": kernels.paged_splits(q.shape[0], q.shape[1],
                                                table.shape[1], sms),
            "shape": {"B": q.shape[0], "Hkv": q.shape[1], "G": q.shape[2],
                      "hd": q.shape[3], "Bs": BLOCK, "MB": table.shape[1],
                      "pos": pos.tolist() if not shape else shape["pos"][0]},
        }
        if not shape:  # the plain version only at the main path's shape
            row["plain_ms"] = time_ms(lambda: _paged_decode_plain(
                q, kp, vp, table, pos, scale), flush, 10)
        results[name] = row
        del q, kp, vp, out
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
            library_device_ms = device_ms(
                lambda: F.rms_norm(x, (d,), w, eps), flush, 50)
        results[f"{rows}x{d}"] = {
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "max_ulp": ulp,
            "ms": device_ms(lambda: rms_norm_triton(x, w, eps), flush, 50,
                            "rms_kernel"),
            "call_ms": time_ms(lambda: rms_norm_triton(x, w, eps), flush,
                               50),
            "plain_ms": time_ms(lambda: _rms_norm_plain(x, w, eps), flush,
                                50),
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
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
# (g) flash attention kernels
# ---------------------------------------------------------------------------


def flash_inputs(dev, dtype, b, t, s, hq, hkv, hd, causal, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    return (rand(b, t, hq, hd), rand(b, s, hkv, hd), rand(b, s, hkv, hd),
            rand(b, t, hq, hd))


def flash_plain(q, k, v, kv_mask, g, causal, scale):
    """The plain versions on the kernels' layout: (out, lse [B, Hq, T],
    dq, dk, dv)."""
    from kubeflow_tpu_torch.ops import attention as A

    b, t, hq, _ = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    kvm = A._fold_mask(kv_mask, b, s_len, hkv, q.device)
    qf, kf, vf = A._fold_q(q, hkv), A._fold_kv(k), A._fold_kv(v)
    block = PLAIN_BLOCK_K
    out, lse = A._flash_fwd_plain(qf, kf, vf, kvm, causal=causal,
                                  scale=scale, block_k=block)
    dq, dk, dv = A._flash_bwd_plain(qf, kf, vf, kvm, out, lse,
                                    A._fold_q(g, hkv), causal=causal,
                                    scale=scale, block_k=block)
    return (A._unfold_q(out, b), lse.reshape(b, hq, t), A._unfold_q(dq, b),
            A._unfold_kv(dk, b), A._unfold_kv(dv, b))


def sdpa_run(q, k, v, g, kv_mask, causal):
    """``F.scaled_dot_product_attention`` and its gradients on the
    kernels' inputs and layout: K/V repeated to the query heads, the kv
    mask and the top-left causal mask as one boolean mask. SDPA leaves a
    row that attends nothing undefined (NaN, or the mean of V, by
    backend): such rows, and the gradients of masked keys, count as 0,
    as the reference has them. Returns (out, dq, dk, dv) in f32."""
    import torch.nn.functional as F

    b, t, hq, _ = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    leaves = [x.transpose(1, 2).contiguous().requires_grad_(True)
              for x in (q, k, v)]
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in leaves[1:])
    attn_mask = None
    if kv_mask is not None or (causal and t != s_len):
        allow = torch.ones(b, 1, t, s_len, dtype=torch.bool, device=q.device)
        if causal:
            allow = allow & torch.ones(t, s_len, dtype=torch.bool,
                                       device=q.device).tril()
        if kv_mask is not None:
            allow = allow & (kv_mask > 0)[:, None, None, :]
        attn_mask = allow
    out = F.scaled_dot_product_attention(
        leaves[0], kx, vx, attn_mask=attn_mask,
        is_causal=causal and attn_mask is None)
    out.backward(g.transpose(1, 2))
    res = [torch.nan_to_num(x.transpose(1, 2).float())
           for x in (out.detach(), *(x.grad for x in leaves))]
    if attn_mask is not None:
        live = attn_mask[:, 0].any(-1)[:, :, None, None]  # [B, T, 1, 1]
        res[0], res[1] = res[0] * live, res[1] * live
    if kv_mask is not None:
        keys = (kv_mask > 0)[:, :, None, None]  # [B, S, 1, 1]
        res[2], res[3] = res[2] * keys, res[3] * keys
    return res


def flash_check(case: str, impl: str, dev, dtype, kv_mask=None, **shape):
    """Kernels (through ``flash_attention`` and autograd, and the lse of
    the forward launcher) against the plain versions on the same inputs,
    with SDPA's errors against the same reference beside them in bf16;
    returns the errors and raises past the tolerances."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.ops.attention import flash_attention

    q, k, v, g = flash_inputs(dev, dtype, **shape)
    causal, scale = shape["causal"], shape["hd"] ** -0.5
    # The plain versions in f32 on the same values.
    ref = flash_plain(q.float(), k.float(), v.float(), kv_mask, g.float(),
                      causal, scale)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, kv_mask=kv_mask,
                          implementation=impl)
    out.backward(g)
    _, lse = kernels.flash_fwd(q, k, v, None if kv_mask is None
                               else kv_mask.float().contiguous(), causal,
                               scale)
    torch.cuda.synchronize()
    got = [out.detach(), lse] + [x.grad for x in leaves]
    tol_out, tol_lse, tol_grad, tol_norm = FLASH_TOL[dtype]
    sdpa_errs, sdpa_rel = {}, {}
    if dtype == torch.bfloat16:
        sdpa = sdpa_run(q, k, v, g, kv_mask, causal)
        for name, a, r in zip(("out", "dq", "dk", "dv"), sdpa,
                              (ref[0],) + ref[2:]):
            diff = a - r.float()
            sdpa_errs[name] = diff.abs().max().item()
            sdpa_rel[name] = (diff.norm() / r.float().norm()).item()
        del sdpa
        tol_out = max(tol_out, 2 * sdpa_errs["out"])
    errs, rel_norms = {}, {}
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        if not torch.isfinite(a).all():
            raise AssertionError(f"flash {case} ({impl}): non-finite {name}")
        diff = a.float() - r.float()
        err = diff.abs().max().item()
        limit = {"out": tol_out, "lse": tol_lse}.get(
            name, tol_grad * r.float().abs().max().item())
        if err > limit:
            raise AssertionError(f"flash {case} ({impl}): {name} max abs "
                                 f"error {err} > {limit}")
        errs[name] = err
        if name.startswith("d"):
            rel = (diff.norm() / r.float().norm()).item()
            limit = max(tol_norm, 2 * sdpa_rel.get(name, 0.0))
            if not rel <= limit:
                raise AssertionError(f"flash {case} ({impl}): {name} "
                                     f"relative norm error {rel} > "
                                     f"{limit}")
            rel_norms[name] = rel
    if kv_mask is not None and not kv_mask[0].any():
        if got[0][0].any() or got[2][0].any():
            raise AssertionError(f"flash {case}: the fully masked row is "
                                 "not 0")
    return {"dtype": str(dtype), **shape, "implementation": impl,
            "max_abs_err": errs, "grad_rel_norm_err": rel_norms,
            "sdpa_max_abs_err": sdpa_errs, "sdpa_grad_rel_norm_err": sdpa_rel}


def causal_pairs(t: int, s_len: int, causal: bool) -> int:
    """(query, key) pairs the attention attends: top-left causal."""
    if not causal:
        return t * s_len
    return sum(min(i + 1, s_len) for i in range(t))


def phase_flash(dev, flush) -> dict:
    import torch.nn.functional as F

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.ops import attention as A

    m = FLASH_MAIN
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(flash_check("main", "splash", dev, dtype, **m))
    cases.append(flash_check("main", "pallas", dev, torch.bfloat16, **m))
    gen = torch.Generator(device=dev).manual_seed(4)
    mask = torch.rand(2, 1024, generator=gen, device=dev) > 0.2
    mask[0] = False
    cases.append(flash_check("masked", "pallas", dev, torch.bfloat16, mask,
                             **{**m, "b": 2, "t": 1024, "s": 1024,
                                "causal": False}))
    cases.append(flash_check("masked", "splash", dev, torch.float32, mask,
                             **{**m, "b": 2, "t": 1024, "s": 1024,
                                "causal": False}))
    cases.append(flash_check("ragged", "splash", dev, torch.bfloat16,
                             **{**m, "t": 1000, "s": 1000}))
    cases.append(flash_check("hd64", "pallas", dev, torch.bfloat16,
                             **{**m, "hd": 64}))
    cases.append(flash_check("G1", "splash", dev, torch.bfloat16,
                             **{**m, "hq": 8, "hkv": 8}))
    max_err = {impl: {part: max(max(c["max_abs_err"][n] for n in names)
                                for c in cases
                                if c["implementation"] == impl)
                      for part, names in (("fwd", ("out", "lse")),
                                          ("bwd", ("dq", "dk", "dv")))}
               for impl in ("splash", "pallas")}

    # Times at the training shape, bf16, L2 flushed before each call.
    q, k, v, g = flash_inputs(dev, torch.bfloat16, **m)
    scale = m["hd"] ** -0.5
    out, lse = kernels.flash_fwd(q, k, v, None, True, scale)
    hkv = m["hkv"]
    qf, kf, vf, gf = (A._fold_q(q, hkv), A._fold_kv(k), A._fold_kv(v),
                      A._fold_q(g, hkv))
    kvm = A._fold_mask(None, m["b"], m["s"], hkv, dev)
    out_f, lse_f = A._flash_fwd_plain(qf, kf, vf, kvm, causal=True,
                                      scale=scale, block_k=PLAIN_BLOCK_K)
    # The yardstick: one PyTorch call of the same function, [B, H, T, D].
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)
    timing = {
        "fwd": {
            "ms": time_ms(lambda: kernels.flash_fwd(q, k, v, None, True,
                                                    scale), flush, 10),
            "plain_ms": time_ms(lambda: A._flash_fwd_plain(
                qf, kf, vf, kvm, causal=True, scale=scale, block_k=PLAIN_BLOCK_K),
                flush, 3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush, 10),
        },
        "bwd": {
            "ms": time_ms(lambda: kernels.flash_bwd(
                q, k, v, None, out, lse, g, True, scale), flush, 5),
            "plain_ms": time_ms(lambda: A._flash_bwd_plain(
                qf, kf, vf, kvm, out_f, lse_f, gf, causal=True, scale=scale,
                block_k=PLAIN_BLOCK_K), flush, 3),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, leaves, gt, retain_graph=True), flush, 10),
        },
    }
    # The f32 CUDA-core route on the same values, the kernels' other route.
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    out32, lse32 = kernels.flash_fwd(q32, k32, v32, None, True, scale)
    timing["fwd"]["f32_ms"] = time_ms(lambda: kernels.flash_fwd(
        q32, k32, v32, None, True, scale), flush, 3)
    timing["bwd"]["f32_ms"] = time_ms(lambda: kernels.flash_bwd(
        q32, k32, v32, None, out32, lse32, g32, True, scale), flush, 2)
    del q32, k32, v32, g32, out32, lse32
    b, t, s_len, hq, hd = m["b"], m["t"], m["s"], m["hq"], m["hd"]
    pairs = b * hq * causal_pairs(t, s_len, True)
    qo_bytes = b * t * hq * hd * 2
    kv_bytes = b * s_len * hkv * hd * 2
    lse_bytes = b * hq * t * 4
    bounds = {
        # q, k, v read; out, lse written. QK^T and PV: 4*D per pair.
        "fwd": bound(2 * qo_bytes + 2 * kv_bytes + lse_bytes,
                     4 * hd * pairs, "bf16"),
        # q, k, v, out, dout, lse read; dq, dk, dv written. QK^T
        # recompute, dP, dV, dK, dQ: 10*D per pair.
        "bwd": bound(4 * qo_bytes + 4 * kv_bytes + lse_bytes,
                     10 * hd * pairs, "bf16"),
    }
    for part, (bound_ms, bound_by) in bounds.items():
        timing[part].update(bound_ms=bound_ms, bound_by=bound_by)
    out_row = {"cases": cases, "max_abs_err": max_err, "timing": timing,
               "shape": {**m, "dtype": "bf16"}}
    emit("g_flash_attention", **out_row)
    del leaves, sdpa_out
    return out_row


# ---------------------------------------------------------------------------
# (h) the training main path, (i) f32 kernel-vs-plain training parity
# ---------------------------------------------------------------------------


def phase_train(smi: str) -> dict:
    import math

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    cfg = loop.RunConfig(
        model=TRAIN_MODEL, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        steps=TRAIN_STEPS, log_every=1, prefetch=2, device="cuda",
        optimizer=OptimizerConfig(name="adafactor", warmup_steps=2))
    lines, stamps = [], []

    def log(line):
        lines.append(line)
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = loop.run(cfg, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    model = get_model(TRAIN_MODEL)
    mcfg = model.config
    steps = [dict(kv.split("=") for kv in line.split()[:3])
             for line in lines if line.startswith("step=")]
    losses = [float(s["loss"]) for s in steps]
    norms = [float(s["grad_norm"]) for s in steps]
    if len(losses) != TRAIN_STEPS:
        raise AssertionError(f"{len(losses)} step lines, wanted "
                             f"{TRAIN_STEPS}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    if abs(losses[0] - math.log(mcfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({mcfg.vocab_size})")
    want = mcfg.n_layers * TRAIN_STEPS
    for key in ("flash_attention_fwd", "flash_attention_bwd"):
        if launches[key] != want:
            raise AssertionError(f"{key} launched {launches[key]} times, "
                                 f"expected {mcfg.n_layers} layers x "
                                 f"{TRAIN_STEPS} steps")
    # Each log line follows a sync (the loss read), so the stamps of the
    # step lines bound whole steps. The rate is taken over all the work
    # from the end of step 1 (which includes warm-up) to the end of the
    # last step, so a stall in any step moves it; the median gap is a
    # per-step statistic beside it.
    step_stamps = stamps[:TRAIN_STEPS]
    timed_steps = TRAIN_STEPS - 1
    window_s = step_stamps[-1] - step_stamps[0]
    gaps = sorted(b - a for a, b in zip(step_stamps, step_stamps[1:]))
    step_p50_s = gaps[len(gaps) // 2]
    d, f, hd = mcfg.d_model, mcfg.d_ff, mcfg.head_dim
    n_params = (2 * mcfg.vocab_size * d + d + mcfg.n_layers * (
        d * (mcfg.n_heads + 2 * mcfg.n_kv_heads) * hd
        + mcfg.n_heads * hd * d + 3 * d * f + 2 * d))
    # bench.py: 6N + 12 * layers * avg attended length * attention width.
    flops_per_token = (6.0 * n_params + 12.0 * mcfg.n_layers
                       * (TRAIN_SEQ + 1) / 2 * mcfg.n_heads * hd)
    tokens_per_s = timed_steps * TRAIN_BATCH * TRAIN_SEQ / window_s
    out = {
        "gpu": smi, "model": TRAIN_MODEL, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "optimizer": "adafactor",
        "dtype": str(mcfg.dtype), "params": n_params, "losses": losses,
        "grad_norms": norms, "launches": launches,
        "timed_steps": timed_steps, "window_s": window_s,
        "step_ms_mean": 1e3 * window_s / timed_steps,
        "step_ms_p50": 1e3 * step_p50_s, "tokens_per_s": tokens_per_s,
        "mfu": flops_per_token * tokens_per_s / PEAK_OPS_PER_S["bf16"],
        "wall_s": wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loop_result": result,
    }
    emit("h_train_main_path", **out)
    return out


def phase_train_f32_parity() -> dict:
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_stream
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.trainer import build_train_step, init_state
    from kubeflow_tpu_torch.weights import flatten

    dev = torch.device("cuda")
    opt_cfg = OptimizerConfig(name="adafactor", warmup_steps=1)
    runs = {}
    for impl in ("splash", "xla"):
        model = get_model(TRAIN_MODEL, dtype=torch.float32, attn_impl=impl)
        state = init_state(torch.Generator(device=dev).manual_seed(0),
                           model, opt_cfg, device=dev)
        step_fn = build_train_step(model, opt_cfg)
        stream = synthetic_stream(model, 1, 1024, seed=5)
        kernels.reset_launches()
        metrics = []
        for _ in range(3):
            state, met = step_fn(state, place_batch(next(stream), dev))
            metrics.append({k: float(met[k]) for k in ("loss",
                                                       "grad_norm")})
        runs[impl] = {"metrics": metrics,
                      "launches": dict(kernels.LAUNCHES),
                      "params": flatten(state.params)}
        del state, step_fn
        torch.cuda.empty_cache()
    if runs["splash"]["launches"]["flash_attention_fwd"] != 9 or \
            runs["xla"]["launches"]["flash_attention_fwd"] != 0:
        raise AssertionError("kernel counts do not show which run used the "
                             f"kernels: {runs['splash']['launches']} / "
                             f"{runs['xla']['launches']}")
    rel = max(abs(a[k] - b[k]) / abs(b[k])
              for a, b in zip(runs["splash"]["metrics"],
                              runs["xla"]["metrics"])
              for k in ("loss", "grad_norm"))
    param_err = max(
        ((p - runs["xla"]["params"][n]).abs().max()
         / runs["xla"]["params"][n].abs().max()).item()
        for n, p in runs["splash"]["params"].items())
    out = {"model": TRAIN_MODEL, "dtype": "float32", "batch": 1,
           "seq": 1024, "steps": 3,
           "kernel": runs["splash"]["metrics"],
           "plain": runs["xla"]["metrics"],
           "max_rel_err_loss_grad_norm": rel,
           "max_param_err_rel_to_leaf_max": param_err,
           "launches": {k: runs[k]["launches"] for k in runs}}
    emit("i_train_f32_kernel_vs_plain", **out)
    if rel > 1e-5 or param_err > 1e-5:
        raise AssertionError(f"f32 training: kernel and plain runs differ "
                             f"(metrics {rel}, params {param_err})")
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

    # (a) the card, and the kernels built side by side: one nvcc per CUDA
    # source, in a thread, while Triton compiles at its first launch.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built: dict = {}

    def build_cuda():
        try:
            for name in ("paged_decode", "flash_attention"):
                kernels.library(name)
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
    flash = phase_flash(dev, flush)
    del flush
    torch.cuda.empty_cache()
    main_path = phase_main_path()
    phase_f32_parity()
    train = phase_train(smi)
    phase_train_f32_parity()

    p, r = paged["bf16"], rms[f"{SLOTS}x2048"]
    table = [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "kubeflow_tpu_torch/csrc/paged_decode.cu",
         "replaces": "kubeflow_tpu/ops/attention.py:392",
         "launches": main_path["launches"]["paged_decode_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in paged.values()),
         "long_ms": paged["long_bf16"]["ms"],
         "busy_ms": paged["busy_bf16"]["ms"],
         "ms": p["ms"], "call_ms": p["call_ms"], "plain_ms": p["plain_ms"],
         "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
         "library_ms": None},
        {"name": "rms_norm", "route": "triton",
         "source": "kubeflow_tpu_torch/ops/rms_norm_triton.py",
         "replaces": "kubeflow_tpu/ops/norms.py:67",
         "launches": main_path["launches"]["rms_norm"],
         "max_abs_err": max(v["max_abs_err"] for v in rms.values()),
         "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]},
    ]
    # One set of kernels serves both TPU kernels' names; the training main
    # path asks for "splash", so the "pallas" rows launch 0 times there.
    for impl, line in (("splash", 239), ("pallas", 172)):
        for part in ("fwd", "bwd"):
            key = f"flash_attention_{part}"
            m = flash["timing"][part]
            table.append({
                "name": key if impl == "splash" else f"{key}[pallas]",
                "route": "cuda",
                "source": "kubeflow_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"kubeflow_tpu/ops/attention.py:{line}",
                "launches": (train["launches"][key] if impl == "splash"
                             else 0),
                "max_abs_err": flash["max_abs_err"][impl][part],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], "f32_ms": m["f32_ms"]})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
