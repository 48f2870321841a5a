#!/usr/bin/env python3
"""Where a decode step's time goes on the GPU, for the port's main path.

    python3 profile_torch_decode.py [--steps 16] [--kv-dtype fp|int8]

``llama-1b`` at full width in bf16 with random weights from a fixed seed:
eight slots admitted with 128-token prompts through
``paged_admit_rows_and_step``, then ``--steps`` ``decode_step`` calls with
the fused read (the paged decode kernel), under ``torch.profiler``. It
prints one JSON line: the host time of a step (timed once without the
profiler and once under it), the device time the step's kernels take
(their durations summed: one stream, so they do not overlap), the
device's idle share, and the kernels that take the most device time. The Chrome trace goes to
``chiprun_out/profile_torch_decode.json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import decode, transformer

    dev = torch.device("cuda")
    cfg = transformer.config("llama-1b")
    params = transformer.init(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    slots, prompt, bs, mb = 8, 128, 16, (256 + 32) // 16
    state = decode.init_paged_state(cfg, slots, slots * mb, bs, mb,
                                    kv_dtype=args.kv_dtype, device=dev)
    state["block_table"].copy_(torch.arange(
        slots * mb, dtype=torch.int32, device=dev).reshape(slots, mb))
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (slots, 256), generator=gen,
                         device=dev, dtype=torch.int32)
    full = torch.full((slots,), 1, dtype=torch.int32, device=dev)
    decode.paged_admit_rows_and_step(
        state, params, cfg, torch.arange(slots, device=dev), toks,
        full * prompt, full * (2 * args.steps + 8),
        torch.zeros(slots, device=dev), kv_fused=True)
    for _ in range(3):  # warm
        decode.decode_step(state, params, cfg, kv_fused=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        decode.decode_step(state, params, cfg, kv_fused=True)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            decode.decode_step(state, params, cfg, kv_fused=True)
        torch.cuda.synchronize()
        profiled_step_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        n_us = by_name.setdefault(e.name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "profile_torch_decode.json"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device_ms = device_us / 1e3 / args.steps
    print(json.dumps({
        "gpu": smi, "model": "llama-1b", "dtype": "bf16",
        "kv_dtype": args.kv_dtype, "slots": slots, "prompt": prompt,
        "steps": args.steps, "step_ms": step_ms,
        "profiled_step_ms": profiled_step_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1 - device_ms / step_ms,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "top_kernels": [
            {"name": name[:80], "per_step": n / args.steps,
             "ms_per_step": us / 1e3 / args.steps,
             "share_of_device": us / device_us}
            for name, (n, us) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
