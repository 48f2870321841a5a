#!/usr/bin/env python3
"""Where a training step's time goes on the GPU, for the port's training
main path.

    python3 profile_torch_train.py [--steps 4] [--trace trace.json]

``flagship-1b`` at full width in bf16 (float32 master weights, adafactor
with a 2-step warmup) at batch 4 x seq 2048, random weights from a fixed
seed: two warm steps, ``--steps`` steps timed without the profiler, then
``--steps`` steps under ``torch.profiler``. It prints one JSON line: the
step time, the device time the step's kernels take (their durations
summed: one stream, so they do not overlap), the device's idle share, the
device time by group (the flash attention kernels, matrix products, the
rest), each flash kernel's time and the kernels that take the most
device time; ``--trace`` also
writes the profiled steps' Chrome trace to that path. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import torch

# flagship-1b's training shape, as chip_smoke.py trains it.
MODEL, BATCH, SEQ = "flagship-1b", 4, 2048


def _group(name: str) -> str:
    """flash (the port's attention kernels), gemm (cuBLAS/CUTLASS matrix
    products) or other (elementwise, reductions, copies)."""
    low = name.lower()
    if "flash_" in low:
        return "flash"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return "gemm"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--trace", help="write the Chrome trace to this path")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_stream
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.trainer import build_train_step, init_state

    dev = torch.device("cuda")
    model = get_model(MODEL)
    opt_cfg = OptimizerConfig(name="adafactor", warmup_steps=2)
    state = init_state(torch.Generator(device=dev).manual_seed(0), model,
                       opt_cfg, device=dev)
    step_fn = build_train_step(model, opt_cfg)
    batches = [place_batch(b, dev) for b, _ in zip(
        synthetic_stream(model, BATCH, SEQ), range(4))]

    def run(n):
        nonlocal state
        for i in range(n):
            state, metrics = step_fn(state, batches[i % len(batches)])
        return float(metrics["loss"])  # waits for the device

    run(2)  # warm
    t0 = time.perf_counter()
    run(args.steps)
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        profiled_step_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list] = {}
    by_group = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        n_us = by_name.setdefault(e.name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.device_time_total
        by_group[_group(e.name)] += e.device_time_total
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:12]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device_ms = device_us / 1e3 / args.steps
    print(json.dumps({
        "gpu": smi, "model": MODEL, "dtype": "bf16",
        "batch": BATCH, "seq": SEQ, "optimizer": "adafactor",
        "steps": args.steps, "step_ms": step_ms,
        "profiled_step_ms": profiled_step_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1 - device_ms / step_ms,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "device_ms_per_step_by_group": {
            k: us / 1e3 / args.steps for k, us in by_group.items()},
        "flash_kernels": [
            {"name": name[:80], "per_step": n / args.steps,
             "ms_per_step": us / 1e3 / args.steps}
            for name, (n, us) in ranked if _group(name) == "flash"],
        "top_kernels": [
            {"name": name[:80], "per_step": n / args.steps,
             "ms_per_step": us / 1e3 / args.steps,
             "share_of_device": us / device_us}
            for name, (n, us) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
