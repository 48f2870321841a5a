#!/usr/bin/env python3
"""Where a training step's time goes on the GPU, for the port's training
main path.

    python3 profile_torch_train.py [--model flagship-deep]
        [--remat-policy llm|llm_res|off|...] [--steps 4] [--trace trace.json]
        [--mesh '{"expert": 2}']

``--model`` at full width and depth in bf16 (float32 master weights),
random weights from a fixed seed, at the shape and with the optimizer
``chip_smoke.py`` trains it with (``RECIPES``): ``flagship-1b`` (the
default), ``flagship-deep`` (with ``grad_dtype="bfloat16"``, bench.py's
recipe) and ``moe-1b`` at batch 4 x seq 2048 with adafactor and a 2-step
warmup; ``bert-base`` at batch 32 x seq 128, the same optimizer;
``resnet50`` at batch 32 with tf_cnn.py's defaults (the default
optimizer). Under the preset's remat or ``--remat-policy`` (``off``: no
remat; transformers only): two warm steps,
``--steps`` steps timed without the profiler, then
``--steps`` steps under ``torch.profiler``, kept only from a complete
session (``chip_smoke.profiled_launches``: a discarded warm-up step, then
a session that recorded every marker write and a whole number of
launches per step). It prints one JSON line: the step time, the peak of
allocated memory, the device
time the step's kernels take (their durations summed: one stream, so
they do not overlap), the device's idle share, the device time by group
(the flash attention kernels, matrix products, convolutions, the rest),
each flash
kernel's time and the kernels that take the most device time;
``--trace`` also writes the kept session's Chrome trace to that path.
With ``--mesh`` (a JSON object of mesh degrees, e.g. ``{"expert": 2}``
for moe-1b) the script starts itself as a gang of as many processes as
the degrees' product (``parallel.launch``), all on ``cuda:0`` over gloo
(NCCL refuses two ranks on one GPU), each rank taking its batch rows of
a global batch of that many rows a batch rank; rank 0 profiles its own
mesh step (the other ranks run the same steps beside it, on the same
card) and prints the line, with the collectives' calls and bytes a step.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import torch

# The training shape chip_smoke.py trains each model at (batch, seq), and
# its optimizer.
_ADAFACTOR = {"name": "adafactor", "warmup_steps": 2}
RECIPES = {
    "flagship-1b": (4, 2048, _ADAFACTOR),
    "flagship-deep": (4, 2048, {**_ADAFACTOR, "grad_dtype": "bfloat16"}),
    "moe-1b": (4, 2048, _ADAFACTOR),
    "bert-base": (32, 128, _ADAFACTOR),
    "resnet50": (32, None, {}),
}


def _group(name: str) -> str:
    """flash (the port's attention kernels), gemm (cuBLAS/CUTLASS matrix
    products), conv (cuDNN convolutions) or other (elementwise,
    reductions, copies)."""
    low = name.lower()
    if "flash_" in low:
        return "flash"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return "gemm"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=sorted(RECIPES),
                   default="flagship-1b")
    p.add_argument("--remat-policy",
                   help="a remat policy of the model config, or 'off'")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--trace", help="write the Chrome trace to this path")
    p.add_argument("--mesh", type=json.loads,
                   help="mesh degrees as JSON; profiles rank 0 of a gang")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import profiled_launches
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.distributed import ENV_PROCESS_ID
    from kubeflow_tpu_torch.train.data import (local_rows, place_batch,
                                               synthetic_stream)
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.trainer import build_train_step, init_state

    if args.mesh and ENV_PROCESS_ID not in os.environ:
        from kubeflow_tpu_torch.parallel.launch import launch

        procs = launch([sys.executable, *sys.argv], math.prod(
            args.mesh.values()), timeout=1800)
        for i, proc in enumerate(procs):
            if proc.returncode:
                print(f"rank {i}:\n{proc.stderr[-3000:]}", file=sys.stderr)
        print(procs[0].stdout, end="")
        return max(proc.returncode for proc in procs)
    mesh, rank, batch_rank, batch_ranks = None, 0, 0, 1
    if args.mesh:
        from kubeflow_tpu_torch.parallel.distributed import (
            global_any, initialize_from_env)
        from kubeflow_tpu_torch.parallel.mesh import (
            BATCH_AXES, MeshConfig, axis_index, axis_size, build_mesh)

        rank = initialize_from_env(device="cuda", backend="gloo",
                                   timeout_s=1800).process_id
        mesh = build_mesh(MeshConfig(**args.mesh), device_type="cuda")
        batch_rank = axis_index(mesh, BATCH_AXES)
        batch_ranks = axis_size(mesh, BATCH_AXES)

    dev = torch.device("cuda")
    overrides = {}
    if args.remat_policy == "off":
        overrides["remat"] = False
    elif args.remat_policy:
        overrides.update(remat=True, remat_policy=args.remat_policy)
    model = get_model(args.model, **overrides)
    batch, seq, opt = RECIPES[args.model]
    opt_cfg = OptimizerConfig(**opt)
    state = init_state(torch.Generator(device=dev).manual_seed(0), model,
                       opt_cfg, mesh, device=dev)
    step_fn = build_train_step(model, opt_cfg, mesh)
    batches = [place_batch(local_rows(b, batch_rank, batch_ranks), dev)
               for b, _ in zip(synthetic_stream(
                   model, batch * batch_ranks, seq or 0), range(4))]

    def run(n):
        nonlocal state
        for i in range(n):
            state, metrics = step_fn(state, batches[i % len(batches)])
        return float(metrics["loss"])  # waits for the device

    torch.cuda.reset_peak_memory_stats()
    run(2)  # warm
    collectives.reset_counts()
    t0 = time.perf_counter()
    run(args.steps)
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    calls = {k: v / args.steps for k, v in collectives.CALLS.items()}
    moved = {k: v / args.steps for k, v in collectives.BYTES.items()}
    if rank:
        # Step beside rank 0 until it has profiled: one agreement a step.
        while True:
            run(1)
            if global_any(False):
                return 0

    # A 16-byte write marks each step in the profiler's record.
    marker = torch.empty(16, dtype=torch.uint8, device=dev)
    if mesh is None:
        kernels = profiled_launches(lambda: run(1), marker, args.steps,
                                    args.trace)
    else:
        kernels = profiled_launches(lambda: (run(1), global_any(False)),
                                    marker, args.steps, args.trace)
        run(1)
        global_any(True)
    device_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list] = {}
    by_group = {"flash": 0.0, "gemm": 0.0, "conv": 0.0, "other": 0.0}
    for e in kernels:
        n_us = by_name.setdefault(e.name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.device_time_total
        by_group[_group(e.name)] += e.device_time_total
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:12]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device_ms = device_us / 1e3 / args.steps
    remat = getattr(model.config, "remat", False)
    print(json.dumps({
        "gpu": smi, "model": args.model, "dtype": "bf16",
        "remat": (getattr(model.config, "remat_policy", "layer") if remat
                  else "off"),
        "grad_dtype": opt_cfg.grad_dtype,
        "batch": batch, "seq": seq, "optimizer": opt_cfg.name,
        "mesh": args.mesh, "profiled_rank": rank,
        "collective_calls_per_step": calls if mesh else None,
        "collective_bytes_per_step": moved if mesh else None,
        "steps": args.steps, "step_ms": step_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
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
