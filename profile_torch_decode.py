#!/usr/bin/env python3
"""Where a decode step's time goes on the GPU, for the port's main path.

    python3 profile_torch_decode.py [--steps 16] [--kv-dtype fp|int8]
                                    [--speculative-k K] [--tp-shards N]

``llama-1b`` at full width in bf16 with random weights from a fixed seed:
eight slots admitted with 128-token prompts through
``paged_admit_rows_and_step``, then ``decode_step`` calls with the fused
read (the paged decode kernel). With ``--speculative-k K`` the same state
then takes ``verify_step`` calls of K drafts a row (random tokens, so
each verify emits its commit token: a verify's shapes and launches do not
depend on what it accepts). With ``--tp-shards N`` the weights and the
pool are cut into N tensor shards (``weights.tensor_shards``,
``decode.shard_decode_state``), all on ``cuda:0``: each layer runs once a
shard and sums the shards' outputs. For each kind of step it prints, in one JSON
line: the host time of a step (``--steps`` steps timed without the
profiler), the device time its kernels take (their durations summed: one
stream, so they do not overlap), the device's idle share, launches per
step and the kernels that take the most device time. Device times come
from a complete profiler session only (``chip_smoke.profiled_launches``:
a discarded warm-up step, then a session that recorded every marker write
and a whole number of launches per step). The decode session's Chrome
trace goes to ``chiprun_out/profile_torch_decode.json``. Needs a CUDA
device.
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


def profile_steps(step, steps: int, trace: str | None = None) -> dict:
    """Host ms of ``step`` (``steps`` calls, no profiler), then its device
    ms, idle share, launches and top kernels from a complete session."""
    from chip_smoke import profiled_launches

    for _ in range(3):  # warm
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    # A 16-byte write marks each step in the profiler's record.
    marker = torch.empty(16, dtype=torch.uint8, device="cuda")
    kernels = profiled_launches(step, marker, steps, trace)
    device_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        n_us = by_name.setdefault(e.name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    device_ms = device_us / 1e3 / steps
    return {
        "step_ms": step_ms, "device_ms_per_step": device_ms,
        "device_idle_share": 1 - device_ms / step_ms,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels": [
            {"name": name[:80], "per_step": n / steps,
             "ms_per_step": us / 1e3 / steps,
             "share_of_device": us / device_us}
            for name, (n, us) in top],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"])
    p.add_argument("--speculative-k", type=int, default=0,
                   help="also profile verify steps of K drafts a row")
    p.add_argument("--tp-shards", type=int, default=1,
                   help="tensor shards of the replica, all on cuda:0")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.models import decode, transformer
    from kubeflow_tpu_torch.weights import tensor_shards

    dev = torch.device("cuda")
    cfg = transformer.config("llama-1b")
    params = transformer.init(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    # Rows of 512 positions: room for the warm, timed and profiled steps
    # (up to five sessions) of both kinds after the 128-token prompts.
    slots, prompt, bs, mb = 8, 128, 16, 512 // 16
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
        full * prompt, full * (mb * bs - prompt - 1),
        torch.zeros(slots, device=dev), kv_fused=True)
    if args.tp_shards > 1:
        params = tensor_shards(params, cfg, args.tp_shards)
        state = decode.shard_decode_state(state, [dev] * args.tp_shards)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    result = {"decode": profile_steps(
        lambda: decode.decode_step(state, params, cfg, kv_fused=True),
        args.steps, str(out_dir / "profile_torch_decode.json"))}
    result["decode"]["positions_after"] = int(state["length"].max())
    if args.speculative_k > 0:
        draft = torch.randint(0, cfg.vocab_size,
                              (slots, args.speculative_k), generator=gen,
                              device=dev, dtype=torch.int32)
        dlen = full * args.speculative_k
        result["verify"] = profile_steps(
            lambda: decode.verify_step(state, params, cfg, draft, dlen,
                                       kv_fused=True), args.steps)
        result["verify"]["positions_after"] = int(state["length"].max())
        if not bool(state["active"].all()):
            raise AssertionError("a row ran out of positions mid-profile")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": smi, "model": "llama-1b", "dtype": "bf16",
        "kv_dtype": args.kv_dtype, "slots": slots, "prompt": prompt,
        "steps": args.steps, "speculative_k": args.speculative_k,
        "tp_shards": args.tp_shards,
        **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
