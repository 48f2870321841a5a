"""PyTorchJob workload: DDP training from the operator's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, the contract
the pytorch-operator injects); counterpart of
``kubeflow_tpu/workloads/torch_xla_ddp.py`` (BASELINE config #3's entry).

    python -m kubeflow_tpu_torch.workloads.torch_xla_ddp [--steps 50]
        [--batch-size 32] [--dim 64] [--hidden 128] [--log-every 10]
        [--seed 0] [--device cpu]

Each rank trains on ``cuda:{RANK % GPUs}`` and joins NCCL; with
``--device cpu`` it trains on the CPU over gloo. Where the JAX package's
version falls back to the CPU silently, this one raises without CUDA
unless ``--device cpu`` is given. The flags and the result line are the
JAX version's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kubeflow_tpu_torch.runtime import strip_glog_args


def _train_torch(args) -> dict:
    import torch
    import torch.distributed as dist
    import torch.nn as nn

    from kubeflow_tpu_torch.device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    distributed = world > 1
    if distributed:
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method="env://", world_size=world, rank=rank)

    torch.manual_seed(args.seed + rank)
    model = nn.Sequential(
        nn.Linear(args.dim, args.hidden), nn.ReLU(),
        nn.Linear(args.hidden, 10),
    ).to(device)
    if distributed:
        from torch.nn.parallel import DistributedDataParallel

        model = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    loss_fn = nn.CrossEntropyLoss()

    loss = None
    for step in range(args.steps):
        x = torch.randn(args.batch_size, args.dim, device=device)
        y = torch.randint(0, 10, (args.batch_size,), device=device)
        opt.zero_grad()
        loss = loss_fn(model(x), y)
        loss.backward()  # DDP all-reduces the gradients here
        opt.step()
        if (step + 1) % args.log_every == 0 and rank == 0:
            print(f"step={step + 1} loss={loss.item():.4f}")

    if distributed:
        dist.barrier()
        dist.destroy_process_group()
    return {"rank": rank, "world_size": world, "steps": args.steps,
            "loss": float(loss.item()) if loss is not None else None}


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="PyTorchJob DDP workload")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    result = _train_torch(args)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
