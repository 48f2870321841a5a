"""Allreduce smoke test; counterpart of
``kubeflow_tpu/workloads/allreduce_smoke.py``.

    python -m kubeflow_tpu_torch.workloads.allreduce_smoke [--value V]
        [--device cpu]

Joins the gang from the JaxJob environment (one process per GPU; NCCL,
or gloo with ``--device cpu``; alone, a process group of one), psums a
known value over every device, checks it and prints the JAX workload's
JSON line; exit 0 when the sum is right. Without CUDA it raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.workloads import strip_glog_args


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="collective allreduce smoke test")
    p.add_argument("--value", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.collectives import psum
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_gang,
        local_device,
        shutdown,
    )
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    info = initialize_gang(device=args.device)
    try:
        device = local_device(info, args.device)
        n_global = dist.get_world_size()
        mesh = build_mesh(MeshConfig(data=-1), device_type=device.type)
        with torch.no_grad():
            out = psum(torch.full((1,), args.value, dtype=torch.float32,
                                  device=device), mesh, "data")
        got = float(out[0])
        want = args.value * n_global
        result = {
            "process_id": info.process_id,
            "num_processes": info.num_processes,
            "local_devices": 1,
            "global_devices": n_global,
            "psum": got,
            "expected": want,
            "ok": abs(got - want) < 1e-4,
        }
        print(json.dumps(result))
    finally:
        shutdown()
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
