"""Allreduce bandwidth benchmark; counterpart of
``kubeflow_tpu/workloads/allreduce_bench.py`` (BASELINE config #4, the
MPIJob/Horovod benchmark's role).

    python -m kubeflow_tpu_torch.workloads.allreduce_bench
        [--min-elems N] [--max-elems N] [--iters K] [--device cpu]

Sweeps float32 buffers from ``--min-elems`` to ``--max-elems`` (x4 a
size), sums each in place over every device of the gang (NCCL on the
GPUs, gloo with ``--device cpu``; alone, a process group of one) and
prints, on process 0, one JSON line a size with its time and the ring
algorithm's bus bandwidth, ``2(n-1)/n x bytes / s`` (0 at n = 1), then
the summary line and the ``kubeflow-tpu-metrics:`` log line; with the
job's environment (``KUBEFLOW_TPU_JOB_NAME``) it publishes
``{"allreduce_peak_gbps": best}`` into the job's ``status.metrics``
(``train.loop.publish_metrics``: a failure is logged, never raised).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kubeflow_tpu_torch.runtime import strip_glog_args

def _bench_one(n_elems: int, iters: int, mesh, device) -> dict:
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.collectives import psum_

    n_global = dist.get_world_size()
    # Summed in place, so no copy of the buffer enters the timed loop;
    # the values are never read (zeros stay zeros).
    x = torch.zeros((n_elems,), dtype=torch.float32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    psum_(x, mesh, "data")  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        psum_(x, mesh, "data")
    sync()
    dt = (time.perf_counter() - t0) / iters
    bytes_ = n_elems * 4
    # Ring-allreduce algorithmic bandwidth: 2(n-1)/n x payload / time.
    algo_bw = (2 * (n_global - 1) / max(n_global, 1)) * bytes_ / dt
    return {
        "elements": n_elems,
        "bytes": bytes_,
        "devices": n_global,
        "seconds_per_allreduce": dt,
        "algo_bandwidth_gbps": algo_bw / 1e9,
    }


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="allreduce bandwidth benchmark")
    p.add_argument("--min-elems", type=int, default=1 << 10)
    p.add_argument("--max-elems", type=int, default=1 << 24)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_gang,
        local_device,
        shutdown,
    )
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    info = initialize_gang(device=args.device)
    try:
        device = local_device(info, args.device)
        mesh = build_mesh(MeshConfig(data=-1), device_type=device.type)
        results = []
        n = args.min_elems
        while n <= args.max_elems:
            r = _bench_one(n, args.iters, mesh, device)
            results.append(r)
            if info.process_id == 0:
                print(json.dumps(r), flush=True)
            n *= 4
    finally:
        shutdown()
    if info.process_id == 0:
        best = max(r["algo_bandwidth_gbps"] for r in results)
        summary = {"metric": "allreduce_peak_bandwidth", "value": best,
                   "unit": "GB/s", "devices": results[0]["devices"]}
        print(json.dumps(summary), flush=True)
        from kubeflow_tpu_torch.train.loop import publish_metrics

        publish_metrics({"allreduce_peak_gbps": best})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
