"""Gang health probe; counterpart of
``kubeflow_tpu/workloads/slice_health.py``.

    python -m kubeflow_tpu_torch.workloads.slice_health
        [--expect-devices N] [--expect-local-devices N]
        [--max-collective-ms MS] [--skip-collective] [--device cpu]
        [--backend gloo]

Checks that the worker has its device and that the gang's collective
works, and exits 0 (healthy) or 1: an init or sidecar container gating a
workload's start, a pre-flight Job on fresh nodes, or a liveness command.
The port runs one process per GPU, so a process has one local device and
the gang's devices are its processes (its world size). The probe is a
timed all-reduce of 2.0 over the gang (NCCL on the GPUs, gloo with
``--device cpu`` or ``--backend gloo``, the transport of ranks that share
one GPU, which NCCL refuses; alone, a process group of one), which must
read ``2 x devices``. It prints one JSON report with the JAX probe's keys
(``platform`` is ``"gpu"`` or ``"cpu"``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kubeflow_tpu_torch.runtime import strip_glog_args


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="GPU gang health probe")
    p.add_argument("--expect-devices", type=int, default=0,
                   help="required global device count (0 = any)")
    p.add_argument("--expect-local-devices", type=int, default=0)
    p.add_argument("--max-collective-ms", type=float, default=0.0,
                   help="fail if the all-reduce probe exceeds this "
                        "(0 = no limit)")
    p.add_argument("--skip-collective", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's (default: NCCL on CUDA, gloo "
                        "on the CPU)")
    args = p.parse_args(argv)

    report: dict = {"healthy": False}
    try:
        import torch
        import torch.distributed as dist

        from kubeflow_tpu_torch.parallel.collectives import psum_
        from kubeflow_tpu_torch.parallel.distributed import (
            initialize_gang,
            local_device,
        )
        from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

        info = initialize_gang(device=args.device, backend=args.backend)
        device = local_device(info, args.device)
        n_local = 1
        n_global = dist.get_world_size()
        report.update(process_id=info.process_id, local_devices=n_local,
                      global_devices=n_global,
                      platform="gpu" if device.type == "cuda" else "cpu")
        if args.expect_local_devices and n_local != args.expect_local_devices:
            raise RuntimeError(
                f"local devices {n_local} != {args.expect_local_devices}")
        if args.expect_devices and n_global != args.expect_devices:
            raise RuntimeError(
                f"global devices {n_global} != {args.expect_devices}")
        if not args.skip_collective:
            mesh = build_mesh(MeshConfig(data=-1), device_type=device.type)

            def probe(value: float) -> float:
                x = torch.full((1,), value, dtype=torch.float32,
                               device=device)
                return float(psum_(x, mesh, "data")[0])  # fetch: done

            probe(1.0)  # warm: the communicator's first use
            t0 = time.perf_counter()
            got = probe(2.0)
            ms = (time.perf_counter() - t0) * 1e3
            report.update(psum=got, collective_ms=round(ms, 3))
            if got != 2.0 * n_global:
                raise RuntimeError(f"psum wrong: {got} != {2.0 * n_global}")
            if args.max_collective_ms and ms > args.max_collective_ms:
                raise RuntimeError(
                    f"collective {ms:.1f}ms > {args.max_collective_ms}ms")
        report["healthy"] = True
        return 0
    except Exception as e:
        report["error"] = str(e)
        return 1
    finally:
        print(json.dumps(report))
        try:
            from kubeflow_tpu_torch.parallel.distributed import shutdown

            shutdown()
        except Exception:
            pass


if __name__ == "__main__":
    raise SystemExit(main())
