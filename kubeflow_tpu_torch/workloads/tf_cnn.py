"""ResNet training workload; counterpart of
``kubeflow_tpu/workloads/tf_cnn.py`` (the tf_cnn_benchmarks role, BASELINE
config #1, the TFJob kind's default command).

    python -m kubeflow_tpu_torch.workloads.tf_cnn [--model resnet50]
        [--batch-size 32] [--steps 100] [--log-every 10]
        [--checkpoint-dir DIR] [--data -1] [--device cpu]

Joins the gang from the JaxJob environment (one process per GPU) and
trains ResNet data-parallel on synthetic images through the training loop
(``train.loop.run`` over the mesh ``{"data": --data}``), then prints the
loop's result as one JSON line. ``--device`` is the loop's (default
``cuda``, which raises without CUDA; ``cpu`` trains on the host).
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.runtime import strip_glog_args


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="ResNet training workload")
    p.add_argument("--model", default="resnet50",
                   help="resnet50 | resnet18 | resnet-test-tiny")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--data", type=int, default=-1,
                   help="data-parallel mesh size (-1 = all devices)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from kubeflow_tpu_torch.parallel.distributed import shutdown
    from kubeflow_tpu_torch.train.loop import RunConfig, run

    try:
        result = run(RunConfig(
            model=args.model,
            mesh={"data": args.data},
            batch_size=args.batch_size,
            steps=args.steps,
            log_every=args.log_every,
            checkpoint_dir=args.checkpoint_dir,
            device=args.device,
        ))
    finally:
        shutdown()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
