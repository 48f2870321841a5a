"""Central-dashboard entrypoint: ``python -m kubeflow_tpu_torch.dashboard``
(serving on :8082); the flags of ``python -m kubeflow_tpu.dashboard``."""

from __future__ import annotations

import argparse
import sys

from kubeflow_tpu_torch.dashboard import Dashboard, make_server
from kubeflow_tpu_torch.runtime import (
    add_client_args,
    client_from_args,
    strip_glog_args,
)


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="kubeflow-tpu central dashboard")
    add_client_args(p)
    p.add_argument("--port", type=int, default=8082)
    p.add_argument("--all-namespaces", action="store_true",
                   help="aggregate across all namespaces")
    args = p.parse_args(argv)

    dash = Dashboard(client_from_args(args),
                     None if args.all_namespaces else args.namespace)
    httpd = make_server(dash, args.port)
    print(f"dashboard on :{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
