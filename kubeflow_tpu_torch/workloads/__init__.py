"""Job workloads; counterparts of ``kubeflow_tpu/workloads/``: the
allreduce smoke test and bandwidth benchmark (BASELINE config #4), the
PyTorchJob DDP workload (config #3), the ResNet training workload
(``tf_cnn``, config #1) and the gang health probe (``slice_health``), one
process per GPU."""


def strip_glog_args(argv: list[str]) -> list[str]:
    """Drop the glog-style flags the operators' manifests pass
    (``--alsologtostderr -v=1``), so the argparse entry points accept the
    manifests' args (a copy of ``kubeflow_tpu/runtime.py``'s)."""
    return [a for a in argv if a != "--alsologtostderr"
            and not a.startswith(("-v=", "--v="))]
