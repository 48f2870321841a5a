"""Job workloads; counterparts of ``kubeflow_tpu/workloads/``: the
allreduce smoke test and bandwidth benchmark (BASELINE config #4), the
PyTorchJob DDP workload (config #3), the ResNet training workload
(``tf_cnn``, config #1) and the gang health probe (``slice_health``), one
process per GPU."""

