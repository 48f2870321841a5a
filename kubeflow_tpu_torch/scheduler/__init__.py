"""The cluster scheduler over GPU nodes; a copy of ``kubeflow_tpu/scheduler``
(heterogeneity-aware gang placement with priority preemption, in the
spirit of Gavel).

- :mod:`~kubeflow_tpu_torch.scheduler.capacity`: pools of GPU hosts
  grouped into slices, built from Node objects, and the throughput book.
- :mod:`~kubeflow_tpu_torch.scheduler.queue`: the weighted-fair priority
  queue with starvation aging.
- :mod:`~kubeflow_tpu_torch.scheduler.controller`: the policy loop as a
  controller over SchedulingPolicy: all-or-nothing gang admission,
  priority preemption, elastic shrink and grow.

Submodules are imported by name; this package imports none of them.
"""
