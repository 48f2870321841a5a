"""Data-parallel and FSDP training over ``torch.distributed``; counterpart of
``kubeflow_tpu/parallel/``.

- :mod:`~kubeflow_tpu_torch.parallel.distributed`: the gang's rendezvous
  from the JaxJob controller's environment (one process per GPU) and the
  host-side agreements (``global_any``, ``global_min_int``, ``barrier``).
- :mod:`~kubeflow_tpu_torch.parallel.mesh`: ``MeshConfig`` and its six
  named axes as a ``DeviceMesh``.
- :mod:`~kubeflow_tpu_torch.parallel.sharding`: the partition rules and
  the shard / unshard of a leaf under a spec.
- :mod:`~kubeflow_tpu_torch.parallel.collectives`: psum, all_gather,
  reduce_scatter and the rest over named mesh axes, differentiable where a
  forward uses them.
- :mod:`~kubeflow_tpu_torch.parallel.launch`: a gang of N processes on one
  host with the JaxJob environment.

The JAX package runs one program over the whole mesh and GSPMD inserts the
collectives; the port runs one process per device and writes each
collective out.
"""
