"""Training over every mesh axis (data, fsdp, expert, tensor, sequence,
pipeline) over ``torch.distributed``, and the layout of a model-parallel
serving replica; counterpart of ``kubeflow_tpu/parallel/``.

- :mod:`~kubeflow_tpu_torch.parallel.distributed`: the gang's rendezvous
  from the JaxJob controller's environment (one process per GPU) and the
  host-side agreements (``global_any``, ``global_min_int``,
  ``broadcast_object``, ``barrier``).
- :mod:`~kubeflow_tpu_torch.parallel.mesh`: ``MeshConfig`` and its six
  named axes as a ``DeviceMesh`` over all the gang's ranks or its first
  ones (``BATCH_AXES`` split the rows, ``MODEL_AXES`` the leaves);
  ``serving_mesh``, the devices of a
  model-parallel serving replica, and ``TensorShards`` and
  ``PipelineStages``, its per-shard and per-stage values.
- :mod:`~kubeflow_tpu_torch.parallel.sharding`: the partition rules, the
  shard / unshard of a leaf under a spec, ``split_tensor`` /
  ``merge_tensor`` of a whole tree into its tensor shards, and
  ``vocab_lookup``, the embedding lookup of a vocabulary split over
  tensor.
- :mod:`~kubeflow_tpu_torch.parallel.collectives`: psum, all_gather,
  reduce_scatter and the rest over named mesh axes, differentiable where a
  forward uses them; Megatron's ``copy_to_tensor`` /
  ``reduce_from_tensor`` (over one model axis or both) /
  ``gather_from_tensor``, and ``tensor_copy`` / ``tensor_sum``, the pair
  that runs only over a tensor degree above 1; ``gather_counts``
  (integers, no gradient);
  ``reduce_shards``, the sum of a serving replica's shards in one
  process; ``ring_permute``, JAX's ``ppermute`` with its gradient.
- :mod:`~kubeflow_tpu_torch.parallel.ring_attention`: exact attention
  over the ``sequence`` ring.
- :mod:`~kubeflow_tpu_torch.parallel.pipeline`: ``stage_layer_ranges``
  and ``pipeline_apply``, the GPipe schedule over ``pipeline``.
- :mod:`~kubeflow_tpu_torch.parallel.reshard`: ``reshard_state``, a live
  train state moved between two meshes bit for bit, and
  ``scaled_mesh_config``, an elastic resize's mesh.
- :mod:`~kubeflow_tpu_torch.parallel.launch`: a gang of N processes on one
  host with the JaxJob environment.

The JAX package runs one program over the whole mesh and GSPMD inserts the
collectives; the port runs one process per device and writes each
collective out.
"""
