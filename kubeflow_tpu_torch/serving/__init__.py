"""LLM serving on the port: engine, continuous decoder, REST server.

Importing this package imports nothing else; ``python -m
kubeflow_tpu_torch.serving`` runs the REST server (``__main__.py``);
``python -m kubeflow_tpu_torch.serving.batch_predict`` the batch
prediction job.
"""
