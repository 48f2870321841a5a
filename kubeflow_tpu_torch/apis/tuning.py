"""The StudyJob CR's names the central dashboard reads; the constants of
``kubeflow_tpu/apis/tuning.py`` (the port's tuning runs through the
Experiment CR, ``apis/experiment.py``)."""

from kubeflow_tpu_torch.apis import API_GROUP

STUDY_JOB_KIND = "StudyJob"
TUNING_API_VERSION = f"{API_GROUP}/v1"
