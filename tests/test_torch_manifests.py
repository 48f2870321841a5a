"""The port's GPU prototypes against the JAX package's TPU prototypes.

Each ported prototype renders on the same parameters as its JAX
counterpart, and the two are equal after this mapping and nothing else:

- ``google.com/tpu`` becomes ``nvidia.com/gpu`` in limits and requests
  (``num_tpu_chips`` / ``chips_per_worker`` are ``num_gpus`` /
  ``gpus_per_worker``);
- JAX's default image becomes the port's (``images.TORCH_CUDA``);
- ``kubeflow_tpu.`` becomes ``kubeflow_tpu_torch.`` in the module a
  container runs;
- a job carries no ``spec.tpu`` block (so JAX's operator sets no TPU
  nodeSelector), and the TPU slice parameters are gone;
- the serving Deployment's ``service`` label names its prototype
  (``gpu-serving``);
- a container without a GPU adds ``--device=cpu`` (the port runs on CUDA
  unless asked), except the host processes' (the gateway, the
  dashboards, the scheduler, the notebook controller and web app), which
  take no device;
- the MPI Launcher asks for no GPU, as JAX's asks for no chip; where the
  workers have GPUs it passes ``--single-process-arg=--device=cpu`` to
  ``mpi_launcher`` in place of the flag, so without ``mpirun`` (as in
  the port's image) it runs the workers' command on the CPU;
- JAX's workload and notebook images named in a config (the training
  operator's ``defaultWorkloadImage``, the web app's default notebook
  image) become the port's.

Every rendered ``gpu-serving`` arg list parses with the port's serving
CLI parser; ``compile_cache_dir`` is refused by name; the job CRs pass
JAX's job validation, and JAX's job controller renders their pods with
the GPU resource, no TPU nodeSelector and the rendezvous environment the
port's gangs read.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu.apis import jobs as jobs_api
from kubeflow_tpu.manifests import generate as jgenerate
from kubeflow_tpu.manifests import images as jimages
from kubeflow_tpu.operators.jobs import JobController
from kubeflow_tpu_torch.manifests import generate, images
from kubeflow_tpu_torch.manifests.core import all_prototypes
from kubeflow_tpu_torch.serving.__main__ import build_parser

ROOT = Path(__file__).resolve().parent.parent
TPU = "google.com/tpu"

# (JAX prototype, the port's, JAX's default image, JAX's accelerator
# parameter, the port's).
PAIRS = {
    "serving": ("tpu-serving", "gpu-serving", jimages.SERVING,
                "num_tpu_chips", "num_gpus"),
    "batch-predict": ("batch-predict", "gpu-batch-predict", jimages.SERVING,
                      "num_tpu_chips", "num_gpus"),
    "inference-server": ("inference-server", "gpu-inference-server", None,
                         "num_tpu_chips", "num_gpus"),
    "job-simple": ("jax-job-simple", "gpu-job-simple", jimages.JAX_TPU,
                   "chips_per_worker", "gpus_per_worker"),
    "tf-job": ("tf-job", "gpu-tf-job", jimages.JAX_TPU,
               "chips_per_worker", "gpus_per_worker"),
    "pytorch-job": ("pytorch-job", "gpu-pytorch-job", jimages.JAX_TPU,
                    "chips_per_worker", "gpus_per_worker"),
    "healthcheck": ("slice-healthcheck", "gpu-healthcheck", jimages.JAX_TPU,
                    "chips_per_worker", "gpus_per_worker"),
    # The front door: host code on the port's image, no accelerator.
    "gateway": ("gateway", "gateway", jimages.PLATFORM, None, None),
    "centraldashboard": ("centraldashboard", "centraldashboard",
                         jimages.PLATFORM, None, None),
    "training-dashboard": ("training-dashboard", "training-dashboard",
                           jimages.PLATFORM, None, None),
    # The RLJob CR (its pods are rendered by the RLJob controller) and
    # the cluster scheduler, a host process.
    "rl": ("rl-job", "gpu-rl", jimages.PLATFORM, "chips_per_replica",
           "gpus_per_replica"),
    "scheduler": ("scheduler", "gpu-scheduler", jimages.PLATFORM, None,
                  None),
    # The manager that runs the port's controllers, the compat jobs and
    # GPU notebooks.
    "training-operator": ("training-operator", "gpu-training-operator",
                          jimages.PLATFORM, None, None),
    "mpi-job": ("mpi-job", "gpu-mpi-job", jimages.JAX_TPU,
                "chips_per_worker", "gpus_per_worker"),
    "mxnet-job": ("mxnet-job", "gpu-mxnet-job", jimages.JAX_TPU,
                  "chips_per_worker", "gpus_per_worker"),
    "chainer-job": ("chainer-job", "gpu-chainer-job", jimages.JAX_TPU,
                    "chips_per_worker", "gpus_per_worker"),
    "notebook-controller": ("notebook-controller", "gpu-notebook-controller",
                            jimages.PLATFORM, None, None),
    "jupyter-web-app": ("jupyter-web-app", "gpu-jupyter-web-app",
                        jimages.PLATFORM, None, None),
    # The secure entrypoint: JAX's names, host code on the port's image.
    "cert-manager": ("cert-manager", "cert-manager", jimages.PLATFORM, None,
                     None),
    "secure-ingress": ("secure-ingress", "secure-ingress", jimages.PLATFORM,
                       None, None),
    "cloud-endpoints": ("cloud-endpoints", "cloud-endpoints", None, None,
                        None),
}
HOST_PAIRS = ("gateway", "centraldashboard", "training-dashboard",
              "scheduler", "notebook-controller", "jupyter-web-app",
              "cert-manager", "secure-ingress", "cloud-endpoints")
# Pairs that ship a CRD whose schema stays JAX's (``spec.tpu`` kept).
JAX_SCHEMA_PAIRS = ("rl", "training-operator", "notebook-controller")
# JAX's images a config names, and the port's in their place.
CONFIG_IMAGES = {jimages.JAX_TPU: images.TORCH_CUDA,
                 jimages.NOTEBOOK: images.NOTEBOOK}

SERVING_PARAMS = [
    {"name": "llama", "model_name": "llama-1b"},
    {"name": "llama", "model_name": "llama-1b", "kv_layout": "paged",
     "kv_fused_attention": True, "num_tpu_chips": 1},
    {"name": "s", "model_path": "/models/ckpt", "num_tpu_chips": 4,
     "replicas": 3, "kv_layout": "paged", "kv_dtype": "int8",
     "prefill_chunk_tokens": 128, "max_prompt_len": 1024,
     "prefix_cache_slots": 8, "prefill_len_buckets": 2,
     "speculative_k": 4, "draft_mode": "model:lm-test-tiny",
     "serving_role": "decode", "tp_shards": 2, "cp_shards": 2,
     "pp_stages": 2, "host_kv_bytes": 1 << 20, "kv_directory_size": 64,
     "cold_store_ref": "mem://c?bytes=4096",
     "kv_import_crossover_tokens": 32, "qos_tenants": "gold=8,free=1",
     "qos_aging_s": 10.0, "weight_peers": "a:8500,b:8500",
     "dtype": "float32", "namespace": "team"},
    {"name": "cpu", "num_tpu_chips": 0, "enable_prometheus": False},
]
PARAMS = {
    "serving": SERVING_PARAMS,
    "batch-predict": [
        {"name": "bp", "model_path": "/m", "input_path": "/in.jsonl",
         "output_path": "/out.jsonl"},
        {"name": "bp", "model_path": "/m", "input_path": "/in.jsonl",
         "output_path": "/out.jsonl", "num_tpu_chips": 0,
         "batch_size": 16}],
    "inference-server": [
        {"name": "triton", "image": "nvcr.io/triton:1", "num_tpu_chips": 2,
         "command": ["serve"], "args": ["--port", 8080]},
        {"name": "x", "image": "img", "route_prefix": "/x/"}],
    **{pair: [{"name": "j"},
              {"name": "j", "num_workers": 4, "chips_per_worker": 2,
               "namespace": "team"},
              {"name": "j", "chips_per_worker": 0}]
       for pair in ("job-simple", "pytorch-job", "healthcheck")},
    "tf-job": [{"name": "j"}, {"name": "j", "num_ps": 2},
               {"name": "j", "chips_per_worker": 2, "num_ps": 1}],
    "gateway": [{}, {"namespace": "team", "replicas": 1,
                     "service_type": "LoadBalancer", "tls_secret": "tls"}],
    "centraldashboard": [{}, {"namespace": "team"}],
    "training-dashboard": [{}, {"namespace": "team"}],
    "rl": [{}, {"name": "podracer", "model": "llama-1b",
                "chips_per_replica": 0, "actor_replicas": 3,
                "actor_max_replicas": 6, "namespace": "team"}],
    "scheduler": [{}, {"namespace": "team", "aging_seconds": 60,
                       "preemption_enabled": False}, {"replicas": 2}],
    "training-operator": [{}, {"replicas": 2}, {
        "namespace": "team", "replicas": 3, "cluster_scoped": False,
        "conversion_ca_bundle": "Q0E=", "default_workload_image": "w:1"}],
    "mpi-job": [{"name": "j"}, {"name": "j", "num_workers": 1},
                {"name": "j", "num_workers": 4, "chips_per_worker": 2,
                 "namespace": "team"},
                {"name": "j", "chips_per_worker": 0}],
    "mxnet-job": [{"name": "j"},
                  {"name": "j", "num_servers": 2, "num_workers": 2},
                  {"name": "j", "chips_per_worker": 0}],
    "chainer-job": [{"name": "j"}, {"name": "j", "num_workers": 3},
                    {"name": "j", "chips_per_worker": 0}],
    "notebook-controller": [{}, {"namespace": "team"}],
    "jupyter-web-app": [{}, {"namespace": "team"},
                        {"default_notebook_image": "my/nb:1"}],
    "cert-manager": [{}, {"namespace": "team",
                          "acme_url": "https://acme.example/dir",
                          "acme_email": "ops@example.com"}],
    "secure-ingress": [
        {}, {"hostname": "kf.example.com", "issuer": "letsencrypt",
             "issuer_type": "acme"},
        {"namespace": "team", "replicas": 1, "disable_jwt_checking": True,
         "duration_seconds": 3600, "renew_before_seconds": 600}],
    "cloud-endpoints": [{}, {"hostname": "kf.example.com",
                             "target": "secure-gateway.kubeflow"}],
}
CASES = [(pair, i) for pair in PAIRS for i in range(len(PARAMS[pair]))]


def _port_params(pair: str, params: dict) -> dict:
    _, _, _, jkey, tkey = PAIRS[pair]
    out = dict(params)
    if jkey is not None and jkey in out:
        out[tkey] = out.pop(jkey)
    return out


def _jax_params(pair: str, params: dict) -> dict:
    """The JAX prototype's parameters; its chips default differs from the
    port's GPU default, so the port's default is passed explicitly."""
    jproto, tproto, _, jkey, tkey = PAIRS[pair]
    from kubeflow_tpu_torch.manifests.core import get_prototype

    out = dict(params)
    if jkey is not None and jkey not in out:
        default = {p.name: p.default
                   for p in get_prototype(tproto).params}[tkey]
        out[jkey] = default
    return out


def _gpus(resources: dict | None) -> int:
    return (resources or {}).get("limits", {}).get(TPU, 0)


def _map_container(c: dict, default_image: str | None, cpu_flag: str):
    if default_image and c.get("image") == default_image:
        c["image"] = images.TORCH_CUDA
    res = c.get("resources")
    if cpu_flag and not _gpus(res):
        c.setdefault(cpu_flag, []).append("--device=cpu")
    if res:
        for part in ("limits", "requests"):
            res[part] = {images.GPU_RESOURCE if k == TPU else k: v
                         for k, v in res[part].items()}
    for key in ("command", "args"):
        if key in c:
            c[key] = [a.replace("kubeflow_tpu.", "kubeflow_tpu_torch.")
                      if isinstance(a, str) else a for a in c[key]]


def _containers(obj: dict):
    spec = obj.get("spec", {})
    if "replicaSpecs" in spec:
        for rs in spec["replicaSpecs"].values():
            yield from rs["template"]["spec"]["containers"]
    elif "template" in spec:
        yield from spec["template"]["spec"]["containers"]


def to_gpu(pair: str, objs: list[dict]) -> list[dict]:
    """JAX's rendering under the stated mapping."""
    jproto, tproto, default_image, _, _ = PAIRS[pair]
    out = copy.deepcopy(objs)
    for obj in out:
        spec = obj.get("spec", {})
        spec.pop("tpu", None)
        labels = [obj["metadata"].get("labels", {})]
        if obj["kind"] == "Deployment":
            labels += [spec["selector"]["matchLabels"],
                       spec["template"]["metadata"]["labels"]]
        if obj["kind"] == "Service":
            labels.append(spec["selector"])
        for lab in labels:
            if lab.get("service") == jproto:
                lab["service"] = tproto
        if obj["kind"] == "RLJob" and spec.get("image") == default_image:
            spec["image"] = images.TORCH_CUDA
        # The port's own entry points take --device; a third-party
        # image's command is its own.
        # The gateway and the dashboards take no --device.
        cpu_flag = ("" if pair == "inference-server" or pair in HOST_PAIRS
                    else
                    "args" if obj["kind"] in ("Deployment", "Job")
                    else "command")
        flagged = []
        if obj["kind"] == "MPIJob":
            specs = spec["replicaSpecs"]
            (worker,) = specs["Worker"]["template"]["spec"]["containers"]
            (launcher,) = specs["Launcher"]["template"]["spec"]["containers"]
            if _gpus(worker.get("resources")):
                at = launcher["command"].index("--")
                launcher["command"].insert(
                    at, "--single-process-arg=--device=cpu")
                flagged.append(launcher)
        for c in _containers(obj):
            _map_container(c, default_image,
                           "" if any(c is f for f in flagged) else cpu_flag)
            if "args" in c:
                c["args"] = [_config_images(a) for a in c["args"]]
        if obj["kind"] == "ConfigMap":
            obj["data"] = {k: _config_images(v)
                           for k, v in obj["data"].items()}
    return out


def _config_images(value):
    if isinstance(value, str):
        for jimage, image in CONFIG_IMAGES.items():
            value = value.replace(jimage, image)
    return value


@pytest.mark.parametrize("pair,i", CASES,
                         ids=[f"{p}-{i}" for p, i in CASES])
def test_gpu_prototype_equals_jax_under_the_mapping(pair, i):
    jproto, tproto = PAIRS[pair][:2]
    params = PARAMS[pair][i]
    want = to_gpu(pair, jgenerate(jproto, _jax_params(pair, params)))
    got = generate(tproto, _port_params(pair, params))
    assert got == want
    text = json.dumps(got)
    assert TPU not in text and "kubeflow_tpu." not in text
    if pair not in JAX_SCHEMA_PAIRS:
        assert '"tpu"' not in text


def test_the_port_registry_holds_only_its_own_prototypes():
    assert set(all_prototypes()) == {t for _, t, *_ in PAIRS.values()}


@pytest.mark.parametrize("i", range(len(SERVING_PARAMS)))
def test_rendered_server_args_parse_with_the_port_cli(i):
    (dep, _svc) = generate("gpu-serving",
                           _port_params("serving", SERVING_PARAMS[i]))
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    assert c["command"] == ["python", "-m", "kubeflow_tpu_torch.serving"]
    args = build_parser().parse_args(c["args"])
    params = SERVING_PARAMS[i]
    assert args.model_name == (params.get("model_name") or params["name"])
    assert args.kv_fused_attention == params.get("kv_fused_attention",
                                                 False)
    assert args.device == ("cpu" if params.get("num_tpu_chips") == 0
                           else "cuda")
    assert args.grpc_port == 9000 and args.rest_port == 8500


def test_unported_server_parameter_is_refused_by_name():
    with pytest.raises(ValueError, match="compile_cache_dir"):
        generate("gpu-serving", {"name": "x", "compile_cache_dir": "/c"})
    # The flag itself: the CLI names it.
    from kubeflow_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--model-name", "x", "--compile-cache-dir=/c"])
    assert e.value.code == 2


@pytest.mark.parametrize("pair", ["job-simple", "tf-job", "pytorch-job",
                                  "healthcheck"])
def test_gpu_jobs_validate_and_reconcile_through_the_jax_operator(
        pair, api):
    tproto = PAIRS[pair][1]
    params = {"name": "g", "num_workers": 2, "gpus_per_worker": 1}
    if pair == "tf-job":
        params["num_ps"] = 1
    (job,) = generate(tproto, params)
    jobs_api.validate_job(job)
    for crd in jobs_api.all_job_crds():
        api.apply(crd)
    api.create(job)
    JobController(api, job["kind"]).reconcile_all()
    pods = api.list("v1", "Pod", "kubeflow")
    assert len(pods) == sum(r["replicas"]
                            for r in job["spec"]["replicaSpecs"].values())
    for pod in pods:
        spec = pod["spec"]
        assert not any("tpu" in k for k in spec.get("nodeSelector", {}))
        (c,) = spec["containers"]
        env = {e["name"]: e.get("value") for e in c["env"]}
        assert c["command"][2].startswith("kubeflow_tpu_torch.workloads.")
        if job["kind"] == "JaxJob":
            assert env["JAX_NUM_PROCESSES"] == "2"
            assert "JAX_COORDINATOR_ADDRESS" in env
        if job["kind"] == "PyTorchJob":
            assert {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= set(env)
        gpus = c.get("resources", {}).get("limits", {})
        if pod["metadata"]["labels"].get(
                "kubeflow-tpu.org/replica-type") == "ps":
            assert not gpus and c["command"][-1] == "--device=cpu"
        else:
            assert gpus == {images.GPU_RESOURCE: 1}


def test_renderer_cli_prints_the_objects():
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.manifests", "gpu-serving",
         "--param", "name=llama", "--param", "model_name=llama-1b",
         "--param", "kv_layout=paged", "--param", "kv_fused_attention=true",
         "--param", "num_gpus=1"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    objs = json.loads(proc.stdout)
    assert objs == generate("gpu-serving", {
        "name": "llama", "model_name": "llama-1b", "kv_layout": "paged",
        "kv_fused_attention": True, "num_gpus": 1})
    bad = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.manifests", "gpu-serving",
         "--param", "name=x", "--param", "compile_cache_dir=/c"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2 and "compile_cache_dir" in bad.stderr
