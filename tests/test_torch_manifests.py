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
  unless asked).

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
}

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
}
CASES = [(pair, i) for pair in PAIRS for i in range(len(PARAMS[pair]))]


def _port_params(pair: str, params: dict) -> dict:
    _, _, _, jkey, tkey = PAIRS[pair]
    out = dict(params)
    if jkey in out:
        out[tkey] = out.pop(jkey)
    return out


def _jax_params(pair: str, params: dict) -> dict:
    """The JAX prototype's parameters; its chips default differs from the
    port's GPU default, so the port's default is passed explicitly."""
    jproto, tproto, _, jkey, tkey = PAIRS[pair]
    from kubeflow_tpu_torch.manifests.core import get_prototype

    out = dict(params)
    if jkey not in out:
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
        # The port's own entry points take --device; a third-party
        # image's command is its own.
        cpu_flag = ("" if pair == "inference-server" else
                    "args" if obj["kind"] in ("Deployment", "Job")
                    else "command")
        for c in _containers(obj):
            _map_container(c, default_image, cpu_flag)
    return out


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
