"""Serving prototypes for the port on NVIDIA GPUs; counterparts of
``kubeflow_tpu/manifests/packages/serving.py`` (``tpu-serving``,
``batch-predict``) and ``inference_servers.py`` (``inference-server``).

Each keeps its JAX prototype's parameters, with ``num_tpu_chips``
renamed ``num_gpus`` (``nvidia.com/gpu`` limits and requests; 0 = a CPU
pod, whose command adds ``--device=cpu``: the port runs on CUDA unless
asked). The commands are the port's (``python -m
kubeflow_tpu_torch.serving``, ``...serving.batch_predict``) and the args
only flags its CLIs accept: a parameter whose flag the port refuses
raises ``ValueError`` naming it, never vanishes from the rendering.
"""

from __future__ import annotations

from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    gateway_route,
    prototype,
)

GRPC_PORT = 9000
REST_PORT = 8500

def _device_args(gpus: int) -> list[str]:
    """The port's CLIs default to ``--device cuda``; a pod without a GPU
    asks for the CPU."""
    return [] if gpus else ["--device=cpu"]


@prototype(
    "gpu-serving",
    "The port's model server Deployment on NVIDIA GPUs: gRPC :9000 + REST "
    ":8500, weights from a checkpoint directory or the seeded init, "
    "prometheus metrics, nvidia.com/gpu resources",
    params=[
        ParamSpec("name"),
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("model_path", "",
                  "checkpoint directory of a port training run (PVC or "
                  "local path); empty boots the seeded init"),
        ParamSpec("model_name", "", "served model name (defaults to `name`)"),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("replicas", 1),
        ParamSpec("num_gpus", 1, "nvidia.com/gpu per replica (0 = CPU)"),
        ParamSpec("batch_size", 8, "max server-side batch size"),
        ParamSpec("batch_timeout_ms", 5, "batching window"),
        ParamSpec("prefix_cache_slots", 0,
                  "prefix-cache entries (0 disables prefix reuse)"),
        ParamSpec("prefix_cache_min_len", 16,
                  "shortest prompt prefix worth caching"),
        ParamSpec("prefill_len_buckets", 0,
                  "power-of-two prefill length buckets below the max "
                  "sequence length (0 = fixed-length prefill)"),
        ParamSpec("speculative_k", 0,
                  "draft tokens verified per decode round (0 disables "
                  "speculative decoding)"),
        ParamSpec("draft_mode", "ngram",
                  "speculative draft proposer: ngram or "
                  "model:<registry-name>"),
        ParamSpec("kv_layout", "dense",
                  "KV-cache layout: dense (full-length row per decode "
                  "slot) or paged (block pool)"),
        ParamSpec("kv_block_size", 16, "tokens per KV block (paged layout)"),
        ParamSpec("kv_pool_blocks", 0,
                  "physical blocks in the paged pool (0 = dense-parity "
                  "sizing)"),
        ParamSpec("kv_dtype", "fp",
                  "paged KV residency precision: fp or int8"),
        ParamSpec("serving_role", "",
                  "disaggregated-fleet role: 'prefill' or 'decode'; empty "
                  "= colocated. Requires kv_layout=paged"),
        ParamSpec("tp_shards", 1,
                  "tensor-parallel shards per replica; the replica takes "
                  "tp*cp*pp GPUs, so size num_gpus to match"),
        ParamSpec("kv_fused_attention", False,
                  "read the paged cache through the paged decode kernel "
                  "(csrc/paged_decode.cu) instead of a gathered dense view"),
        ParamSpec("prefill_chunk_tokens", 0,
                  "chunked prefill chunk size (0 disables; requires "
                  "kv_layout=paged)"),
        ParamSpec("max_prompt_len", 0,
                  "longest admissible prompt (0 = the prefill window)"),
        ParamSpec("cp_shards", 1,
                  "context-parallel shards for chunk prefill attention"),
        ParamSpec("pp_stages", 1, "pipeline-parallel decoder stages"),
        ParamSpec("host_kv_bytes", 0,
                  "host-RAM KV tier budget in bytes (paged layout; 0 "
                  "disables); size the pod's memory request to cover it"),
        ParamSpec("kv_directory_size", 0,
                  "fleet KV economy: affinity keys the prefix->holder "
                  "directory tracks (0 disables; requires kv_layout=paged)"),
        ParamSpec("cold_store_ref", "",
                  "shared cold content-addressed KV store "
                  "('mem://<name>[?bytes=<n>]'; empty disables)"),
        ParamSpec("kv_import_crossover_tokens", 0,
                  "minimum prefill tokens a peer/cold import must save "
                  "(0 = any strictly deeper match)"),
        ParamSpec("qos_tenants", "",
                  "multi-tenant QoS: 'name=weight[:rate[:burst"
                  "[:priority]]]' comma-separated (empty disables)"),
        ParamSpec("qos_aging_s", 30.0,
                  "seconds of queue wait worth one priority point"),
        ParamSpec("compile_cache_dir", "",
                  "not yet ported: eager PyTorch compiles nothing to "
                  "cache, so a non-empty value raises"),
        ParamSpec("weight_peers", "",
                  "comma-separated host:port donors a newborn pulls its "
                  "weights from over :pull (empty = checkpoint boot)"),
        ParamSpec("enable_prometheus", True),
        ParamSpec("dtype", "bfloat16"),
    ],
)
def gpu_serving(
    name: str,
    namespace: str,
    model_path: str,
    model_name: str,
    image: str,
    replicas: int,
    num_gpus: int,
    batch_size: int,
    batch_timeout_ms: int,
    prefix_cache_slots: int,
    prefix_cache_min_len: int,
    prefill_len_buckets: int,
    speculative_k: int,
    draft_mode: str,
    kv_layout: str,
    kv_block_size: int,
    kv_pool_blocks: int,
    kv_dtype: str,
    serving_role: str,
    tp_shards: int,
    kv_fused_attention: bool,
    prefill_chunk_tokens: int,
    max_prompt_len: int,
    cp_shards: int,
    pp_stages: int,
    host_kv_bytes: int,
    kv_directory_size: int,
    cold_store_ref: str,
    kv_import_crossover_tokens: int,
    qos_tenants: str,
    qos_aging_s: float,
    compile_cache_dir: str,
    weight_peers: str,
    enable_prometheus: bool,
    dtype: str,
) -> list[dict]:
    if compile_cache_dir:
        # The server refuses --compile-cache-dir (its UNPORTED_FLAGS).
        raise ValueError(
            "gpu-serving: compile_cache_dir (--compile-cache-dir) is not "
            "yet ported to the PyTorch package")
    model_name = model_name or name
    labels = {"app": name, "service": "gpu-serving"}
    args = [
        f"--model-name={model_name}",
        f"--model-path={model_path}",
        f"--grpc-port={GRPC_PORT}",
        f"--rest-port={REST_PORT}",
        f"--batch-size={batch_size}",
        f"--batch-timeout-ms={batch_timeout_ms}",
        f"--prefix-cache-slots={prefix_cache_slots}",
        f"--prefix-cache-min-len={prefix_cache_min_len}",
        f"--prefill-len-buckets={prefill_len_buckets}",
        f"--speculative-k={speculative_k}",
        f"--draft-mode={draft_mode}",
        f"--kv-layout={kv_layout}",
        f"--kv-block-size={kv_block_size}",
        f"--kv-pool-blocks={kv_pool_blocks}",
        f"--kv-dtype={kv_dtype}",
        f"--tp-shards={tp_shards}",
        f"--dtype={dtype}",
    ]
    if serving_role:
        args.insert(-1, f"--serving-role={serving_role}")
    if kv_fused_attention:
        args.insert(-1, "--kv-fused-attention")
    if prefill_chunk_tokens:
        args.insert(-1, f"--prefill-chunk-tokens={prefill_chunk_tokens}")
    if max_prompt_len:
        args.insert(-1, f"--max-prompt-len={max_prompt_len}")
    if cp_shards > 1:
        args.insert(-1, f"--cp-shards={cp_shards}")
    if pp_stages > 1:
        args.insert(-1, f"--pp-stages={pp_stages}")
    if host_kv_bytes:
        args.insert(-1, f"--host-kv-bytes={host_kv_bytes}")
    if kv_directory_size:
        args.insert(-1, f"--kv-directory-size={kv_directory_size}")
    if cold_store_ref:
        args.insert(-1, f"--cold-store-ref={cold_store_ref}")
    if kv_import_crossover_tokens:
        args.insert(-1, "--kv-import-crossover-tokens="
                    f"{kv_import_crossover_tokens}")
    if qos_tenants:
        args.insert(-1, f"--qos-tenants={qos_tenants}")
        args.insert(-1, f"--qos-aging-s={qos_aging_s}")
    if weight_peers:
        args.insert(-1, f"--weight-peers={weight_peers}")
    if enable_prometheus:
        args.append("--enable-prometheus")
    args += _device_args(num_gpus)
    pod_annotations = (
        {
            "prometheus.io/scrape": "true",
            "prometheus.io/path": "/monitoring/prometheus/metrics",
            "prometheus.io/port": str(REST_PORT),
        }
        if enable_prometheus
        else None
    )
    return [
        k8s.deployment(
            name,
            namespace,
            containers=[
                k8s.container(
                    name,
                    image,
                    command=["python", "-m", "kubeflow_tpu_torch.serving"],
                    args=args,
                    ports={"grpc": GRPC_PORT, "rest": REST_PORT},
                    resources=images.gpu_resources(num_gpus),
                    liveness_probe=k8s.tcp_probe(GRPC_PORT, initial_delay=30),
                    readiness_probe=k8s.http_probe(
                        f"/v1/models/{model_name}", REST_PORT, initial_delay=20
                    ),
                )
            ],
            replicas=replicas,
            labels=labels,
            pod_annotations=pod_annotations,
        ),
        k8s.service(
            name,
            namespace,
            selector=labels,
            ports=[
                {"name": "grpc", "port": GRPC_PORT, "targetPort": GRPC_PORT},
                {"name": "rest", "port": REST_PORT, "targetPort": REST_PORT},
            ],
            labels=labels,
            annotations={
                **gateway_route(
                    name, f"/models/{name}/",
                    f"{name}.{namespace}:{REST_PORT}"),
                **({"prometheus.io/scrape": "true",
                    "prometheus.io/path":
                        "/monitoring/prometheus/metrics",
                    "prometheus.io/port": str(REST_PORT)}
                   if enable_prometheus else {}),
            },
        ),
    ]


@prototype(
    "gpu-batch-predict",
    "Batch prediction Job over a dataset on the port, on NVIDIA GPUs",
    params=[
        ParamSpec("name"),
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("model_path"),
        ParamSpec("input_path"),
        ParamSpec("output_path"),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("num_gpus", 1),
        ParamSpec("batch_size", 64),
    ],
)
def gpu_batch_predict(
    name: str,
    namespace: str,
    model_path: str,
    input_path: str,
    output_path: str,
    image: str,
    num_gpus: int,
    batch_size: int,
) -> list[dict]:
    return [
        {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": k8s.metadata(name, namespace, {"app": name}),
            "spec": {
                "backoffLimit": 2,
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": k8s.pod_spec(
                        [
                            k8s.container(
                                name,
                                image,
                                command=["python", "-m",
                                         "kubeflow_tpu_torch.serving."
                                         "batch_predict"],
                                args=[
                                    f"--model-path={model_path}",
                                    f"--input-path={input_path}",
                                    f"--output-path={output_path}",
                                    f"--batch-size={batch_size}",
                                    *_device_args(num_gpus),
                                ],
                                resources=images.gpu_resources(num_gpus),
                            )
                        ],
                        restart_policy="Never",
                    ),
                },
            },
        }
    ]


@prototype(
    "gpu-inference-server",
    "Generic third-party inference server Deployment + routed Service on "
    "NVIDIA GPUs",
    params=[
        ParamSpec("name"),
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", "REQUIRED", "inference server image"),
        ParamSpec("port", 8080, "HTTP predict port"),
        ParamSpec("command", None, "container command override (list)"),
        ParamSpec("args", None, "container args (list)"),
        ParamSpec("replicas", 1),
        ParamSpec("num_gpus", 0, "nvidia.com/gpu per replica"),
        ParamSpec("route_prefix", "", "gateway prefix (default /<name>/)"),
    ],
)
def gpu_inference_server(
    name: str,
    namespace: str,
    image: str,
    port: int,
    command,
    args,
    replicas: int,
    num_gpus: int,
    route_prefix: str,
) -> list[dict]:
    labels = {"app": name, "app.kubernetes.io/component": "inference"}
    prefix = route_prefix or f"/{name}/"
    container = k8s.container(
        name,
        image,
        command=list(command) if command else None,
        args=[str(a) for a in args] if args else None,
        ports={"http": port},
        resources=images.gpu_resources(num_gpus),
    )
    return [
        k8s.deployment(
            name,
            namespace,
            containers=[container],
            replicas=replicas,
            labels=labels,
        ),
        k8s.service(
            name,
            namespace,
            selector=labels,
            ports=[{"name": "http", "port": port, "targetPort": port}],
            labels=labels,
            annotations={
                **gateway_route(name, prefix, f"{name}.{namespace}:{port}"),
                "prometheus.io/scrape": "true",
                "prometheus.io/port": str(port),
            },
        ),
    ]
