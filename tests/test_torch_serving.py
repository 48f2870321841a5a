"""The port's serving stack against the JAX package's, and its guards.

``ContinuousDecoder`` of both packages serve the same prompts with the
same weights (the JAX init, handed across as numpy arrays) at
``dtype=float32`` on the CPU; greedy streams, EOS stops included, must
be identical. The port's REST server is driven over HTTP, every option
of an unported feature must raise, and the package must import neither
JAX nor the JAX package.
"""

import http.client
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving.cold_store import ColdKvStore  # noqa: E402,E501
from kubeflow_tpu_torch.serving.continuous import (  # noqa: E402
    ContinuousDecoder,
    PromptTooLong,
)
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.kv_directory import KvDirectory  # noqa: E402,E501
from kubeflow_tpu_torch.serving.qos import QosPolicy  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 9, 2], list(range(4, 20))]
# A token the f32 lm-test-tiny streams of PROMPTS emit mid-stream, so
# the EOS stop really happens.
EOS = 219
DECODER_KW = dict(slots=4, prefill_len=32, max_new_tokens=8,
                  kv_layout="paged", kv_block_size=8, eos_id=EOS)


@pytest.fixture(scope="module")
def weights():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    return spec.config, jparams, jax.tree.map(np.asarray, jparams)


def _streams(decoder):
    try:
        return [decoder.generate(p, 8, timeout=120) for p in PROMPTS]
    finally:
        decoder.stop()


@pytest.fixture(scope="module")
def jax_streams(weights):
    jcfg, jparams, _ = weights
    return {chunk: _streams(JaxDecoder(jparams, jcfg, chunk_size=chunk,
                                       kv_fused=True, **DECODER_KW))
            for chunk in (1, 4)}


@pytest.mark.parametrize("chunk,kv_fused,kv_dtype", [
    (1, True, "fp"), (4, True, "fp"), (4, False, "fp"), (1, True, "int8")])
def test_decoder_greedy_streams_match_jax(weights, jax_streams, chunk,
                                          kv_fused, kv_dtype):
    _, _, tree = weights
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    params = params_from_numpy(tree, tcfg, "cpu")
    decoder = ContinuousDecoder(params, tcfg, chunk_size=chunk,
                                kv_fused=kv_fused, kv_dtype=kv_dtype,
                                **DECODER_KW)
    got = _streams(decoder)
    if kv_dtype == "int8":
        jcfg, jparams, _ = weights
        want = _streams(JaxDecoder(jparams, jcfg, chunk_size=chunk,
                                   kv_fused=kv_fused, kv_dtype="int8",
                                   **DECODER_KW))
    else:
        want = jax_streams[chunk]
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert ([r["finish_reason"] for r in got]
            == [r["finish_reason"] for r in want])
    assert "eos" in [r["finish_reason"] for r in got]
    assert decoder.metrics()["kv_blocks_in_use"] == 0


def test_decoder_rejects_too_long_and_bad_tokens(weights):
    _, _, tree = weights
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    decoder = ContinuousDecoder(params_from_numpy(tree, tcfg, "cpu"), tcfg,
                                **DECODER_KW)
    try:
        with pytest.raises(PromptTooLong):
            decoder.submit(list(range(33)), 4)
        with pytest.raises(ValueError, match="token ids"):
            decoder.submit([tcfg.vocab_size], 4)
        res = decoder.generate([1, 2], 0, timeout=60)
        assert res["tokens"] == [] and res["prefill_logits"].shape == (
            tcfg.vocab_size,)
    finally:
        decoder.stop()


_OPTIONS = [
    (dict(kv_layout="dense", prefill_chunk_tokens=8),
     "requires kv_layout='paged'"),
    (dict(prefix_cache_slots=2), None),
    (dict(speculative_k=2), None),
    (dict(qos=QosPolicy({})), None),
    (dict(host_kv_bytes=1 << 20), None),
    (dict(prefill_chunk_tokens=8), None),
    (dict(tp_shards=2, tp_devices=["cpu", "cpu"]), None),
    (dict(cp_shards=2), "set prefill_chunk_tokens > 0"),
    (dict(pp_stages=2, kv_fused=True), "does not compose with kv_fused"),
    (dict(role="prefill"), None),
    (dict(kv_directory=KvDirectory(8), replica_name="a"), None),
    (dict(cold_store=ColdKvStore(1 << 20), host_kv_bytes=1 << 20), None),
]


@pytest.mark.parametrize("option,match", _OPTIONS,
                         ids=[next(iter(o)) for o, _ in _OPTIONS])
def test_decoder_unported_options_raise(weights, option, match):
    """Options of features not yet ported raise; the dense layout refuses
    chunking, the ring wants chunked prefill and pipeline stages refuse
    the fused kernel, as JAX does. The paged prefix cache, chunked
    prefill, speculation, QoS, the host KV tier, the fleet roles, tensor
    shards and the fleet KV economy's directory and cold store are
    ported: those options build a decoder that serves (the ring and the
    stages: tests/test_torch_long_context_parallel.py; the economy:
    tests/test_torch_kv_economy.py)."""
    _, _, tree = weights
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    kw = {**DECODER_KW, **option}
    params = params_from_numpy(tree, tcfg, "cpu")
    if match is not None:
        with pytest.raises(ValueError, match=match):
            ContinuousDecoder(params, tcfg, **kw)
        return
    decoder = ContinuousDecoder(params, tcfg, **kw)
    try:
        assert len(decoder.generate(PROMPTS[3], 4, timeout=60)["tokens"]) == 4
    finally:
        decoder.stop()


def _engine_cfg(**kw):
    base = dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                kv_fused=True, eos_id=EOS, dtype="float32", device="cpu")
    return EngineConfig(**{**base, **kw})


@pytest.mark.parametrize("option", [
    dict(checkpoint_dir="/nonexistent"), dict(weight_peers="127.0.0.1:1"),
    dict(prefix_cache_slots=2)],
    ids=lambda o: next(iter(o)))
def test_server_unported_options_raise(option):
    """The boot chain as JAX's: a checkpoint directory without a
    checkpoint raises, a dead donor falls back to the init; the paged
    prefix cache builds its trie."""
    if "checkpoint_dir" in option:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ModelServer(_engine_cfg(**option), port=0)
        return
    server = ModelServer(_engine_cfg(weight_pull_timeout_s=5.0, **option),
                         port=0)
    try:
        if "weight_peers" in option:
            assert server.engine.weight_pull_source == "init"
            assert server.engine.boot_weights_version == 0
        else:
            assert server.decoder.prefix_cache is not None
        assert server.decoder.metrics()["kv_layout"] == "paged"
    finally:
        server.stop()


@pytest.mark.parametrize("option", [
    dict(decode_mode="lockstep"), dict(kv_layout="dense", kv_fused=False)],
    ids=lambda o: next(iter(o)))
def test_server_builds_lockstep_and_dense(option):
    """The JAX server's other decode mode and its default layout: a
    lockstep server has no decoder (generation rides the batcher), a
    dense one decodes into dense rows."""
    server = ModelServer(_engine_cfg(**option), port=0)
    try:
        if option.get("decode_mode") == "lockstep":
            assert server.decoder is None
        else:
            assert server.decoder.metrics()["kv_layout"] == "dense"
    finally:
        server.stop()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_http_predict_stream_and_probes_match_jax(weights, jax_streams):
    server = ModelServer(_engine_cfg(), port=0, params=weights[2])
    server.start()
    try:
        port = server.port
        path = "/v1/models/lm-test-tiny:predict"
        status, text = _request(port, "POST", path, {"instances": [
            {"tokens": p, "max_new_tokens": 8} for p in PROMPTS]})
        assert status == 200
        preds = json.loads(text)["predictions"]
        want = jax_streams[1]
        assert [p["tokens"] for p in preds] == [r["tokens"] for r in want]
        assert all(p["next_token"] == p["tokens"][0] for p in preds)

        status, text = _request(port, "POST", path, {
            "stream": True,
            "instances": [{"tokens": PROMPTS[0], "max_new_tokens": 8}]})
        assert status == 200
        recs = [json.loads(line) for line in text.splitlines() if line]
        assert recs[-1]["done"] and recs[-1]["tokens"] == want[0]["tokens"]
        assert [r["token"] for r in recs[:-1]] == want[0]["tokens"]

        assert _request(port, "GET", "/healthz") == (
            200, json.dumps({"status": "ok"}))
        assert _request(port, "GET", "/readyz")[0] == 200
        status, text = _request(port, "GET", "/v1/models/lm-test-tiny")
        assert status == 200 and json.loads(text)["state"] == "AVAILABLE"
        # A plain predict (no max_new_tokens): last-position logits and
        # their argmax, the greedy stream's first token.
        status, text = _request(port, "POST", path, {
            "instances": [{"tokens": PROMPTS[0]}]})
        assert status == 200
        pred = json.loads(text)["predictions"][0]
        assert pred["next_token"] == int(np.argmax(pred["logits"]))
        assert pred["next_token"] == want[0]["tokens"][0]
        assert _request(port, "POST", "/v1/models/other:predict", {
            "instances": [{"tokens": [1], "max_new_tokens": 1}]})[0] == 404
        assert _request(port, "POST", path, {"instances": [
            {"tokens": list(range(40)), "max_new_tokens": 1}]})[0] == 413
    finally:
        server.stop()


_REFUSED_FLAGS = {
    # Ported: refused, as the JAX CLI refuses them, where they cannot
    # serve (tensor shards and QoS need the continuous decoder, the host
    # tier the paged layout).
    "--tp-shards": ["--kv-layout", "paged", "--tp-shards", "2",
                    "--decode-mode", "lockstep"],
    "--qos-tenants": ["--qos-tenants", "gold=2", "--decode-mode",
                      "lockstep"],
    "--host-kv-bytes": ["--host-kv-bytes", "2"],
}


@pytest.mark.parametrize("flag", list(_REFUSED_FLAGS))
def test_cli_rejects_unported_flags(flag, capsys):
    from kubeflow_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--model-name", "lm-test-tiny", *_REFUSED_FLAGS[flag]])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["--speculative-k", "2", "--decode-mode", "lockstep"],
    ["--speculative-k", "2", "--draft-mode", "bogus"]],
    ids=["lockstep", "draft-mode"])
def test_cli_rejects_speculation_it_cannot_serve(extra):
    """As the JAX CLI: verification rides the continuous decoder, and the
    draft mode is ``ngram`` or ``model:<name>``."""
    from kubeflow_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--model-name", "lm-test-tiny", "--grpc-port", "-1", *extra])
    assert e.value.code == 2


def test_cli_rejects_dense_layout_and_bad_block_size():
    from kubeflow_tpu_torch.serving.__main__ import main

    for extra in (["--prefill-chunk-tokens", "8"],
                  ["--max-prompt-len", "256"],
                  ["--kv-layout", "paged", "--kv-block-size", "7"]):
        with pytest.raises(SystemExit) as e:
            main(["--model-name", "lm-test-tiny", *extra])
        assert e.value.code == 2


# The port's platform surface (manifests, the Experiment, InferenceService
# and rollout controllers, the sweep, the lint, the apiserver client and
# fake, the gateway and the dashboards), held to the same rule.
PLATFORM_MODULES = [
    "kubeflow_tpu_torch.apis.certificates",
    "kubeflow_tpu_torch.apis.experiment",
    "kubeflow_tpu_torch.apis.inference",
    "kubeflow_tpu_torch.apis.notebooks",
    "kubeflow_tpu_torch.apis.pipelines",
    "kubeflow_tpu_torch.apis.tuning",
    "kubeflow_tpu_torch.auth.pki",
    "kubeflow_tpu_torch.auth.tokens",
    "kubeflow_tpu_torch.dashboard",
    "kubeflow_tpu_torch.dashboard.__main__",
    "kubeflow_tpu_torch.dashboard.training",
    "kubeflow_tpu_torch.gateway",
    "kubeflow_tpu_torch.gateway.__main__",
    "kubeflow_tpu_torch.gateway.admin",
    "kubeflow_tpu_torch.gateway.jwt_auth",
    "kubeflow_tpu_torch.gateway.proxy",
    "kubeflow_tpu_torch.gateway.resilience",
    "kubeflow_tpu_torch.gateway.routing",
    "kubeflow_tpu_torch.apis.jobs",
    "kubeflow_tpu_torch.apis.rl",
    "kubeflow_tpu_torch.apis.scheduling",
    "kubeflow_tpu_torch.k8s_client",
    "kubeflow_tpu_torch.k8s_fake",
    "kubeflow_tpu_torch.manifests.__main__",
    "kubeflow_tpu_torch.manifests.core",
    "kubeflow_tpu_torch.manifests.images",
    "kubeflow_tpu_torch.manifests.notebooks",
    "kubeflow_tpu_torch.manifests.objects",
    "kubeflow_tpu_torch.manifests.rl",
    "kubeflow_tpu_torch.manifests.scheduling",
    "kubeflow_tpu_torch.manifests.secure_entrypoint",
    "kubeflow_tpu_torch.manifests.serving",
    "kubeflow_tpu_torch.manifests.training",
    "kubeflow_tpu_torch.observability.lint",
    "kubeflow_tpu_torch.operators.__main__",
    "kubeflow_tpu_torch.operators.base",
    "kubeflow_tpu_torch.operators.experiment",
    "kubeflow_tpu_torch.operators.inference",
    "kubeflow_tpu_torch.operators.jobs",
    "kubeflow_tpu_torch.operators.leader",
    "kubeflow_tpu_torch.operators.certificate",
    "kubeflow_tpu_torch.operators.certificates",
    "kubeflow_tpu_torch.operators.notebook",
    "kubeflow_tpu_torch.operators.notebooks",
    "kubeflow_tpu_torch.operators.rl",
    "kubeflow_tpu_torch.operators.rollout",
    "kubeflow_tpu_torch.operators.runstore",
    "kubeflow_tpu_torch.runtime",
    "kubeflow_tpu_torch.scheduler.__main__",
    "kubeflow_tpu_torch.scheduler.capacity",
    "kubeflow_tpu_torch.scheduler.controller",
    "kubeflow_tpu_torch.scheduler.queue",
    "kubeflow_tpu_torch.tuning.suggestions",
    "kubeflow_tpu_torch.tuning.sweep",
    "kubeflow_tpu_torch.webapps.jupyter",
    "kubeflow_tpu_torch.workloads.chainermn_train",
    "kubeflow_tpu_torch.workloads.mpi_launcher",
    "kubeflow_tpu_torch.workloads.mxnet_ps",
]


def test_package_imports_neither_jax_nor_the_jax_package():
    root = Path(__file__).resolve().parent.parent
    code = (
        "import importlib, pkgutil, sys\n"
        "import kubeflow_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'kubeflow_tpu_torch.serving.scenarios' in sys.modules\n"
        # The platform surface: every module walked and imported.
        f"missing = [m for m in {PLATFORM_MODULES!r}\n"
        "           if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'optax',\n"
        "             'kubeflow_tpu', 'ml_dtypes') or n.startswith(('jax.',\n"
        "             'optax.', 'kubeflow_tpu.', 'ml_dtypes.')))\n"
        "print(len(list(pkgutil.walk_packages(pkg.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "kubeflow_tpu_torch.gateway", "kubeflow_tpu_torch.gateway.__main__",
    "kubeflow_tpu_torch.dashboard", "kubeflow_tpu_torch.dashboard.training",
    "kubeflow_tpu_torch.operators.leader",
    "kubeflow_tpu_torch.operators.notebook",
    "kubeflow_tpu_torch.operators.notebooks",
    "kubeflow_tpu_torch.auth.pki",
    "kubeflow_tpu_torch.apis.certificates",
    "kubeflow_tpu_torch.operators.certificate",
    "kubeflow_tpu_torch.operators.certificates",
    "kubeflow_tpu_torch.manifests.secure_entrypoint",
    "kubeflow_tpu_torch.webapps.jupyter",
    "kubeflow_tpu_torch.workloads.mpi_launcher",
    "kubeflow_tpu_torch.workloads.mxnet_ps",
    "kubeflow_tpu_torch.workloads.chainermn_train"])
def test_front_door_imports_neither_torch_nor_jax(module):
    """The gateway, the dashboards and the other host-only modules (leader
    election, the notebook controller and web app, the certificate
    controllers with their entry point, PKI, CRDs and prototypes, the MPI
    launcher and the two numpy workloads) are host code: a fresh interpreter that
    imports one of them (and the JWT path the gateway's flags reach)
    loads no module of ``kubeflow_tpu``, no ``jax`` and no ``torch``."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "importlib.import_module('kubeflow_tpu_torch.gateway.jwt_auth')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'torch', 'kubeflow_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "profile_torch_decode.py",
                                    "profile_torch_train.py"])
def test_card_scripts_import_neither_jax_nor_the_jax_package(script):
    """The scripts that run on the card, read with ``ast``: no import of
    ``jax``, ``optax`` or ``kubeflow_tpu`` anywhere in them (the card's
    machine has no JAX)."""
    import ast

    root = Path(__file__).resolve().parent.parent
    tree = ast.parse((root / script).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names, "no imports found"
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "optax", "kubeflow_tpu")]
    assert not bad, bad
