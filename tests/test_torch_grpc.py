"""The port's gRPC :9000 surface and the CLI flags around it.

``Predict`` returns the body the REST predict returns, ``PredictStream``
the streamed tokens, ``GetModelMetadata`` the REST metadata; the
``x-request-id`` metadata is honored and echoed. The CLI serves gRPC on
:9000 by default, ``--grpc-port -1`` disables it, ``--enable-prometheus``
is accepted, and without grpcio the default exits 2 naming
``--grpc-port -1``. lm-test-tiny at ``dtype=float32`` on the CPU.
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
grpc = pytest.importorskip("grpc")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.serving import __main__ as cli  # noqa: E402
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.grpc_server import (  # noqa: E402
    client_stubs,
    stream_stub,
)
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODEL = "lm-test-tiny"
PROMPTS = [[1, 2, 3], [7, 5], list(range(4, 20))]


@pytest.fixture(scope="module")
def server():
    spec = get_model(MODEL, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray,
                        spec.init(jax.random.PRNGKey(0), spec.config))
    srv = ModelServer(
        EngineConfig(model=MODEL, batch_size=4, max_seq_len=32,
                     max_new_tokens=8, kv_layout="paged", kv_block_size=8,
                     prefix_cache_slots=2, dtype="float32", device="cpu"),
        port=0, grpc_port=0, params=tree, batch_timeout_ms=2)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def channel(server):
    assert server.grpc_port > 0  # port 0 resolved to the bound port
    ch = grpc.insecure_channel(f"127.0.0.1:{server.grpc_port}")
    yield ch
    ch.close()


def _rest(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", f"/v1/models/{MODEL}:predict",
                     body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_predict_returns_the_rest_body(server, channel):
    predict, _ = client_stubs(channel)
    instances = [{"tokens": p, "max_new_tokens": 6} for p in PROMPTS]
    instances.append({"tokens": [9, 9, 2]})  # a plain predict
    got = predict(MODEL, instances)
    status, want = _rest(server.port, {"instances": instances})
    assert status == 200 and got == want
    assert [len(p["tokens"]) for p in got["predictions"][:3]] == [6, 6, 6]


def test_predict_stream_returns_the_streamed_tokens(server, channel):
    predict, _ = client_stubs(channel)
    want = predict(MODEL, [{"tokens": PROMPTS[2], "max_new_tokens": 8}])
    recs = list(stream_stub(channel)(
        MODEL, {"tokens": PROMPTS[2], "max_new_tokens": 8}))
    toks = want["predictions"][0]["tokens"]
    assert [r["token"] for r in recs[:-1]] == toks
    assert recs[-1]["done"] and recs[-1]["tokens"] == toks


def test_get_model_metadata(server, channel):
    _, metadata = client_stubs(channel)
    meta = metadata(MODEL)
    assert meta["name"] == MODEL and meta["state"] == "AVAILABLE"
    with pytest.raises(grpc.RpcError) as e:
        metadata("other")
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_request_id_metadata_is_echoed_and_keys_the_timeline(server,
                                                             channel):
    predict, _ = client_stubs(channel)
    body, md = predict(MODEL, [{"tokens": [3, 4], "max_new_tokens": 2}],
                       metadata=(("x-request-id", "grpc-rid-1"),),
                       with_call=True)
    assert md["x-request-id"] == "grpc-rid-1"
    assert len(body["predictions"][0]["tokens"]) == 2
    (rec,) = server.decoder.trace.find("grpc-rid-1")
    assert rec["status"] == "length"
    _, md = predict(MODEL, [{"tokens": [3]}], with_call=True)
    assert len(md["x-request-id"]) == 16  # minted when absent


def test_errors_map_to_status_codes(server, channel):
    predict, _ = client_stubs(channel)
    with pytest.raises(grpc.RpcError) as e:
        predict("other", [{"tokens": [1]}])
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as e:
        predict(MODEL, [{"tokens": list(range(40)), "max_new_tokens": 1}])
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_grpc_traffic_counts_in_the_exposition(server, channel):
    predict, _ = client_stubs(channel)
    before = server.metrics._requests.value
    predict(MODEL, [{"tokens": [5, 6]}])
    assert server.metrics._requests.value == before + 1


def test_a_taken_port_is_refused_not_shared(server):
    from kubeflow_tpu_torch.serving.grpc_server import GrpcPredictionService

    with pytest.raises(OSError, match=f"port {server.grpc_port}"):
        GrpcPredictionService(server, port=server.grpc_port)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra,grpc_port", [
    ([], 9000), (["--grpc-port", "-1"], None),
    (["--grpc-port", "0", "--enable-prometheus"], 0)],
    ids=["default", "disabled", "ephemeral_prometheus"])
def test_cli_grpc_port_flags(monkeypatch, extra, grpc_port):
    built = []

    def fake_serve_forever(self):
        built.append(self)

    monkeypatch.setattr(ModelServer, "serve_forever", fake_serve_forever)
    assert cli.main(["--model-name", MODEL, "--device", "cpu",
                     "--rest-port", "0", "--max-seq-len", "16", *extra]) == 0
    try:
        assert built[0].grpc_port == grpc_port
    finally:
        built[0].stop()


def test_cli_without_grpcio_exits_2_naming_the_flag():
    """grpc made unimportable in a subprocess: the default CLI refuses
    to start without :9000 and names ``--grpc-port -1``; with that flag
    it gets past the check (it then fails on the absent card)."""
    code = (
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "from kubeflow_tpu_torch.serving.__main__ import main\n"
        "sys.exit(main(sys.argv[1:]))\n")
    base = [sys.executable, "-c", code, "--model-name", MODEL,
            "--rest-port", "0"]
    proc = subprocess.run(base, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "--grpc-port -1" in proc.stderr
    proc = subprocess.run(base + ["--grpc-port", "-1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
