"""The port's job entry points against the JAX package's, on the CPU.

- ``workloads.slice_health`` in a gloo gang of two: healthy, the
  all-reduce of 2.0 reading 4.0, the report's keys JAX's (healthy and
  failing); without CUDA and without ``--device cpu`` it reports the
  error and exits 1.
- ``workloads.tf_cnn`` trains ``resnet-test-tiny`` for 2 steps and prints
  the loop's result with JAX's workload's keys.
- ``serving.batch_predict`` writes the JSONL JAX's writes over the same
  instances at float32 with JAX's weights carried across (greedy
  generations token for token, plain predicts' logits within 1e-4), the
  bad rows (a line that is not JSON, instances both engines refuse) on
  the same lines with the same errors; its summary is JAX's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores.
torch.set_num_threads(2)

import jax  # noqa: E402

from kubeflow_tpu.serving import batch_predict as jbatch  # noqa: E402
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig  # noqa: E402,E501
from kubeflow_tpu.serving.engine import InferenceEngine as JEngine  # noqa: E402,E501
from kubeflow_tpu.workloads import slice_health as jhealth  # noqa: E402
from kubeflow_tpu.workloads import tf_cnn as jtf_cnn  # noqa: E402
from kubeflow_tpu_torch.parallel import launch  # noqa: E402
from kubeflow_tpu_torch.serving import batch_predict as tbatch  # noqa: E402
from kubeflow_tpu_torch.serving.engine import EngineConfig as TEngineConfig  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402,E501

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _jax_report(capsys, *args):
    code = jhealth.main(list(args))
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_slice_health_in_a_gang_of_two_reports_as_jax(capsys):
    jcode, jok = _jax_report(capsys)
    jbad_code, jbad = _jax_report(capsys, "--expect-devices", "3")
    assert (jcode, jbad_code) == (0, 1)
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.workloads.slice_health",
           "--device", "cpu", "--alsologtostderr", "-v=1"]
    ok = launch.launch(cmd + ["--expect-devices", "2",
                              "--expect-local-devices", "1"], 2,
                       env=_env(), cwd=ROOT, timeout=TIMEOUT_S)
    for i, p in enumerate(ok):
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert set(r) == set(jok)
        assert r["healthy"] and r["process_id"] == i
        assert (r["local_devices"], r["global_devices"]) == (1, 2)
        assert r["psum"] == 4.0 and r["platform"] == "cpu"
        assert r["collective_ms"] > 0
    bad = launch.launch(cmd + ["--expect-devices", "3"], 2, env=_env(),
                        cwd=ROOT, timeout=TIMEOUT_S)
    for p in bad:
        assert p.returncode == 1
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert set(r) == set(jbad) and not r["healthy"]
        assert r["error"] == "global devices 2 != 3"


def test_slice_health_without_cuda_reports_the_error():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.workloads.slice_health"],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 1
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not r["healthy"] and "CUDA is not available" in r["error"]


def test_tf_cnn_trains_resnet_test_tiny(capsys):
    assert jtf_cnn.main(["--model", "resnet-test-tiny", "--steps", "2",
                         "--batch-size", "8", "--log-every", "1"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.workloads.tf_cnn",
         "--model", "resnet-test-tiny", "--steps", "2", "--batch-size", "8",
         "--log-every", "1", "--device", "cpu"],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["step"] == want["step"] == 2
    assert np.isfinite(got["loss"]) and got["devices"] == 1
    assert "step=2 loss=" in proc.stdout


# Sixteen instances: plain predicts and greedy generations, a line that
# is not JSON, a blank line, and instances both engines refuse (JAX
# clamps out-of-range token ids where the port refuses them, so none is
# here).
INSTANCES = [
    {"tokens": [1, 2, 3]}, {"tokens": [7, 5], "max_new_tokens": 4},
    {"tokens": [9, 9, 9, 9, 2]}, "{not json", {"tokens": []},
    {"tokens": list(range(4, 20)), "max_new_tokens": 3},
    {"tokens": [5]}, {"tokens": [1, "a"]}, "",
    {"tokens": [11, 12], "max_new_tokens": 2}, {"tokens": [3, 1, 4, 1, 5]},
    {"tokens": [2], "max_new_tokens": -1}, {"tokens": [8, 8]},
    {"tokens": [250, 3], "max_new_tokens": 5}, {"tokens": [6, 6, 6]},
    {"tokens": [42]}]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_batch_predict_writes_jax_s_jsonl(tmp_path):
    src = tmp_path / "in.jsonl"
    src.write_text("".join((x if isinstance(x, str) else json.dumps(x))
                           + "\n" for x in INSTANCES))
    common = dict(model="lm-test-tiny", batch_size=4, max_seq_len=32,
                  max_new_tokens=8, dtype="float32")
    jengine = JEngine(JEngineConfig(**common))
    tengine = TEngine(TEngineConfig(**common, device="cpu"),
                      params=jax.tree.map(np.asarray, jengine.params))
    jlog, tlog = [], []
    want = jbatch.run_batch_predict(jengine, str(src), str(tmp_path / "j"),
                                    4, log=jlog.append)
    got = tbatch.run_batch_predict(tengine, str(src), str(tmp_path / "t"),
                                   4, log=tlog.append)
    assert {k: v for k, v in got.items() if k != "output_path"} == {
        k: v for k, v in want.items() if k != "output_path"} == {
        "instances": 14, "errors": 4}
    jrows, trows = _rows(tmp_path / "j"), _rows(tmp_path / "t")
    # A line that is not JSON is written at once, the chunk's rows later.
    assert [r["line"] for r in trows] == [r["line"] for r in jrows]
    assert sorted(r["line"] for r in trows) == [
        i for i, x in enumerate(INSTANCES) if x != ""]
    generated = 0
    for t, j in zip(trows, jrows):
        assert set(t) == set(j), (t, j)
        if "error" in j:
            assert t["error"] == j["error"]
        elif "tokens" in j:
            assert t["tokens"] == j["tokens"]
            generated += 1
        else:
            for key, value in j.items():
                if key != "line":
                    np.testing.assert_allclose(t[key], value, rtol=1e-4,
                                               atol=1e-4, err_msg=key)
    assert generated == 4
    assert tlog[0].startswith("batch predict done: ")


def test_batch_predict_cli(tmp_path):
    src = tmp_path / "in.jsonl"
    src.write_text('{"tokens": [1, 2]}\nnope\n')
    out = tmp_path / "out.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.batch_predict",
         "--input-path", str(src), "--output-path", str(out),
         "--batch-size", "2", "--device", "cpu"],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = {r["line"]: r for r in _rows(out)}
    assert sorted(rows) == [0, 1]
    assert "logits" in rows[0] and "error" in rows[1]
    assert '"errors": 1' in proc.stdout
