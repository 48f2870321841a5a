"""Batch prediction job; counterpart of
``kubeflow_tpu/serving/batch_predict.py`` (the tf-batch-predict role).

    python -m kubeflow_tpu_torch.serving.batch_predict --input-path IN
        --output-path OUT [--model-name lm-test-tiny] [--model-path DIR]
        [--batch-size 8] [--max-seq-len 128] [--device cpu]

Reads JSONL instances, runs them through the inference engine in chunks
of the server's batch size and writes one JSONL prediction a line, each
with the input's ``line`` number; a line that is not JSON, or an instance
the engine refuses, gets ``{"line": n, "error": ...}`` instead (the chunk
then runs one instance at a time, so one bad row does not spoil the
others). The job exits 0 whatever the rows hold. As the port's server
does, the engine refuses token ids outside the vocabulary, where the JAX
engine clamps them.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.runtime import strip_glog_args


def run_batch_predict(engine, input_path: str, output_path: str,
                      batch_size: int, *, log=print) -> dict:
    total = errors = 0
    with open(input_path) as fin, open(output_path, "w") as fout:
        chunk: list[dict] = []
        lines: list[int] = []

        def flush():
            nonlocal total, errors
            if not chunk:
                return
            try:
                for inst in chunk:
                    engine.validate_instance(inst)
                preds = engine.predict_batch(chunk)
            except ValueError:
                # One instance at a time, so one bad row does not spoil
                # the chunk.
                preds = []
                for inst in chunk:
                    try:
                        engine.validate_instance(inst)
                        preds.extend(engine.predict_batch([inst]))
                    except ValueError as e_one:
                        preds.append({"error": str(e_one)})
                        errors += 1
            for line_no, pred in zip(lines, preds):
                fout.write(json.dumps({"line": line_no, **pred}) + "\n")
            total += len(chunk)
            chunk.clear()
            lines.clear()

        for i, line in enumerate(fin):
            line = line.strip()
            if not line:
                continue
            try:
                chunk.append(json.loads(line))
            except json.JSONDecodeError as e:
                fout.write(json.dumps({"line": i, "error": str(e)}) + "\n")
                errors += 1
                continue
            lines.append(i)
            if len(chunk) >= batch_size:
                flush()
        flush()
    summary = {"instances": total, "errors": errors,
               "output_path": output_path}
    log(f"batch predict done: {json.dumps(summary)}")
    return summary


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="batch prediction job")
    p.add_argument("--model-name", default="lm-test-tiny",
                   help="registry model name")
    p.add_argument("--model-path", default="",
                   help="checkpoint dir (empty = fresh init)")
    p.add_argument("--input-path", required=True, help="JSONL instances")
    p.add_argument("--output-path", required=True, help="JSONL predictions")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from kubeflow_tpu_torch.serving.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(EngineConfig(
        model=args.model_name,
        checkpoint_dir=args.model_path or None,
        batch_size=args.batch_size,
        max_seq_len=args.max_seq_len,
        device=args.device,
    ))
    run_batch_predict(engine, args.input_path, args.output_path,
                      args.batch_size)
    return 0  # bad rows are recorded in the output, not fatal


if __name__ == "__main__":
    raise SystemExit(main())
