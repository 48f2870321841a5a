"""CLI: ``python -m kubeflow_tpu_torch.serving --model-name llama-1b
--kv-layout paged --kv-fused-attention [--kv-dtype int8] [--device cuda]``.

Counterpart of ``kubeflow_tpu/serving/__main__.py``: the JAX CLI's flag
names for the options this package has ported, plus ``--device``. Every
other flag of the JAX CLI is rejected by name, never ignored.
"""

from __future__ import annotations

import argparse
import sys

from kubeflow_tpu_torch.serving.engine import EngineConfig
from kubeflow_tpu_torch.serving.server import ModelServer

# Flags of the JAX CLI whose features are not yet ported.
UNPORTED_FLAGS = (
    "--model-path", "--grpc-port", "--batch-timeout-ms",
    "--prefix-cache-slots", "--prefix-cache-min-len", "--speculative-k",
    "--draft-mode", "--serving-role", "--tp-shards",
    "--prefill-chunk-tokens", "--max-prompt-len", "--cp-shards",
    "--pp-stages", "--host-kv-bytes", "--kv-directory-size",
    "--cold-store-ref", "--kv-import-crossover-tokens", "--qos-tenants",
    "--qos-aging-s", "--compile-cache-dir", "--weight-peers",
    "--weight-pull-timeout-s", "--enable-prometheus",
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.serving")
    p.add_argument("--model-name", required=True,
                   help="registry model name (kubeflow_tpu_torch.models)")
    p.add_argument("--rest-port", type=int, default=8500)
    p.add_argument("--batch-size", type=int, default=8,
                   help="decode slots (concurrent sequences)")
    p.add_argument("--max-seq-len", type=int, default=128,
                   help="prompt length every admission is padded to")
    p.add_argument("--max-new-tokens", type=int, default=16,
                   help="per-request generation cap")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="token id ending a generation early; -1 disables")
    p.add_argument("--decode-mode", default="continuous",
                   choices=["continuous"])
    p.add_argument("--decode-chunk", type=int, default=1,
                   help="decode steps per scheduler round")
    p.add_argument("--prefill-len-buckets", type=int, default=0,
                   help="power-of-two prefill length buckets below "
                        "max-seq-len (0 = pad every prompt to max-seq-len)")
    p.add_argument("--kv-layout", default="dense",
                   choices=["dense", "paged"],
                   help="only 'paged' is ported")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="tokens per KV block; must divide max-seq-len + "
                        "max-new-tokens")
    p.add_argument("--kv-pool-blocks", type=int, default=0,
                   help="physical blocks in the pool (0 = batch-size "
                        "sequences at worst case)")
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"])
    p.add_argument("--kv-fused-attention", action="store_true",
                   help="read the paged cache through the paged decode "
                        "kernel instead of a gathered dense view")
    p.add_argument("--stream-timeout-s", type=float, default=60.0)
    p.add_argument("--dtype", default="",
                   choices=["", "bfloat16", "float32"],
                   help="compute dtype override; empty keeps the preset's")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (raises without a CUDA device) or 'cpu'")
    for arg in sys.argv[1:] if argv is None else argv:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            p.error(f"{flag} is not yet ported to the PyTorch package")
    args = p.parse_args(argv)
    if args.kv_layout != "paged":
        p.error("--kv-layout=dense is not yet ported; pass --kv-layout "
                "paged")
    if args.kv_block_size <= 0:
        p.error("--kv-block-size must be positive")
    total = args.max_seq_len + args.max_new_tokens
    if total % args.kv_block_size:
        p.error(f"--kv-block-size {args.kv_block_size} must divide "
                f"max-seq-len + max-new-tokens = {total}")

    server = ModelServer(
        EngineConfig(
            model=args.model_name,
            batch_size=args.batch_size,
            max_seq_len=args.max_seq_len,
            max_new_tokens=args.max_new_tokens,
            top_k=args.top_k,
            eos_id=None if args.eos_id < 0 else args.eos_id,
            decode_mode=args.decode_mode,
            decode_chunk=args.decode_chunk,
            prefill_len_buckets=args.prefill_len_buckets,
            kv_layout=args.kv_layout,
            kv_block_size=args.kv_block_size,
            kv_pool_blocks=args.kv_pool_blocks,
            kv_dtype=args.kv_dtype,
            kv_fused=args.kv_fused_attention,
            stream_timeout_s=args.stream_timeout_s,
            dtype=args.dtype,
            device=args.device,
        ),
        port=args.rest_port,
    )
    print(f"serving {args.model_name} on REST :{args.rest_port} "
          f"({server.engine.device})")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
