"""CLI: ``python -m kubeflow_tpu_torch.serving --model-name llama-1b``.

Counterpart of ``kubeflow_tpu/serving/__main__.py``: the JAX CLI's flag
names and defaults for the options this package has ported, plus
``--device``. With no further flags it serves as the JAX CLI does: REST on
:8500 and gRPC on :9000 (``--grpc-port -1`` disables it), the metrics at
``/monitoring/prometheus/metrics`` (``--enable-prometheus`` is accepted
and changes nothing, as in JAX), the continuous decoder on the dense KV
layout, plain predicts through the dynamic batcher.
``--decode-mode lockstep``, ``--prefix-cache-slots N`` (either layout),
``--kv-layout paged [--kv-fused-attention] [--kv-dtype int8]`` and
``--prefill-chunk-tokens N --max-prompt-len M`` (paged),
``--speculative-k K [--draft-mode ngram|model:<name>]``, the host KV tier
(``--host-kv-bytes``, paged), the fleet KV economy
(``--kv-directory-size``, ``--cold-store-ref``,
``--kv-import-crossover-tokens``, paged), QoS (``--qos-tenants``,
``--qos-aging-s``),
a disaggregated role (``--serving-role prefill|decode``, paged), tensor
parallelism (``--tp-shards N``: with ``--device cuda`` the shards take
``cuda:0`` .. ``cuda:N-1`` and the CLI exits 2 naming the devices when
fewer GPUs are visible; with ``--device cpu`` every shard runs on the
host), context parallelism (``--cp-shards N``, with
``--prefill-chunk-tokens`` on the paged gathered path), pipeline stages
(``--pp-stages N``; the replica takes tp x cp x pp devices, as tensor
shards do) and the boot weights' source (``--model-path`` for a
checkpoint directory, ``--weight-peers`` with
``--weight-pull-timeout-s``) choose the other ported paths. The JAX CLI's
``--compile-cache-dir`` is rejected by name, never ignored: eager PyTorch
compiles nothing to cache. Without grpcio the default ``--grpc-port``
exits 2: the server never starts without :9000 unasked.
"""

from __future__ import annotations

import argparse
import sys

from kubeflow_tpu_torch.parallel.mesh import serving_mesh
from kubeflow_tpu_torch.serving.cold_store import cold_store_from_ref
from kubeflow_tpu_torch.serving.engine import EngineConfig
from kubeflow_tpu_torch.serving.qos import parse_tenants
from kubeflow_tpu_torch.serving.server import ModelServer

# Flags of the JAX CLI whose features are not yet ported.
UNPORTED_FLAGS = ("--compile-cache-dir",)


def _grpc_importable() -> bool:
    try:
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.serving")
    p.add_argument("--model-name", required=True,
                   help="registry model name (kubeflow_tpu_torch.models)")
    p.add_argument("--model-path", default="",
                   help="checkpoint directory of a training run: the "
                        "newest step gives the boot weights (empty boots "
                        "from the seeded init)")
    p.add_argument("--rest-port", type=int, default=8500)
    p.add_argument("--grpc-port", type=int, default=9000,
                   help="gRPC predict port (tf-serving :9000 contract); "
                        "-1 disables")
    p.add_argument("--batch-size", type=int, default=8,
                   help="decode slots (concurrent sequences) and the plain "
                        "predict batch")
    p.add_argument("--batch-timeout-ms", type=float, default=5.0,
                   help="dynamic batcher window for plain predicts")
    p.add_argument("--max-seq-len", type=int, default=128,
                   help="prompt length every admission is padded to")
    p.add_argument("--max-new-tokens", type=int, default=16,
                   help="per-request generation cap")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="token id ending a generation early; -1 disables")
    p.add_argument("--decode-mode", default="continuous",
                   choices=["continuous", "lockstep"],
                   help="continuous: per-request lengths decoupled + "
                        "streaming; lockstep: one prefill + decode loop "
                        "per batch")
    p.add_argument("--decode-chunk", type=int, default=1,
                   help="decode steps per scheduler round")
    p.add_argument("--prefix-cache-slots", type=int, default=0,
                   help="prefix-cache entries for reuse of shared prompt "
                        "prefixes (0 disables): pool rows on the dense "
                        "layout, refcount-shared blocks on the paged one")
    p.add_argument("--prefix-cache-min-len", type=int, default=16,
                   help="shortest prefix worth caching/matching")
    p.add_argument("--prefill-len-buckets", type=int, default=0,
                   help="power-of-two prefill length buckets below "
                        "max-seq-len (0 = pad every prompt to max-seq-len)")
    p.add_argument("--speculative-k", type=int, default=0,
                   help="draft tokens verified per decode round (0 "
                        "disables speculative decoding); greedy outputs "
                        "are unchanged")
    p.add_argument("--draft-mode", default="ngram",
                   help="speculative draft proposer: 'ngram' (host-side "
                        "prompt/output lookup) or 'model:<registry-name>' "
                        "(a draft model)")
    p.add_argument("--kv-layout", default="dense",
                   choices=["dense", "paged"],
                   help="'dense' reserves a full-length row per decode "
                        "slot; 'paged' backs requests with blocks of a "
                        "shared pool")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="tokens per KV block (paged); must divide "
                        "max-seq-len + max-new-tokens")
    p.add_argument("--kv-pool-blocks", type=int, default=0,
                   help="physical blocks in the pool (0 = batch-size "
                        "sequences at worst case)")
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"])
    p.add_argument("--kv-fused-attention", action="store_true",
                   help="read the paged cache through the paged decode "
                        "kernel instead of a gathered dense view")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="admit prompts whose suffix exceeds this many "
                        "tokens as a chain of chunks interleaved with "
                        "decode (0 disables; paged layout)")
    p.add_argument("--max-prompt-len", type=int, default=0,
                   help="longest prompt served (0 = max-seq-len; beyond "
                        "it needs --prefill-chunk-tokens)")
    p.add_argument("--serving-role", default="",
                   choices=["", "prefill", "decode"],
                   help="disaggregated role: 'prefill' exports prompt KV "
                        "over :prefill, 'decode' takes it over :import; "
                        "empty = colocated. Requires --kv-layout=paged")
    p.add_argument("--tp-shards", type=int, default=1,
                   help="tensor-parallel shards per replica (continuous "
                        "mode): >1 runs the decoder over a tp-wide "
                        "tensor mesh — weights Megatron-split, the KV "
                        "pool sharded over the KV-head axis; must "
                        "divide the model's kv heads / heads / d_ff "
                        "and the pod needs that many chips")
    p.add_argument("--cp-shards", type=int, default=1,
                   help="context-parallel shards: >1 runs each prefill "
                        "chunk's attention ring-style over a sequence "
                        "mesh axis; requires --prefill-chunk-tokens and "
                        "the paged gather path; the replica needs "
                        "tp*cp*pp devices")
    p.add_argument("--pp-stages", type=int, default=1,
                   help="pipeline-parallel decoder stages: >1 splits "
                        "the layer stack AND the KV pool's layer dim "
                        "over stages; must divide the model's n_layers; "
                        "the replica needs tp*cp*pp devices")
    p.add_argument("--host-kv-bytes", type=int, default=0,
                   help="host-RAM KV tier budget in bytes (paged layout; "
                        "0 disables): prefix evictions demote blocks "
                        "there, misses promote them back, and QoS "
                        "suspensions park live streams' KV there")
    p.add_argument("--kv-directory-size", type=int, default=0,
                   help="fleet KV economy: distinct prefix affinity keys "
                        "the prefix->holder directory tracks (paged "
                        "layout; 0 disables). Local misses probe its "
                        "hints and pull the deepest advertised prefix "
                        "from the holding peer over :kv, prefilling only "
                        "the tail")
    p.add_argument("--cold-store-ref", default="",
                   help="shared cold content-addressed KV store "
                        "('mem://<name>[?bytes=<n>]'; empty disables): "
                        "host-tier evictions demote payloads there; the "
                        "weights epoch rides the content key, so a live "
                        "push invalidates pre-swap blobs")
    p.add_argument("--kv-import-crossover-tokens", type=int, default=0,
                   help="minimum prefill tokens a peer or cold import "
                        "must save over the best local tier; 0 imports "
                        "any strictly deeper match")
    p.add_argument("--qos-tenants", default="",
                   help="QoS tenants: 'name=weight[:rate[:burst"
                        "[:priority]]]' comma-separated (empty disables); "
                        "requests carry X-Tenant/X-Priority/X-Deadline-Ms, "
                        "an over-rate tenant gets 429 + Retry-After")
    p.add_argument("--qos-aging-s", type=float, default=30.0,
                   help="seconds of queue wait worth one priority point "
                        "(<= 0 disables aging)")
    p.add_argument("--weight-peers", default="",
                   help="comma-separated host:port donors to pull the "
                        "boot weights from over :pull (tried in order, "
                        "then --model-path, then the init)")
    p.add_argument("--weight-pull-timeout-s", type=float, default=30.0,
                   help="per-donor budget for the boot-time weight pull")
    p.add_argument("--stream-timeout-s", type=float, default=60.0)
    p.add_argument("--dtype", default="",
                   choices=["", "bfloat16", "float32"],
                   help="compute dtype override; empty keeps the preset's")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (raises without a CUDA device) or 'cpu'")
    # Metrics are always served at /monitoring/prometheus/metrics; the
    # flag keeps the serving manifest's args valid, as in JAX.
    p.add_argument("--enable-prometheus", action="store_true")
    for arg in sys.argv[1:] if argv is None else argv:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            p.error(f"{flag} is not yet ported to the PyTorch package")
    args = p.parse_args(argv)
    continuous = args.decode_mode == "continuous"
    if args.eos_id >= 0 and not continuous:
        # Only the continuous decoder stops early; lockstep would return
        # post-EOS tokens.
        p.error("--eos-id requires --decode-mode=continuous")
    if args.prefix_cache_slots > 0 and not continuous:
        p.error("--prefix-cache-slots requires --decode-mode=continuous")
    if args.speculative_k > 0 and not continuous:
        # Verification rides the continuous decode state.
        p.error("--speculative-k requires --decode-mode=continuous")
    if not (args.draft_mode == "ngram"
            or args.draft_mode.startswith("model:")):
        p.error("--draft-mode must be 'ngram' or 'model:<name>'")
    if args.kv_dtype != "fp" and args.kv_layout != "paged":
        p.error("--kv-dtype=int8 requires --kv-layout=paged")
    if args.kv_fused_attention and args.kv_layout != "paged":
        p.error("--kv-fused-attention requires --kv-layout=paged")
    if args.serving_role and args.kv_layout != "paged":
        # The handoff rides the block pool; dense rows have no blocks.
        p.error("--serving-role requires --kv-layout=paged")
    if args.tp_shards < 1:
        p.error("--tp-shards must be >= 1")
    if args.cp_shards < 1:
        p.error("--cp-shards must be >= 1")
    if args.pp_stages < 1:
        p.error("--pp-stages must be >= 1")
    if args.prefill_chunk_tokens < 0:
        p.error("--prefill-chunk-tokens must be >= 0")
    if args.max_prompt_len < 0:
        p.error("--max-prompt-len must be >= 0")
    if args.prefill_chunk_tokens and args.kv_layout != "paged":
        # Chunks write through the block table; dense rows have none.
        p.error("--prefill-chunk-tokens requires --kv-layout=paged")
    if (args.max_prompt_len > args.max_seq_len
            and not args.prefill_chunk_tokens):
        p.error("--max-prompt-len beyond max-seq-len requires "
                "--prefill-chunk-tokens")
    if args.cp_shards > 1 and not args.prefill_chunk_tokens:
        # The sequence axis only carries chunked-prefill attention.
        p.error("--cp-shards requires --prefill-chunk-tokens")
    if args.cp_shards > 1 and args.kv_fused_attention:
        p.error("--cp-shards uses the gathered ring read; drop "
                "--kv-fused-attention")
    if args.pp_stages > 1 and args.decode_mode != "continuous":
        p.error("--pp-stages requires --decode-mode=continuous")
    if args.host_kv_bytes < 0:
        p.error("--host-kv-bytes must be >= 0")
    if args.host_kv_bytes and args.kv_layout != "paged":
        # The tier stores exported block payloads.
        p.error("--host-kv-bytes requires --kv-layout=paged")
    if args.kv_directory_size < 0:
        p.error("--kv-directory-size must be >= 0")
    if args.kv_import_crossover_tokens < 0:
        p.error("--kv-import-crossover-tokens must be >= 0")
    if ((args.kv_directory_size or args.cold_store_ref)
            and args.kv_layout != "paged"):
        # Imports land through the paged scatter; dense rows have no
        # block pool to install a pulled prefix into.
        p.error("--kv-directory-size/--cold-store-ref require "
                "--kv-layout=paged")
    if args.cold_store_ref:
        try:
            cold_store_from_ref(args.cold_store_ref)
        except ValueError as e:
            # A mistyped store URL fails at flag parsing, not by serving
            # without its cold tier.
            p.error(f"--cold-store-ref: {e}")
    if args.qos_tenants:
        if not continuous:
            # QoS ordering lives in the continuous decoder's queue.
            p.error("--qos-tenants requires --decode-mode=continuous")
        try:
            parse_tenants(args.qos_tenants)
        except ValueError as e:
            p.error(f"--qos-tenants: {e}")
    if args.tp_shards > 1 and not continuous:
        # Only the continuous decoder shards; ignoring the flag would
        # report one shard's numbers as model-parallel ones.
        p.error("--tp-shards requires --decode-mode=continuous")
    replica = args.tp_shards * args.cp_shards * args.pp_stages
    if replica > 1 and args.device != "cpu":
        try:
            serving_mesh(args.tp_shards, cp=args.cp_shards,
                         pp=args.pp_stages)
        except ValueError as e:
            p.error(f"--tp-shards: {e}" if args.tp_shards > 1 else str(e))
    if args.kv_layout == "paged":
        if not continuous:
            p.error("--kv-layout=paged requires --decode-mode=continuous")
        if args.kv_block_size <= 0:
            p.error("--kv-block-size must be positive")
        total = ((args.max_prompt_len or args.max_seq_len)
                 + args.max_new_tokens)
        if total % args.kv_block_size:
            p.error(f"--kv-block-size {args.kv_block_size} must divide "
                    f"max-prompt-len + max-new-tokens = {total}")
    if args.grpc_port >= 0 and not _grpc_importable():
        p.error("gRPC (:9000 by default) needs the grpcio package, which "
                "cannot be imported here; pass --grpc-port -1 to serve "
                "REST only")

    server = ModelServer(
        EngineConfig(
            model=args.model_name,
            checkpoint_dir=args.model_path or None,
            batch_size=args.batch_size,
            max_seq_len=args.max_seq_len,
            max_new_tokens=args.max_new_tokens,
            top_k=args.top_k,
            eos_id=None if args.eos_id < 0 else args.eos_id,
            decode_mode=args.decode_mode,
            decode_chunk=args.decode_chunk,
            prefix_cache_slots=args.prefix_cache_slots,
            prefix_cache_min_len=args.prefix_cache_min_len,
            prefill_len_buckets=args.prefill_len_buckets,
            speculative_k=args.speculative_k,
            draft_mode=args.draft_mode,
            kv_layout=args.kv_layout,
            kv_block_size=args.kv_block_size,
            kv_pool_blocks=args.kv_pool_blocks,
            kv_dtype=args.kv_dtype,
            kv_fused=args.kv_fused_attention,
            stream_timeout_s=args.stream_timeout_s,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            max_prompt_len=args.max_prompt_len,
            serving_role=args.serving_role,
            tp_shards=args.tp_shards,
            cp_shards=args.cp_shards,
            pp_stages=args.pp_stages,
            host_kv_bytes=args.host_kv_bytes,
            kv_directory_size=args.kv_directory_size,
            cold_store_ref=args.cold_store_ref,
            kv_import_crossover_tokens=args.kv_import_crossover_tokens,
            qos_tenants=args.qos_tenants,
            qos_aging_s=args.qos_aging_s,
            weight_peers=args.weight_peers,
            weight_pull_timeout_s=args.weight_pull_timeout_s,
            dtype=args.dtype,
            device=args.device,
        ),
        port=args.rest_port,
        grpc_port=None if args.grpc_port < 0 else args.grpc_port,
        batch_timeout_ms=args.batch_timeout_ms,
    )
    print(f"serving {args.model_name} on REST :{args.rest_port} "
          f"gRPC :{args.grpc_port} ({server.engine.device})", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
