#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card.
It builds the port's kernels from the checkout's sources (one ``nvcc``
per CUDA source, all at once, beside Triton's first compile), holds each
against its plain PyTorch version at the shapes its main paths give it,
serves ``llama-1b`` at full width through the port's REST ``ModelServer``
and its CLI (the paged KV cache read by the paged decode kernel, with
the paged prefix path, chunked prefill and speculative decoding; the
default dense server, whose plain predicts run the flash forward kernel,
and its metrics, request ids and gRPC; the host KV tier, QoS with
suspension, the prefill/decode handoff and live weight pushes), trains
``flagship-1b`` and ``flagship-deep`` at full width (and depth) through
the port's training loop with attention in the flash kernels, serves and
trains the other families (``moe-1b``, ``bert-base``, ``resnet50``) at
full size, trains over ``torch.distributed`` (the mesh path over NCCL, a
gang of two over gloo, the allreduce and DDP workloads), runs tensor
parallelism (a llama-1b replica of two shards on the card, a tensor gang
of two training flagship-1b), the sequence and pipeline axes (a cp=2
ring and two pipeline stages serving llama-1b, gangs of two training
flagship-1b over sequence and flagship-deep over pipeline), elastic
training (a gang that shrinks and grows while flagship-1b trains) and the
job entry points (the health probe, the ResNet workload, batch predict),
the decoder fleet with its KV economy, the remote actor fleet and the RL
learner on the fleet, and checks the output. Phases, each printed as one JSON line:

(a) the card and the kernels' build times;
(b) the paged decode kernel against ``_paged_decode_plain`` at the main
    path's shape (bf16, f32 and int8 pools; sentinel table entries, a
    parked row, a row with pos < 0), at the chunked path's shape (bf16,
    8 rows of 114 columns, one parked, one with pos < 0), at moe-1b's
    serving shape (bf16 and int8: Hkv 4, G 4, hd 64, the main path's
    rows and columns) and at two
    kernel-only bf16 shapes (one row of 4096 positions; 32 rows of
    2048), tolerance 2e-3: both
    compute in float32 and differ only in the order of the sums. ``ms``
    is the kernel's device time (``torch.profiler`` durations, L2
    flushed before each launch), ``call_ms`` the time of the Python call
    around it, beside the bound and its share;
(c) the RMSNorm Triton kernel against ``_rms_norm_plain``, bf16, within
    one bf16 ulp; ``ms`` device time, ``call_ms`` the call's;
(d) the main path: HTTP requests of mixed lengths, one streamed; every
    request gets its token count and the paged decode kernel launches
    exactly ``n_layers`` times per decode forward;
(e) the same requests at float32 with the fused read on and off: the
    greedy tokens must be identical;
(g) the flash attention kernels (forward; backward from one output
    cotangent) against ``_flash_fwd_plain`` / ``_flash_bwd_plain`` on the
    same inputs: the training shape (B=4, T=S=2048, Hq=32, Hkv=4, D=128,
    causal) in bf16 and f32, non-causal with a kv mask that masks a whole
    batch row, a ragged T=S=1000, D=64, G=1, and the ``"pallas"`` name
    beside ``"splash"``. f32 runs the CUDA-core route, which differs from
    the plain versions only in the order of its f32 sums: out and lse
    1e-4, gradients 1e-4 of the largest reference gradient and a
    difference whose norm is within 1e-5 of the reference's. bf16 runs
    the tensor-core route, which rounds P (before P.V and dV) and dS
    (before dQ and dK) to bf16, as SDPA's flash kernels do, where the
    plain versions keep them in f32; so its limits stand on SDPA's own
    error against the same reference on the same inputs, printed beside
    the kernels': out max(1e-2, 2 x SDPA's), lse 1e-4, gradients 2e-2 of
    the largest reference gradient and a difference whose norm is within
    max(2^-8, 2 x SDPA's) of the reference's, so an error of a few
    percent on typical gradients fails even where the largest one hides
    it. Times at the training shape beside the plain versions, the
    bound, ``F.scaled_dot_product_attention`` (forward, and backward
    alone), a yardstick the port never calls, and the f32 CUDA-core
    route on the same values. Then the same kernels at three models'
    attention (``phase_model_flash``), bf16 and f32 under the same
    limits, each through the implementation its model names:
    flagship-deep's training shape (B 4, T=S=2048, Hq 24 over Hkv 4:
    group 6, D 128, causal); BERT's (non-causal over a key-padding mask
    whose row 0 masks every key, hd 64, G 1, 12 heads; B 32 x T 128 and
    B 8 x T 512); moe-1b's (Hq 16 over Hkv 4: group 4, hd 64, causal;
    its training shape B 4 x T 2048 and its plain predict's B 8 x T
    256). At each model's first shape in bf16: the device time of the
    forward and the backward, the call time, the plain versions', SDPA's
    on the same mask (call and device) and the bound of the pairs
    attended;
(h) the training main path: ``train.loop.run`` at ``flagship-1b``, batch
    4 x seq 2048, adafactor with a 2-step warmup, bf16, 8 steps; losses
    and gradient norms finite, the first loss near ln(vocab), and each
    flash kernel launched exactly n_layers times a step; tokens/s and
    MFU (``bench.py``'s formula against 989 TFLOP/s) over the whole
    window of steps 2-8, and the median step time beside them;
(i) float32 parity: ``flagship-1b`` at full width in f32, batch 1 x seq
    1024, 3 train steps with ``attn_impl="splash"`` (the kernels) and
    ``"xla"`` (plain): losses and gradient norms within 1e-5 relative,
    parameters within 1e-5 of each leaf's largest magnitude;
(j) the flash forward kernel at the plain predict's shape (llama-1b over
    the server batch: B=8, T=S=256, Hq=16, Hkv=8, D=128, causal, no kv
    mask) against ``_flash_fwd_plain``, under (g)'s limits: bf16 out
    within max(1e-2, 2 x SDPA's error), lse 1e-4; f32 1e-4. Device time
    (``device_ms``), the call's time, the plain version's, SDPA's and the
    bound;
(k) the default server: ``ModelServer`` with the JAX package's defaults
    (dense KV layout, continuous decode) at llama-1b, bf16: (d)'s six
    requests over HTTP, one streamed, each with its token count (no
    paged or flash kernel launches: the dense decode reads the cache
    with einsums, as JAX does); a plain predict of 8 instances returns
    ``next_token`` and ``logits`` and launches the flash forward exactly
    ``n_layers`` times (one batch), timed over HTTP and through the
    engine alone (call and device time); a ``decode_mode="lockstep"``
    server answers the six requests; a request sharing a primed prefix
    (``prefix_cache_slots=2``) records a prefix hit. Decode tokens/s and
    streamed TTFT beside (d)'s paged numbers;
(l) float32 parity of the layouts: (e)'s requests, one at a time,
    greedy, through the dense continuous decoder, a lockstep server and
    a prefix-cached dense server (cold, then warm) must give the tokens
    of (e)'s paged runs; the plain predict of the six prompts (one
    batch, n_layers flash launches on the CUDA-core route) must give
    each request's first token as ``next_token``, and logits within 1e-4
    of the dense decoder's prefill logits;
(m) the default server's surfaces: after (k)'s requests its
    ``/monitoring/prometheus/metrics`` must count exactly the tokens
    they got (``serving_tokens_emitted_total``) and the requests sent
    (``serving_requests_admitted_total``), every response must echo its
    ``X-Request-ID``, and ``/debug/requests?id=`` must return each
    closed timeline. Then ``grpc_available`` (``import grpc`` here) and
    the CLI as a user starts it (logs under ``chiprun_out/``): with
    grpcio, the default flags serve gRPC :9000 and a ``Predict`` body
    equals the REST body; without it, the default flags exit 2 naming
    ``--grpc-port -1``. Beside it the CLI with ``--kv-layout paged
    --kv-fused-attention --prefix-cache-slots 4 --prefill-chunk-tokens
    128 --max-prompt-len 1792 --grpc-port -1`` answers a 1500-token
    prompt and a prefix hit, ``--speculative-k 4 --kv-layout paged
    --grpc-port -1`` answers a request, ``--host-kv-bytes 67108864
    --qos-tenants gold=8:0:0:10,free=1 --serving-role decode`` (paged,
    fused, prefix cache) answers a tenant's request and its exposition
    shows QoS, the tier's budget and the role, and ``--speculative-k 2
    --decode-mode lockstep`` exits 2, and ``--tp-shards 2`` exits 2
    naming the devices (one card; (x) places two shards on it);
(n) the paged prefix path, llama-1b, bf16, ``kv_fused``, 8 slots,
    ``max_seq_len`` 256, ``max_new_tokens`` 32, Bs 16,
    ``prefix_cache_slots`` 4: a primed 160-token system prompt (10
    whole blocks) shared by four streamed requests (suffixes of 8-64),
    then two requests sharing 168 tokens (one copy-on-write); shared
    blocks, copies and hits counted, the paged decode kernel launched
    exactly n_layers times per decode forward; streamed TTFT warm beside
    the same requests cold (no prefix cache), each from the second of
    two passes on fresh servers;
(o) chunked prefill, llama-1b, bf16, ``kv_fused``, ``max_seq_len`` 256,
    ``prefill_chunk_tokens`` 128, ``max_prompt_len`` 1792 (+32 = 114
    blocks): a 1500-token prompt admitted as a chain of 12 chunks while
    two short requests stream; the short streams' largest inter-token
    gap during the chain, one chunk's mean time, the long request's
    TTFT, the paged kernel's launches against the decode forwards; the
    span read of one chunk ([1, 128, 16, 128] over 114 blocks) per
    layer: the grouped walk, the one-block walk and the gathered read
    beside the bound; a 1793-token prompt answers 413;
(p) float32 parity, greedy, one request at a time: (n)'s requests
    through decoders sharing one set of weights, prefix warm (primed) =
    cold = fused = gathered, and (o)'s long prompt chunked (fused: the
    paged kernel at 8 rows of 114 columns) = monolithic (a decoder with
    ``max_seq_len`` 1792, no chunking, the gathered plain read), and the
    fused monolithic decoder = the gathered one;
(q) speculation, llama-1b, bf16, 8 slots, ``max_seq_len`` 256,
    ``max_new_tokens`` 64, paged, Bs 16, ``kv_fused``: (d)'s six requests
    and four prompts of a short pattern repeated to 64-128 tokens, all at
    once over HTTP, on a server with ``speculative_k`` 0 and one with 4
    (n-gram drafts), alternating (off, on, on, off) after a
    warm-up each; decode tokens/s as median and spread of each side, the
    ``serving_spec_*`` counters from the exposition and ``spec_draft_k``,
    the tokens a verify round emits, the ``serving_dispatch_seconds``
    means by kind, and the paged kernel's launches = n_layers x the
    forwards that read through it (every decode forward and each
    verify's commit pass; the scoring pass walks the span) in every run.
    Then one run on the dense default server with the draft model
    ``model:llama-1b`` (acceptance, draft dispatches), beside one without
    speculation, each after a warm-up. Then the gates,
    float32, greedy, the ten requests one at a time (at most 32 new
    tokens each, ``SPEC_GATE_NEW``): speculation on
    equals off token for token on paged fused, paged gathered, dense,
    dense with ``model:llama-1b`` and paged fused with ``chunk_size`` 2
    (``verify_chunk``);
(s) the single-replica serving features, llama-1b at full width and
    depth, bf16, 8 slots, paged, ``kv_fused``, through ``ModelServer``
    over HTTP. The host tier on an fp pool and an int8 one (24 blocks, a
    64 MiB tier): a primed 160-token prefix hit in HBM, eight requests
    that fill the pool so the cached prefixes demote, a hit on the
    demoted prefix (promoted back), a cold admission: the streamed TTFT
    of each, ``kv_host_demotions``/``promotions``/``tier_bytes``, and the
    demote and promote ms per block (export to pageable host memory,
    import from it, 10 blocks). Suspension: tenants gold (priority 10)
    and free (0), a pool of 18 blocks; a free 64-token stream decoding
    when a gold 200-token request arrives is suspended to the tier and
    resumes after it (``kv_suspends``, ``kv_resumes``, park-to-resume ms
    from its timeline). The handoff: a ``role="prefill"`` server pushes a
    200-token prompt's KV to a ``role="decode"`` one over ``:prefill``
    with ``handoff_to``, whose predict hits it; the envelope's bytes and
    the export, pack, unpack and import ms (a live push over HTTP runs
    in (bb4)). Then the port's trainer writes a llama-1b checkpoint (one step, default
    optimizer) and the CLI boots from it with ``--model-path``. The
    paged kernel launches n_layers times per decode forward in every
    run. The f32 gates (greedy, fused and gathered read each): a
    host-tier hit = an HBM hit of the primed prefix (fp, int8) and = a
    cold admission (fp); a suspended and resumed stream = the stream
    never suspended; decode after a handoff = colocated; admissions
    after a push = a decoder cold-started on the pushed weights;
(r) flagship-deep (its flash shape is checked in (g)) at full width
    and depth (16 layers, d 3072, 1.53B parameters) through
    ``train.loop.run``, batch 4 x seq 2048, bf16 on f32 masters,
    adafactor with ``grad_dtype="bfloat16"``, synthetic tokens, 4 steps
    under remat ``"llm"``, ``"llm_res"`` and off: tokens/s, the median
    step, MFU and the peak of allocated memory, and each flash kernel
    launched exactly 16 x 8 times backward and 16 x 8 x 2 forward where
    the backward recomputes it ("llm"), 16 x 8 otherwise; then the f32
    gates at reduced depth: every remat policy and ``scan_group_size`` 2
    against remat off (3 steps, 2 layers, batch 1 x seq 512: losses,
    gradient norms and parameters within 1e-5, and bit for bit or not
    printed), ``loss_chunks`` 8 against the unchunked loss (1e-5), a run
    of 4 steps resumed from its checkpoint to 8 against a straight run of
    8, on synthetic tokens and on a token file the script writes (1 layer;
    bit for bit, every leaf of the final checkpoints), and a
    ``profile_dir`` run whose Chrome trace must name the flash kernels;
    the work files go under ``build/chip_smoke/`` and are removed;
(t) mixture of experts, ``moe-1b`` at full width and depth (8 layers,
    d 1024, 16/4 heads, 8 experts, top-2; 791M parameters), bf16, seed-0
    weights: (d)'s six requests over HTTP on a paged fused server (the
    paged kernel n_layers times a decode forward, at hd 64, Hkv 4, G 4)
    and on the dense default server, with tokens/s and the streamed
    TTFT; a plain predict of 8 on the dense server (n_layers flash
    forwards); one paged fused decode step of 8 rows through
    ``models/decode.py``: its CUDA launches, device ms and step ms; 8
    training steps at batch 4 x 2048 through ``train.loop.run``
    (adafactor, the preset's remat ``"dots"``: each flash forward twice a
    step): samples/s, tokens/s, MFU by the parameters a token uses, the
    router aux loss of each step and peak memory; the f32 gates at 2
    layers: greedy tokens of prompts of at most 80 tokens, one at a
    time, equal on the paged fused and gathered reads, the dense layout
    and lockstep ``generate`` (at these shapes no expert overflows on any
    path, so the paths compute one function), and three train steps
    with the kernels = the plain path within 1e-5;
(u) BERT, ``bert-base``, bf16: a plain predict of 8 instances of mixed
    lengths up to 128 over REST and over gRPC (the bodies equal; 12
    flash forwards for the batch; no decoder), the batch through the
    engine alone (call and device ms); 8 MLM training steps at batch 32 x
    128 (adafactor); the f32 gate on one padded batch: the card's
    sequence output and ``pooled`` within 1e-5 of a float64 forward on
    the host (``bert_forward_f64``; the host's f32 plain path's error
    against it printed beside), the loss within 1e-5 and gradients 1e-4
    of each leaf's largest of the CPU's plain versions, and a row alone =
    the same row padded in a batch, within 1e-5;
(v) ResNet, ``resnet50``, bf16: a plain predict of 8 random 224x224
    images over REST (probabilities and classes); 8 training steps at
    batch 32 with tf_cnn.py's defaults: samples/s; the gate: after one f32
    train step every batch norm's running statistics equal a plain
    PyTorch recomputation (``plain_bn_stats``) within 1e-5. No kernel runs
    here: the JAX package computes ResNet without a Pallas kernel;
(w) training over ``torch.distributed`` (``phase_mesh``): (w1) in a
    process group of one rank over NCCL, ``train.loop.run`` at
    flagship-1b, 4 x 2048, bf16, adafactor, 8 steps with ``mesh={"data":
    1, "fsdp": 1}`` (each flash kernel n_layers times a step; the bytes
    through the collectives' all-reduce, at least the f32 gradients a
    step, and the all-reduce ops in a profiled step show the mesh path
    ran), its tokens/s, MFU and
    median step beside (h)'s, the NCCL kernels' device ms a step (a
    profiled 4-step run), psum / all_gather / reduce_scatter
    at world size 1 on 64 MiB, and the f32 gate at 2 layers: the mesh
    step = the no-mesh step within 1e-6; (w2) a gang of two processes on
    the card over gloo (NCCL refuses two ranks on one GPU; which gloo
    collectives take CUDA tensors is printed), flagship-1b at 1 layer,
    f32, 1 x 1024 a rank, 3 steps at data=2 and lr 1e-2, equal to one
    process on both rows within the f32 tolerances of
    tests/test_torch_train.py (every matrix moves by more than 10x the
    parameter tolerance), its step
    time labelled gloo through the host; (w3) the allreduce smoke test and
    bandwidth benchmark as a user runs them (alone: NCCL at world size 1,
    whose bus bandwidth reads 0 by the ring formula); (w4) the DDP
    workload on cuda:0, 10 steps;
(x) tensor parallelism (``phase_tensor_parallel``): (x1) llama-1b at
    full width and depth, bf16, paged fused, (d)'s requests over HTTP on
    a server of two shards on the card (``tp_devices`` cuda:0 twice)
    beside a server of one: tokens/s, streamed TTFT, the paged kernel's
    launches (2 x 16 x the decode forwards), the exposition's
    ``serving_tp_shards`` and per-shard KV bytes (half the unsharded);
    the paged kernel at a shard's shape (B 8, Hkv 4, G 2, hd 128; bf16,
    f32, int8) against the plain version within 2e-3; the f32 gates at 2
    layers: tp=2 = tp=1 token for token on paged fused and gathered,
    dense, chunked prefill and speculation (``speculative_k`` 2), each
    request's last logits within 1e-5 relative, and a handoff exported
    at tp=2 decodes at tp=1 as a colocated replica does; (x2) a gang of
    two tensor ranks on the card over gloo (``GANG_WORKER``): flagship-1b
    at full width and depth, bf16, adafactor, 1 x 2048 rows on both
    ranks, 2 steps: each step's time, the collectives' calls and bytes a
    step, the flash kernels' launches (3 x 2 each a rank) and their names
    in each rank's profiled step; the flash kernels at a rank's shape (B
    1, T 2048, Hq 16 over Hkv 2, hd 128) against the plain versions under
    (g)'s limits; the f32 gate at 2 layers, 3 steps at lr 1e-2: losses
    and gradient norms within 1e-5 relative of one process (a gradient
    tp x too large moves the norm), parameters within 1e-4 relative +
    1e-5, every matrix moved over 10x that limit. The kernel checks at a
    shard's and a rank's shapes run at the start, after (g)
    (``tp_kernel_checks``), and are printed with (x);
(y) the mixture of experts over the mesh axes (``phase_moe_mesh``): (y1)
    moe-1b at full width and depth, bf16, paged fused, (d)'s requests
    over HTTP on a server of two shards on the card beside one (every
    expert on each shard, its d_ff columns): tokens/s, streamed TTFT,
    paged launches (2 x 8 x the decode forwards), ``serving_tp_shards``
    and per-shard KV bytes; the paged kernel at a shard's shape (B 8, Hkv
    2, G 4, hd 64; bf16, f32, int8) within 2e-3; (x1)'s f32 gates on
    moe-1b at 2 layers; (y2) moe-1b at full width and depth in gloo gangs
    of two on the card (``GANG_WORKER``) over ``{"tensor": 2}`` and
    ``{"expert": 2}``, 1 x 2048 rows a rank, 2 steps: each step's time,
    the collectives' calls and bytes a step, the flash kernels' launches
    and their names in each rank's profiled step; the flash pair at a
    tensor rank's shape (B 1, T 2048, Hq 8 over Hkv 2, hd 64) and at an
    expert rank's (B 1, T 2048, Hq 16 over Hkv 4, hd 64) against the
    plain versions under (g)'s limits; (y3) the f32 gates at 2 layers and
    capacity factor 0.5 (experts overflow), those two gangs and a
    ``{"data": 2}`` gang (a row a rank) against one process on the global
    batch: losses, ``router_aux_loss`` and gradient norms within 1e-6
    relative, parameters within 1e-4 relative + 1e-5, every matrix moved
    over 10x that limit, the choices dropped past capacity above 0 (data)
    and equal to one process's (global capacity, not a rank's); (y4)
    bert-base over ``{"tensor": 2}``, 4 MLM steps at 32 x 128 bf16 and the
    f32 gate at 2 layers (sgd at lr 1, 1e-5); the flash pair at its
    tensor rank's shape (B 32, T 128, 6 heads, hd 64, masked) under (g)'s
    limits. The kernel checks run at the start with (x)'s. One card cannot show NCCL
    across cards: the gangs' collectives go through the host;
(z) the sequence and pipeline axes (``phase_long_axes``): (z1) llama-1b,
    bf16, paged, gathered, chunks of 128: (o)'s 1500-token prompt while
    two streams decode on a server whose chunk dispatches fold their span
    read through a ring of two shards on the card, beside one (one
    chunk's ms, the long TTFT, ``serving_cp_shards``); the ring's span
    read at the chunk's shape against the gathered read, f32 within 1e-5
    and bf16 within 3e-2; f32 gates at 2 layers: cp 2 and cp 2 x tp 2 =
    cp 1 on a 300-token chain and a 40-token prompt; (z2) llama-1b, bf16,
    (d)'s requests on servers of two pipeline stages (8 + 8 layers) on
    the card beside one, dense and paged gathered: tokens/s, TTFT,
    ``serving_pp_stages``, the KV bytes a token a stage (half); f32 gates:
    pp 2 = pp 1 dense, paged, chunked and at pp 2 x tp 2; (z3) a gloo gang
    of two over ``{"sequence": 2}`` training flagship-1b (full width, 1
    layer) with ``context_parallel``, 1 x 2048 rows, 2 steps: step time, the ring's
    permutes and bytes a step; f32 gate at 2 layers within 1e-6; (z4) a
    gang of two over ``{"pipeline": 2}`` training flagship-deep (8 + 8
    layers), 4 x 2048 rows, 4 microbatches, remat ``"llm"``, 2 steps:
    step time, each rank's peak memory, flash launches a rank (8 x 4 x 2,
    the forward twice) named in its trace; the flash pair at a stage's
    microbatch shape (B 1, T 2048, Hq 24 over Hkv 4, hd 128; run at the
    start) under (g)'s limits; f32 gate at 2 layers within 1e-6;
(aa) elastic training and the job entry points (``phase_elastic``):
    (aa1) a gloo gang of two on cuda:0 trains flagship-1b at full width,
    1 layer, through the loop, bf16, adafactor, 1 x 2048 rows a rank,
    ``{"data": -1}``, one run of 4 steps whose injected source shrinks
    the mesh 2 -> 1 at step 1 and grows it back at step 2; each move bit
    for bit its restore reference (the move's checkpoint restored into
    the new mesh, run with no resize to the next move or the end: every
    loss and every file of the checkpoint there); the reshard's and the
    downtime's ms, the events' method, leaves and bytes, the bytes each
    rank sent and received, each rank's allocated memory before and
    after each move, its flash launches (1 layer x the steps it trained
    as a member), and the kill path's floor (the shrink's synchronous
    save, then its reference run's init, restore into the target mesh
    and first step); (aa2) f32 gates at 2 layers (flagship-1b's
    architecture, 512 wide) in a gloo gang of four on the card: shrink
    4 -> 2 and grow 2 -> 4 over dp, dp x fsdp 2 and dp x tp 2, each bit
    for bit its restore reference and within gang_run's limits of one
    process on the same rows; (aa3) ``workloads.slice_health --backend
    gloo`` in a gang of two (healthy, its all-reduce ms), ``tf_cnn
    --model resnet50 --steps 4`` (samples/s) and llama-1b's batch
    predict over 16 JSONL lines (one not JSON, one instance refused:
    their line numbers and errors, the flash forward's launches, the ms
    an instance). Checkpoints live under ``build/chip_smoke/elastic``,
    removed after;
(bb) the decoder fleet and its KV economy, the remote actor fleet and
    the RL learner (``phase_fleet``): (bb1) three llama-1b replicas, bf16,
    paged, fused, sharing a ``KvDirectory`` and a ``mem://`` cold store
    behind a ``DecoderFleet``: (n)'s 160-token system prompt primed and
    served on one, served on a second (a peer hit: the holder's
    ``export_prefix`` through the envelope codec), then pushed out of the
    first through its host tier into cold and served on the third (a
    cold hit after two stale hints): each hit's TTFT beside a cold
    prefill of the same prompt, its import's ms and bytes, its prefill
    tokens (the 16-token tail), the paged kernel n_layers times per
    decode forward, every block back after a drain; (bb2) one prefill and
    two decode replicas: three relayed prompts (``handoffs``), a
    ``broadcast_weights`` of a new tree to all three under live streams
    (each replica's place and swap ms, the peak of allocated memory, the
    largest inter-token gap during the push beside the median), a decode
    replica stopped under a stream (the 502-coded error) and the next
    submit on a survivor; (bb3) ``train.rl.run_rl`` at llama-1b: the
    learner (float32 masters, adafactor) and two actors on the card,
    batch 4, 64-token prompts, 32 new tokens, 4 steps, a push every 2:
    the result dict, the learner's flash launches (16 x 4 x 2 forward, x
    1 backward), the actors' paged launches (16 x their decode
    forwards), then the restart-per-update baseline at 2 steps of
    batch 1; (bb4) a
    ``ModelServer`` at llama-1b's width and ``F32_GATE_LAYERS`` depth
    and a dead target behind a ``RemoteActorFleet``: rollouts over
    ``:predict``, a broadcast over ``:weights`` while four streams decode
    (bytes, ms, MB/s, the swap's stall beside a decode dispatch, the
    flushed entries), a ``fetch_kv`` over ``:kv`` (envelope bytes, ms)
    and a miss (404);
    (bb5) f32 gates at 2 layers, every replica fused: streams through a
    fleet (affine, spilled, after a peer hit, after a cold hit, after a
    relay) = a plain decoder's; three replicas decoding at once = each
    alone; an envelope made stale by a push mid-pull refused and counted;
(cc) the serving scenario registry and BERT and ResNet over the sequence
    and pipeline axes (``phase_scenarios_axes``): (cc1) the port's
    ``scenarios.run_trial("decode-tps")`` at llama-1b, bf16, quick, at
    its defaults and at ``{"slots": 8, "kv_block_size": 8,
    "prefill_len_buckets": 2}``: each objective vector and ``config``,
    both drains at 0 blocks; ``synthetic-knobs`` once; (cc2) the
    ``prefix-reuse``, ``speculative`` and ``concurrency-sweep`` bench
    entries at llama-1b in f32 (full width and depth), quick: each dict,
    no ``regression`` marker, ``tokens_identical`` true; no kernel
    launches in (cc1) or (cc2) (no scenario sets ``kv_fused``, as in
    JAX); (cc3) gloo gangs of two on the card whose ranks are replicas:
    bert-base over ``{"sequence": 2}`` (32 x 128 rows on both, 2 steps,
    flash launches 12 x 2 a rank each way, named in each rank's trace)
    and resnet50 over ``{"pipeline": 2}`` (batch 32, 2 steps, no
    launch): each rank's step ms and the collectives' calls and bytes a
    step; f32 gates (BERT at 2 layers, sgd at lr 1; ResNet at two
    bottleneck blocks, sgd at lr 3, its one process over a mesh of
    itself): each rank's losses and final state equal one process on the
    same batches within 1e-5 and 1e-4 + 1e-5;
(dd) the port deployed and tuned as the platform does it
    (``phase_manifests``): (dd1) ``gpu-serving`` rendered for llama-1b
    (paged, the paged kernel, one GPU) in bf16 and in f32, each started
    as its container's own command (this interpreter for ``python``, free
    ports for the pod's 8500 and 9000): boot to ready, TTFT, tokens/s of
    six requests at once, a gRPC Predict equal to the REST body, the
    port's lint over the exposition (no violation), the paged kernel's
    launches from the exposition (``serving_kernel_launches_total``) equal
    to 16 x the decode forwards over the window, and the f32 server's
    greedy tokens equal to the same rendering's engine in this process
    with the gathered plain read; (dd2) a ``decode-tps`` Experiment
    (tpe, seed 7, 3 trials) at llama-1b through the port's
    ``ExperimentController`` on its fake apiserver: Succeeded, trial 0
    the defaults, JAX's trial seeds, drains at 0, each trial's tokens/s,
    the best and the improvement;
(f) the kernel table: each kernel's launches on the main paths, its
    error, its time, its plain version's time and its bound; the paged
    and RMSNorm rows give device time as ``ms`` and the call's as
    ``call_ms`` (the paged row also its device time at the long, busy
    and chunked shapes), the flash rows the call's at the training
    shape (hundreds of microseconds, where host time is noise) and the
    f32 CUDA-core route's (``f32_ms``); the flash rows count flagship-1b's
    and each flagship-deep run's launches (``launches_by_path``) and add
    the times at flagship-deep's shape (``deep_shape``: ``ms`` device
    time); the flash forward row adds the predict path's
    launches and its device and call times at the predict shape; the
    paged row counts its launches on (d), (n), (o), (q)'s runs with
    speculation on, (s) and (t) (``launches_by_path``) and adds the times
    at moe-1b's shape (``moe_shape``); the flash rows add (t)'s and
    (u)'s launches and the times at BERT's and moe-1b's shapes
    (``bert_shape``, ``moe_shape``), and (w1)'s (``mesh_train``); the
    paged row (x1)'s launches (``tp2_serving``: both shards') and its
    times at a shard's shape (``tp_shard_shape``), the flash rows (x2)'s
    launches on each rank and their times at a rank's shape
    (``tp_rank_shape``); the paged row (y1)'s launches
    (``moe_tp2_serving``) and its times at moe-1b's shard shape
    (``moe_tp_shard_shape``), the flash rows (y2)'s and (y4)'s launches on
    each rank and their times at moe-1b's tensor- and expert-rank shapes
    and bert-base's tensor-rank shape (``moe_tp_rank_shape``,
    ``moe_ep_rank_shape``, ``bert_tp_rank_shape``); the flash rows (z4)'s
    launches on each stage and their times at a stage's microbatch shape
    (``pp_stage_shape``); the flash rows (aa1)'s launches on each rank of
    each run (``elastic_shrink_rank0`` ...) and the forward row (aa3)'s
    batch predict's (``batch_predict``); the paged row (bb)'s launches
    (``fleet_economy``, ``fleet_churn``, ``fleet_rl_actors``,
    ``fleet_remote``) and the flash rows the RL learner's
    (``rl_learner``) and (cc3)'s BERT ranks'
    (``bert_sequence2_train_rank0``, ``_rank1``); the paged row (dd1)'s
    rendered servers' (``rendered_server_bf16``, ``_f32``).

Every ``gang_run`` is a job of one gang of two (``GANG``) kept across
them, so each of its ranks starts once.

TF32 is off throughout, so float32 products are full float32. Any
failure exits non-zero; the last line, printed only on success, is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the checkout beside it, it fails before printing any result.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

# H100 SXM, NVIDIA's data sheet (dense rates, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PAGED_TOL = 2e-3
# Flash kernels against their plain versions: {dtype: (out, lse, grads as
# a fraction of the largest reference gradient, the norm of the gradients'
# difference as a fraction of the reference's norm)}; in bf16 the out and
# norm limits are floors under twice SDPA's error (see the docstring).
FLASH_TOL = {torch.float32: (1e-4, 1e-4, 1e-4, 1e-5),
             torch.bfloat16: (1e-2, 1e-4, 2e-2, 2.0 ** -8)}
# The training shape of flagship-1b at batch 4 x seq 2048.
FLASH_MAIN = dict(b=4, t=2048, s=2048, hq=32, hkv=4, hd=128, causal=True)
PLAIN_BLOCK_K = 1024  # flagship-1b's attn_block_k, for the plain path
TRAIN_MODEL, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "flagship-1b", 4, 2048, 8
# (r): flagship-deep at full width and depth under remat "llm", "llm_res"
# and off (None); its flash shape, Hq 24 over Hkv 4 (group 6); the depth
# of the f32 gates and of the resume check.
DEEP_MODEL, DEEP_BATCH, DEEP_SEQ, DEEP_STEPS = "flagship-deep", 4, 2048, 4
DEEP_POLICIES = ("llm", "llm_res", None)
FLASH_DEEP = dict(b=4, t=2048, s=2048, hq=24, hkv=4, hd=128, causal=True)
DEEP_GATE_LAYERS, DEEP_RESUME_LAYERS = 2, 1
# (w): the depth of the mesh path's f32 gate.
W_GATE_LAYERS = 2
# (g) at bert-base's attention: 12 heads over 12 (G 1), hd 64, non-causal
# over a key-padding mask; (u)'s training batch at T 128 and a batch of 8
# at the position table's 512.
FLASH_BERT = dict(b=32, t=128, s=128, hq=12, hkv=12, hd=64, causal=False)
FLASH_BERT_LONG = dict(FLASH_BERT, b=8, t=512, s=512)
# (g) at moe-1b's attention: 16 heads over 4 (G 4), hd 64, causal; (t)'s
# training shape and its plain predict's (the server batch padded to
# MAX_SEQ).
FLASH_MOE = dict(b=4, t=2048, s=2048, hq=16, hkv=4, hd=64, causal=True)
FLASH_MOE_PREDICT = dict(FLASH_MOE, b=8, t=256, s=256)
REMAT_POLICIES = ("dots", "dots_batched", "llm", "llm_qkv", "llm_attn",
                  "llm_res", "none")

MODEL = "llama-1b"
SLOTS, MAX_SEQ, MAX_NEW, BLOCK = 8, 256, 32, 16
# The f32 decode gates of (p), (q) and (s): llama-1b's width at this
# depth (its 16 layers cut to keep the script inside its 1200 s limit;
# every path the gates compare runs at any depth).
F32_GATE_LAYERS = 2
# The plain predict's attention: llama-1b's heads over the server batch,
# padded to MAX_SEQ.
FLASH_PREDICT = dict(b=SLOTS, t=MAX_SEQ, s=MAX_SEQ, hq=16, hkv=8, hd=128,
                     causal=True)
PREDICT_LOGIT_TOL = 1e-4
# (prompt length, max_new_tokens) of the main path's requests; the third
# one is streamed.
REQUESTS = [(5, 32), (40, 16), (128, 32), (200, 24), (256, 32), (17, 8)]
STREAMED = 2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Mean time of one call of ``fn`` over ``iters`` calls, between CUDA
    events around the call, each after a write of ``flush`` (larger than
    L2) so every call finds its inputs in HBM, as a decode step finds the
    next layer's pool. For a kernel of microseconds this includes the
    host work of the call while the card waits; ``device_ms`` does not."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


# The flush's own kernel: zero_() of a uint8 tensor.
FLUSH_KERNEL = "FillFunctor<unsigned char>"


def profiled_launches(fn, flush: torch.Tensor, iters: int,
                      trace: str | None = None) -> list:
    """The CUDA kernel records ``torch.profiler`` takes over ``iters``
    calls of ``fn``, each after a write of ``flush``. The profiler drops
    records at the start of a session (on the H100 it has lost the first
    flush write, and once every launch of a kernel), so the calls run
    twice under one profiler: a warm-up step whose records are discarded,
    then the recorded step. A record counts only when it holds every
    flush write and a whole number of launches of ``fn`` a call; up to
    ten sessions are tried (on the H100 a run has lost records in five
    in a row, two of them empty), a second apart, then it raises. ``trace`` names a file for
    the kept session's Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(10):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        flushes = sum(FLUSH_KERNEL in e.name for e in events)
        own = [e for e in events if FLUSH_KERNEL not in e.name]
        if flushes == iters and own and len(own) % iters == 0:
            if trace:
                prof.export_chrome_trace(trace)
            return own
        seen.append((flushes, len(own)))
    raise AssertionError(f"the profiler kept an incomplete record in each "
                         f"session: (flush writes, other launches) {seen} "
                         f"for {iters} calls")


def device_ms(fn, flush: torch.Tensor, iters: int,
              kernel: str | None = None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after a write
    of ``flush``, from the kernel durations ``torch.profiler`` records
    (a complete session of :func:`profiled_launches`): the card's time
    alone, without the host time of the Python call (which ``time_ms``
    includes). ``kernel`` names the one kernel a call must launch; None
    sums every kernel but the flush's."""
    events = profiled_launches(fn, flush, iters)
    if kernel is not None:
        events = [e for e in events if kernel in e.name]
        if len(events) != iters:
            raise AssertionError(f"profiler saw {len(events)} launches of "
                                 f"{kernel} in {iters} calls")
    return sum(e.device_time_total for e in events) / iters / 1e3


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# (b) paged decode attention
# ---------------------------------------------------------------------------


# Kernel-only shapes of the paged kernel beside the main path's (bf16,
# llama-1b's Hkv=8, G=2, hd=128, Bs=16): one row of 4096 positions, and
# 32 rows of 2048. The chunked path's shape: 8 slots of 114 columns
# (max_prompt_len 1792 + 32), rows spread over the span, one parked at
# the table horizon and one with pos < 0.
PAGED_LONG = dict(b=1, mb=256, pos=[4095])
PAGED_BUSY = dict(b=32, mb=128, pos=[2047] * 32)
PAGED_CHUNKED = dict(b=SLOTS, mb=114,
                     pos=[1531, 1823, 1024, 700, 300, 40, 114 * BLOCK, -1])
# moe-1b's paged serving shape: Hkv 4, G 4, hd 64, the main path's slots
# and columns.
PAGED_MOE = dict(hkv=4, g=4, hd=64)


def paged_inputs(kv: str, dev, quantize, b=SLOTS,
                 mb=(MAX_SEQ + MAX_NEW) // BLOCK, pos=None, hkv=8, g=2,
                 hd=128):
    """Decode shapes, llama-1b's by default: Hkv=8, G=2, hd=128, Bs=16, a
    pool of B*MB blocks behind a permuted table. By default the main
    path's B=8 slots and MB=(256+32)/16=18 columns, with a sentinel inside
    a live span, a parked row and a row with pos < 0."""
    bs = BLOCK
    n = b * mb
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.float32 if kv == "f32" else torch.bfloat16
    q = torch.randn(b, hkv, g, hd, generator=gen, device=dev).to(dt)

    def pool():
        p = torch.randn(n, bs, hkv, hd, generator=gen, device=dev)
        return quantize(p) if kv == "int8" else p.to(dt)

    kp, vp = pool(), pool()
    table = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32).reshape(b, mb)
    smoke = pos is None
    if smoke:
        pos = [7, 40, 100, 150, 200, 287, mb * bs, -1]
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    for row in range(b):  # unallocated tails are sentinel (== N)
        p = int(pos[row])
        table[row, (p // bs + 1) if p >= 0 else 0:] = n
    if smoke:
        table[3, 0] = n  # a sentinel inside the live span clamps to N-1
    return q, kp, vp, table, pos


def paged_bound(q, kp, table, pos, kv: str) -> tuple[float, str]:
    b, hkv, g, hd = q.shape
    mb, bs = table.shape[1], (kp["q"] if kv == "int8" else kp).shape[1]
    live = sum(0 if p < 0 else min(p + 1, mb * bs) for p in pos.tolist())
    elem = {"bf16": 2, "f32": 4, "int8": 1}[kv]
    kv_bytes = 2 * live * hkv * (hd * elem + (4 if kv == "int8" else 0))
    other = (q.numel() * q.element_size() + q.numel() * 4
             + table.numel() * 4 + pos.numel() * 4)
    ops = live * hkv * g * (4 * hd + 5)  # q·k, p·v, max, exp, sum
    return bound(kv_bytes + other, ops, kv)


def paged_cases(dev, flush, cases) -> dict:
    """Each of ``cases`` ((name, kv, shape)): the paged kernel against
    ``_paged_decode_plain`` within PAGED_TOL, its device and call times,
    the bound and, at the main path's rows and columns, the plain
    version's time."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.decode import _quantize_kv
    from kubeflow_tpu_torch.ops.attention import _paged_decode_plain

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    for name, kv, shape in cases:
        q, kp, vp, table, pos = paged_inputs(kv, dev, _quantize_kv, **shape)
        scale = q.shape[-1] ** -0.5
        ref = _paged_decode_plain(q, kp, vp, table, pos, scale)
        out = kernels.paged_decode(q, kp, vp, table, pos, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"paged decode ({name}): non-finite output")
        err = (out - ref).abs().max().item()
        if err > PAGED_TOL:
            raise AssertionError(f"paged decode ({name}): max abs error "
                                 f"{err} > {PAGED_TOL}")
        if (pos < 0).any() and out[pos < 0].any():
            raise AssertionError(f"paged decode ({name}): pos < 0 row not 0")
        del ref

        def call():
            return kernels.paged_decode(q, kp, vp, table, pos, scale)

        bound_ms, bound_by = paged_bound(q, kp, table, pos, kv)
        ms = device_ms(call, flush, 50, "paged_decode_kernel")
        row = {
            "max_abs_err": err, "tolerance": PAGED_TOL, "ms": ms,
            "call_ms": time_ms(call, flush, 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
            "splits_cols": kernels.paged_splits(q.shape[0], q.shape[1],
                                                table.shape[1], sms),
            "shape": {"B": q.shape[0], "Hkv": q.shape[1], "G": q.shape[2],
                      "hd": q.shape[3], "Bs": BLOCK, "MB": table.shape[1],
                      "pos": (pos.tolist() if shape.get("b", SLOTS) < 16
                              else shape["pos"][0])},
        }
        if "b" not in shape:  # the plain version at the serving shapes
            row["plain_ms"] = time_ms(lambda: _paged_decode_plain(
                q, kp, vp, table, pos, scale), flush, 10)
        results[name] = row
        del q, kp, vp, out
    return results


def phase_paged(dev, flush) -> dict:
    cases = [(kv, kv, {}) for kv in ("bf16", "f32", "int8")]
    cases += [("long_bf16", "bf16", PAGED_LONG), ("busy_bf16", "bf16",
                                                   PAGED_BUSY),
              ("chunked_bf16", "bf16", PAGED_CHUNKED),
              ("moe_bf16", "bf16", PAGED_MOE), ("moe_int8", "int8",
                                                PAGED_MOE)]
    results = paged_cases(dev, flush, cases)
    emit("b_paged_decode", results=results)
    return results


# ---------------------------------------------------------------------------
# (c) RMSNorm
# ---------------------------------------------------------------------------


def phase_rms(dev, flush) -> dict:
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.norms import _rms_norm_plain
    from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

    d, eps = 2048, 1e-5
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.randn(d, generator=gen, device=dev)
    results = {}
    for rows in (SLOTS, SLOTS * MAX_SEQ):
        x = (3 * torch.randn(rows, d, generator=gen, device=dev)).bfloat16()
        out = rms_norm_triton(x, w, eps)
        ref = _rms_norm_plain(x, w, eps)
        ulp = (out.view(torch.int16).int()
               - ref.view(torch.int16).int()).abs().max().item()
        if ulp > 1:
            raise AssertionError(f"rms_norm [{rows}, {d}]: {ulp} bf16 ulp")
        bound_ms, bound_by = bound(2 * x.numel() * 2 + d * 4, 4 * x.numel(),
                                   "bf16")
        with warnings.catch_warnings():
            # The f32 weight keeps F.rms_norm off its fused path; it is
            # timed as it comes, on the kernel's own inputs.
            warnings.simplefilter("ignore")
            library_ms = time_ms(lambda: F.rms_norm(x, (d,), w, eps),
                                 flush, 50)
            library_device_ms = device_ms(
                lambda: F.rms_norm(x, (d,), w, eps), flush, 50)
        results[f"{rows}x{d}"] = {
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "max_ulp": ulp,
            "ms": device_ms(lambda: rms_norm_triton(x, w, eps), flush, 50,
                            "rms_kernel"),
            "call_ms": time_ms(lambda: rms_norm_triton(x, w, eps), flush,
                               50),
            "plain_ms": time_ms(lambda: _rms_norm_plain(x, w, eps), flush,
                                50),
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit("c_rms_norm", results=results)
    return results


# ---------------------------------------------------------------------------
# (d) the main path, (e) f32 fused vs gather
# ---------------------------------------------------------------------------


def request_bodies(vocab: int) -> list[dict]:
    rng = np.random.RandomState(0)
    return [{"tokens": rng.randint(0, vocab, size=n).tolist(),
             "max_new_tokens": want} for n, want in REQUESTS]


def post(port: int, body: dict, stream: bool = False, rid: str = "",
         stamps: list | None = None, headers: dict | None = None,
         model: str = MODEL):
    """One predict with ``X-Request-ID: rid`` (when given; the response
    must echo it) and ``headers``; returns (tokens, seconds to the first
    token line or to the response). ``stamps`` collects each streamed
    token line's arrival time."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", f"/v1/models/{model}:predict",
                     body=json.dumps({**({"stream": True} if stream else {}),
                                      "instances": [body]}),
                     headers={**({"X-Request-ID": rid} if rid else {}),
                              **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()!r}")
        if rid and resp.getheader("X-Request-ID") != rid:
            raise AssertionError(f"X-Request-ID {rid!r} echoed as "
                                 f"{resp.getheader('X-Request-ID')!r}")
        if not stream:
            pred = json.loads(resp.read())["predictions"][0]
            return pred["tokens"], time.perf_counter() - t0
        first, recs = None, []
        for line in resp:
            if line.strip():
                recs.append(json.loads(line))
                if stamps is not None and "token" in recs[-1]:
                    stamps.append(time.perf_counter())
                if first is None:
                    first = time.perf_counter() - t0
        if "error" in recs[-1]:
            raise AssertionError(f"stream failed: {recs[-1]}")
        toks = [r["token"] for r in recs[:-1]]
        if toks != recs[-1]["tokens"]:
            raise AssertionError("streamed tokens disagree with the summary")
        return toks, first
    finally:
        conn.close()


def get(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.status != 200:
            raise AssertionError(f"GET {path}: HTTP {resp.status}: {body}")
        return body
    finally:
        conn.close()


def predict(port: int, instances: list[dict],
            model: str = MODEL) -> list[dict]:
    """One predict of several instances; returns the predictions."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", f"/v1/models/{model}:predict",
                     body=json.dumps({"instances": instances}))
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()!r}")
        return json.loads(resp.read())["predictions"]
    finally:
        conn.close()


def engine_cfg(**kw):
    """The smoke's server: llama-1b over SLOTS slots, the paged layout
    unless ``kw`` says otherwise."""
    from kubeflow_tpu_torch.serving.engine import EngineConfig

    return EngineConfig(**{**dict(
        model=MODEL, batch_size=SLOTS, max_seq_len=MAX_SEQ,
        max_new_tokens=MAX_NEW, kv_layout="paged", kv_block_size=BLOCK,
        device="cuda"), **kw})


def drive(server) -> dict:
    """(d)'s requests over HTTP all at once after a warm request, the
    STREAMED one streamed where the server streams (a lockstep server
    does not). Launch counts are zeroed just before and read just after.
    Checks each request's token count."""
    from kubeflow_tpu_torch import kernels

    cfg = server.engine.model.config
    name = server.engine.cfg.model
    bodies = request_bodies(cfg.vocab_size)
    tag = f"{server.engine.cfg.kv_layout}-{server.engine.cfg.decode_mode}"
    rids = [f"{tag}-warm"] + [f"{tag}-{i}" for i in range(len(bodies))]
    warm = post(server.port, {"tokens": [1, 2, 3], "max_new_tokens": 2},
                rid=rids[0], model=name)
    dec = server.decoder
    streamed = STREAMED if dec is not None else None
    steps0 = dec.steps if dec is not None else 0
    results: list = [None] * len(bodies)

    def run(i):
        results[i] = post(server.port, bodies[i], stream=i == streamed,
                          rid=rids[i + 1], model=name)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    kernels.reset_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for (n, want), res in zip(REQUESTS, results):
        if res is None:
            raise AssertionError(f"request ({n} prompt tokens) did not finish")
        if len(res[0]) != want:
            raise AssertionError(f"request ({n} prompt tokens) got "
                                 f"{len(res[0])} tokens, wanted {want}")
        if not all(0 <= t < cfg.vocab_size for t in res[0]):
            raise AssertionError("token id outside the vocabulary")
    tokens = sum(len(res[0]) for res in results)
    out = {
        "model": name, "dtype": str(cfg.dtype), "slots": SLOTS,
        "max_seq_len": MAX_SEQ, "max_new_tokens": MAX_NEW,
        "kv_layout": server.engine.cfg.kv_layout,
        "decode_mode": server.engine.cfg.decode_mode,
        "requests": [{"prompt": n, "max_new_tokens": w} for n, w in REQUESTS],
        "decode_forwards": dec.steps - steps0 if dec is not None else None,
        "tokens": tokens, "wall_s": wall,
        "decode_tokens_per_s": tokens / wall, "launches": launches,
        "request_ids": rids, "requests_sent": len(rids),
        "tokens_returned": len(warm[0]) + tokens,
    }
    if streamed is not None:
        out["ttft_streamed_ms"] = 1e3 * results[streamed][1]
    return out


def phase_main_path() -> dict:
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer(engine_cfg(kv_fused=True), port=0)
    server.start()
    try:
        cfg = server.engine.model.config
        out = drive(server)
    finally:
        server.stop()
    forwards, launches = out["decode_forwards"], out["launches"]
    want_launches = cfg.n_layers * forwards
    if forwards <= 0 or launches["paged_decode_attention"] != want_launches:
        raise AssertionError(
            f"paged decode kernel launched "
            f"{launches['paged_decode_attention']} times, expected "
            f"{cfg.n_layers} layers x {forwards} decode forwards")
    emit("d_main_path", **out)
    return out


def phase_f32_parity() -> dict:
    """Greedy tokens at float32 with the fused read (the kernel) and the
    gathered read (plain PyTorch) must be identical. Requests run one at
    a time, so both runs batch alike."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.server import ModelServer

    streams = {}
    for fused in (True, False):
        server = ModelServer(engine_cfg(kv_fused=fused, dtype="float32"),
                             port=0)
        try:
            bodies = request_bodies(server.engine.model.config.vocab_size)
            kernels.reset_launches()
            streams[fused] = [server.handle_predict(
                MODEL, {"instances": [b]})["predictions"][0]["tokens"]
                for b in bodies]
            launched = kernels.LAUNCHES["paged_decode_attention"]
        finally:
            server.stop()
            del server
            torch.cuda.empty_cache()
        if (launched > 0) != fused:
            raise AssertionError(f"fused={fused}: {launched} kernel launches")
    out = compare_streams(streams[True], streams[False])
    emit("e_f32_fused_vs_gather", **out)
    if not out["identical"]:
        raise AssertionError("f32 greedy tokens differ between the fused "
                             "and the gathered read")
    return {**out, "streams": streams[True]}


def compare_streams(a: list, b: list) -> dict:
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    return {"identical": a == b, "tokens_equal": same,
            "tokens": sum(len(r) for r in a)}


# ---------------------------------------------------------------------------
# (g) flash attention kernels
# ---------------------------------------------------------------------------


def flash_inputs(dev, dtype, b, t, s, hq, hkv, hd, causal, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    return (rand(b, t, hq, hd), rand(b, s, hkv, hd), rand(b, s, hkv, hd),
            rand(b, t, hq, hd))


def flash_plain(q, k, v, kv_mask, g, causal, scale):
    """The plain versions on the kernels' layout: (out, lse [B, Hq, T],
    dq, dk, dv)."""
    from kubeflow_tpu_torch.ops import attention as A

    b, t, hq, _ = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    kvm = A._fold_mask(kv_mask, b, s_len, hkv, q.device)
    qf, kf, vf = A._fold_q(q, hkv), A._fold_kv(k), A._fold_kv(v)
    block = PLAIN_BLOCK_K
    out, lse = A._flash_fwd_plain(qf, kf, vf, kvm, causal=causal,
                                  scale=scale, block_k=block)
    dq, dk, dv = A._flash_bwd_plain(qf, kf, vf, kvm, out, lse,
                                    A._fold_q(g, hkv), causal=causal,
                                    scale=scale, block_k=block)
    return (A._unfold_q(out, b), lse.reshape(b, hq, t), A._unfold_q(dq, b),
            A._unfold_kv(dk, b), A._unfold_kv(dv, b))


def sdpa_run(q, k, v, g, kv_mask, causal):
    """``F.scaled_dot_product_attention`` and its gradients on the
    kernels' inputs and layout: K/V repeated to the query heads, the kv
    mask and the top-left causal mask as one boolean mask. SDPA leaves a
    row that attends nothing undefined (NaN, or the mean of V, by
    backend): such rows, and the gradients of masked keys, count as 0,
    as the reference has them. Returns (out, dq, dk, dv) in f32."""
    import torch.nn.functional as F

    b, t, hq, _ = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    leaves = [x.transpose(1, 2).contiguous().requires_grad_(True)
              for x in (q, k, v)]
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in leaves[1:])
    attn_mask = None
    if kv_mask is not None or (causal and t != s_len):
        allow = torch.ones(b, 1, t, s_len, dtype=torch.bool, device=q.device)
        if causal:
            allow = allow & torch.ones(t, s_len, dtype=torch.bool,
                                       device=q.device).tril()
        if kv_mask is not None:
            allow = allow & (kv_mask > 0)[:, None, None, :]
        attn_mask = allow
    out = F.scaled_dot_product_attention(
        leaves[0], kx, vx, attn_mask=attn_mask,
        is_causal=causal and attn_mask is None)
    out.backward(g.transpose(1, 2))
    res = [torch.nan_to_num(x.transpose(1, 2).float())
           for x in (out.detach(), *(x.grad for x in leaves))]
    if attn_mask is not None:
        live = attn_mask[:, 0].any(-1)[:, :, None, None]  # [B, T, 1, 1]
        res[0], res[1] = res[0] * live, res[1] * live
    if kv_mask is not None:
        keys = (kv_mask > 0)[:, :, None, None]  # [B, S, 1, 1]
        res[2], res[3] = res[2] * keys, res[3] * keys
    return res


def flash_check(case: str, impl: str, dev, dtype, kv_mask=None, **shape):
    """Kernels (through ``flash_attention`` and autograd, and the lse of
    the forward launcher) against the plain versions on the same inputs,
    with SDPA's errors against the same reference beside them in bf16;
    returns the errors and raises past the tolerances."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.ops.attention import flash_attention

    q, k, v, g = flash_inputs(dev, dtype, **shape)
    causal, scale = shape["causal"], shape["hd"] ** -0.5
    # The plain versions in f32 on the same values.
    ref = flash_plain(q.float(), k.float(), v.float(), kv_mask, g.float(),
                      causal, scale)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, kv_mask=kv_mask,
                          implementation=impl)
    out.backward(g)
    _, lse = kernels.flash_fwd(q, k, v, None if kv_mask is None
                               else kv_mask.float().contiguous(), causal,
                               scale)
    torch.cuda.synchronize()
    got = [out.detach(), lse] + [x.grad for x in leaves]
    tol_out, tol_lse, tol_grad, tol_norm = FLASH_TOL[dtype]
    sdpa_errs, sdpa_rel = {}, {}
    if dtype == torch.bfloat16:
        sdpa = sdpa_run(q, k, v, g, kv_mask, causal)
        for name, a, r in zip(("out", "dq", "dk", "dv"), sdpa,
                              (ref[0],) + ref[2:]):
            diff = a - r.float()
            sdpa_errs[name] = diff.abs().max().item()
            sdpa_rel[name] = (diff.norm() / r.float().norm()).item()
        del sdpa
        tol_out = max(tol_out, 2 * sdpa_errs["out"])
    errs, rel_norms = {}, {}
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        if not torch.isfinite(a).all():
            raise AssertionError(f"flash {case} ({impl}): non-finite {name}")
        diff = a.float() - r.float()
        err = diff.abs().max().item()
        limit = {"out": tol_out, "lse": tol_lse}.get(
            name, tol_grad * r.float().abs().max().item())
        if err > limit:
            raise AssertionError(f"flash {case} ({impl}): {name} max abs "
                                 f"error {err} > {limit}")
        errs[name] = err
        if name.startswith("d"):
            rel = (diff.norm() / r.float().norm()).item()
            limit = max(tol_norm, 2 * sdpa_rel.get(name, 0.0))
            if not rel <= limit:
                raise AssertionError(f"flash {case} ({impl}): {name} "
                                     f"relative norm error {rel} > "
                                     f"{limit}")
            rel_norms[name] = rel
    if kv_mask is not None and not kv_mask[0].any():
        if got[0][0].any() or got[2][0].any():
            raise AssertionError(f"flash {case}: the fully masked row is "
                                 "not 0")
    return {"dtype": str(dtype), **shape, "implementation": impl,
            "max_abs_err": errs, "grad_rel_norm_err": rel_norms,
            "sdpa_max_abs_err": sdpa_errs, "sdpa_grad_rel_norm_err": sdpa_rel}


def causal_pairs(t: int, s_len: int, causal: bool) -> int:
    """(query, key) pairs the attention attends: top-left causal."""
    if not causal:
        return t * s_len
    return sum(min(i + 1, s_len) for i in range(t))


def phase_flash(dev, flush) -> dict:
    import torch.nn.functional as F

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.ops import attention as A

    m = FLASH_MAIN
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(flash_check("main", "splash", dev, dtype, **m))
    cases.append(flash_check("main", "pallas", dev, torch.bfloat16, **m))
    gen = torch.Generator(device=dev).manual_seed(4)
    mask = torch.rand(2, 1024, generator=gen, device=dev) > 0.2
    mask[0] = False
    cases.append(flash_check("masked", "pallas", dev, torch.bfloat16, mask,
                             **{**m, "b": 2, "t": 1024, "s": 1024,
                                "causal": False}))
    cases.append(flash_check("masked", "splash", dev, torch.float32, mask,
                             **{**m, "b": 2, "t": 1024, "s": 1024,
                                "causal": False}))
    cases.append(flash_check("ragged", "splash", dev, torch.bfloat16,
                             **{**m, "t": 1000, "s": 1000}))
    cases.append(flash_check("hd64", "pallas", dev, torch.bfloat16,
                             **{**m, "hd": 64}))
    cases.append(flash_check("G1", "splash", dev, torch.bfloat16,
                             **{**m, "hq": 8, "hkv": 8}))
    max_err = {impl: {part: max(max(c["max_abs_err"][n] for n in names)
                                for c in cases
                                if c["implementation"] == impl)
                      for part, names in (("fwd", ("out", "lse")),
                                          ("bwd", ("dq", "dk", "dv")))}
               for impl in ("splash", "pallas")}

    # Times at the training shape, bf16, L2 flushed before each call.
    q, k, v, g = flash_inputs(dev, torch.bfloat16, **m)
    scale = m["hd"] ** -0.5
    out, lse = kernels.flash_fwd(q, k, v, None, True, scale)
    hkv = m["hkv"]
    qf, kf, vf, gf = (A._fold_q(q, hkv), A._fold_kv(k), A._fold_kv(v),
                      A._fold_q(g, hkv))
    kvm = A._fold_mask(None, m["b"], m["s"], hkv, dev)
    out_f, lse_f = A._flash_fwd_plain(qf, kf, vf, kvm, causal=True,
                                      scale=scale, block_k=PLAIN_BLOCK_K)
    # The yardstick: one PyTorch call of the same function, [B, H, T, D].
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)
    timing = {
        "fwd": {
            "ms": time_ms(lambda: kernels.flash_fwd(q, k, v, None, True,
                                                    scale), flush, 10),
            "plain_ms": time_ms(lambda: A._flash_fwd_plain(
                qf, kf, vf, kvm, causal=True, scale=scale, block_k=PLAIN_BLOCK_K),
                flush, 3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush, 10),
        },
        "bwd": {
            "ms": time_ms(lambda: kernels.flash_bwd(
                q, k, v, None, out, lse, g, True, scale), flush, 5),
            "plain_ms": time_ms(lambda: A._flash_bwd_plain(
                qf, kf, vf, kvm, out_f, lse_f, gf, causal=True, scale=scale,
                block_k=PLAIN_BLOCK_K), flush, 3),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, leaves, gt, retain_graph=True), flush, 10),
        },
    }
    # The f32 CUDA-core route on the same values, the kernels' other route.
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    out32, lse32 = kernels.flash_fwd(q32, k32, v32, None, True, scale)
    timing["fwd"]["f32_ms"] = time_ms(lambda: kernels.flash_fwd(
        q32, k32, v32, None, True, scale), flush, 3)
    timing["bwd"]["f32_ms"] = time_ms(lambda: kernels.flash_bwd(
        q32, k32, v32, None, out32, lse32, g32, True, scale), flush, 2)
    del q32, k32, v32, g32, out32, lse32
    b, t, s_len, hq, hd = m["b"], m["t"], m["s"], m["hq"], m["hd"]
    pairs = b * hq * causal_pairs(t, s_len, True)
    qo_bytes = b * t * hq * hd * 2
    kv_bytes = b * s_len * hkv * hd * 2
    lse_bytes = b * hq * t * 4
    bounds = {
        # q, k, v read; out, lse written. QK^T and PV: 4*D per pair.
        "fwd": bound(2 * qo_bytes + 2 * kv_bytes + lse_bytes,
                     4 * hd * pairs, "bf16"),
        # q, k, v, out, dout, lse read; dq, dk, dv written. QK^T
        # recompute, dP, dV, dK, dQ: 10*D per pair.
        "bwd": bound(4 * qo_bytes + 4 * kv_bytes + lse_bytes,
                     10 * hd * pairs, "bf16"),
    }
    for part, (bound_ms, bound_by) in bounds.items():
        timing[part].update(bound_ms=bound_ms, bound_by=bound_by)
    out_row = {"cases": cases, "max_abs_err": max_err, "timing": timing,
               "shape": {**m, "dtype": "bf16"}}
    emit("g_flash_attention", **out_row)
    del leaves, sdpa_out
    return out_row


def phase_model_flash(dev, flush, case: str, impl, shapes: tuple,
                      masked: bool = False, iters: tuple = (10, 5)) -> dict:
    """(g) at one model's attention: the flash kernels (through
    ``implementation=impl``, as the model calls them) against the plain
    versions under (g)'s limits, bf16 (the tensor cores) and f32 (the CUDA
    cores), at each of ``shapes``; where ``masked``, over a random
    key-padding mask whose row 0 masks every key (which must give 0). At
    the first shape in bf16: the device time of the forward and of the
    backward's kernels, the call time, the plain versions', SDPA's on the
    same mask (forward, and backward alone; call and device) and the
    bound, as (g) counts it, over the pairs attended: every query of a row
    against the row's live keys, or the causal pairs."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.ops import attention as A

    cases = []
    for shape in shapes:
        mask = bert_mask(dev, shape["b"], shape["s"]) if masked else None
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(flash_check(case, impl, dev, dtype, mask, **shape))
    m = shapes[0]
    causal, scale, hkv = m["causal"], m["hd"] ** -0.5, m["hkv"]
    mask = bert_mask(dev, m["b"], m["s"]) if masked else None
    maskf = None if mask is None else mask.float()
    q, k, v, g = flash_inputs(dev, torch.bfloat16, **m)
    out, lse = kernels.flash_fwd(q, k, v, maskf, causal, scale)
    qf, kf, vf, gf = (A._fold_q(q, hkv), A._fold_kv(k), A._fold_kv(v),
                      A._fold_q(g, hkv))
    kvm = A._fold_mask(maskf, m["b"], m["s"], hkv, dev)
    out_f, lse_f = A._flash_fwd_plain(qf, kf, vf, kvm, causal=causal,
                                      scale=scale, block_k=PLAIN_BLOCK_K)
    # The yardstick: one PyTorch call of the same function, [B, H, T, D].
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    sdpa_kw = ({"attn_mask": mask[:, None, None, :]} if masked
               else {"is_causal": causal})
    if m["hq"] != hkv:
        sdpa_kw["enable_gqa"] = True
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)

    def fwd():
        return kernels.flash_fwd(q, k, v, maskf, causal, scale)

    def bwd():
        return kernels.flash_bwd(q, k, v, maskf, out, lse, g, causal, scale)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, leaves, gt, retain_graph=True)

    timing = {
        "fwd": {"ms": device_ms(fwd, flush, iters[0], "flash_fwd_tc_kernel"),
                "call_ms": time_ms(fwd, flush, iters[0]),
                "plain_ms": time_ms(lambda: A._flash_fwd_plain(
                    qf, kf, vf, kvm, causal=causal, scale=scale,
                    block_k=PLAIN_BLOCK_K), flush, 3),
                "library_ms": time_ms(sdpa_fwd, flush, iters[0]),
                "library_device_ms": device_ms(sdpa_fwd, flush, iters[0])},
        "bwd": {"ms": device_ms(bwd, flush, iters[1]),
                "call_ms": time_ms(bwd, flush, iters[1]),
                "plain_ms": time_ms(lambda: A._flash_bwd_plain(
                    qf, kf, vf, kvm, out_f, lse_f, gf, causal=causal,
                    scale=scale, block_k=PLAIN_BLOCK_K), flush, 3),
                "library_ms": time_ms(sdpa_bwd, flush, iters[1]),
                "library_device_ms": device_ms(sdpa_bwd, flush, iters[1])},
    }
    if masked:
        pairs = m["hq"] * m["t"] * int(mask.sum())
    else:
        pairs = m["b"] * m["hq"] * causal_pairs(m["t"], m["s"], causal)
    qo_bytes, kv_bytes = q.numel() * 2, k.numel() * 2
    side_bytes = lse.numel() * 4 + (0 if maskf is None else maskf.numel() * 4)
    for part, (bytes_moved, ops) in {
            # q, k, v (and the mask) read; out, lse written. QK^T and PV:
            # 4*D a pair.
            "fwd": (2 * qo_bytes + 2 * kv_bytes + side_bytes,
                    4 * m["hd"] * pairs),
            # q, k, v, out, dout, lse read; dq, dk, dv written. QK^T
            # recompute, dP, dV, dK, dQ: 10*D a pair.
            "bwd": (4 * qo_bytes + 4 * kv_bytes + side_bytes,
                    10 * m["hd"] * pairs)}.items():
        bound_ms, bound_by = bound(bytes_moved, ops, "bf16")
        timing[part].update(bound_ms=bound_ms, bound_by=bound_by)
    max_err = {part: max(max(c["max_abs_err"][n] for n in names)
                         for c in cases)
               for part, names in (("fwd", ("out", "lse")),
                                   ("bwd", ("dq", "dk", "dv")))}
    shape = {**m, "dtype": "bf16"}
    if masked:
        shape["live_keys"] = int(mask.sum())
    res = {"shape": shape, "cases": cases, "max_abs_err": max_err,
           "timing": timing}
    emit(f"g_flash_{case}_shape", **res)
    del leaves, sdpa_out
    torch.cuda.empty_cache()
    return res


def flash_fwd_ref(q, k, v, causal, scale):
    """The plain forward in f32 on the kernels' layout: (out, lse [B, Hq,
    T])."""
    from kubeflow_tpu_torch.ops import attention as A

    b, t, hq, _ = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    kvm = A._fold_mask(None, b, s_len, hkv, q.device)
    out, lse = A._flash_fwd_plain(
        A._fold_q(q.float(), hkv), A._fold_kv(k.float()),
        A._fold_kv(v.float()), kvm, causal=causal, scale=scale,
        block_k=PLAIN_BLOCK_K)
    return A._unfold_q(out, b), lse.reshape(b, hq, t)


def phase_flash_predict(dev, flush) -> dict:
    """(j): the flash forward at the plain predict's shape, bf16 (the
    tensor-core route) and f32 (the CUDA-core route)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch import kernels

    m = FLASH_PREDICT
    scale = m["hd"] ** -0.5
    pairs = m["b"] * m["hq"] * causal_pairs(m["t"], m["s"], True)
    results = {}
    for dtype, kind, kernel in ((torch.bfloat16, "bf16",
                                 "flash_fwd_tc_kernel"),
                                (torch.float32, "f32", "flash_fwd_kernel")):
        q, k, v, _ = flash_inputs(dev, dtype, **m)
        ref_out, ref_lse = flash_fwd_ref(q, k, v, True, scale)
        out, lse = kernels.flash_fwd(q, k, v, None, True, scale)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        def call():
            return kernels.flash_fwd(q, k, v, None, True, scale)

        sdpa_err = (sdpa().transpose(1, 2).float()
                    - ref_out).abs().max().item()
        torch.cuda.synchronize()
        tol_out, tol_lse = FLASH_TOL[dtype][:2]
        if dtype == torch.bfloat16:
            tol_out = max(tol_out, 2 * sdpa_err)
        errs = {}
        for name, a, r, tol in (("out", out, ref_out, tol_out),
                                ("lse", lse, ref_lse, tol_lse)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"flash predict shape ({kind}): "
                                     f"non-finite {name}")
            errs[name] = (a.float() - r).abs().max().item()
            if errs[name] > tol:
                raise AssertionError(f"flash predict shape ({kind}): {name} "
                                     f"max abs error {errs[name]} > {tol}")
        # q, k, v read once; out and lse written once. QK^T and PV: 4*D a
        # pair.
        bound_ms, bound_by = bound(
            q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            + 4 * lse.numel(), 4 * m["hd"] * pairs, kind)
        results[kind] = {
            "max_abs_err": errs, "tolerance": {"out": tol_out, "lse": tol_lse},
            "sdpa_max_abs_err": sdpa_err,
            "device_ms": device_ms(call, flush, 50, kernel),
            "call_ms": time_ms(call, flush, 50),
            "plain_ms": time_ms(lambda: flash_fwd_ref(q, k, v, True, scale),
                                flush, 5),
            "library_ms": time_ms(sdpa, flush, 50),
            "library_device_ms": device_ms(sdpa, flush, 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del q, k, v, out, lse, qt, kt, vt
    emit("j_flash_predict_shape", shape=m, results=results)
    return results


# ---------------------------------------------------------------------------
# (k) the default server, (l) f32 parity of the layouts
# ---------------------------------------------------------------------------


def serve(cfg, fn, **server_kw):
    """``fn(server)`` on a started ModelServer built from ``cfg`` (and
    ``server_kw``); the server is stopped and its memory returned after."""
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer(cfg, port=0, **server_kw)
    server.start()
    try:
        return fn(server)
    finally:
        server.stop()
        del server
        torch.cuda.empty_cache()


def phase_default_server(paged: dict) -> dict:
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.engine import EngineConfig

    def jax_defaults(**kw):
        return EngineConfig(model=MODEL, batch_size=SLOTS,
                            max_seq_len=MAX_SEQ, max_new_tokens=MAX_NEW,
                            device="cuda", **kw)

    def continuous(server):
        run = drive(server)
        run["surfaces"] = check_surfaces(server, run)
        cfg = server.engine.model.config
        bodies = request_bodies(cfg.vocab_size)
        # Eight plain instances, one server batch.
        plain = [{"tokens": b["tokens"]} for b in bodies] + [
            {"tokens": bodies[4]["tokens"][:n]} for n in (64, 255)]
        kernels.reset_launches()
        t0 = time.perf_counter()
        preds = predict(server.port, plain)
        run["plain_predict_ms"] = 1e3 * (time.perf_counter() - t0)
        run["plain_launches"] = dict(kernels.LAUNCHES)
        # The same batch through the engine alone (no HTTP, no JSON of
        # 8 x vocab logits), and the card's share of it.
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        batch = lambda: server.engine.predict_batch(plain)  # noqa: E731
        run["predict_batch_ms"] = time_ms(batch, flush, 5)
        run["predict_batch_device_ms"] = device_ms(batch, flush, 5)
        run["n_layers"], run["vocab"] = cfg.n_layers, cfg.vocab_size
        run["plain_predictions"] = preds
        return run

    dense = serve(jax_defaults(), continuous)
    preds = dense.pop("plain_predictions")
    surfaces = dense.pop("surfaces")
    if dense["launches"]["paged_decode_attention"] or \
            dense["launches"]["flash_attention_fwd"]:
        raise AssertionError(f"dense decode launched {dense['launches']}")
    for pred in preds:
        logits = np.asarray(pred["logits"], np.float32)
        if logits.shape != (dense["vocab"],) or not np.isfinite(logits).all():
            raise AssertionError(f"plain predict logits {logits.shape}")
        if pred["next_token"] != int(np.argmax(logits)):
            raise AssertionError("plain predict next_token is not the "
                                 "argmax of its logits")
    launched = dense["plain_launches"]["flash_attention_fwd"]
    if len(preds) != SLOTS or launched != dense["n_layers"]:
        raise AssertionError(
            f"plain predict of {len(preds)} instances launched the flash "
            f"forward {launched} times, expected {dense['n_layers']} layers "
            "x 1 batch")
    lockstep = serve(jax_defaults(decode_mode="lockstep"), drive)

    def prefix(server):
        bodies = request_bodies(server.engine.model.config.vocab_size)
        system = bodies[4]["tokens"][:192]
        if not server.decoder.prime_prefix(system):
            raise AssertionError("prime_prefix refused the system prompt")
        toks, _ = post(server.port, {"tokens": system + bodies[1]["tokens"],
                                     "max_new_tokens": 16})
        if len(toks) != 16:
            raise AssertionError(f"prefix request got {len(toks)} tokens")
        return server.decoder.metrics()

    pm = serve(jax_defaults(prefix_cache_slots=2), prefix)
    if pm["prefix_hits"] < 1 or pm["prefix_tokens_reused"] <= 0:
        raise AssertionError(f"no prefix hit: {pm}")
    out = {
        "dense": dense, "lockstep": lockstep,
        "prefix": {k: pm[k] for k in ("prefix_hits", "prefix_misses",
                                      "prefix_tokens_reused",
                                      "prefix_suffix_tokens",
                                      "prefix_inserts")},
        "paged_decode_tokens_per_s": paged["decode_tokens_per_s"],
        "paged_ttft_streamed_ms": paged["ttft_streamed_ms"],
    }
    emit("k_default_server", **out)
    out["surfaces"] = surfaces
    return out


def phase_f32_layouts(paged_streams: list) -> dict:
    """(l): float32 greedy tokens through the dense decoder, lockstep and
    the prefix cache (cold, warm) against (e)'s paged streams, requests
    one at a time; and the plain predict against the dense decoder's
    prefill logits."""
    from kubeflow_tpu_torch import kernels

    def f32(**kw):
        return engine_cfg(kv_layout="dense", dtype="float32", **kw)

    def one_at_a_time(server, **extra):
        bodies = request_bodies(server.engine.model.config.vocab_size)
        return [server.handle_predict(MODEL, {"instances": [
            {**b, **extra}]})["predictions"][0] for b in bodies]

    def dense_run(server):
        bodies = request_bodies(server.engine.model.config.vocab_size)
        gen = one_at_a_time(server, return_logits=True)
        kernels.reset_launches()
        plain = server.handle_predict(MODEL, {"instances": [
            {"tokens": b["tokens"]} for b in bodies]})["predictions"]
        return gen, plain, kernels.LAUNCHES["flash_attention_fwd"], \
            server.engine.model.config.n_layers

    gen, plain, launched, n_layers = serve(f32(), dense_run)
    lockstep = serve(f32(decode_mode="lockstep"),
                     lambda server: one_at_a_time(server))

    def prefix_run(server):
        cold = one_at_a_time(server)
        warm = one_at_a_time(server)
        return cold, warm, server.decoder.metrics()

    cold, warm, pm = serve(f32(prefix_cache_slots=len(REQUESTS)), prefix_run)
    toks = {name: [p["tokens"] for p in preds] for name, preds in (
        ("dense", gen), ("lockstep", lockstep), ("prefix_cold", cold),
        ("prefix_warm", warm))}
    out = {name: compare_streams(t, paged_streams)
           for name, t in toks.items()}
    out["prefix_warm_vs_cold"] = compare_streams(toks["prefix_warm"],
                                                 toks["prefix_cold"])
    out["prefix_hits"] = pm["prefix_hits"]
    out["prefix_tokens_reused"] = pm["prefix_tokens_reused"]
    logit_err = max(
        float(np.abs(np.asarray(p["logits"]) - np.asarray(g["logits"])).max())
        for p, g in zip(plain, gen))
    first = [p["next_token"] == g["tokens"][0] for p, g in zip(plain, gen)]
    out.update(plain_launches=launched, plain_next_token_equal=sum(first),
               plain_logits_max_abs_err=logit_err,
               plain_logits_tolerance=PREDICT_LOGIT_TOL)
    emit("l_f32_layouts", **out)
    bad = [name for name in toks if not out[name]["identical"]]
    if bad or not out["prefix_warm_vs_cold"]["identical"]:
        raise AssertionError(f"f32 greedy tokens differ from the paged "
                             f"runs: {bad}")
    if pm["prefix_hits"] < 1:
        raise AssertionError("the warm pass hit no prefix")
    if not all(first) or logit_err > PREDICT_LOGIT_TOL:
        raise AssertionError(f"plain predict disagrees with the decoder's "
                             f"prefill: next_token {first}, logits "
                             f"{logit_err}")
    if launched != n_layers:
        raise AssertionError(f"f32 plain predict launched the flash forward "
                             f"{launched} times, expected {n_layers}")
    return out


# ---------------------------------------------------------------------------
# (m) the default server's surfaces, (n) the paged prefix path, (o) chunked
# prefill, (p) their float32 parity
# ---------------------------------------------------------------------------

# (n): a 160-token system prompt (10 whole blocks) shared by four requests
# with suffixes of 8-64 tokens, then two requests that share 168 tokens
# (not block-aligned: one copy-on-write).
SYSTEM_LEN, PREFIX_SUFFIXES, SHARED_LEN = 160, (8, 24, 40, 64), 168
PREFIX_NEW = 32
# (o): chunked prefill at max_prompt_len 1792 (+32 = 1824 = 114 blocks).
CHUNK_TOKENS, MAX_PROMPT, LONG_PROMPT = 128, 1792, 1500
CHUNK_SHORT = [(40, 32), (64, 32)]  # the streams live during the chain
# (s): a 160-token primed prefix (10 whole blocks); a pool of 24 blocks
# that the eight pressure requests (12 + 32 tokens: 3 blocks each) fill,
# so the cached prefixes demote to a 64 MiB host tier; the suspension's
# pool of 18 blocks (one worst-case row) holds a 64-token low-priority
# stream (6 blocks) or a 200-token high-priority one (15), not both.
TIER_SYSTEM, TIER_POOL, TIER_BYTES = 160, 24, 64 << 20
TIER_PRESSURE = 8
QOS_TENANTS = "gold=8:0:0:10,free=1"
SUSPEND_POOL, VICTIM_LEN, GOLD_LEN = 18, 64, 200
HANDOFF_LEN = 200


def parse_exposition(text: str) -> dict:
    """{sample (name and labels): value} of a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def check_surfaces(server, run: dict) -> dict:
    """(m), on (k)'s server after its requests: the exposition's token
    and admission counters against what the requests got, and each
    request's closed timeline at /debug/requests?id=."""
    text = get(server.port, "/monitoring/prometheus/metrics")
    samples = parse_exposition(text)
    emitted = samples["serving_tokens_emitted_total"]
    admitted = samples["serving_requests_admitted_total"]
    if emitted != run["tokens_returned"]:
        raise AssertionError(f"serving_tokens_emitted_total {emitted}, the "
                             f"requests got {run['tokens_returned']}")
    if admitted != run["requests_sent"]:
        raise AssertionError(f"serving_requests_admitted_total {admitted}, "
                             f"{run['requests_sent']} requests sent")
    timelines = {}
    for rid in run["request_ids"]:
        recs = json.loads(get(server.port,
                              f"/debug/requests?id={rid}"))["requests"]
        if len(recs) != 1 or recs[0]["status"] not in ("length", "eos"):
            raise AssertionError(f"timeline of {rid}: {recs}")
        timelines[rid] = {"status": recs[0]["status"],
                          "duration_ms": recs[0]["duration_ms"],
                          "events": len(recs[0]["events"])}
    return {"tokens_emitted_total": emitted,
            "requests_admitted_total": admitted,
            "requests_sent": run["requests_sent"],
            "tokens_returned": run["tokens_returned"],
            "request_ids_echoed": len(run["request_ids"]),
            "timelines": timelines,
            "families": text.count("# TYPE ")}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_cli(*flags: str):
    """``python -m kubeflow_tpu_torch.serving --model-name llama-1b`` with
    ``flags``, as a user starts it; output to files under chiprun_out/
    (created on demand)."""
    import os

    os.makedirs("chiprun_out", exist_ok=True)
    name = "_".join(f.strip("-").replace("/", "_")
                    for f in flags[:2]) or "default"
    log = open(f"chiprun_out/cli_{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving", "--model-name",
         MODEL, *flags], stdout=log, stderr=subprocess.STDOUT, text=True)
    proc.started = time.perf_counter()
    return proc, log


def wait_ready(proc, port: int, timeout: float = 300.0) -> float:
    """Seconds from the CLI's start until /readyz answers ready."""
    while time.perf_counter() - proc.started < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"the CLI exited {proc.returncode} before "
                                 "it served")
        try:
            if json.loads(get(port, "/readyz"))["ready"]:
                return time.perf_counter() - proc.started
        except (OSError, AssertionError, ValueError):
            pass
        time.sleep(0.1)
    raise AssertionError(f"the CLI was not ready in {timeout} s")


def stop_procs(procs) -> None:
    for proc, log in procs:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        log.close()


def phase_surfaces(default: dict) -> dict:
    """(m): (k)'s scrape, then the CLI on the card. With grpcio, the CLI
    with default flags serves gRPC :9000 and a Predict body equals the
    REST body; without it, the CLI with default flags exits 2 naming
    ``--grpc-port -1``. Beside it, the CLI with the paged prefix path and
    chunked prefill (``--grpc-port -1``) answers a long prompt and a
    prefix hit, the CLI with ``--speculative-k 4`` on the paged layout
    answers a request, the CLI with the host KV tier, QoS and a decode
    role (``--host-kv-bytes``, ``--qos-tenants``, ``--serving-role
    decode``) answers a tenant's request, ``--speculative-k 2
    --decode-mode lockstep`` exits 2, and ``--tp-shards 2`` exits 2
    naming the devices (its shards take cuda:0 and cuda:1 by default; the
    card is one)."""
    import importlib.util

    from kubeflow_tpu_torch.models.registry import get_model

    vocab = get_model(MODEL).config.vocab_size
    grpc_available = importlib.util.find_spec("grpc") is not None
    out = {"metrics": default["surfaces"], "grpc_available": grpc_available}
    rest_default, rest_paged, rest_spec, rest_qos = (
        free_port(), free_port(), free_port(), free_port())
    paged_flags = ("--kv-layout", "paged", "--kv-fused-attention",
                   "--prefix-cache-slots", "4", "--prefill-chunk-tokens",
                   str(CHUNK_TOKENS), "--max-prompt-len", str(MAX_PROMPT),
                   "--grpc-port", "-1", "--rest-port", str(rest_paged))
    procs = []
    try:
        procs.append(start_cli("--rest-port", str(rest_default)))
        procs.append(start_cli(*paged_flags))
        procs.append(start_cli("--speculative-k", "4", "--kv-layout",
                               "paged", "--grpc-port", "-1", "--rest-port",
                               str(rest_spec)))
        procs.append(start_cli(
            "--host-kv-bytes", str(TIER_BYTES), "--qos-tenants",
            QOS_TENANTS, "--serving-role", "decode", "--kv-layout", "paged",
            "--kv-fused-attention", "--prefix-cache-slots", "4",
            "--grpc-port", "-1", "--rest-port", str(rest_qos)))
        for flags, says in ((("--tp-shards", "2"), "devices"),
                            (("--speculative-k", "2", "--decode-mode",
                              "lockstep"), "requires --decode-mode")):
            refused = subprocess.run(
                [sys.executable, "-m", "kubeflow_tpu_torch.serving",
                 "--model-name", MODEL, *flags],
                capture_output=True, text=True, timeout=120)
            if refused.returncode != 2 or says not in refused.stderr:
                raise AssertionError(f"{' '.join(flags)}: exit "
                                     f"{refused.returncode}: "
                                     f"{refused.stderr}")
            out[f"exit_{flags[0].strip('-')}"] = refused.returncode
        default_proc = procs[0][0]
        if grpc_available:
            import grpc

            from kubeflow_tpu_torch.serving.grpc_server import client_stubs

            out["default_cli_ready_s"] = wait_ready(default_proc,
                                                    rest_default)
            inst = {"tokens": request_bodies(vocab)[1]["tokens"],
                    "max_new_tokens": 8}
            conn = http.client.HTTPConnection("127.0.0.1", rest_default,
                                              timeout=120)
            conn.request("POST", f"/v1/models/{MODEL}:predict",
                         body=json.dumps({"instances": [inst]}))
            rest_body = json.loads(conn.getresponse().read())
            conn.close()
            with grpc.insecure_channel("127.0.0.1:9000") as channel:
                predict, _ = client_stubs(channel)
                grpc_body, md = predict(
                    MODEL, [inst], timeout=120, with_call=True,
                    metadata=(("x-request-id", "smoke-grpc"),))
            if grpc_body != rest_body:
                raise AssertionError(f"gRPC body {grpc_body} != REST body "
                                     f"{rest_body}")
            if md.get("x-request-id") != "smoke-grpc":
                raise AssertionError(f"gRPC request id echoed as {md}")
            # :9000 answered from this CLI, not from another process on
            # the port: its own timelines hold the call.
            recs = json.loads(get(rest_default, "/debug/requests?id="
                                  "smoke-grpc"))["requests"]
            if len(recs) != 1 or recs[0]["status"] not in ("length", "eos"):
                raise AssertionError(f"the CLI's timeline of the gRPC call: "
                                     f"{recs}")
            out["grpc_predict_equals_rest"] = True
            out["grpc_timeline_in_cli"] = True
            out["grpc_tokens"] = grpc_body["predictions"][0]["tokens"]
        else:
            code = default_proc.wait(timeout=120)
            procs[0][1].flush()
            text = open(procs[0][1].name).read()
            if code != 2 or "--grpc-port -1" not in text:
                raise AssertionError(f"the default CLI without grpcio exited "
                                     f"{code}: {text[-2000:]}")
            out["default_cli_exit"] = code
        out["paged_cli_ready_s"] = wait_ready(procs[1][0], rest_paged)
        rng = np.random.RandomState(7)
        system = rng.randint(0, vocab, size=SYSTEM_LEN).tolist()
        asks = [rng.randint(0, vocab, size=LONG_PROMPT).tolist(),
                system + rng.randint(0, vocab, size=12).tolist(),
                system + rng.randint(0, vocab, size=20).tolist()]
        got = [len(post(rest_paged, {"tokens": t, "max_new_tokens": 16})[0])
               for t in asks]
        samples = parse_exposition(get(rest_paged,
                                       "/monitoring/prometheus/metrics"))
        out["paged_cli"] = {
            "tokens": got,
            "prefix_hits": samples["serving_prefix_hits_total"],
            "prefill_chunks": samples["serving_prefill_chunks_total"],
            "kv_shared_blocks": samples["serving_kv_shared_blocks_total"]}
        if (got != [16, 16, 16] or samples["serving_prefix_hits_total"] < 1
                or samples["serving_prefill_chunks_total"] < 1):
            raise AssertionError(f"the paged CLI: {out['paged_cli']}")
        out["spec_cli_ready_s"] = wait_ready(procs[2][0], rest_spec)
        pat = rng.randint(0, vocab, size=5).tolist()
        got = len(post(rest_spec, {"tokens": pat * 12,
                                   "max_new_tokens": 16})[0])
        samples = parse_exposition(get(rest_spec,
                                       "/monitoring/prometheus/metrics"))
        out["spec_cli"] = {
            "tokens": got, "verify_dispatches":
                samples["serving_spec_verify_dispatches_total"]}
        if got != 16:
            raise AssertionError(f"the speculative CLI: {out['spec_cli']}")
        out["features_cli_ready_s"] = wait_ready(procs[3][0], rest_qos)
        got = len(post(rest_qos, {"tokens": pat * 12, "max_new_tokens": 16},
                       headers={"X-Tenant": "gold", "X-Priority": "5"})[0])
        text = get(rest_qos, "/monitoring/prometheus/metrics")
        samples = parse_exposition(text)
        # The tier's families exist only with a tier (its byte gauges read
        # 0 while it is empty, as JAX's do).
        tier = "# TYPE serving_kv_host_eviction_age_seconds histogram" in text
        out["features_cli"] = {
            "tokens": got, "qos_enabled": samples["serving_qos_enabled"],
            "host_tier": tier,
            "role_decode": samples['serving_role{role="decode"}'],
            "tenant_buckets": sorted(
                k for k in samples if k.startswith(
                    "serving_tenant_queue_wait_seconds_count{"))}
        if (got != 16 or samples["serving_qos_enabled"] != 1 or not tier
                or samples['serving_role{role="decode"}'] != 1):
            raise AssertionError(f"the features CLI: {out['features_cli']}")
    finally:
        stop_procs(procs)
    emit("m_default_server_surfaces", **out)
    return out


def prefix_requests(vocab: int) -> tuple[list[int], list[dict]]:
    """(n)'s system prompt and requests: four over the system prompt
    (suffixes of 8-64), then two sharing 168 tokens."""
    rng = np.random.RandomState(3)
    system = rng.randint(0, vocab, size=SYSTEM_LEN).tolist()
    reqs = [system + rng.randint(0, vocab, size=n).tolist()
            for n in PREFIX_SUFFIXES]
    shared = system + rng.randint(0, vocab, size=SHARED_LEN -
                                  SYSTEM_LEN).tolist()
    reqs += [shared + rng.randint(0, vocab, size=n).tolist()
             for n in (16, 24)]
    return system, [{"tokens": t, "max_new_tokens": PREFIX_NEW}
                    for t in reqs]


def drive_prefix(server, reqs: list[dict], tag: str) -> list:
    """The four system requests at once, streamed, then the two that
    share 168 tokens one after the other. Returns [(tokens, ttft_s)]."""
    results: list = [None] * len(reqs)

    def run(i):
        results[i] = post(server.port, reqs[i], stream=True,
                          rid=f"{tag}-{i}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(PREFIX_SUFFIXES))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for i in range(len(PREFIX_SUFFIXES), len(reqs)):
        run(i)
    if any(r is None or len(r[0]) != PREFIX_NEW for r in results):
        raise AssertionError(f"prefix requests ({tag}): {results}")
    return results


def phase_prefix_path() -> dict:
    """(n): llama-1b, bf16, paged, kv_fused, prefix_cache_slots 4. The
    system prompt is primed; (n)'s requests run warm, then on a server
    without the prefix cache, cold; the second of two such passes is
    kept."""
    from kubeflow_tpu_torch import kernels

    def warm(server):
        cfg = server.engine.model.config
        system, reqs = prefix_requests(cfg.vocab_size)
        if not server.decoder.prime_prefix(system):
            raise AssertionError("prime_prefix refused the system prompt")
        dec = server.decoder
        steps0 = dec.steps
        kernels.reset_launches()
        results = drive_prefix(server, reqs, "prefix-warm")
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = dec.steps - steps0
        return results, launches, forwards, cfg.n_layers, dec.metrics()

    def cold(server):
        _, reqs = prefix_requests(server.engine.model.config.vocab_size)
        return drive_prefix(server, reqs, "prefix-cold")

    # Each side is measured on a fresh server after an unmeasured pass of
    # the same requests, so neither pays the first use of a kernel or of
    # a GEMM shape in this process (the span forward's are new here).
    for _ in range(2):
        results, launches, forwards, n_layers, m = serve(
            engine_cfg(kv_fused=True, prefix_cache_slots=4), warm)
        cold_results = serve(engine_cfg(kv_fused=True), cold)
    if forwards <= 0 or launches != n_layers * forwards:
        raise AssertionError(f"paged decode kernel launched {launches} "
                             f"times, expected {n_layers} layers x "
                             f"{forwards} decode forwards")
    if m["kv_shared_blocks"] <= 0 or m["kv_cow_copies"] < 1 or \
            m["prefix_hits"] < len(results):
        raise AssertionError(f"prefix path counters: {m}")
    out = {
        "model": MODEL, "dtype": "bfloat16", "slots": SLOTS,
        "max_seq_len": MAX_SEQ, "max_new_tokens": MAX_NEW,
        "block": BLOCK, "system_prompt": SYSTEM_LEN,
        "requests": [len(r["tokens"]) for r in
                     prefix_requests(32000)[1]],
        "launches": launches, "decode_forwards": forwards,
        **{k: m[k] for k in ("prefix_hits", "prefix_misses",
                             "prefix_tokens_reused", "prefix_suffix_tokens",
                             "kv_shared_blocks", "kv_cow_copies",
                             "prefix_inserts", "prefix_evictions")},
        "ttft_warm_ms": [1e3 * r[1] for r in results],
        "ttft_cold_ms": [1e3 * r[1] for r in cold_results],
    }
    out["ttft_warm_mean_ms"] = float(np.mean(out["ttft_warm_ms"]))
    out["ttft_cold_mean_ms"] = float(np.mean(out["ttft_cold_ms"]))
    emit("n_prefix_path", **out)
    return out


def span_timing(dev) -> dict:
    """The span read of one chunk at llama-1b's chunk shape (q [1, 128,
    16, 128] at positions 1280-1407 of a 114-block row, bf16 pool): the
    grouped walk (the fused path; also at 1024 positions a step), the
    one-block walk and the gathered read, per layer, CUDA-event time with
    L2 flushed, and the device time of the walk and the gathered read;
    and the bound."""
    from kubeflow_tpu_torch.models.decode import _gqa_attention, _pool_gather
    from kubeflow_tpu_torch.models.transformer import config
    from kubeflow_tpu_torch.ops import attention as A

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cfg = config(MODEL)
    mb = (MAX_PROMPT + MAX_NEW) // BLOCK
    hkv, hq, hd, s_w = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, CHUNK_TOKENS
    gen = torch.Generator(device=dev).manual_seed(9)
    n = SLOTS * mb
    kp = torch.randn(n, BLOCK, hkv, hd, generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(n, BLOCK, hkv, hd, generator=gen,
                     device=dev).bfloat16()
    table = torch.randperm(n, generator=gen, device=dev)[:mb].to(
        torch.int32)[None]
    q = torch.randn(1, s_w, hq, hd, generator=gen, device=dev).bfloat16()
    pos = torch.tensor([1280], dtype=torch.int32, device=dev)
    cols = pos.long()[:, None] + torch.arange(s_w, device=dev)[None]
    mask = (torch.arange(mb * BLOCK, device=dev)[None, None, :]
            <= cols[:, :, None])[:, None, None]

    def walk():
        return A.paged_span_attention(q, kp, vp, table, pos,
                                      n_kv_heads=hkv)

    qg = q.reshape(1, s_w, hkv, hq // hkv, hd)

    def one_block():
        return A._paged_span_plain(qg, kp, vp, table, pos, hd ** -0.5)

    def walk_1024():
        return A._span_walk(qg, kp, vp, table, pos, hd ** -0.5,
                            1024 // BLOCK)

    def gathered():
        return _gqa_attention(q, _pool_gather(kp, table),
                              _pool_gather(vp, table), mask, cfg)

    err = (walk().float() - one_block().reshape(1, s_w, hq, hd)).abs().max()
    walk_launches = len(profiled_launches(walk, flush, 5)) // 5
    live = 1280 + s_w
    pairs = hq * sum(1280 + i + 1 for i in range(s_w))
    bound_ms, bound_by = bound(
        2 * live * hkv * hd * 2 + q.numel() * (2 + 4) + 4 * mb,
        4 * hd * pairs, "bf16")
    return {"shape": {"q": [1, s_w, hq, hd], "blocks": mb, "pos": 1280},
            "group_positions": A.SPAN_GROUP_POSITIONS,
            "steps_per_layer": -(-mb * BLOCK // A.SPAN_GROUP_POSITIONS),
            "walk_launches_per_layer": walk_launches,
            "walk_ms": time_ms(walk, flush, 20),
            "walk_device_ms": device_ms(walk, flush, 10),
            "walk_1024_positions_ms": time_ms(walk_1024, flush, 10),
            "one_block_walk_ms": time_ms(one_block, flush, 5),
            "gathered_ms": time_ms(gathered, flush, 20),
            "gathered_device_ms": device_ms(gathered, flush, 10),
            "walk_vs_one_block_max_abs_err": err.item(),
            "bound_ms": bound_ms, "bound_by": bound_by}


def chunk_chain(server) -> dict:
    """(o)'s drive on a started chunked server: a 300-token warm-up, then
    the LONG_PROMPT-token prompt admitted as a chain while the CHUNK_SHORT
    requests stream; the chain's interior chunks, the decode forwards and
    paged launches in it, the short streams' inter-token gaps during it,
    one chunk's mean ms (``serving_prefill_chunk_seconds``) and the
    status a (MAX_PROMPT + 1)-token prompt answers."""
    from kubeflow_tpu_torch import kernels

    cfg = server.engine.model.config
    dec = server.decoder
    rng = np.random.RandomState(5)
    shorts = [{"tokens": rng.randint(0, cfg.vocab_size, size=n).tolist(),
               "max_new_tokens": w} for n, w in CHUNK_SHORT]
    long = {"tokens": rng.randint(0, cfg.vocab_size,
                                  size=LONG_PROMPT).tolist(),
            "max_new_tokens": MAX_NEW}
    # Warm-up: a 300-token prompt takes the chunk path's shapes once,
    # so no measured chunk pays a first use in this process.
    post(server.port, {"tokens": rng.randint(
        0, cfg.vocab_size, size=300).tolist(), "max_new_tokens": 2})
    hist = dec._h_prefill_chunk.labels()
    steps0, chunks0 = dec.steps, dec.prefill_chunks
    hist0 = (hist.count, hist.sum)
    kernels.reset_launches()
    stamps = [[] for _ in shorts]
    results: list = [None] * (len(shorts) + 1)

    def go(i):
        if i < len(shorts):
            results[i] = post(server.port, shorts[i], stream=True,
                              stamps=stamps[i], rid=f"chunk-short-{i}")
        else:
            results[i] = post(server.port, long, stream=True,
                              rid="chunk-long")

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(shorts))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 300
    while not all(len(st) >= 2 for st in stamps):
        if time.perf_counter() > deadline:
            raise AssertionError("the short streams did not start")
        time.sleep(0.001)
    t_long = time.perf_counter()
    go(len(shorts))
    t_first = t_long + results[-1][1]
    for t in threads:
        t.join(timeout=600)
    launches = kernels.LAUNCHES["paged_decode_attention"]
    forwards = dec.steps - steps0
    chunks = dec.prefill_chunks - chunks0
    gaps = [b - a for st in stamps for a, b in zip(st, st[1:])
            if a >= t_long and b <= t_first]
    status = None
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=60)
    try:
        conn.request("POST", f"/v1/models/{MODEL}:predict",
                     body=json.dumps({"instances": [{
                         "tokens": [1] * (MAX_PROMPT + 1),
                         "max_new_tokens": 1}]}))
        resp = conn.getresponse()
        resp.read()
        status = resp.status
    finally:
        conn.close()
    return {"results": results, "launches": launches,
            "forwards": forwards, "chunks": chunks, "gaps": gaps,
            "chunk_ms_mean": 1e3 * (hist.sum - hist0[1])
            / max(hist.count - hist0[0], 1),
            "n_layers": cfg.n_layers, "status_1793": status,
            "metrics": dec.metrics()}


def phase_chunked() -> dict:
    """(o): llama-1b, bf16, paged, kv_fused, prefill_chunk_tokens 128,
    max_prompt_len 1792: a 1500-token prompt admitted as a chain of 12
    chunks while two short requests stream; a 1793-token prompt answers
    413."""
    r = serve(engine_cfg(kv_fused=True, prefill_chunk_tokens=CHUNK_TOKENS,
                         max_prompt_len=MAX_PROMPT), chunk_chain)
    want_chunks = -(-LONG_PROMPT // CHUNK_TOKENS) - 1
    if r["forwards"] <= 0 or r["launches"] != r["n_layers"] * r["forwards"]:
        raise AssertionError(f"paged decode kernel launched {r['launches']} "
                             f"times, expected {r['n_layers']} layers x "
                             f"{r['forwards']} decode forwards")
    if r["chunks"] != want_chunks:
        raise AssertionError(f"{r['chunks']} interior chunks, expected "
                             f"{want_chunks}")
    lens = [len(x[0]) for x in r["results"]]
    if lens != [w for _, w in CHUNK_SHORT] + [MAX_NEW]:
        raise AssertionError(f"chunked phase token counts {lens}")
    if r["status_1793"] != 413:
        raise AssertionError(f"a {MAX_PROMPT + 1}-token prompt answered "
                             f"{r['status_1793']}, not 413")
    if not r["gaps"]:
        raise AssertionError("no short-stream token arrived during the "
                             "chain")
    span = span_timing(torch.device("cuda"))
    out = {
        "model": MODEL, "dtype": "bfloat16", "max_seq_len": MAX_SEQ,
        "prefill_chunk_tokens": CHUNK_TOKENS, "max_prompt_len": MAX_PROMPT,
        "long_prompt": LONG_PROMPT, "chunks": want_chunks + 1,
        "interior_chunks": r["chunks"], "launches": r["launches"],
        "decode_forwards": r["forwards"],
        "short_streams": CHUNK_SHORT,
        "max_inter_token_gap_during_chain_ms": 1e3 * max(r["gaps"]),
        "median_inter_token_gap_during_chain_ms":
            1e3 * float(np.median(r["gaps"])),
        "chunk_ms_mean": r["chunk_ms_mean"],
        "long_ttft_ms": 1e3 * r["results"][-1][1],
        "status_1793": r["status_1793"], "span": span,
    }
    emit("o_chunked_prefill", **out)
    return out


def phase_f32_prefix_chunk_parity(dev=torch.device("cuda")) -> dict:
    """(p): float32, greedy, requests one at a time through decoders
    sharing one set of weights: (n)'s requests prefix warm (primed) =
    cold = fused = gathered; (o)'s long prompt chunked = monolithic (a
    decoder with max_seq_len 1792, no chunking and the gathered read),
    and the fused monolithic decoder = the gathered one; llama-1b's width
    at F32_GATE_LAYERS layers."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    model = get_model(MODEL, dtype=torch.float32, n_layers=F32_GATE_LAYERS)
    params = model.init(model.config,
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cfg = model.config
    system, reqs = prefix_requests(cfg.vocab_size)
    base = dict(slots=SLOTS, prefill_len=MAX_SEQ, max_new_tokens=MAX_NEW,
                kv_layout="paged", kv_block_size=BLOCK)

    def streams(prompts, prime=None, **kw):
        dec = ContinuousDecoder(params, cfg, **{**base, **kw})
        try:
            if prime is not None and not dec.prime_prefix(prime):
                raise AssertionError("prime_prefix refused")
            toks = [dec.generate(p["tokens"], p["max_new_tokens"],
                                 timeout=600)["tokens"] for p in prompts]
            return toks, dec.metrics()
        finally:
            dec.stop()
            torch.cuda.empty_cache()

    runs = {}
    for name, fused, slots_ in (("warm_fused", True, 4),
                                ("cold_fused", True, 0),
                                ("warm_gathered", False, 4),
                                ("cold_gathered", False, 0)):
        runs[name] = streams(reqs, system if slots_ else None,
                             kv_fused=fused, prefix_cache_slots=slots_)
    rng = np.random.RandomState(5)
    for n, _ in CHUNK_SHORT:
        rng.randint(0, cfg.vocab_size, size=n)
    long = [{"tokens": rng.randint(0, cfg.vocab_size,
                                   size=LONG_PROMPT).tolist(),
             "max_new_tokens": MAX_NEW}]
    runs["chunked"] = streams(long, kv_fused=True,
                              prefill_chunk_tokens=CHUNK_TOKENS,
                              max_prompt_len=MAX_PROMPT)
    # The monolithic reference reads the cache gathered (plain), so the
    # chunked run's decode steps hold the paged kernel at (8, 8, 114)
    # against the plain read; the fused monolithic run sits beside it.
    runs["monolithic"] = streams(long, kv_fused=False,
                                 prefill_len=MAX_PROMPT)
    runs["monolithic_fused"] = streams(long, kv_fused=True,
                                       prefill_len=MAX_PROMPT)
    ref = runs["cold_gathered"][0]
    out = {name: compare_streams(runs[name][0], ref)
           for name in ("warm_fused", "cold_fused", "warm_gathered")}
    out["chunked_vs_monolithic"] = compare_streams(
        runs["chunked"][0], runs["monolithic"][0])
    out["monolithic_fused_vs_gathered"] = compare_streams(
        runs["monolithic_fused"][0], runs["monolithic"][0])
    out["warm_prefix_hits"] = runs["warm_fused"][1]["prefix_hits"]
    out["warm_cow_copies"] = runs["warm_fused"][1]["kv_cow_copies"]
    out["chunked_interior_chunks"] = runs["chunked"][1]["prefill_chunks"]
    emit("p_f32_prefix_chunk_parity", **out)
    bad = [k for k, v in out.items() if isinstance(v, dict)
           and not v["identical"]]
    if bad:
        raise AssertionError(f"f32 greedy tokens differ: {bad}")
    if out["warm_prefix_hits"] < len(reqs) or out["warm_cow_copies"] < 1:
        raise AssertionError(f"the warm f32 run hit {out['warm_prefix_hits']}"
                             f" prefixes, {out['warm_cow_copies']} copies")
    if out["chunked_interior_chunks"] < 1:
        raise AssertionError("the chunked f32 run chunked nothing")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# (q) speculation
# ---------------------------------------------------------------------------

# (q): speculative_k 4 over (d)'s six requests and four prompts of a short
# pattern repeated to 64-128 tokens (the n-gram proposer drafts from the
# first round); max_new_tokens 64, two runs a side, alternating.
SPEC_K, SPEC_NEW, SPEC_RUNS = 4, 64, 2
# The f32 gates' tokens a request (at most; the patterns ask for 64).
SPEC_GATE_NEW = 32
SPEC_PATTERNS = [(3, 64), (5, 96), (7, 112), (4, 128)]


def spec_requests(vocab: int) -> list[dict]:
    rng = np.random.RandomState(11)
    pats = []
    for n, length in SPEC_PATTERNS:
        pat = rng.randint(0, vocab, size=n).tolist()
        pats.append({"tokens": (pat * length)[:length],
                     "max_new_tokens": SPEC_NEW})
    return request_bodies(vocab) + pats


def count_verify_tokens(dec) -> dict:
    """Wrap ``dec._dispatch_block`` to count the tokens verify steps route
    to live requests, and the rows they reach."""
    counted = {"tokens": 0, "rows": 0}
    route = dec._dispatch_block

    def counting(toks, emitted):
        live = [s for s in range(dec.slots) if dec._slot_req[s] is not None]
        counted["tokens"] += int(emitted[live].sum())
        counted["rows"] += int(emitted[live, 0].sum())
        route(toks, emitted)

    dec._dispatch_block = counting
    return counted


def spec_run(server, reqs: list[dict], counted: dict) -> dict:
    """All of ``reqs`` at once over HTTP: tokens/s, the decoder's counter
    deltas, the paged kernel's launches against the forwards that read
    through it (a verify's scoring pass walks the span; its commit pass
    and every decode forward read through the kernel)."""
    from kubeflow_tpu_torch import kernels

    dec = server.decoder
    m0, tok0, rows0 = dec.metrics(), counted["tokens"], counted["rows"]
    results: list = [None] * len(reqs)

    def go(i):
        results[i] = post(server.port, reqs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    kernels.reset_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["paged_decode_attention"]
    m1 = dec.metrics()
    for body, res in zip(reqs, results):
        if res is None or len(res[0]) != body["max_new_tokens"]:
            raise AssertionError(f"speculation request: {res}")
    delta = {k: m1[k] - m0[k] for k in (
        "decode_steps", "spec_verify_dispatches", "spec_drafted_tokens",
        "spec_accepted_tokens", "tokens_emitted")}
    forwards = (delta["decode_steps"]
                - dec.chunk_size * delta["spec_verify_dispatches"])
    tokens = sum(len(r[0]) for r in results)
    return {"tokens": tokens, "wall_s": wall,
            "decode_tokens_per_s": tokens / wall, "launches": launches,
            "kernel_forwards": forwards,
            "verify_tokens": counted["tokens"] - tok0,
            "verify_rows": counted["rows"] - rows0, **delta}


def dispatch_means(port: int) -> dict:
    samples = parse_exposition(get(port, "/monitoring/prometheus/metrics"))
    out = {}
    for kind in ("decode", "verify", "admit"):
        n = samples.get(f'serving_dispatch_seconds_count{{kind="{kind}"}}', 0)
        s_ = samples.get(f'serving_dispatch_seconds_sum{{kind="{kind}"}}', 0)
        out[kind] = {"count": n, "mean_ms": 1e3 * s_ / n if n else None}
    spec = {k: samples[f"serving_{k}_total"] for k in (
        "spec_drafted_tokens", "spec_accepted_tokens",
        "spec_verify_dispatches", "spec_draft_dispatches")}
    spec["spec_acceptance_rate"] = samples["serving_spec_acceptance_rate"]
    return {"dispatch": out, "exposition": spec}


def spec_f32_gates(dev=torch.device("cuda")) -> dict:
    """f32, greedy, (q)'s requests one at a time through decoders sharing
    one set of weights: speculation on (K 4) equals off, token for token,
    on paged fused, paged gathered, dense, dense with model:llama-1b and
    paged fused with chunk_size 2 (verify_chunk); llama-1b's width at
    F32_GATE_LAYERS layers."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    model = get_model(MODEL, dtype=torch.float32, n_layers=F32_GATE_LAYERS)
    params = model.init(model.config,
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cfg = model.config
    reqs = spec_requests(cfg.vocab_size)
    base = dict(slots=SLOTS, prefill_len=MAX_SEQ, max_new_tokens=SPEC_NEW,
                kv_block_size=BLOCK)

    def streams(**kw):
        dec = ContinuousDecoder(params, cfg, **{**base, **kw})
        try:
            toks = [dec.generate(r["tokens"],
                                 min(r["max_new_tokens"], SPEC_GATE_NEW),
                                 timeout=600)["tokens"] for r in reqs]
            return toks, dec.metrics()
        finally:
            dec.stop()
            del dec
            torch.cuda.empty_cache()

    paged = dict(kv_layout="paged")
    off = {"paged_fused": streams(**paged, kv_fused=True),
           "paged_gathered": streams(**paged),
           "dense": streams()}
    cases = {
        "paged_fused": ("paged_fused", dict(**paged, kv_fused=True)),
        "paged_gathered": ("paged_gathered", dict(**paged)),
        "dense": ("dense", {}),
        "dense_model_draft": ("dense", dict(draft_mode=f"model:{MODEL}")),
        "paged_fused_chunk2": ("paged_fused", dict(**paged, kv_fused=True,
                                                   chunk_size=2)),
    }
    out = {}
    for name, (ref, kw) in cases.items():
        toks, m = streams(speculative_k=SPEC_K, **kw)
        cmp = compare_streams(toks, off[ref][0])
        if not cmp["identical"]:
            first = next(((i, j) for i, (a, b) in enumerate(
                zip(toks, off[ref][0])) for j, (x, y) in enumerate(zip(a, b))
                if x != y), None)
            cmp["first_difference"] = first
        out[name] = {**cmp, **{k: m[k] for k in (
            "spec_verify_dispatches", "spec_drafted_tokens",
            "spec_accepted_tokens", "spec_draft_dispatches")}}
    out["off_layouts_agree"] = (
        off["paged_fused"][0] == off["paged_gathered"][0] == off["dense"][0])
    del params
    torch.cuda.empty_cache()
    return out


def phase_speculation() -> dict:
    """(q): llama-1b, bf16, 8 slots, max_seq_len 256, max_new_tokens 64,
    paged, Bs 16, kv_fused: (q)'s ten requests at once on a server with
    speculative_k 0 and one with 4 (n-gram drafts), alternating, two
    measured runs each after a warm-up; then one run on the dense default
    server with the draft model ``model:llama-1b`` and one without
    speculation; then the f32 gates."""
    from kubeflow_tpu_torch.serving.server import ModelServer

    cfgs = {k: engine_cfg(kv_fused=True, max_new_tokens=SPEC_NEW,
                          speculative_k=k) for k in (0, SPEC_K)}
    servers = {k: ModelServer(c, port=0) for k, c in cfgs.items()}
    runs: dict = {0: [], SPEC_K: []}
    try:
        for srv in servers.values():
            srv.start()
        cfg = servers[0].engine.model.config
        reqs = spec_requests(cfg.vocab_size)
        counted = {k: count_verify_tokens(srv.decoder)
                   for k, srv in servers.items()}
        for k, srv in servers.items():  # warm-up, unmeasured
            spec_run(srv, reqs, counted[k])
        for k in (0, SPEC_K, SPEC_K, 0):
            runs[k].append(spec_run(servers[k], reqs, counted[k]))
        read = {k: dispatch_means(srv.port) for k, srv in servers.items()}
        draft_k = servers[SPEC_K].decoder.metrics()["spec_draft_k"]
        n_layers = cfg.n_layers
    finally:
        for srv in servers.values():
            srv.stop()
        del servers
        torch.cuda.empty_cache()
    for k, rs in runs.items():
        for r in rs:
            if r["kernel_forwards"] <= 0 or \
                    r["launches"] != n_layers * r["kernel_forwards"]:
                raise AssertionError(
                    f"speculative_k={k}: paged decode kernel launched "
                    f"{r['launches']} times, expected {n_layers} layers x "
                    f"{r['kernel_forwards']} kernel-reading forwards")
    on = runs[SPEC_K]
    if not sum(r["spec_verify_dispatches"] for r in on):
        raise AssertionError("no verify round ran with speculation on")

    def spread(k):
        tps = sorted(r["decode_tokens_per_s"] for r in runs[k])
        return {"median": tps[len(tps) // 2], "min": tps[0], "max": tps[-1],
                "runs": tps}

    verify_disp = sum(r["spec_verify_dispatches"] for r in on)

    def model_draft(server):
        dec = server.decoder
        counted_m = count_verify_tokens(dec)
        spec_run(server, reqs, counted_m)  # warm-up
        r = spec_run(server, reqs, counted_m)
        m = dec.metrics()
        return {**{k: r[k] for k in ("decode_tokens_per_s", "wall_s",
                                     "spec_verify_dispatches",
                                     "spec_drafted_tokens",
                                     "spec_accepted_tokens")},
                "tokens_per_verify_dispatch":
                    r["verify_tokens"] / max(r["spec_verify_dispatches"], 1),
                "tokens_per_row_per_verify":
                    r["verify_tokens"] / max(r["verify_rows"], 1),
                "spec_acceptance_rate": m["spec_acceptance_rate"],
                "spec_draft_dispatches": m["spec_draft_dispatches"],
                "spec_draft_k": m["spec_draft_k"]}

    from kubeflow_tpu_torch.serving.engine import EngineConfig

    def dense(**kw):
        return EngineConfig(model=MODEL, batch_size=SLOTS,
                            max_seq_len=MAX_SEQ, max_new_tokens=SPEC_NEW,
                            device="cuda", **kw)

    md = serve(dense(speculative_k=SPEC_K, draft_mode=f"model:{MODEL}"),
               model_draft)
    md["dense_off_tokens_per_s"] = serve(dense(), model_draft)[
        "decode_tokens_per_s"]
    if md["spec_draft_dispatches"] <= 0:
        raise AssertionError(f"the draft model proposed nothing: {md}")
    gates = spec_f32_gates()
    out = {
        "model": MODEL, "dtype": "bfloat16", "slots": SLOTS,
        "max_seq_len": MAX_SEQ, "max_new_tokens": SPEC_NEW,
        "block": BLOCK, "speculative_k": SPEC_K, "draft_mode": "ngram",
        "requests": [len(r["tokens"]) for r in spec_requests(32000)],
        "decode_tokens_per_s": {"off": spread(0), "on": spread(SPEC_K)},
        "order": "off, on, on, off",
        "exposition": read[SPEC_K]["exposition"],
        "spec_draft_k": draft_k,
        "tokens_per_verify_dispatch":
            sum(r["verify_tokens"] for r in on) / verify_disp,
        "tokens_per_row_per_verify":
            sum(r["verify_tokens"] for r in on)
            / max(sum(r["verify_rows"] for r in on), 1),
        "dispatch_ms": {"on": read[SPEC_K]["dispatch"],
                        "off": read[0]["dispatch"]},
        "launches": {k: [r["launches"] for r in rs]
                     for k, rs in (("off", runs[0]), ("on", on))},
        "kernel_forwards": {k: [r["kernel_forwards"] for r in rs]
                            for k, rs in (("off", runs[0]), ("on", on))},
        "runs": {"off": runs[0], "on": on},
        "model_draft_dense": md,
        "f32_gates": gates,
    }
    emit("q_speculation", **out)
    bad = [k for k, v in gates.items()
           if isinstance(v, dict) and not v["identical"]]
    if bad:
        raise AssertionError(f"f32 greedy tokens differ with speculation on: "
                             f"{bad}")
    if not gates["paged_fused"]["spec_verify_dispatches"]:
        raise AssertionError("the f32 gate ran no verify round")
    out["paged_launches"] = sum(r["launches"] for r in on)
    return out


# ---------------------------------------------------------------------------
# (h) the training main path, (i) f32 kernel-vs-plain training parity
# ---------------------------------------------------------------------------


def n_params(mcfg, active: bool = True) -> int:
    """A transformer's parameters; of an MoE model, those a token uses
    (the router and its top-k experts) unless ``active`` is False."""
    d, f, hd = mcfg.d_model, mcfg.d_ff, mcfg.head_dim
    ffn = 3 * d * f
    if mcfg.n_experts:
        ffn = d * mcfg.n_experts + ffn * (
            mcfg.expert_top_k if active else mcfg.n_experts)
    return (2 * mcfg.vocab_size * d + d + mcfg.n_layers * (
        d * (mcfg.n_heads + 2 * mcfg.n_kv_heads) * hd
        + mcfg.n_heads * hd * d + ffn + 2 * d))


def drive_train(cfg) -> dict:
    """``train.loop.run(cfg)`` (``log_every`` 1) with the launch counts
    reset just before it and read just after; losses and gradient norms
    finite, the first loss near ln(classes: the vocabulary, or ResNet's
    classes). Samples/s over the whole window from the end of step 1
    (which includes warm-up) to the end of the last step, so a stall in
    any step moves it; for a transformer also tokens/s and MFU (bench.py's
    formula, 6N + 12 * layers * avg attended length * attention width
    FLOPs a token, N the parameters a token uses, against 989 TFLOP/s);
    the median step beside them; MoE's router aux loss of each step; the
    peak of allocated memory over the run, with what was allocated before
    it (what earlier phases still hold) and the run's own rise above
    that."""
    import math

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train import loop

    lines, stamps = [], []

    def log(line):
        lines.append(line)
        stamps.append(time.perf_counter())

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = loop.run(cfg, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    model = get_model(cfg.model, **cfg.model_overrides)
    mcfg = model.config
    step_lines = [(line, at) for line, at in zip(lines, stamps)
                  if line.startswith("step=")]
    steps = [dict(kv.split("=", 1) for kv in line.split() if "=" in kv)
             for line, _ in step_lines]
    losses = [float(x["loss"]) for x in steps]
    norms = [float(x["grad_norm"]) for x in steps]
    if len(losses) != cfg.steps:
        raise AssertionError(f"{len(losses)} step lines, wanted "
                             f"{cfg.steps}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    classes = (mcfg.num_classes if model.family == "resnet"
               else mcfg.vocab_size)
    if abs(losses[0] - math.log(classes)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({classes})")
    # Each log line follows a sync (the loss read), so the stamps of the
    # step lines bound whole steps.
    step_stamps = [at for _, at in step_lines]
    timed_steps = cfg.steps - 1
    window_s = step_stamps[-1] - step_stamps[0]
    gaps = sorted(b - a for a, b in zip(step_stamps, step_stamps[1:]))
    out = {
        "model": cfg.model, "family": model.family,
        "batch": cfg.batch_size, "steps": cfg.steps,
        "optimizer": cfg.optimizer.name,
        "grad_dtype": cfg.optimizer.grad_dtype, "dtype": str(mcfg.dtype),
        "losses": losses, "grad_norms": norms, "launches": launches,
        "timed_steps": timed_steps, "window_s": window_s,
        "step_ms_mean": 1e3 * window_s / timed_steps,
        "step_ms_p50": 1e3 * gaps[len(gaps) // 2],
        "samples_per_s": timed_steps * cfg.batch_size / window_s,
    }
    if model.family != "resnet":
        out.update(seq=cfg.seq_len, layers=mcfg.n_layers,
                   remat=mcfg.remat,
                   tokens_per_s=out["samples_per_s"] * cfg.seq_len)
    if model.family == "transformer":
        params = n_params(mcfg)
        flops_per_token = (6.0 * params + 12.0 * mcfg.n_layers
                           * (cfg.seq_len + 1) / 2 * mcfg.n_heads
                           * mcfg.head_dim)
        out.update(
            remat_policy=mcfg.remat_policy, params=params,
            mfu=flops_per_token * out["tokens_per_s"]
            / PEAK_OPS_PER_S["bf16"])
        if mcfg.n_experts:
            out["params_total"] = n_params(mcfg, active=False)
            out["router_aux_losses"] = [float(x["router_aux_loss"])
                                        for x in steps]
    return {
        **out,
        "wall_s": wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "allocated_before_gb": before / 1e9,
        "peak_memory_rise_gb": (torch.cuda.max_memory_allocated()
                                - before) / 1e9,
        "loop_result": result,
    }


def phase_train(smi: str) -> dict:
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    cfg = loop.RunConfig(
        model=TRAIN_MODEL, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        steps=TRAIN_STEPS, log_every=1, prefetch=2, device="cuda",
        optimizer=OptimizerConfig(name="adafactor", warmup_steps=2))
    out = drive_train(cfg)
    want = out["layers"] * TRAIN_STEPS
    for key in ("flash_attention_fwd", "flash_attention_bwd"):
        if out["launches"][key] != want:
            raise AssertionError(f"{key} launched {out['launches'][key]} "
                                 f"times, expected {out['layers']} layers "
                                 f"x {TRAIN_STEPS} steps")
    out = {"gpu": smi, **out}
    emit("h_train_main_path", **out)
    return out


def _train_steps(dev, model_name: str, steps: int, seq: int, *, mesh=None,
                 **overrides):
    """(metrics, params, launches) of ``steps`` train steps of
    ``model_name`` in f32 with ``overrides``, adafactor with a 1-step
    warmup, from seed-0 weights on seed-5 synthetic tokens, batch 1; over
    ``mesh`` when one is given."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_stream
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.trainer import build_train_step, init_state
    from kubeflow_tpu_torch.weights import flatten

    model = get_model(model_name, dtype=torch.float32, **overrides)
    opt_cfg = OptimizerConfig(name="adafactor", warmup_steps=1)
    state = init_state(torch.Generator(device=dev).manual_seed(0), model,
                       opt_cfg, mesh, device=dev)
    step_fn = build_train_step(model, opt_cfg, mesh)
    stream = synthetic_stream(model, 1, seq, seed=5)
    kernels.reset_launches()
    metrics = []
    for _ in range(steps):
        state, met = step_fn(state, place_batch(next(stream), dev))
        metrics.append({k: float(met[k]) for k in ("loss", "grad_norm")})
    return metrics, flatten(state.params), dict(kernels.LAUNCHES)


def _compare(got, ref) -> dict:
    """Two runs' (metrics, params): the largest relative error of the
    losses and gradient norms, the largest parameter error relative to
    its leaf's largest magnitude, and whether they are bit for bit
    equal."""
    (m_a, p_a), (m_b, p_b) = got, ref
    return {
        "max_rel_err_loss_grad_norm": max(
            abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(m_a, m_b)
            for k in ("loss", "grad_norm")),
        "max_param_err_rel_to_leaf_max": max(
            ((p - p_b[n]).abs().max() / p_b[n].abs().max()).item()
            for n, p in p_a.items()),
        "bitwise": m_a == m_b and all(torch.equal(p, p_b[n])
                                      for n, p in p_a.items())}


def _check_close(name: str, errs: dict, tol: float) -> None:
    if errs["max_rel_err_loss_grad_norm"] > tol or \
            errs["max_param_err_rel_to_leaf_max"] > tol:
        raise AssertionError(f"{name}: {errs} past {tol}")


def phase_train_f32_parity() -> dict:
    dev = torch.device("cuda")
    runs = {impl: _train_steps(dev, TRAIN_MODEL, 3, 1024, attn_impl=impl)
            for impl in ("splash", "xla")}
    launches = {impl: run[2] for impl, run in runs.items()}
    if launches["splash"]["flash_attention_fwd"] != 9 or \
            launches["xla"]["flash_attention_fwd"] != 0:
        raise AssertionError("kernel counts do not show which run used the "
                             f"kernels: {launches}")
    errs = _compare(runs["splash"][:2], runs["xla"][:2])
    out = {"model": TRAIN_MODEL, "dtype": "float32", "batch": 1,
           "seq": 1024, "steps": 3, "kernel": runs["splash"][0],
           "plain": runs["xla"][0], **errs, "launches": launches}
    emit("i_train_f32_kernel_vs_plain", **out)
    _check_close("f32 training: kernel and plain runs", errs, 1e-5)
    return out


# ---------------------------------------------------------------------------
# (r) flagship-deep: its training under remat, and the f32 gates of remat,
# the chunked loss, resume and the profiler hook
# ---------------------------------------------------------------------------


def phase_deep_train(smi: str) -> dict:
    """flagship-deep at full width and depth through ``train.loop.run``,
    batch 4 x seq 2048, bf16 compute on f32 masters, adafactor,
    ``grad_dtype="bfloat16"`` (bench.py:456-458's recipe), synthetic
    tokens, under remat "llm", "llm_res" and off. Each flash kernel must
    launch the expected number of times: the backward once a layer a
    step, the forward once more where the backward recomputes it."""
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    runs = {}
    for policy in DEEP_POLICIES:
        overrides = ({"remat": True, "remat_policy": policy} if policy
                     else {"remat": False})
        cfg = loop.RunConfig(
            model=DEEP_MODEL, model_overrides=overrides,
            batch_size=DEEP_BATCH, seq_len=DEEP_SEQ, steps=DEEP_STEPS,
            log_every=1, prefetch=2, device="cuda",
            optimizer=OptimizerConfig(name="adafactor", warmup_steps=2,
                                      grad_dtype="bfloat16"))
        out = drive_train(cfg)
        rerun = policy not in (None, "llm_res")
        want = {"flash_attention_fwd":
                out["layers"] * DEEP_STEPS * (2 if rerun else 1),
                "flash_attention_bwd": out["layers"] * DEEP_STEPS}
        for key, n in want.items():
            if out["launches"][key] != n:
                raise AssertionError(f"flagship-deep ({policy}): {key} "
                                     f"launched {out['launches'][key]} "
                                     f"times, expected {n}")
        out["expected_launches"] = want
        runs[policy or "off"] = out
        emit("r_deep_train", gpu=smi, policy=policy or "off", **out)
    return runs


def _leaf_diff(flat_a: dict, flat_b: dict) -> tuple[bool, float]:
    """(bit for bit equal, largest difference relative to its leaf's
    largest magnitude) of two checkpoints' leaves."""
    if set(flat_a) != set(flat_b):
        raise AssertionError("the checkpoints hold different leaves")
    rel = max(float(np.abs(flat_a[k].astype(np.float64) - flat_b[k]).max()
                    / max(float(np.abs(flat_b[k]).max()), 1e-30))
              for k in flat_a)
    return all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_a), rel


def _resume_check(dev, workdir: str, data_path: str | None) -> dict:
    """A run of 4 steps, its checkpoint, then a resumed run to 8 against a
    straight run of 8, at f32 and reduced depth: the logged loss of every
    step and the final checkpoints (parameters, optimizer slots, counts),
    leaf by leaf. A second straight run says whether a run repeats bit for
    bit on this card; where it does, resume must too, and where it does
    not, resume must differ from the straight run by no more than 1e-5 of
    each leaf's largest magnitude."""
    import os

    from kubeflow_tpu_torch.train import checkpoint as ckpt
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    opt_cfg = OptimizerConfig(name="adafactor", warmup_steps=1)
    logs = {}

    def run(tag, steps, ckpt_dir):
        cfg = loop.RunConfig(
            model=DEEP_MODEL, model_overrides={
                "n_layers": DEEP_RESUME_LAYERS, "dtype": "float32"},
            batch_size=1, seq_len=512, steps=steps, log_every=1,
            prefetch=2, device=str(dev), optimizer=opt_cfg,
            data_path=data_path, checkpoint_dir=ckpt_dir)
        loop.run(cfg, log=lambda line: logs.setdefault(tag, []).append(
            line))

    def step_losses(tag):
        return [ln.split()[1] for ln in logs[tag] if ln.startswith("step=")]

    dirs = {tag: os.path.join(workdir, tag)
            for tag in ("straight", "again", "resumed")}
    run("straight", 8, dirs["straight"])
    run("again", 8, dirs["again"])
    run("first", 4, dirs["resumed"])
    run("second", 8, dirs["resumed"])
    if logs["second"][0] != "resumed from checkpoint step 4":
        raise AssertionError(f"no resume: {logs['second'][0]}")
    final = {tag: ckpt._load(d, 8) for tag, d in dirs.items()}
    repeat_bitwise, repeat_rel = _leaf_diff(final["again"], final["straight"])
    bitwise, rel = _leaf_diff(final["resumed"], final["straight"])
    out = {"data": "token_file" if data_path else "synthetic",
           "losses": step_losses("straight"),
           "resumed_losses": step_losses("first") + step_losses("second"),
           "bitwise": bitwise, "max_rel_diff": rel,
           "repeat_bitwise": repeat_bitwise, "repeat_max_rel_diff": repeat_rel,
           "leaves": len(final["straight"])}
    if repeat_bitwise and not bitwise or rel > 1e-5:
        raise AssertionError(f"resume differs from the straight run: {out}")
    return out


def phase_deep_gates(dev=torch.device("cuda")) -> dict:
    """f32 at reduced depth on the card: every remat policy and
    ``scan_group_size`` 2 against remat off (3 steps: losses, gradient
    norms and parameters within 1e-5, as (i)); ``loss_chunks`` 8 against
    the unchunked loss (1e-5: the same f32 sums in chunk order); resume
    against a straight run, on synthetic tokens and on a token file the
    script writes (bit for bit where a straight run repeats bit for bit:
    the same f32 operations on the same values; see ``_resume_check``);
    a ``profile_dir`` run whose trace names the flash kernels."""
    import glob
    import os
    import shutil
    import tempfile

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.tokenstore import write_token_file

    out = {"layers": DEEP_GATE_LAYERS, "batch": 1, "seq": 512,
           "dtype": "float32", "steps": 3}

    def steps(**overrides):
        return _train_steps(dev, DEEP_MODEL, 3, 512,
                            n_layers=DEEP_GATE_LAYERS, **overrides)

    ref_m, ref_p, ref_l = steps(remat=False)
    remat = {}
    for policy in REMAT_POLICIES + ("group2",):
        kw = ({"remat_policy": "llm", "scan_layers": True,
               "scan_group_size": 2} if policy == "group2"
              else {"remat_policy": policy})
        m, p, launches = steps(remat=True, **kw)
        remat[policy] = {**_compare((m, p), (ref_m, ref_p)),
                         "flash_fwd_launches": launches[
                             "flash_attention_fwd"]}
        del p
    out["remat_vs_off"] = remat
    out["off_flash_fwd_launches"] = ref_l["flash_attention_fwd"]
    m, p, _ = steps(remat=False, loss_chunks=8)
    out["loss_chunks_8_vs_unchunked"] = _compare((m, p), (ref_m, ref_p))
    del p, ref_p
    for name, errs in [*(("remat " + k, v) for k, v in remat.items()),
                       ("loss_chunks 8", out["loss_chunks_8_vs_unchunked"])]:
        _check_close(name, errs, 1e-5)
    torch.cuda.empty_cache()

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(dir=root)
    try:
        tokens = os.path.join(work, "corpus.ktpu")
        write_token_file(tokens, np.random.default_rng(0).integers(
            0, get_model(DEEP_MODEL).config.vocab_size, 200_000))
        out["resume"] = [
            _resume_check(dev, os.path.join(work, "synthetic"), None),
            _resume_check(dev, os.path.join(work, "token_file"), tokens)]
        prof_dir = os.path.join(work, "profile")
        lines = []
        loop.run(loop.RunConfig(
            model=DEEP_MODEL, model_overrides={"n_layers": DEEP_GATE_LAYERS},
            batch_size=1, seq_len=512, steps=4, log_every=1,
            device=str(dev),
            optimizer=OptimizerConfig(name="adafactor", warmup_steps=1),
            profile_dir=prof_dir, profile_start_step=1, profile_steps=2),
            log=lines.append)
        traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
        if f"profiler trace written to {prof_dir}" not in lines or \
                len(traces) != 1:
            raise AssertionError(f"no profiler trace: {traces} {lines}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels, flash = {}, {}
        for e in events:
            if e.get("cat") == "kernel":
                name = e.get("name", "")[:80]
                kernels[name] = kernels.get(name, 0) + 1
                if "flash_" in name:
                    flash[name] = flash.get(name, 0) + 1
        if not any("flash_fwd" in n for n in flash) or \
                not any("flash_bwd" in n for n in flash):
            raise AssertionError(f"the trace names no flash kernel: "
                                 f"{sorted(kernels)[:20]}")
        out["profile"] = {"trace_bytes": os.path.getsize(traces[0]),
                          "flash_kernels": flash}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("r_deep_f32_gates", **out)
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# (s) the single-replica serving features
# ---------------------------------------------------------------------------


def require_launches(launches: int, forwards: int, n_layers: int,
                     what: str) -> None:
    if forwards <= 0 or launches != n_layers * forwards:
        raise AssertionError(f"{what}: paged decode kernel launched "
                             f"{launches} times, expected {n_layers} layers "
                             f"x {forwards} decode forwards")


def timeline(port: int, rid: str) -> dict:
    recs = json.loads(get(port, f"/debug/requests?id={rid}"))["requests"]
    if len(recs) != 1:
        raise AssertionError(f"timeline of {rid}: {recs}")
    return recs[0]


def tier_copy_ms(dec, nblk: int, reps: int = 5) -> dict:
    """What demoting and promoting ``nblk`` blocks of ``dec``'s pool
    costs: the export (``_export_ids``: the gather, then the copy to
    pageable host memory, which returns when done) and the import of that
    payload into free blocks (``import_blocks`` from the host, then a
    synchronize); medians of ``reps`` runs, on blocks taken from the free
    list (cached entries evicted for them) and returned after."""
    from kubeflow_tpu_torch.models.decode import import_blocks
    from kubeflow_tpu_torch.serving.kv_tier import payload_nbytes

    with dec._prefix_lock:
        dec._reclaim_blocks(nblk)  # cached entries give their blocks back
        blocks = dec._alloc.alloc(nblk)
    try:
        exp, imp = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = dec._export_ids(blocks)
            exp.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            with dec._state_lock:
                import_blocks(dec._state["pool"], blocks, payload)
            torch.cuda.synchronize()
            imp.append(time.perf_counter() - t0)
    finally:
        with dec._prefix_lock:
            for b in blocks:
                dec._alloc.free(b)
    nbytes = payload_nbytes(payload)
    d, p = float(np.median(exp)), float(np.median(imp))
    return {"blocks": nblk, "bytes": nbytes, "demote_ms": 1e3 * d,
            "promote_ms": 1e3 * p, "demote_ms_per_block": 1e3 * d / nblk,
            "promote_ms_per_block": 1e3 * p / nblk,
            "demote_gb_per_s": nbytes / d / 1e9,
            "promote_gb_per_s": nbytes / p / 1e9}


def tier_run(kv_dtype: str) -> dict:
    """(s1) on one kv dtype: a primed prefix hit in HBM; eight requests
    that fill the pool, so the cached prefixes demote; a request over
    the demoted prefix (promoted, then a prefix hit); a cold admission.
    Streamed TTFT of each; launches counted over the whole run."""
    from kubeflow_tpu_torch import kernels

    def fn(server):
        dec, port = server.decoder, server.port
        cfg = server.engine.model.config
        rng = np.random.RandomState(11)

        def toks(n):
            return rng.randint(0, cfg.vocab_size, size=n).tolist()

        system = toks(TIER_SYSTEM)
        if not dec.prime_prefix(system):
            raise AssertionError("prime_prefix refused the system prompt")
        steps0 = dec.steps
        kernels.reset_launches()
        hbm = post(port, {"tokens": system + toks(8), "max_new_tokens": 8},
                   stream=True)
        pressure = [toks(12) for _ in range(TIER_PRESSURE)]
        got: list = [None] * TIER_PRESSURE

        def one(i):
            got[i] = post(port, {"tokens": pressure[i],
                                 "max_new_tokens": MAX_NEW})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(TIER_PRESSURE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(g is None or len(g[0]) != MAX_NEW for g in got):
            raise AssertionError(f"pressure requests: {got}")
        mid = dec.metrics()
        host = post(port, {"tokens": system + toks(8), "max_new_tokens": 8},
                    stream=True)
        after = dec.metrics()
        cold = post(port, {"tokens": toks(TIER_SYSTEM + 8),
                           "max_new_tokens": 8}, stream=True)
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = dec.steps - steps0
        m = dec.metrics()
        copy = tier_copy_ms(dec, TIER_SYSTEM // BLOCK)
        return {"launches": launches, "decode_forwards": forwards,
                "n_layers": cfg.n_layers, "mid": mid, "after": after,
                "m": m, "copy": copy,
                "ttft_ms": {"hbm_hit": 1e3 * hbm[1],
                            "host_tier_hit": 1e3 * host[1],
                            "cold": 1e3 * cold[1]},
                "tokens": [len(hbm[0]), len(host[0]), len(cold[0])]}

    r = serve(engine_cfg(kv_fused=True, kv_dtype=kv_dtype,
                         prefix_cache_slots=4, kv_pool_blocks=TIER_POOL,
                         host_kv_bytes=TIER_BYTES), fn)
    require_launches(r["launches"], r["decode_forwards"], r["n_layers"],
                     f"host tier ({kv_dtype})")
    mid, after, m = r["mid"], r["after"], r["m"]
    if (mid["kv_host_demotions"] < 2 or after["kv_host_hits"] < 1
            or after["kv_host_promotions"] < 1 or r["tokens"] != [8] * 3
            or after["prefix_hits"] != mid["prefix_hits"] + 1):
        raise AssertionError(f"host tier ({kv_dtype}): {r}")
    keys = ("kv_host_demotions", "kv_host_promotions", "kv_host_hits",
            "kv_host_evictions", "kv_host_tier_bytes",
            "kv_host_tier_high_water_bytes", "kv_host_tier_entries",
            "prefix_hits", "prefix_evictions", "kv_blocks_total")
    return {"kv_dtype": kv_dtype, **{k: m[k] for k in keys},
            "ttft_ms": r["ttft_ms"], **r["copy"],
            "launches": r["launches"], "decode_forwards": r["decode_forwards"]}


def suspend_run() -> dict:
    """(s2): a low-priority stream (tenant free) decoding when a
    high-priority request (tenant gold) arrives that the pool cannot hold
    beside it: the stream is suspended to the host tier and resumes after
    the gold finishes. Park-to-resume from the stream's timeline."""
    from kubeflow_tpu_torch import kernels

    def fn(server):
        dec, port = server.decoder, server.port
        cfg = server.engine.model.config
        rng = np.random.RandomState(12)
        victim = rng.randint(0, cfg.vocab_size, size=VICTIM_LEN).tolist()
        gold = rng.randint(0, cfg.vocab_size, size=GOLD_LEN).tolist()
        steps0 = dec.steps
        kernels.reset_launches()
        stamps: list = []
        res: dict = {}

        def run_victim():
            res["victim"] = post(port, {"tokens": victim,
                                        "max_new_tokens": MAX_NEW},
                                 stream=True, rid="s-victim", stamps=stamps,
                                 headers={"X-Tenant": "free"})

        th = threading.Thread(target=run_victim)
        th.start()
        deadline = time.perf_counter() + 120
        while not stamps and time.perf_counter() < deadline:
            time.sleep(0.002)
        gold_res = post(port, {"tokens": gold, "max_new_tokens": MAX_NEW},
                        rid="s-gold", headers={"X-Tenant": "gold"})
        th.join(timeout=600)
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = dec.steps - steps0
        events = {e["name"]: e["t_ms"]
                  for e in timeline(port, "s-victim")["events"]}
        return {"launches": launches, "decode_forwards": forwards,
                "n_layers": cfg.n_layers, "m": dec.metrics(),
                "victim": res.get("victim"), "gold": gold_res,
                "events": events}

    r = serve(engine_cfg(kv_fused=True, prefix_cache_slots=4,
                         kv_pool_blocks=SUSPEND_POOL,
                         host_kv_bytes=TIER_BYTES,
                         qos_tenants=QOS_TENANTS), fn)
    require_launches(r["launches"], r["decode_forwards"], r["n_layers"],
                     "suspension")
    m, ev = r["m"], r["events"]
    if (m["kv_suspends"] < 1 or m["kv_resumes"] < 1
            or "suspend" not in ev or "resume" not in ev
            or r["victim"] is None or len(r["victim"][0]) != MAX_NEW
            or len(r["gold"][0]) != MAX_NEW
            or m["kv_host_tier_pinned_bytes"] != 0):
        raise AssertionError(f"suspension: {r}")
    return {"kv_suspends": m["kv_suspends"], "kv_resumes": m["kv_resumes"],
            "kv_host_hits": m["kv_host_hits"],
            "kv_defer_admissions": m["kv_defer_admissions"],
            "tenant_served": m["tenant_served"],
            "park_to_resume_ms": ev["resume"] - ev["suspend"],
            "gold_ms": 1e3 * r["gold"][1],
            "launches": r["launches"], "decode_forwards": r["decode_forwards"]}


def post_json(port: int, verb: str, body: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", f"/v1/models/{MODEL}:{verb}",
                     body=json.dumps(body))
        resp = conn.getresponse()
        out = resp.read()
        if resp.status != 200:
            raise AssertionError(f":{verb}: HTTP {resp.status}: {out[:300]!r}")
        return json.loads(out)
    finally:
        conn.close()


def handoff_run() -> dict:
    """(s3): a role="prefill" server and a role="decode" server in this
    process. Over HTTP, :prefill with handoff_to pushes a 200-token
    prompt's KV to the decode server, whose predict then hits it; then
    the pieces of a second handoff timed apart: the prefill with its
    export, the export alone (``export_prompt`` of a prompt now cached),
    the pack and JSON encode, the JSON decode and unpack, the import
    (``import_prompt``)."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving import handoff
    from kubeflow_tpu_torch.serving.server import ModelServer

    servers = [ModelServer(engine_cfg(kv_fused=True, prefix_cache_slots=4,
                                      serving_role=role), port=0)
               for role in ("prefill", "decode")]
    try:
        for s in servers:
            s.start()
        pre, dec = servers
        vocab = pre.engine.model.config.vocab_size
        n_layers = pre.engine.model.config.n_layers
        rng = np.random.RandomState(13)
        prompts = [rng.randint(0, vocab, size=HANDOFF_LEN).tolist()
                   for _ in range(2)]
        steps0 = pre.decoder.steps + dec.decoder.steps
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = post_json(pre.port, "prefill", {
            "instances": [{"tokens": prompts[0]}],
            "handoff_to": f"127.0.0.1:{dec.port}"})
        http_ms = 1e3 * (time.perf_counter() - t0)
        if not out["handoff"]:
            raise AssertionError(f":prefill did not hand off: {out}")
        first = post(dec.port, {"tokens": prompts[0],
                                "max_new_tokens": MAX_NEW}, stream=True)
        t_pre = time.perf_counter()
        pre.decoder.export_prompt(prompts[1])  # its prefill, then export
        t0 = time.perf_counter()
        h = pre.decoder.export_prompt(prompts[1])  # export alone
        t1 = time.perf_counter()
        body = json.dumps(handoff.pack(h))
        t2 = time.perf_counter()
        h2 = handoff.unpack(json.loads(body))
        t3 = time.perf_counter()
        if not dec.decoder.import_prompt(h2):
            raise AssertionError("import_prompt refused the handoff")
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        second = post(dec.port, {"tokens": prompts[1],
                                 "max_new_tokens": MAX_NEW}, stream=True)
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = pre.decoder.steps + dec.decoder.steps - steps0
        m, mp = dec.decoder.metrics(), pre.decoder.metrics()
    finally:
        for s in servers:
            s.stop()
        del servers
        torch.cuda.empty_cache()
    require_launches(launches, forwards, n_layers, "handoff")
    if (m["kv_handoff_imports"] != 2 or m["prefix_hits"] != 2
            or mp["kv_handoff_exports"] != 3
            or [len(first[0]), len(second[0])] != [MAX_NEW] * 2):
        raise AssertionError(f"handoff: decode {m}, prefill {mp}")
    return {"prompt": HANDOFF_LEN, "prefix_len": h["prefix_len"],
            "envelope_bytes": len(body),
            "payload_bytes": sum(int(t.nbytes) for t in (
                h["payload"]["k"], h["payload"]["v"])),
            "http_prefill_push_ms": http_ms,
            "prefill_and_export_ms": 1e3 * (t0 - t_pre),
            "export_ms": 1e3 * (t1 - t0), "pack_ms": 1e3 * (t2 - t1),
            "unpack_ms": 1e3 * (t3 - t2), "import_ms": 1e3 * (t4 - t3),
            "ttft_after_handoff_ms": [1e3 * first[1], 1e3 * second[1]],
            "kv_handoff_exports": mp["kv_handoff_exports"],
            "kv_handoff_imports": m["kv_handoff_imports"],
            "kv_handoff_tokens": m["kv_handoff_tokens"],
            "launches": launches, "decode_forwards": forwards}


def checkpoint_boot(workdir: str) -> dict:
    """(s4, the boot): the port's trainer writes a llama-1b checkpoint (one
    step of ``train.loop.run``, batch 1 x seq 256, the default optimizer,
    whose state the engine restores, as JAX's does), then the CLI boots
    from it with ``--model-path`` and answers a request; its exposition
    counts a weight install from the checkpoint."""
    import os
    import shutil

    from kubeflow_tpu_torch.train.loop import RunConfig, run

    ckpt = os.path.join(workdir, "llama_ckpt")
    t0 = time.perf_counter()
    run(RunConfig(model=MODEL, batch_size=1, seq_len=MAX_SEQ, steps=1,
                  checkpoint_dir=ckpt), log=lambda *a, **k: None)
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ckpt) for f in fs)
    port = free_port()
    procs = [start_cli("--model-path", ckpt, "--kv-layout", "paged",
                       "--kv-fused-attention", "--grpc-port", "-1",
                       "--rest-port", str(port))]
    try:
        ready_s = wait_ready(procs[0][0], port, timeout=600)
        toks, _ = post(port, {"tokens": [1, 2, 3], "max_new_tokens": 8})
        samples = parse_exposition(get(port,
                                       "/monitoring/prometheus/metrics"))
    finally:
        stop_procs(procs)
        shutil.rmtree(ckpt, ignore_errors=True)
    installs = samples.get('serving_weight_pulls_total{source="checkpoint"}')
    if len(toks) != 8 or installs != 1:
        raise AssertionError(f"checkpoint boot: {toks}, installs {installs}")
    return {"checkpoint_bytes": size, "train_and_save_s": train_s,
            "cli_ready_s": ready_s, "weights_s": samples.get(
                'serving_cold_start_seconds{phase="weights"}'),
            "tokens": len(toks)}


def f32_gates(dev=torch.device("cuda")) -> dict:
    """(s5): float32, greedy, llama-1b's width at F32_GATE_LAYERS layers,
    decoders sharing one set of weights, each gate with the fused read (the paged kernel) and
    the gathered read (plain PyTorch): a host-tier hit = an HBM hit of the
    same primed prefix (fp and int8) and = a cold admission (fp); a
    suspended and resumed stream = the stream never suspended; decode
    after a handoff = colocated; admissions after a push = a decoder
    cold-started on the pushed weights."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder
    from kubeflow_tpu_torch.serving.qos import QosPolicy

    model = get_model(MODEL, dtype=torch.float32, n_layers=F32_GATE_LAYERS)
    cfg = model.config

    def init(seed):
        return model.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)

    w0, w1 = init(0), init(1)
    rng = np.random.RandomState(15)
    system = rng.randint(0, cfg.vocab_size, size=TIER_SYSTEM).tolist()
    ask = system + rng.randint(0, cfg.vocab_size, size=8).tolist()
    victim = rng.randint(0, cfg.vocab_size, size=VICTIM_LEN).tolist()
    gold = rng.randint(0, cfg.vocab_size, size=GOLD_LEN).tolist()
    base = dict(slots=SLOTS, prefill_len=MAX_SEQ, max_new_tokens=MAX_NEW,
                kv_layout="paged", kv_block_size=BLOCK,
                prefix_cache_slots=4)

    def decoder(params=w0, **kw):
        return ContinuousDecoder(params, cfg, **{**base, **kw})

    def run(fn, params=w0, **kw):
        d = decoder(params, **kw)
        try:
            return fn(d)
        finally:
            d.stop()
            torch.cuda.empty_cache()

    def gen(d, toks, n=16):
        return d.generate(toks, n, timeout=600)["tokens"]

    def tier_hit(d):
        gen(d, ask)  # publishes ask's prefix
        with d._prefix_lock:
            while d.prefix_cache.evict_lru():
                pass
        out = gen(d, ask)
        if d.metrics()["kv_host_hits"] < 1:
            raise AssertionError("the host-tier gate promoted nothing")
        return out

    def hbm_hit(d):
        if not d.prime_prefix(ask[:-1]):
            raise AssertionError("prime_prefix refused")
        return gen(d, ask)

    def suspended(d):
        h = d.submit(victim, MAX_NEW, tenant="free")
        while not h._req.out:
            time.sleep(0.002)
        d.generate(gold, MAX_NEW, tenant="gold", timeout=600)
        out = h.result(timeout=600)["tokens"]
        if d.metrics()["kv_suspends"] < 1:
            raise AssertionError("the suspension gate suspended nothing")
        return out

    def handoff(fused):
        h = run(lambda a: a.export_prompt(ask), kv_fused=fused,
                role="prefill")

        def imported(d):
            if not d.import_prompt(h):
                raise AssertionError("import_prompt refused the handoff")
            return gen(d, ask)

        return run(imported, kv_fused=fused, role="decode")

    def pushed(d):
        gen(d, ask)
        d.update_weights(w1)
        return gen(d, ask)

    qos = dict(qos=QosPolicy(QOS_TENANTS), host_kv_bytes=TIER_BYTES,
               kv_pool_blocks=SUSPEND_POOL)
    out = {}
    for fused in (True, False):
        side = "fused" if fused else "gathered"
        for kv in ("fp", "int8"):
            hit = run(tier_hit, kv_fused=fused, kv_dtype=kv,
                      host_kv_bytes=TIER_BYTES)
            ref = run(hbm_hit, kv_fused=fused, kv_dtype=kv)
            out[f"tier_{kv}_{side}"] = compare_streams([hit], [ref])
            if kv == "fp":
                cold = run(lambda d: gen(d, ask), kv_fused=fused,
                           prefix_cache_slots=0)
                out[f"tier_fp_vs_cold_{side}"] = compare_streams([hit],
                                                                 [cold])
        out[f"suspend_{side}"] = compare_streams(
            [run(suspended, kv_fused=fused, **qos)],
            [run(lambda d: gen(d, victim, MAX_NEW), kv_fused=fused)])
        out[f"handoff_{side}"] = compare_streams(
            [handoff(fused)], [run(lambda d: gen(d, ask), kv_fused=fused)])
        out[f"push_{side}"] = compare_streams(
            [run(pushed, kv_fused=fused)],
            [run(lambda d: gen(d, ask), params=w1, kv_fused=fused)])
    del w0, w1
    torch.cuda.empty_cache()
    bad = [k for k, v in out.items() if not v["identical"]]
    if bad:
        raise AssertionError(f"f32 greedy tokens differ: {bad}: {out}")
    return out


def phase_serving_features(smi: str) -> dict:
    """(s): llama-1b at full width and depth, bf16, 8 slots, paged,
    ``kv_fused``, through ``ModelServer`` over HTTP: the host tier on fp
    and int8 pools, suspension and resume, the prefill/decode handoff and
    a boot from a checkpoint; then the f32 gates (the live push over HTTP
    is (bb4)'s).
    The paged kernel launches n_layers times per decode forward in every
    bf16 run."""
    import os
    import shutil

    workdir = os.path.join("build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    out = {"gpu": smi}
    runs = (("host_tier", lambda: {kv: tier_run(kv)
                                   for kv in ("fp", "int8")}),
            ("suspension", suspend_run), ("handoff", handoff_run),
            ("checkpoint_boot", lambda: checkpoint_boot(workdir)),
            ("f32_gates", f32_gates))
    try:
        for name, fn in runs:
            out[name] = fn()
            emit(f"s_{name}", **out[name])  # each as it lands
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["launches"] = (sum(r["launches"] for r in out["host_tier"].values())
                       + sum(out[k]["launches"] for k in (
                           "suspension", "handoff")))
    out["decode_forwards"] = (
        sum(r["decode_forwards"] for r in out["host_tier"].values())
        + sum(out[k]["decode_forwards"] for k in (
            "suspension", "handoff")))
    emit("s_serving_features", gpu=smi, launches=out["launches"],
         decode_forwards=out["decode_forwards"])
    return out


# ---------------------------------------------------------------------------
# The other model families: (g) at BERT's attention, (t) MoE, (u) BERT,
# (v) ResNet
# ---------------------------------------------------------------------------

# (t): moe-1b at full width and depth (8 layers, d 1024, 16/4 heads, 8
# experts, top-2), trained at batch 4 x 2048; the f32 gates at 2 layers.
MOE_MODEL, MOE_BATCH, MOE_SEQ, MOE_STEPS, MOE_GATE_LAYERS = (
    "moe-1b", 4, 2048, 8, 2)
# (prompt length, max_new_tokens) of the MoE gates, one request at a time.
# Capacity follows the call's padded shape: a [1, 256] admission gives an
# expert 80 slots, lockstep's [8, 256] 640, a decode step of 8 slots 2. A
# prompt of at most 80 tokens (one choice an expert a token) and one row
# a decode step (two choices, on two experts) overflow none of them, so
# every path computes the same function and the tokens must agree.
MOE_GATE_REQUESTS = [(5, 32), (40, 16), (80, 32), (17, 8), (64, 24),
                     (33, 32)]
# (u): bert-base; a plain predict of 8 instances of these lengths at
# max_seq_len 128; training at batch 32 x 128; the f32 gate's batch.
BERT_MODEL, BERT_SEQ, BERT_BATCH, BERT_STEPS = "bert-base", 128, 32, 8
BERT_PREDICT_LENGTHS = [128, 5, 77, 128, 40, 100, 12, 64]
BERT_GATE_BATCH, BERT_GATE_LENGTHS = 4, [128, 40, 100, 7]
# (v): resnet50; a plain predict of 8 224x224 images; training at batch 32
# with tf_cnn.py's defaults (its RunConfig's optimizer); the BN gate's
# batch.
RESNET_MODEL, RESNET_BATCH, RESNET_STEPS, RESNET_GATE_BATCH = (
    "resnet50", 32, 8, 8)


def bert_mask(dev, b: int, s: int, seed: int = 5) -> torch.Tensor:
    """Key-padding masks of random lengths in 1..s; row 0 masks every key,
    as a pad row of a server batch does."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    mask[0] = False
    return mask


def decode_step_profile(params, cfg, dev, prompt: int = 128) -> dict:
    """One paged fused decode step of all SLOTS rows (each admitted with a
    ``prompt``-token prompt) through ``models/decode.py`` directly: the
    CUDA launches a step (``profiled_launches``), their device ms, and
    the step's time between CUDA events."""
    from kubeflow_tpu_torch.models import decode as D

    mb = (prompt + 128) // BLOCK
    state = D.init_paged_state(cfg, SLOTS, SLOTS * mb, BLOCK, mb,
                               device=dev)
    state["block_table"].copy_(torch.arange(
        SLOTS * mb, dtype=torch.int32, device=dev).reshape(SLOTS, mb))
    gen = torch.Generator(device=dev).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    full = torch.full((SLOTS,), prompt, dtype=torch.int32, device=dev)
    state, *_ = D.paged_admit_rows_and_step(
        state, params, cfg, torch.arange(SLOTS, device=dev), toks, full,
        full * 8, torch.zeros(SLOTS, device=dev), kv_fused=True)

    def step():
        return D.decode_step(state, params, cfg, kv_fused=True)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    events = profiled_launches(step, flush, 5)
    out = {"prompt": prompt, "slots": SLOTS,
           "launches_per_step": len(events) / 5,
           "device_ms": sum(e.device_time_total for e in events) / 5 / 1e3,
           "step_ms": time_ms(step, flush, 10)}
    out["idle_share"] = 1.0 - out["device_ms"] / out["step_ms"]
    del state, flush
    torch.cuda.empty_cache()
    return out


def moe_f32_gates(dev) -> dict:
    """(t)'s gates at f32 and MOE_GATE_LAYERS layers, seed-0 weights:
    greedy tokens of MOE_GATE_REQUESTS one at a time through the paged
    decoder with the fused read (the kernel) and the gathered one, the
    dense decoder and lockstep ``generate`` over the engine's padded
    batch (one real row) must agree; then three train steps with the
    flash kernels and with the plain path (``attn_impl="xla"``): losses,
    gradient norms and parameters within 1e-5."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    model = get_model(MOE_MODEL, dtype=torch.float32,
                      n_layers=MOE_GATE_LAYERS)
    cfg = model.config
    params = model.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    rng = np.random.RandomState(3)
    bodies = [(rng.randint(0, cfg.vocab_size, size=n).tolist(), want)
              for n, want in MOE_GATE_REQUESTS]
    streams, launched = {}, {}
    paged = dict(kv_layout="paged", kv_block_size=BLOCK)
    for name, kw in (("paged_fused", dict(paged, kv_fused=True)),
                     ("paged_gathered", paged), ("dense", {})):
        dec = ContinuousDecoder(params, cfg, slots=SLOTS,
                                prefill_len=MAX_SEQ, max_new_tokens=MAX_NEW,
                                **kw)
        kernels.reset_launches()
        try:
            streams[name] = [dec.generate(t, want, timeout=300)["tokens"]
                             for t, want in bodies]
        finally:
            dec.stop()
        launched[name] = kernels.LAUNCHES["paged_decode_attention"]
    if launched["paged_fused"] <= 0 or launched["paged_gathered"] or \
            launched["dense"]:
        raise AssertionError(f"MoE gates: paged kernel launches {launched}")
    lock = []
    for t, want in bodies:
        toks = torch.zeros((SLOTS, MAX_SEQ), dtype=torch.int32, device=dev)
        toks[0, :len(t)] = torch.tensor(t, dtype=torch.int32, device=dev)
        lengths = torch.ones(SLOTS, dtype=torch.int32, device=dev)
        lengths[0] = len(t)
        row_valid = torch.zeros(SLOTS, dtype=torch.bool, device=dev)
        row_valid[0] = True
        out, _ = generate(params, toks, lengths, cfg, max_new_tokens=MAX_NEW,
                          generator=torch.Generator(device=dev),
                          temperature=torch.zeros(SLOTS, device=dev),
                          row_valid=row_valid)
        lock.append(out[0, :want].tolist())
    streams["lockstep"] = lock
    tokens = {name: compare_streams(s, streams["paged_fused"])
              for name, s in streams.items()}
    del params
    torch.cuda.empty_cache()
    runs = {impl: _train_steps(dev, MOE_MODEL, 3, 1024, attn_impl=impl,
                               n_layers=MOE_GATE_LAYERS)
            for impl in ("splash", "xla")}
    fwd = MOE_GATE_LAYERS * 3 * (2 if cfg.remat else 1)
    launches = {impl: run[2] for impl, run in runs.items()}
    if launches["splash"]["flash_attention_fwd"] != fwd or \
            launches["xla"]["flash_attention_fwd"] != 0:
        raise AssertionError(f"MoE f32 training launches {launches}, "
                             f"expected {fwd} forwards on the kernel run")
    errs = _compare(runs["splash"][:2], runs["xla"][:2])
    out = {"layers": MOE_GATE_LAYERS, "requests": MOE_GATE_REQUESTS,
           "tokens": tokens, "paged_launches": launched,
           "train": {"kernel": runs["splash"][0], "plain": runs["xla"][0],
                     **errs, "launches": launches}}
    bad = [name for name, c in tokens.items() if not c["identical"]]
    if bad:
        raise AssertionError(f"MoE f32 greedy tokens differ from the paged "
                             f"fused run: {bad} ({tokens})")
    _check_close("MoE f32 training: kernel and plain runs", errs, 1e-5)
    return out


def phase_moe(smi: str) -> dict:
    """(t): moe-1b at full width and depth, bf16, seed-0 weights. (d)'s six
    requests over HTTP on the paged fused server (the paged kernel n_layers
    times a decode forward) and on the dense default server, with decode
    tokens/s and the streamed TTFT; a plain predict of 8 on the dense
    server (the flash forward n_layers times); one decode step's launches,
    device ms and step ms (``decode_step_profile``); 8 training steps at
    batch 4 x 2048 through ``train.loop.run`` (adafactor, the preset's
    remat "dots", so the backward runs each flash forward again); the f32
    gates (``moe_f32_gates``)."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    dev = torch.device("cuda")

    def paged_run(server):
        run = drive(server)
        cfg = server.engine.model.config
        want = cfg.n_layers * run["decode_forwards"]
        if run["launches"]["paged_decode_attention"] != want:
            raise AssertionError(
                f"moe-1b paged: {run['launches']} for "
                f"{run['decode_forwards']} decode forwards")
        run["decode_step"] = decode_step_profile(server.engine.params, cfg,
                                                 dev)
        return run

    def dense_run(server):
        run = drive(server)
        cfg = server.engine.model.config
        bodies = request_bodies(cfg.vocab_size)
        plain = [{"tokens": b["tokens"]} for b in bodies] + [
            {"tokens": bodies[4]["tokens"][:n]} for n in (64, 255)]
        kernels.reset_launches()
        t0 = time.perf_counter()
        preds = predict(server.port, plain, model=MOE_MODEL)
        run["plain_predict_ms"] = 1e3 * (time.perf_counter() - t0)
        run["plain_launches"] = dict(kernels.LAUNCHES)
        for pred in preds:
            logits = np.asarray(pred["logits"], np.float32)
            if logits.shape != (cfg.vocab_size,) or \
                    not np.isfinite(logits).all() or \
                    pred["next_token"] != int(np.argmax(logits)):
                raise AssertionError("moe-1b plain predict: bad logits")
        if run["plain_launches"]["flash_attention_fwd"] != cfg.n_layers or \
                run["launches"]["paged_decode_attention"]:
            raise AssertionError(f"moe-1b dense: {run['launches']}, plain "
                                 f"{run['plain_launches']}")
        return run

    paged = serve(engine_cfg(model=MOE_MODEL, kv_fused=True), paged_run)
    dense = serve(engine_cfg(model=MOE_MODEL, kv_layout="dense"), dense_run)
    train = drive_train(loop.RunConfig(
        model=MOE_MODEL, batch_size=MOE_BATCH, seq_len=MOE_SEQ,
        steps=MOE_STEPS, log_every=1, prefetch=2, device="cuda",
        optimizer=OptimizerConfig(name="adafactor", warmup_steps=2)))
    fwd = train["layers"] * MOE_STEPS * (2 if train["remat"] else 1)
    want = {"flash_attention_fwd": fwd,
            "flash_attention_bwd": train["layers"] * MOE_STEPS}
    for key, n in want.items():
        if train["launches"][key] != n:
            raise AssertionError(f"moe-1b training: {key} launched "
                                 f"{train['launches'][key]} times, "
                                 f"expected {n}")
    aux = train["router_aux_losses"]
    if len(aux) != MOE_STEPS or not all(np.isfinite(aux)) or \
            not all(a > 0 for a in aux):
        raise AssertionError(f"moe-1b router aux losses {aux}")
    gates = moe_f32_gates(dev)
    out = {"gpu": smi, "paged": paged, "dense": dense, "train": train,
           "gates": gates}
    emit("t_moe", **out)
    return out


def bert_forward_f64(flat: dict, tokens, pad_mask, cfg):
    """BERT's forward in float64 on the host, written out from the model's
    definition (word + position + type embeddings and a layer norm;
    post-norm layers of masked softmax attention and a tanh-GELU MLP; the
    tanh pooler on the first token), independent of the port's code:
    (sequence output [B, T, D], pooled [B, D])."""
    import torch.nn.functional as F

    p = {k: v.detach().cpu().double() for k, v in flat.items()}
    tokens, mask = tokens.long().cpu(), pad_mask.cpu().bool()
    b, t = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def norm(x, scale, bias):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + cfg.norm_eps) * scale + bias

    x = norm(p["embed/word"][tokens] + p["embed/position"][:t][None]
             + p["embed/type"][torch.zeros_like(tokens)],
             p["embed/ln/scale"], p["embed/ln/bias"])
    for i in range(cfg.n_layers):
        w = {k[len("layers/"):]: v[i] for k, v in p.items()
             if k.startswith("layers/")}

        def heads(name):
            y = x @ w[f"attn/w{name}"] + w[f"attn/b{name}"]
            return y.reshape(b, t, h, hd).transpose(1, 2)

        scores = heads("q") @ heads("k").transpose(-1, -2) * hd ** -0.5
        scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
        ctx = (torch.softmax(scores, -1) @ heads("v")).transpose(
            1, 2).reshape(b, t, h * hd)
        x = norm(x + ctx @ w["attn/wo"] + w["attn/bo"],
                 w["ln_attn/scale"], w["ln_attn/bias"])
        y = F.gelu(x @ w["mlp/wi"] + w["mlp/bi"], approximate="tanh")
        x = norm(x + y @ w["mlp/wo"] + w["mlp/bo2"], w["ln_mlp/scale"],
                 w["ln_mlp/bias"])
    pooled = torch.tanh(x[:, 0] @ p["pooler/kernel"] + p["pooler/bias"])
    return x, pooled


def bert_f32_gate(dev) -> dict:
    """(u)'s gate at f32, seed-0 weights of bert-base: the kernel path (the
    card) and the plain path (the same entry points on the CPU, the plain
    flash versions) on one padded batch (rows of BERT_GATE_LENGTHS real
    tokens under a ``pad_mask``). The sequence output and ``pooled`` of
    the card are held within 1e-5 of their largest magnitude against
    :func:`bert_forward_f64` (the host's f32 plain path read 3.3e-6 and
    1.44e-5 from the card on two machines; both paths' errors against the
    float64 forward are printed, and the two f32 paths' against each
    other); the MLM loss within 1e-5 relative and every gradient within
    1e-4 of its leaf's largest (or of 1e-3 of the largest of all, where
    that is larger) of the plain path's; and on the card a row alone
    equals the same row padded to 128 in a batch."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_batch
    from kubeflow_tpu_torch.weights import _unflatten, flatten

    model = get_model(BERT_MODEL, dtype=torch.float32)
    cfg = model.config
    params = model.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    batch = synthetic_batch(model, BERT_GATE_BATCH, BERT_SEQ, seed=7)
    lengths = np.asarray(BERT_GATE_LENGTHS)
    batch["pad_mask"] = (np.arange(BERT_SEQ)[None, :]
                         < lengths[:, None]).astype(np.float32)
    batch["mlm_labels"] = np.where(batch["pad_mask"] > 0,
                                   batch["mlm_labels"], -1).astype(np.int32)
    runs = {}
    for name, where in (("kernel", dev), ("plain", torch.device("cpu"))):
        leaves = {k: p.detach().to(where).requires_grad_(True)
                  for k, p in flatten(params).items()}
        tree = _unflatten(leaves)
        b = place_batch(batch, where)
        kernels.reset_launches()
        seq, pooled = model.apply(tree, b["tokens"], cfg,
                                  pad_mask=b["pad_mask"])
        loss, _ = model.loss_fn(tree, b, cfg)
        loss.backward()
        runs[name] = (seq.detach().cpu(), pooled.detach().cpu(),
                      loss.item(), {k: None if p.grad is None
                                    else p.grad.cpu()
                                    for k, p in leaves.items()},
                      dict(kernels.LAUNCHES))
    (seq_k, pool_k, loss_k, grads_k, launch_k) = runs["kernel"]
    (seq_p, pool_p, loss_p, grads_p, launch_p) = runs["plain"]
    seq_64, pool_64 = bert_forward_f64(
        flatten(params), torch.from_numpy(batch["tokens"]),
        torch.from_numpy(batch["pad_mask"]), cfg)

    def rel(a, b):
        return ((a.double() - b).abs().max() / b.abs().max()).item()

    # bk's gradient is zero up to rounding (softmax is blind to a shift
    # of every key by q·bk), so each leaf is held against the larger of
    # its own largest gradient and 1e-3 of the largest of all.
    largest = max(g.abs().max() for g in grads_p.values() if g is not None)
    grad_errs = {k: ((g - grads_p[k]).abs().max()
                     / torch.maximum(grads_p[k].abs().max(),
                                     1e-3 * largest)).item()
                 for k, g in grads_k.items() if g is not None}
    worst = max(grad_errs, key=grad_errs.get)
    out = {"batch": BERT_GATE_BATCH, "lengths": BERT_GATE_LENGTHS,
           "seq_err": rel(seq_k, seq_64), "pooled_err": rel(pool_k, pool_64),
           "plain_seq_err_vs_f64": rel(seq_p, seq_64),
           "plain_pooled_err_vs_f64": rel(pool_p, pool_64),
           "seq_err_vs_plain": rel(seq_k, seq_p.double()),
           "pooled_err_vs_plain": rel(pool_k, pool_p.double()),
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_err_rel_to_leaf_max": grad_errs[worst],
           "grad_err_worst_leaf": worst,
           "launches": {"kernel": launch_k, "plain": launch_p}}
    # Padding isolation on the card: row 1 alone against row 1 padded.
    n = BERT_GATE_LENGTHS[1]
    with torch.no_grad():
        tokens = torch.from_numpy(batch["tokens"]).to(dev)
        alone, pa = model.apply(params, tokens[1:2, :n], cfg)
        mask = torch.from_numpy(batch["pad_mask"][1:2]).to(dev)
        padded, pp = model.apply(params, tokens[1:2], cfg, pad_mask=mask)
    out["padding_seq_err"] = rel(padded[:, :n].cpu(), alone.cpu())
    out["padding_pooled_err"] = rel(pp.cpu(), pa.cpu())
    if launch_k["flash_attention_fwd"] != 2 * cfg.n_layers or \
            launch_k["flash_attention_bwd"] != cfg.n_layers or \
            launch_p["flash_attention_fwd"]:
        raise AssertionError(f"BERT gate launches: {out['launches']}")
    for key, tol in (("seq_err", 1e-5), ("pooled_err", 1e-5),
                     ("loss_rel_err", 1e-5),
                     ("grad_err_rel_to_leaf_max", 1e-4),
                     ("padding_seq_err", 1e-5),
                     ("padding_pooled_err", 1e-5)):
        if not out[key] <= tol:
            raise AssertionError(f"BERT f32 gate: {key} {out[key]} > {tol}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_bert(smi: str) -> dict:
    """(u): bert-base at full width and depth, bf16, seed-0 weights. A plain
    predict of 8 instances (BERT_PREDICT_LENGTHS, up to 128) over REST and
    over gRPC: the two bodies' ``pooled`` equal, finite, 768 wide, and the
    flash forward launched n_layers (12) times for the batch; the batch
    through the engine alone (call and device ms). 8 MLM training steps at
    batch 32 x 128 (adafactor): samples/s and each flash kernel n_layers
    times a step. The f32 gate (``bert_f32_gate``)."""
    import grpc

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.serving.grpc_server import client_stubs
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    dev = torch.device("cuda")

    def run(server):
        cfg = server.engine.model.config
        if server.decoder is not None:
            raise AssertionError("a BERT server built a decoder")
        rng = np.random.RandomState(4)
        instances = [{"tokens": rng.randint(0, cfg.vocab_size,
                                            size=n).tolist()}
                     for n in BERT_PREDICT_LENGTHS]
        predict(server.port, instances[:1], model=BERT_MODEL)  # warm-up
        kernels.reset_launches()
        t0 = time.perf_counter()
        rest = predict(server.port, instances, model=BERT_MODEL)
        out = {"rest_ms": 1e3 * (time.perf_counter() - t0),
               "launches": dict(kernels.LAUNCHES)}
        with grpc.insecure_channel(
                f"127.0.0.1:{server.grpc_port}") as channel:
            do_predict, _ = client_stubs(channel)
            t0 = time.perf_counter()
            body = do_predict(BERT_MODEL, instances, timeout=120)
            out["grpc_ms"] = 1e3 * (time.perf_counter() - t0)
        out["grpc_equals_rest"] = body["predictions"] == rest
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        batch = lambda: server.engine.predict_batch(instances)  # noqa: E731
        out["predict_batch_ms"] = time_ms(batch, flush, 5)
        out["predict_batch_device_ms"] = device_ms(batch, flush, 5)
        pooled = np.asarray([p["pooled"] for p in rest], np.float32)
        out["n_layers"] = cfg.n_layers
        if pooled.shape != (SLOTS, cfg.d_model) or \
                not np.isfinite(pooled).all():
            raise AssertionError(f"BERT pooled {pooled.shape}")
        return out

    served = serve(EngineConfig(model=BERT_MODEL, batch_size=SLOTS,
                                max_seq_len=BERT_SEQ, device="cuda"), run,
                   grpc_port=0)
    if not served["grpc_equals_rest"]:
        raise AssertionError("BERT: the gRPC body differs from the REST one")
    if served["launches"]["flash_attention_fwd"] != served["n_layers"]:
        raise AssertionError(f"BERT predict of {SLOTS} launched "
                             f"{served['launches']}, expected "
                             f"{served['n_layers']} flash forwards")
    train = drive_train(loop.RunConfig(
        model=BERT_MODEL, batch_size=BERT_BATCH, seq_len=BERT_SEQ,
        steps=BERT_STEPS, log_every=1, prefetch=2, device="cuda",
        optimizer=OptimizerConfig(name="adafactor", warmup_steps=2)))
    for key in ("flash_attention_fwd", "flash_attention_bwd"):
        if train["launches"][key] != train["layers"] * BERT_STEPS:
            raise AssertionError(f"BERT training: {key} launched "
                                 f"{train['launches'][key]} times")
    gate = bert_f32_gate(dev)
    out = {"gpu": smi, "predict": served, "train": train, "gate": gate}
    emit("u_bert", **out)
    return out


def plain_bn_stats(params, images) -> dict:
    """Every batch norm's merged running statistics of a train forward of
    ResNet-50, recomputed in plain PyTorch (NCHW, ``F.conv2d`` with XLA's
    padding, ``F.batch_norm`` to normalise): path → (mean, var), 0.9 ·
    old + 0.1 · the batch's, biased variance."""
    import torch.nn.functional as F

    stats = {}

    def conv(x, w, stride=1):
        k = w.shape[0]
        out = -(-x.shape[2] // stride)
        total = max((out - 1) * stride + k - x.shape[2], 0)
        x = F.pad(x, (total // 2, total - total // 2) * 2)
        return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)

    def bn(x, p, path):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        stats[path] = (0.9 * p["mean"] + 0.1 * mean,
                       0.9 * p["var"] + 0.1 * var)
        return F.batch_norm(x, None, None, p["scale"], p["bias"],
                            training=True, eps=1e-5)

    with torch.no_grad():
        x = images.permute(0, 3, 1, 2)
        x = F.relu(bn(conv(x, params["stem"]["conv"], 2),
                      params["stem"]["bn"], "stem/bn"))
        x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        for si, stage in enumerate(params["stages"]):
            for bi, p in enumerate(stage):
                stride = 2 if si > 0 and bi == 0 else 1
                path = f"stages/{si}/{bi}"
                h = F.relu(bn(conv(x, p["conv1"]), p["bn1"], f"{path}/bn1"))
                h = F.relu(bn(conv(h, p["conv2"], stride), p["bn2"],
                              f"{path}/bn2"))
                h = bn(conv(h, p["conv3"]), p["bn3"], f"{path}/bn3")
                if "proj" in p:
                    x = bn(conv(x, p["proj"], stride), p["bn_proj"],
                           f"{path}/bn_proj")
                x = F.relu(x + h)
    return stats


def resnet_bn_gate(dev) -> dict:
    """(v)'s gate: one train step of resnet50 in f32 (batch 8, sgd, seed-0
    weights) through the trainer; every batch norm's running statistics
    after it must equal ``plain_bn_stats`` of the step's own input and
    weights within 1e-5 of their largest magnitude. No kernel runs."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_batch
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.trainer import build_train_step, init_state
    from kubeflow_tpu_torch.weights import _unflatten, flatten

    model = get_model(RESNET_MODEL, dtype=torch.float32)
    opt = OptimizerConfig(name="sgd", warmup_steps=1)
    state = init_state(torch.Generator(device=dev).manual_seed(0), model,
                       opt, device=dev)
    before = {k: v.clone() for k, v in flatten(state.params).items()}
    batch = place_batch(synthetic_batch(model, RESNET_GATE_BATCH, seed=11),
                        dev)
    want = plain_bn_stats(_unflatten(before), batch["images"])
    kernels.reset_launches()
    state, met = build_train_step(model, opt)(state, batch)
    after = flatten(state.params)
    err = 0.0
    for path, (mean, var) in want.items():
        for key, ref in (("mean", mean), ("var", var)):
            got = after[f"{path}/{key}"]
            err = max(err, ((got - ref).abs().max()
                            / ref.abs().max()).item())
    moved = max((after[f"{p}/var"] - before[f"{p}/var"]).abs().max().item()
                for p in want)
    out = {"batch": RESNET_GATE_BATCH, "batch_norms": len(want),
           "max_err_rel_to_leaf_max": err, "largest_var_move": moved,
           "loss": float(met["loss"]), "launches": dict(kernels.LAUNCHES)}
    if len(want) != 53 or not err <= 1e-5 or not moved > 0 or \
            any(out["launches"].values()):
        raise AssertionError(f"ResNet BN gate: {out}")
    del state
    torch.cuda.empty_cache()
    return out


def phase_resnet(smi: str) -> dict:
    """(v): resnet50 at full size, bf16, seed-0 weights. A plain predict of
    8 random 224x224 images over REST: probabilities that sum to 1 and
    classes that are their argmax; the batch through the engine alone
    (call and device ms). 8 training steps at batch 32 through
    ``train.loop.run`` with tf_cnn.py's defaults (the default optimizer):
    samples/s, the median step, peak memory. The BN gate
    (``resnet_bn_gate``). No kernel of the port runs here: the TPU
    package computes ResNet without a Pallas kernel."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.engine import EngineConfig
    from kubeflow_tpu_torch.train import loop

    dev = torch.device("cuda")

    def run(server):
        cfg = server.engine.model.config
        rng = np.random.RandomState(5)
        images = [{"images": rng.standard_normal(
            (cfg.image_size, cfg.image_size, 3)).astype(np.float32).tolist()}
            for _ in range(SLOTS)]
        predict(server.port, images[:1], model=RESNET_MODEL)  # warm-up
        kernels.reset_launches()
        t0 = time.perf_counter()
        preds = predict(server.port, images, model=RESNET_MODEL)
        out = {"rest_ms": 1e3 * (time.perf_counter() - t0),
               "launches": dict(kernels.LAUNCHES)}
        for pred in preds:
            p = np.asarray(pred["probabilities"], np.float64)
            if p.shape != (cfg.num_classes,) or abs(p.sum() - 1) > 1e-3 or \
                    pred["classes"] != int(np.argmax(p)):
                raise AssertionError("ResNet predict: bad probabilities")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        batch = lambda: server.engine.predict_batch(images)  # noqa: E731
        out["predict_batch_ms"] = time_ms(batch, flush, 5)
        out["predict_batch_device_ms"] = device_ms(batch, flush, 5)
        return out

    served = serve(EngineConfig(model=RESNET_MODEL, batch_size=SLOTS,
                                device="cuda"), run)
    train = drive_train(loop.RunConfig(
        model=RESNET_MODEL, batch_size=RESNET_BATCH, steps=RESNET_STEPS,
        log_every=1, prefetch=2, device="cuda"))
    if any(served["launches"].values()) or any(train["launches"].values()):
        raise AssertionError("a kernel launched on the ResNet path")
    gate = resnet_bn_gate(dev)
    out = {"gpu": smi, "predict": served, "train": train, "gate": gate}
    emit("v_resnet", **out)
    return out


# ---------------------------------------------------------------------------
# (w) data-parallel and FSDP training over torch.distributed
# ---------------------------------------------------------------------------

# (w2): one rank of a gang of two on the one card over gloo (NCCL refuses
# two ranks on one GPU): which gloo collectives take CUDA tensors, three
# f32 steps of flagship-1b cut to 1 layer at data=2 on this rank's row of
# each global batch of two, and on rank 0 the same steps in one process
# over both rows; rank 0 prints the comparison as one JSON line.
W2_WORKER = """
import json, time
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.distributed import (initialize_from_env,
    shutdown)
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.train import data, trainer
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.weights import flatten

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
info = initialize_from_env(device="cuda", backend="gloo", timeout_s=300)
r, dev = info.process_id, torch.device("cuda", 0)
probe = {}
x = torch.ones(1024, device=dev)
for name, fn in (
        ("all_reduce", lambda: dist.all_reduce(x.clone())),
        ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(2048, device=dev), x)),
        ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(512, device=dev), x))):
    try:
        fn()
        torch.cuda.synchronize()
        probe[name] = "ok"
    except Exception as e:
        probe[name] = f"{type(e).__name__}: {str(e)[:120]}"
mesh = build_mesh(MeshConfig(data=2), device_type="cuda")
model = get_model("flagship-1b", dtype=torch.float32, n_layers=1)
# At lr 1e-2 three steps move every matrix by far more than the
# parameter tolerance below, so a gang that skipped or garbled an update
# fails it.
opt = OptimizerConfig(name="adafactor", warmup_steps=1, learning_rate=1e-2)
batches = [data.synthetic_batch(model, 2, 1024, seed=5 + i)
           for i in range(3)]

def run(mesh, rows):
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                               model, opt, mesh, device=dev)
    step = trainer.build_train_step(model, opt, mesh)
    init = {k: p.clone() for k, p in flatten(state.params).items()}
    mets, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, data.place_batch(rows(b), dev))
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return mets, flatten(state.params), times, init

mets, params, times, _ = run(mesh, lambda b: data.local_rows(b, r, 2))
if r == 0:
    ref, ref_params, ref_times, init = run(None, lambda b: b)
    rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mets, ref)
              for k in a)
    worst = max(((p - ref_params[n]).abs()
                 - 1e-4 * ref_params[n].abs()).max().item()
                for n, p in params.items())
    # The smallest matrix's largest move over the tolerance's largest.
    moved = min(((p - init[n]).abs().max()
                 / (1e-4 * p.abs().max() + 1e-5)).item()
                for n, p in ref_params.items() if p.ndim >= 2)
    print(json.dumps({"gloo_on_cuda": probe, "gang": mets, "one": ref,
                      "max_rel_err_loss_grad_norm": rel,
                      "max_param_excess_over_1e-4_rel": worst,
                      "min_matrix_update_over_tolerance": moved,
                      "gang_step_s": times, "one_step_s": ref_times}))
shutdown()
"""
MESH_WORKDIR = "build/chip_smoke/mesh"


def nccl_kernels(trace: str) -> tuple[int, float, dict]:
    """(launches, device ms) of the kernels named for NCCL in a Chrome
    trace ``torch.profiler`` wrote, and the count of each host-side
    all-reduce op in it (by name; c10d's op and its NCCL record)."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    own = [e for e in events if e.get("cat") == "kernel"
           and "nccl" in e.get("name", "").lower()]
    ops: dict = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel" and \
                re.search(r"all_?reduce", name, re.IGNORECASE):
            ops[name] = ops.get(name, 0) + 1
    return len(own), sum(e["dur"] for e in own) / 1e3, ops


def collective_checks(dev, mesh) -> dict:
    """The collectives' values at world size 1 over NCCL, on 64 MiB of
    f32 (each must return its input): psum, all_gather, reduce_scatter
    over the batch axes."""
    from kubeflow_tpu_torch.parallel import collectives as c
    from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES

    x = torch.randn(1 << 24, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    with torch.no_grad():
        for name, fn in (("psum", c.psum), ("all_gather", c.all_gather),
                         ("reduce_scatter", c.reduce_scatter)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(x, mesh, BATCH_AXES)
            torch.cuda.synchronize()
            out[name] = {"equal": bool(torch.equal(y, x)),
                         "call_ms": 1e3 * (time.perf_counter() - t0)}
            if not out[name]["equal"]:
                raise AssertionError(f"{name} at world size 1 changed its "
                                     "input")
    return out


def module_json_lines(module: str, *args: str, timeout: float = 300.0
                      ) -> list[dict]:
    """``python -m module args`` as a user runs it: exit 0, and its
    stdout's JSON lines."""
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def phase_mesh(smi: str, no_mesh: dict) -> dict:
    """(w) training over torch.distributed. (w1) In a process group of one
    rank over NCCL: ``train.loop.run`` at flagship-1b, 4 x 2048, bf16,
    adafactor, 8 steps with ``mesh={"data": 1, "fsdp": 1}`` (the mesh
    path's all-reduces of the gradients, the loss's count and the metrics
    run at world size 1: the collectives' byte counts must hold every
    parameter's f32 gradient a step and a profiled step's trace an
    all-reduce op), each
    flash kernel n_layers times a step, its tokens/s, MFU and median
    step beside (h)'s ``no_mesh`` run; a 4-step
    run with ``profile_dir`` gives the NCCL kernels' device ms of a step;
    the collectives' values at world size 1; the f32 gate at 2 layers
    (3 steps, batch 1 x 1024): the mesh step = the no-mesh step within
    1e-6 relative. (w2) ``W2_WORKER`` in a gang of two over gloo on the
    card: every step within tests/test_torch_train.py's f32 tolerances of
    one process on both rows, at a learning rate whose updates are over
    10x the parameter tolerance; its step time is gloo's, through the
    host. (w3) the allreduce smoke test and bandwidth benchmark as a user
    runs them (alone: NCCL at world size 1). (w4) the DDP workload on
    cuda:0, 10 steps."""
    import math
    import shutil

    from kubeflow_tpu_torch.parallel import collectives, distributed
    from kubeflow_tpu_torch.parallel.launch import launch
    from kubeflow_tpu_torch.parallel.mesh import single_device_mesh
    from kubeflow_tpu_torch.train import loop
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    common = dict(model=TRAIN_MODEL, batch_size=TRAIN_BATCH,
                  seq_len=TRAIN_SEQ, log_every=1, prefetch=2, device="cuda",
                  mesh={"data": 1, "fsdp": 1},
                  optimizer=OptimizerConfig(name="adafactor",
                                            warmup_steps=2))
    distributed.initialize_gang({}, device="cuda")
    try:
        collectives.reset_counts()
        train = drive_train(loop.RunConfig(steps=TRAIN_STEPS, **common))
        calls, moved = dict(collectives.CALLS), dict(collectives.BYTES)
        want = train["layers"] * TRAIN_STEPS
        for key in ("flash_attention_fwd", "flash_attention_bwd"):
            if train["launches"][key] != want:
                raise AssertionError(
                    f"mesh path: {key} launched {train['launches'][key]} "
                    f"times, expected {want}")
        # Only the mesh path reduces gradients: each step all-reduces at
        # least every parameter's f32 gradient.
        if moved["all_reduce"] < TRAIN_STEPS * 4 * train["params"]:
            raise AssertionError(
                f"the loop did not take the mesh path: {moved} bytes "
                f"through the collectives in {TRAIN_STEPS} steps")
        shutil.rmtree(MESH_WORKDIR, ignore_errors=True)
        loop.run(loop.RunConfig(steps=4, profile_dir=MESH_WORKDIR,
                                profile_start_step=2, profile_steps=1,
                                **common), log=lambda *a: None)
        (trace,) = [os.path.join(MESH_WORKDIR, n)
                    for n in os.listdir(MESH_WORKDIR)]
        nccl_launches, nccl_ms, allreduce_ops = nccl_kernels(trace)
        if not allreduce_ops:
            raise AssertionError("the mesh step's trace holds no "
                                 "all-reduce op")
        shutil.rmtree(MESH_WORKDIR, ignore_errors=True)
        mesh = single_device_mesh("cuda")
        checks = collective_checks(dev, mesh)
        runs = [_train_steps(dev, TRAIN_MODEL, 3, 1024, mesh=m,
                             n_layers=W_GATE_LAYERS)
                for m in (None, mesh)]
    finally:
        distributed.shutdown()
    gate = _compare(runs[1][:2], runs[0][:2])
    w1 = {"gpu": smi, "world_size": 1, "backend": "nccl", **train,
          "nccl_kernels_per_step": nccl_launches,
          "nccl_device_ms_per_step": nccl_ms,
          "allreduce_ops_per_step": allreduce_ops,
          "collective_calls_per_step": {
              k: v / TRAIN_STEPS for k, v in calls.items()},
          "collective_bytes_per_step": {
              k: v / TRAIN_STEPS for k, v in moved.items()},
          "no_mesh_h": {k: no_mesh[k] for k in (
              "tokens_per_s", "mfu", "step_ms_p50", "step_ms_mean")},
          "collectives_world1": checks,
          "f32_gate": {"layers": W_GATE_LAYERS, **gate}}
    emit("w1_mesh_nccl", **w1)
    _check_close("mesh step = no-mesh step", gate, 1e-6)

    t0 = time.perf_counter()
    procs = launch([sys.executable, "-c", W2_WORKER], 2, timeout=600)
    for i, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"(w2) rank {i} exited {p.returncode}:\n"
                                 f"{p.stderr[-3000:]}")
    w2 = json.loads(procs[0].stdout.strip().splitlines()[-1])
    w2.update(gpu=smi, wall_s=time.perf_counter() - t0,
              transport="gloo through the host (not NCCL)")
    emit("w2_gloo_gang_of_two", **w2)
    if w2["max_rel_err_loss_grad_norm"] > 1e-5 or \
            w2["max_param_excess_over_1e-4_rel"] > 1e-5 or \
            w2["min_matrix_update_over_tolerance"] < 10:
        raise AssertionError(f"(w2) the gang of two differs from one "
                             f"process: {w2}")

    smoke = module_json_lines("kubeflow_tpu_torch.workloads.allreduce_smoke")
    bench = module_json_lines("kubeflow_tpu_torch.workloads.allreduce_bench")
    if not smoke[-1]["ok"] or smoke[-1]["psum"] != 1.0:
        raise AssertionError(f"allreduce smoke: {smoke}")
    if any(r.get("algo_bandwidth_gbps", 0.0) != 0.0 for r in bench):
        raise AssertionError("bus bandwidth at n = 1 must read 0")
    w3 = {"gpu": smi, "smoke": smoke, "bench": bench}
    emit("w3_allreduce_workloads", **w3)
    ddp = module_json_lines("kubeflow_tpu_torch.workloads.torch_xla_ddp",
                            "--steps", "10")[-1]
    if not (ddp["steps"] == 10 and math.isfinite(ddp["loss"])):
        raise AssertionError(f"DDP workload: {ddp}")
    emit("w4_ddp_workload", gpu=smi, **ddp)
    out = {"w1": w1, "w2": w2, "w3": w3, "w4": ddp,
           "phase_s": time.perf_counter() - t_phase}
    emit("w_phase_time", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# (x) tensor parallelism: a replica of two shards on the card, a gang of
# two tensor ranks
# ---------------------------------------------------------------------------

TP = 2
# Both shards of the replica on the one card: every launch and every sum
# across the shards runs, the shards one after the other.
TP_DEVICES = ("cuda:0",) * TP
# The paged kernel on one of llama-1b's shards: Hkv 8 over 2, G 2.
PAGED_TP_SHARD = dict(hkv=8 // TP, g=2, hd=128)
# flagship-1b's attention on one of two tensor ranks, 1 x 2048 rows.
FLASH_TP_RANK = dict(b=1, t=2048, s=2048, hq=32 // TP, hkv=4 // TP, hd=128,
                     causal=True)
X_GATE_LAYERS, X_TRAIN_STEPS, X_CHUNK_PROMPT = 2, 2, 300
GANG_RESULT = "build/chip_smoke/gang_result.json"

# One rank of a gang of two on the card over gloo, both on cuda:0 (NCCL
# refuses two ranks on one GPU); its argument is a JSON object: the
# device ("cuda", or "cpu" to try it on the host), the model and its
# overrides, the mesh, the full-size steps (0: none), the rows a batch
# rank takes and their length, whether a profiled step must name the
# flash kernels, and the f32 gate's depth, rows a batch rank, length and
# overrides. Under context parallelism a sequence rank takes its chunk of
# its rows' tokens. The full-size run: bf16, adafactor, each step's ms and
# metrics, the collectives' calls and bytes a step, the kernel launches,
# the flash kernels' names in a profiled step (one rank's profiler at a
# time; a session that misses them is tried again, as the ranks agree).
# The f32 gate: 3 steps of the gate's optimizer and learning rate (which
# move every matrix the loss reaches far past the parameter tolerance)
# over global batches of which each rank takes
# its batch rows, counting the MoE choices dropped past capacity; rank 0
# first runs one process over the whole batches, then gathers the gang's
# state and holds it against them. The gate's depth is ``gate_layers``
# layers (None: the depth ``gate_overrides`` sets, ResNet's stages). With
# ``replicas`` (a mesh whose ranks all hold the whole state) every rank
# also holds its own final state against rank 0's one process, broadcast
# to it, and reports its metrics; with ``one_mesh`` that one process runs
# over a mesh of rank 0 alone (the mesh path's sums). The gate's
# convolutions take cuDNN's deterministic algorithms. Every rank writes
# its result.
GANG_WORKER = """
import json, math, os, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from kubeflow_tpu_torch import kernels
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.models.transformer import count_dropped
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.distributed import (global_any,
    initialize_from_env)
from kubeflow_tpu_torch.parallel.launch import serve_jobs
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, MeshConfig,
    axis_index, axis_size, build_mesh, destroy_mesh)
from kubeflow_tpu_torch.train import data, trainer
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.weights import flatten


def job(a):
    torch.backends.cudnn.deterministic = False
    if a["device"] == "cuda":
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = initialize_from_env(device=a["device"], backend="gloo",
                               timeout_s=900)
    r = info.process_id
    dev = torch.device("cuda", 0) if a["device"] == "cuda" else \
        torch.device(a["device"])
    mesh = build_mesh(MeshConfig(**a["mesh"]), device_type=dev.type)
    bi, bn = axis_index(mesh, BATCH_AXES), axis_size(mesh, BATCH_AXES)
    si, sn = axis_index(mesh, "sequence"), axis_size(mesh, "sequence")
    result = {"batch_index": bi}

    def mine(model, b):
        b = data.local_rows(b, bi, bn)
        if getattr(model.config, "context_parallel", False):
            b = data.local_tokens(b, si, sn)
        return b

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def batches(model, rows, seq, seed, n):
        return [data.synthetic_batch(model, rows * bn, seq, seed=seed + i)
                for i in range(n)]

    if a["steps"]:
        model = get_model(a["model"], **a["overrides"])
        opt = OptimizerConfig(name="adafactor", warmup_steps=2)
        state = trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                                   model, opt, mesh, device=dev)
        step = trainer.build_train_step(model, opt, mesh)
        local = [data.place_batch(mine(model, b), dev) for b in
                 batches(model, a["rows"], a["seq"], 7, a["steps"])]
        kernels.reset_launches()
        collectives.reset_counts()
        mets, times = [], []
        for b in local:
            sync()
            t0 = time.perf_counter()
            state, met = step(state, b)
            mets.append({k: float(v) for k, v in met.items()})
            sync()
            times.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        calls, moved = dict(collectives.CALLS), dict(collectives.BYTES)
        names = []
        for turn in range(2 if dev.type == "cuda" and a["trace"] else 0):
            for attempt in range(3):
                if r == turn:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        state, _ = step(state, local[0])
                        sync()
                    names = sorted({e.key for e in prof.key_averages()
                                    if "flash" in e.key})
                else:
                    state, _ = step(state, local[0])
                    sync()
                if global_any(r == turn and len(names) >= 2):
                    break
        result.update({
            "rank_launches": launches, "flash_kernels_in_trace": names,
            "step_s": times, "metrics": mets,
            "collective_calls_per_step": {k: v / a["steps"]
                                          for k, v in calls.items()},
            "collective_bytes_per_step": {k: v / a["steps"]
                                          for k, v in moved.items()},
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else None})
        del state, step, local
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    one_mesh = build_mesh(MeshConfig(data=1), device_type=dev.type,
                          ranks=[0]) if a["one_mesh"] else None
    depth = {} if a["gate_layers"] is None else {"n_layers": a["gate_layers"]}
    gmodel = get_model(a["model"], dtype=torch.float32, **depth,
                       **a["gate_overrides"])
    gopt = OptimizerConfig(name=a["gate_opt"], warmup_steps=1,
                           learning_rate=a["gate_lr"])
    gbatches = batches(gmodel, a["gate_rows"], a["gate_seq"], 5, 3)

    def run(m, rows):
        st = trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                                gmodel, gopt, m, device=dev)
        fn = trainer.build_train_step(gmodel, gopt, m)
        ms, dropped = [], 0
        for b in gbatches:
            with count_dropped() as drops:
                st, met = fn(st, data.place_batch(rows(b), dev))
            dropped += int(sum(drops))
            ms.append({k: float(met[k]) for k in ("loss", "grad_norm",
                                                  "router_aux_loss")
                       if k in met})
        local = flatten(st.params)
        if m is not None:
            st = st.layout.gather_state(st)
        return ms, (None if st is None else flatten(st.params)), dropped, local

    # Rank 0's one process first; the gang's first collective waits for it.
    if r == 0:
        tree = gmodel.init(gmodel.config,
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev, param_dtype=torch.float32)
        init = {k: p.detach().clone() for k, p in flatten(tree).items()}
        # One process's gradient at the initial weights on the first batch. A
        # leaf whose gradient norm is at most ZERO_GRAD of the whole one's is
        # zero up to rounding (BERT's bk: softmax is blind to a shift of every
        # key by q.bk; the pooler and NSP head, which the MLM loss does not
        # reach): no update need move it.
        ZERO_GRAD = 1e-6
        leaves = flatten(tree)
        for p in leaves.values():
            p.requires_grad_(True)
        loss, _ = gmodel.loss_fn(tree, data.place_batch(gbatches[0], dev),
                                 gmodel.config)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        gnorm = {k: 0.0 if g is None else g.norm().item()
                 for k, g in zip(leaves, grads)}
        total = math.sqrt(sum(v * v for v in gnorm.values()))
        still = {k: v for k, v in gnorm.items() if v <= ZERO_GRAD * total}
        del tree, leaves, loss, grads
        one, one_params, one_dropped, _ = run(one_mesh, lambda b: b)
    gang, gang_params, dropped, gang_local = run(mesh, lambda b: mine(gmodel, b))
    result["gate_dropped"] = dropped
    if a["replicas"]:
        import torch.distributed as dist
        keys = sorted(gang_local)
        own = torch.cat([gang_local[k].detach().float().reshape(-1).cpu()
                         for k in keys])
        ref = torch.cat([one_params[k].float().reshape(-1).cpu()
                         for k in keys]) if r == 0 else torch.empty_like(own)
        dist.broadcast(ref, 0)
        result["replica_gate"] = {
            "metrics": gang,
            "param_excess_over_1e-4_rel": ((own - ref).abs()
                                           - 1e-4 * ref.abs()).max().item()}
    if r == 0:
        rel = max(abs(g[k] - o[k]) / abs(o[k]) for g, o in zip(gang, one)
                  for k in o)
        worst = max(((p.to(dev) - one_params[n]).abs()
                     - 1e-4 * one_params[n].abs()).max().item()
                    for n, p in gang_params.items())
        # The smallest matrix's largest move over the tolerance's largest,
        # over every leaf of two dims or more whose gradient is not zero up
        # to rounding.
        moved_min = min(((p - init[n]).abs().max()
                         / (1e-4 * p.abs().max() + 1e-5)).item()
                        for n, p in one_params.items()
                        if p.ndim >= 2 and n not in still)
        result["f32_gate"] = {
            "layers": a["gate_layers"] or a["gate_overrides"],
            "rows": a["gate_rows"] * bn,
            "seq": a["gate_seq"], "overrides": a["gate_overrides"],
            "gang": gang, "one": one, "max_rel_err_metrics": rel,
            "max_param_excess_over_1e-4_rel": worst,
            "min_matrix_update_over_tolerance": moved_min,
            "gradient_norm": total,
            "leaves_zero_gradient_up_to_rounding": still,
            "optimizer": a["gate_opt"], "learning_rate": a["gate_lr"],
            "one_process_dropped": one_dropped}
    with open(a["out"] + f".{r}", "w") as f:
        json.dump(result, f)
    destroy_mesh(mesh)
    if one_mesh is not None:
        destroy_mesh(one_mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

# One job a line of stdin (the port's gang protocol).
serve_jobs(job)
"""


def tp_serving_run(tp: int, model: str = MODEL) -> dict:
    """(d)'s requests over HTTP on a paged fused server of ``model``
    (llama-1b by default; full width and depth, bf16) of ``tp`` shards on
    TP_DEVICES: tokens/s and the streamed TTFT, the paged kernel's
    launches (tp x n_layers x the decode forwards), and the exposition's
    shard count and per-shard KV bytes."""
    from kubeflow_tpu_torch.serving.server import ModelServer

    kw = {} if tp == 1 else dict(tp_shards=tp, tp_devices=TP_DEVICES)
    server = ModelServer(engine_cfg(kv_fused=True, model=model, **kw),
                         port=0)
    server.start()
    try:
        n_layers = server.engine.model.config.n_layers
        out = drive(server)
        samples = parse_exposition(get(server.port,
                                       "/monitoring/prometheus/metrics"))
    finally:
        server.stop()
        del server
        torch.cuda.empty_cache()
    launches = out["launches"]["paged_decode_attention"]
    if out["decode_forwards"] <= 0 or \
            launches != tp * n_layers * out["decode_forwards"]:
        raise AssertionError(
            f"tp={tp}: paged kernel launched {launches} times, expected "
            f"{tp} shards x {n_layers} layers x {out['decode_forwards']} "
            "decode forwards")
    return {**{k: out[k] for k in ("decode_forwards", "tokens", "wall_s",
                                   "decode_tokens_per_s",
                                   "ttft_streamed_ms")},
            "paged_launches": launches,
            "serving_tp_shards": samples["serving_tp_shards"],
            "kv_bytes_per_token": samples["serving_kv_bytes_per_token"],
            "kv_bytes_total": samples["serving_kv_bytes_total"]}


def tp_f32_gates(dev, model_name: str = MODEL) -> dict:
    """f32, greedy, ``model_name`` (llama-1b by default) at full width
    and X_GATE_LAYERS layers, the
    requests one at a time through decoders sharing one set of weights:
    tp=2 on TP_DEVICES equals tp=1 token for token on the paged fused and
    gathered reads, the dense layout, chunked prefill (a 300-token prompt
    in chunks of 64 beside (d)'s) and speculation (``speculative_k`` 2 on
    the paged fused read, (q)'s requests); each request's logits after
    its last step agree within 1e-5 of their largest magnitude. Then a
    handoff of a 200-token prompt exported by a tp=2 prefill replica and
    imported by a tp=1 decode replica decodes as one exported at tp=1
    does, on the same calls; for a dense model both decode as a
    colocated tp=1 replica does (an MoE's capacity follows the call's
    shape, so a cold admission of the whole prompt may drop other
    choices than the handoff's calls, in JAX too)."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving import handoff
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    model = get_model(model_name, dtype=torch.float32,
                      n_layers=X_GATE_LAYERS)
    cfg = model.config
    params = model.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    reqs = request_bodies(cfg.vocab_size)
    rng = np.random.RandomState(17)
    long_req = {"tokens": rng.randint(0, cfg.vocab_size,
                                      size=X_CHUNK_PROMPT).tolist(),
                "max_new_tokens": 16}
    paged = dict(kv_layout="paged", kv_block_size=BLOCK)
    paths = {
        "paged_fused": (dict(paged, kv_fused=True), reqs),
        "paged_gathered": (paged, reqs),
        "dense": ({}, reqs),
        "chunked": (dict(paged, kv_fused=True, prefill_chunk_tokens=64,
                         max_prompt_len=512), reqs + [long_req]),
        "speculation": (dict(paged, kv_fused=True, speculative_k=2,
                             max_new_tokens=SPEC_NEW),
                        spec_requests(cfg.vocab_size)),
    }

    def run(tp, kw, prompts):
        tp_kw = {} if tp == 1 else dict(tp_shards=tp,
                                        tp_devices=TP_DEVICES)
        dec = ContinuousDecoder(params, cfg, **{
            **dict(slots=SLOTS, prefill_len=MAX_SEQ,
                   max_new_tokens=MAX_NEW), **kw, **tp_kw})
        try:
            kernels.reset_launches()
            toks, logits = [], []
            for r in prompts:
                toks.append(dec.generate(r["tokens"], r["max_new_tokens"],
                                         timeout=600)["tokens"])
                with dec._state_lock:
                    logits.append(dec._state["last_logits"].clone())
            return (toks, torch.stack(logits), dict(kernels.LAUNCHES),
                    dec.metrics())
        finally:
            dec.stop()
            del dec
            torch.cuda.empty_cache()

    out = {}
    for name, (kw, prompts) in paths.items():
        one, two = run(1, kw, prompts), run(TP, kw, prompts)
        cmp = compare_streams(two[0], one[0])
        err = ((two[1] - one[1]).abs().max()
               / one[1].abs().max()).item()
        out[name] = {**cmp, "last_logits_rel_err": err,
                     "paged_launches": [one[2]["paged_decode_attention"],
                                        two[2]["paged_decode_attention"]]}
        if name == "speculation":
            out[name]["spec_verify_dispatches"] = [
                one[3]["spec_verify_dispatches"],
                two[3]["spec_verify_dispatches"]]
        if name == "chunked":
            out[name]["prefill_chunks"] = [one[3]["prefill_chunks"],
                                           two[3]["prefill_chunks"]]

    prompt = reqs[3]["tokens"]
    roles = dict(paged, kv_fused=True, prefix_cache_slots=4,
                 prefix_cache_min_len=8)

    def decoder(tp, role):
        tp_kw = {} if tp == 1 else dict(tp_shards=tp,
                                        tp_devices=TP_DEVICES)
        return ContinuousDecoder(params, cfg, slots=SLOTS,
                                 prefill_len=MAX_SEQ,
                                 max_new_tokens=MAX_NEW, role=role,
                                 **roles, **tp_kw)

    def handed_off(tp):
        exp, imp = decoder(tp, "prefill"), decoder(1, "decode")
        try:
            h = exp.export_prompt(prompt)
            env = json.dumps(handoff.pack(h))
            if not imp.import_prompt(handoff.unpack(json.loads(env))):
                raise AssertionError(f"tp=1 import refused a tp={tp} "
                                     "export")
            got = imp.generate(prompt, MAX_NEW, timeout=600)["tokens"]
            return got, h, env, imp.metrics()["prefix_hits"]
        finally:
            exp.stop()
            imp.stop()
            del exp, imp

    ref, _, _, ref_hits = handed_off(1)
    got, h, env, hits = handed_off(TP)
    identical = got == ref and ref_hits >= 1
    if not cfg.n_experts:
        colo = decoder(1, "")
        try:
            identical &= colo.generate(prompt, MAX_NEW,
                                       timeout=600)["tokens"] == ref
        finally:
            colo.stop()
    del params
    torch.cuda.empty_cache()
    out["handoff_tp2_to_tp1"] = {
        "identical": identical, "prefix_len": h["prefix_len"],
        "tp_shards": h["tp_shards"],
        "envelope_mesh": json.loads(env)["mesh"],
        "envelope_bytes": len(env), "prefix_hits": hits}
    return out


def tp_kernel_checks(dev, flush, tag: str, paged_shape: dict, impl,
                     flash_shape: dict) -> tuple[dict, dict]:
    """The kernels at a model's tensor-shard shapes, run at the start with
    (b) and (g) while the profiler's records are whole (after the later
    phases, sessions in this process have kept 1-3 launches of 10): the
    paged kernel at a serving shard's ``paged_shape`` (bf16, f32, int8;
    cases ``{tag}_{kv}``) and the flash pair at a tensor rank's
    ``flash_shape`` through ``impl``, as the model calls it."""
    shard = paged_cases(dev, flush, [
        (f"{tag}_{kv}", kv, paged_shape) for kv in ("bf16", "f32", "int8")])
    rank_flash = phase_model_flash(dev, flush, f"{tag}_rank", impl,
                                   (flash_shape,))
    return shard, rank_flash


def rank_flash_timing(rank_flash: dict) -> dict:
    """The flash pair's times and errors at a tensor rank's shape, forward
    and backward, from :func:`tp_kernel_checks`."""
    return {part: {k: rank_flash["timing"][part][k] for k in (
        "ms", "call_ms", "plain_ms", "library_ms", "library_device_ms",
        "bound_ms", "bound_by")} | {"max_abs_err": rank_flash[
            "max_abs_err"][part]} for part in ("fwd", "bwd")}


def tp_serving_checks(smi: str, phase: str, model: str,
                      shard: dict) -> dict:
    """``model`` at full width and depth, bf16, paged fused, over HTTP: a
    server of two shards on the card beside a server of one
    (:func:`tp_serving_run`), the exposition's shard count and per-shard
    bytes (half the unsharded), the paged kernel's shard-shape checks
    (``shard``), and the f32 gates of :func:`tp_f32_gates`, each of which
    must hold and take its path."""
    serving = {tp: tp_serving_run(tp, model) for tp in (1, TP)}
    if serving[TP]["serving_tp_shards"] != TP or \
            2 * serving[TP]["kv_bytes_per_token"] != \
            serving[1]["kv_bytes_per_token"]:
        raise AssertionError(f"({phase}) exposition under tp: {serving}")
    gates = tp_f32_gates(torch.device("cuda"), model)
    out = {"gpu": smi, "model": model, "tp_devices": list(TP_DEVICES),
           "serving": {f"tp{tp}": run for tp, run in serving.items()},
           "tokens_per_s_ratio": serving[TP]["decode_tokens_per_s"]
           / serving[1]["decode_tokens_per_s"],
           "paged_shard_shape": shard, "f32_gates": gates}
    emit(phase, **out)
    for name, g in gates.items():
        if not g["identical"] or g.get("last_logits_rel_err", 0.0) > 1e-5:
            raise AssertionError(f"({phase}) f32 gate {name}: {g}")
    if min(gates["speculation"]["spec_verify_dispatches"]) <= 0 or \
            min(gates["chunked"]["prefill_chunks"]) <= 0 or \
            gates["handoff_tp2_to_tp1"]["prefix_hits"] < 1:
        raise AssertionError(f"({phase}) a gate did not take its path: "
                             f"{gates}")
    return out


class CardGang:
    """The GANG_WORKER gang of two on the card (the port's
    :class:`~kubeflow_tpu_torch.parallel.launch.Gang`), started at its
    first job and kept for the next ones, so each rank pays its start (the
    interpreter, torch, the CUDA context, the process group) once for
    every run of :func:`gang_run`. A job that fails or overruns closes the
    gang and the next job starts another; ``main`` stops it at the end."""

    def __init__(self) -> None:
        self.gang = None

    def run(self, name: str, args: dict, timeout: float) -> None:
        from kubeflow_tpu_torch.parallel.launch import Gang

        if self.gang is None or not self.gang.alive():
            self.stop()
            self.gang = Gang(2, GANG_WORKER, grace=60.0)
        try:
            self.gang.run(args, timeout)
        except RuntimeError as e:
            raise AssertionError(f"({name}) {e}") from None

    def stop(self) -> None:
        if self.gang is not None:
            self.gang.close()
            self.gang = None


GANG = CardGang()


def gang_run(smi: str, name: str, model: str, mesh: dict, steps: int,
             rows: int, seq: int, gate_rows: int, gate_seq: int,
             gate_overrides: dict, tol: float, gate_opt: str = "adafactor",
             gate_lr: float = 1e-2, overrides: dict | None = None,
             want: dict | None = None,
             gate_layers: int | None = X_GATE_LAYERS,
             replicas: bool = False, one_mesh: bool = False) -> dict:
    """One job (a run named ``name``) of the card's GANG_WORKER gang of
    two, ``GANG``; checks its f32 gate (metrics
    within ``tol`` relative of one process's, parameters within 1e-4
    relative + 1e-5, every matrix moved over 10x that limit; with
    ``replicas``, each rank's metrics and state so) and, with
    full-size steps of ``model`` with ``overrides``, each rank's flash
    launches (``want``; by default n_layers x steps each, twice the
    forwards under remat) and, where it launches them, the flash kernels
    named in each rank's trace."""
    import shutil

    from kubeflow_tpu_torch.models.registry import get_model

    os.makedirs(os.path.dirname(GANG_RESULT), exist_ok=True)
    overrides = overrides or {}
    if want is None:
        # A remat region runs its forward again in the backward.
        cfg = get_model(model, **overrides).config
        want = {"flash_attention_fwd": cfg.n_layers * steps * (
                    2 if getattr(cfg, "remat", False) else 1),
                "flash_attention_bwd": cfg.n_layers * steps}
    trace = any(want.values())
    args = dict(device="cuda", model=model, overrides=overrides, mesh=mesh,
                steps=steps, rows=rows, seq=seq, trace=trace,
                gate_layers=gate_layers, gate_rows=gate_rows,
                gate_seq=gate_seq, replicas=replicas, one_mesh=one_mesh,
                gate_overrides=gate_overrides, gate_opt=gate_opt,
                gate_lr=gate_lr, out=GANG_RESULT)
    t0 = time.perf_counter()
    GANG.run(name, args, timeout=900)
    ranks = []
    for i in range(2):
        with open(f"{GANG_RESULT}.{i}") as f:
            ranks.append(json.load(f))
    shutil.rmtree(os.path.dirname(GANG_RESULT), ignore_errors=True)
    # Each batch rank's own choices, once (a model-axis group counts the
    # same rows on every rank).
    dropped = sum({r["batch_index"]: r["gate_dropped"]
                   for r in ranks}.values())
    out = {"gpu": smi, "model": model, "mesh": mesh,
           "transport": "gloo through the host (not NCCL)",
           "wall_s": time.perf_counter() - t0, **ranks[0],
           "gang_dropped": dropped}
    if steps:
        out["rank1_launches"] = ranks[1]["rank_launches"]
        out.update({f"rank1_{k}": ranks[1][k] for k in (
            "flash_kernels_in_trace", "step_s", "collective_calls_per_step",
            "collective_bytes_per_step")})
    if steps:
        out["expected_flash_launches_per_rank"] = want
    emit(name, **out)
    if steps:
        for r in ranks:
            if any(r["rank_launches"][k] != n for k, n in want.items()):
                raise AssertionError(f"({name}) flash launches "
                                     f"{r['rank_launches']}, expected "
                                     f"{want}")
            if trace and (
                    not any("fwd" in n for n in r["flash_kernels_in_trace"])
                    or not any("bwd" in n
                               for n in r["flash_kernels_in_trace"])):
                raise AssertionError(f"({name}) a rank's trace does not "
                                     f"name the flash kernels: {r}")
    g = ranks[0]["f32_gate"]
    if g["max_rel_err_metrics"] > tol or \
            g["max_param_excess_over_1e-4_rel"] > 1e-5 or \
            g["min_matrix_update_over_tolerance"] < 10:
        raise AssertionError(f"({name}) the gang differs from one "
                             f"process: {g}")
    if dropped != g["one_process_dropped"]:
        raise AssertionError(f"({name}) the gang dropped {dropped} choices, "
                             f"one process {g['one_process_dropped']}")
    for i, r in enumerate(ranks if replicas else ()):
        rg = r["replica_gate"]
        rel = max(abs(x[k] - o[k]) / abs(o[k])
                  for x, o in zip(rg["metrics"], g["one"]) for k in o)
        if rel > tol or rg["param_excess_over_1e-4_rel"] > 1e-5:
            raise AssertionError(f"({name}) rank {i} differs from one "
                                 f"process: {rel}, {rg}")
    return out


def phase_tensor_parallel(smi: str, shard: dict, rank_flash: dict) -> dict:
    """(x) tensor parallelism. (x1) :func:`tp_serving_checks` on llama-1b:
    tokens/s and the streamed TTFT of two shards beside one, the paged
    kernel's launches (2 x 16 x the decode forwards), the exposition, the
    paged kernel at a shard's shape (B 8, Hkv 4, G 2, hd 128; bf16, f32,
    int8) within PAGED_TOL, the f32 gates (the kernel checks at a shard's
    and a rank's shapes are :func:`tp_kernel_checks`'s). (x2)
    :func:`gang_run`, a gang of two tensor ranks on the card over gloo:
    flagship-1b at full width and depth, bf16, 1 x 2048 rows on both
    ranks, each step's time, the collectives' calls and bytes a step, the
    flash kernels' launches and their names in a profiled step on each
    rank; the flash kernels at a rank's shape (Hq 16 over Hkv 2, hd 128,
    1 x 2048) against the plain versions under (g)'s limits; the f32
    gate at 2 layers (1 x 1024 rows, adafactor at lr 1e-2): the gang's
    losses and gradient norms within 1e-5 relative of one process's, its
    parameters within 1e-4 relative + 1e-5, every matrix moved over 10x
    that limit."""
    t_phase = time.perf_counter()
    x1 = tp_serving_checks(smi, "x1_tp_serving", MODEL, shard)
    x2 = gang_run(smi, "x2_tp_train", TRAIN_MODEL, {"tensor": TP},
                  X_TRAIN_STEPS, 1, FLASH_TP_RANK["t"], 1, 1024, {}, 1e-5)
    x2["flash_rank_shape"] = rank_flash_timing(rank_flash)
    emit("x2_flash_tp_rank", **x2["flash_rank_shape"])
    out = {"x1": x1, "x2": x2, "phase_s": time.perf_counter() - t_phase}
    emit("x_phase_time", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# (y) the mixture of experts over the mesh axes: moe-1b served by tensor
# shards and trained over tensor, expert and data; BERT over tensor
# ---------------------------------------------------------------------------

# The paged kernel on one of moe-1b's two shards: Hkv 4 over 2, G 4, hd 64.
PAGED_MOE_TP_SHARD = dict(hkv=4 // TP, g=4, hd=64)
# moe-1b's attention on one of two tensor ranks, 1 x 2048 rows: Hq 8 over
# Hkv 2 (G 4), hd 64, causal.
FLASH_MOE_TP_RANK = dict(FLASH_MOE, b=1, hq=16 // TP, hkv=4 // TP)
# moe-1b's attention on an expert or data rank (y2, y3): its whole heads,
# 1 x 2048 rows.
FLASH_MOE_EP_RANK = dict(FLASH_MOE, b=1)
# bert-base's attention on one of two tensor ranks (y4): 6 heads of 12,
# masked, 32 x 128 rows.
FLASH_BERT_TP_RANK = dict(FLASH_BERT, hq=12 // TP, hkv=12 // TP)
# (y2)-(y4): the steps at full size, the MoE gates' rows' length and
# capacity factor (experts overflow at 0.5).
Y_TRAIN_STEPS, Y_GATE_SEQ, Y_GATE_CF = 2, 512, 0.5


def phase_moe_mesh(smi: str, shard: dict, rank_flash: dict,
                   ep_rank_flash: dict, bert_rank_flash: dict) -> dict:
    """(y) the mixture of experts over the mesh axes, and BERT over tensor.
    (y1) moe-1b at full width and depth, bf16, paged fused, (d)'s six
    requests over HTTP: a server of two shards on the card beside one
    (tokens/s, streamed TTFT, paged launches 2 x 8 x the decode forwards,
    ``serving_tp_shards`` and the per-shard KV bytes); the paged kernel at
    a shard's shape (Hkv 2, G 4, hd 64; :func:`tp_kernel_checks`); the f32
    gates of :func:`tp_f32_gates` on moe-1b at 2 layers. (y2) moe-1b at
    full width and depth, 1 x 2048 rows a rank, Y_TRAIN_STEPS steps, in
    gloo gangs of two on the card over ``{"tensor": 2}`` and ``{"expert":
    2}``: each step's time, the collectives' calls and bytes a step, the
    flash kernels named in each rank's trace; the flash pair at a tensor
    rank's shape and at an expert rank's (B 1, moe-1b's whole heads;
    ``ep_rank_flash``) against the plain versions. (y3) the f32 gates at 2
    layers, capacity factor Y_GATE_CF: those two gangs and a
    ``{"data": 2}`` gang against one process on the global batch
    (losses, ``router_aux_loss`` and gradient norms within 1e-6
    relative), the data gang's dropped choices above 0 and equal to one
    process's. (y4) bert-base over ``{"tensor": 2}``: 4 MLM steps at 32 x
    128 and its f32 gate at 2 layers against one process (sgd at lr 1,
    1e-5); the flash pair at a tensor rank's shape (6 heads, masked;
    ``bert_rank_flash``) against the plain versions. The kernel checks
    run at the start (``main``), as (x)'s do."""
    t_phase = time.perf_counter()
    y1 = tp_serving_checks(smi, "y1_moe_tp_serving", MOE_MODEL, shard)
    cf = {"expert_capacity_factor": Y_GATE_CF}
    y2 = {}
    for axis in ("tensor", "expert"):
        y2[axis] = gang_run(smi, f"y2_moe_{axis}{TP}", MOE_MODEL,
                            {axis: TP}, Y_TRAIN_STEPS, 1, FLASH_MOE["t"], 1,
                            Y_GATE_SEQ, cf, 1e-6)
    y2["flash_rank_shape"] = rank_flash_timing(rank_flash)
    emit("y2_flash_moe_tp_rank", **y2["flash_rank_shape"])
    y2["flash_ep_rank_shape"] = rank_flash_timing(ep_rank_flash)
    emit("y2_flash_moe_ep_rank", **y2["flash_ep_rank_shape"])
    y3 = gang_run(smi, f"y3_moe_data{TP}", MOE_MODEL, {"data": TP}, 0, 1,
                  FLASH_MOE["t"], 1, Y_GATE_SEQ, cf, 1e-6)
    if y3["gang_dropped"] <= 0:
        raise AssertionError(f"(y3) no expert overflowed: {y3}")
    # sgd, as the CPU tests train BERT: bk's gradient is zero up to
    # rounding (softmax is blind to a shift of every key by q.bk), which a
    # normalising update turns into a step whose sign is the rounding's.
    # At lr 1 (an update of norm at most 1: the gradients are clipped to
    # 1) every matrix moves past 10x the parameter limit; at lr 0.1 the
    # least moved read 2.9x on an H100.
    y4 = gang_run(smi, f"y4_bert_tensor{TP}", BERT_MODEL, {"tensor": TP},
                  Y_TRAIN_STEPS, BERT_BATCH, BERT_SEQ, 8, BERT_SEQ, {}, 1e-5,
                  "sgd", 1.0)
    y4["flash_rank_shape"] = rank_flash_timing(bert_rank_flash)
    emit("y4_flash_bert_tp_rank", **y4["flash_rank_shape"])
    out = {"y1": y1, "y2": y2, "y3": y3, "y4": y4,
           "phase_s": time.perf_counter() - t_phase}
    emit("y_phase_time", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# (z) the sequence and pipeline axes: llama-1b served by a cp=2 ring and by
# two pipeline stages; flagship-1b trained over sequence, flagship-deep
# over pipeline
# ---------------------------------------------------------------------------

CP = PP = 2
# Both ring shards, and both stages, on the one card.
CP_DEVICES = ("cuda:0",) * CP
PP_DEVICES = ("cuda:0",) * PP
DEEP_MODEL = "flagship-deep"
Z_TRAIN_STEPS, Z_MICRO = 2, 4
# (z3)'s flagship-1b at full width, 1 of its 3 layers: its step is the
# all-reduce of the whole f32 gradient through gloo (4.52 GB at 3
# layers); the cut pays for (cc).
Z3_LAYERS = 1
PP_OVERRIDES = {"pipeline_stages": PP, "pipeline_microbatches": Z_MICRO}
# flagship-deep's attention on one stage's microbatch: 1 x 2048 rows, Hq
# 24 over Hkv 4, hd 128.
FLASH_PP_STAGE = dict(FLASH_DEEP, b=1)
RING_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def ring_span_check(dev) -> dict:
    """The ring's span read at llama-1b's chunk shape (q [1, 128, 16,
    128] at positions 1280-1407 of the gathered 1824-position row, Hkv 8)
    over CP shards on the card, against the gathered read the decoder
    takes without a ring, f32 and bf16: max abs error, and each one's
    CUDA-event time with L2 flushed (plain PyTorch both: JAX's ring is
    XLA einsums, no kernel)."""
    from kubeflow_tpu_torch.models.decode import _gqa_attention
    from kubeflow_tpu_torch.models.transformer import config
    from kubeflow_tpu_torch.ops.attention import ring_span_attention

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    total = MAX_PROMPT + MAX_NEW
    out = {"shape": {"q": [1, CHUNK_TOKENS, 16, 128], "positions": total,
                     "pos": 1280, "cp": CP}}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = config(MODEL, dtype=dtype)
        hkv, hq, hd = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
        gen = torch.Generator(device=dev).manual_seed(11)
        q = torch.randn(1, CHUNK_TOKENS, hq, hd, generator=gen,
                        device=dev).to(dtype)
        k, v = (torch.randn(1, total, hkv, hd, generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        pos = torch.tensor([1280], dtype=torch.int32, device=dev)
        cols = pos.long()[:, None] + torch.arange(CHUNK_TOKENS,
                                                  device=dev)[None]
        mask = (torch.arange(total, device=dev)[None, None, :]
                <= cols[:, :, None])[:, None, None]

        def ring():
            return ring_span_attention(q, k, v, pos, n_kv_heads=hkv,
                                       devices=CP_DEVICES)

        def gathered():
            return _gqa_attention(q, k, v, mask, cfg)

        err = (ring().reshape(1, CHUNK_TOKENS, -1)
               - gathered().float()).abs().max().item()
        name = "f32" if dtype == torch.float32 else "bf16"
        out[name] = {"max_abs_err": err, "tolerance": RING_TOL[dtype],
                     "ring_ms": time_ms(ring, flush, 10),
                     "gathered_ms": time_ms(gathered, flush, 10)}
        if err > RING_TOL[dtype]:
            raise AssertionError(f"(z1) the ring's span read differs from "
                                 f"the gathered read by {err} ({name})")
    return out


def cp_serving_run(cp: int) -> dict:
    """(o)'s chain (:func:`chunk_chain`) on a paged, gathered server of
    llama-1b (full size, bf16) whose chunk dispatches read through a
    ``cp``-shard ring on CP_DEVICES (none at cp 1): one chunk's ms, the
    long prompt's TTFT, the exposition's ``serving_cp_shards``."""
    kw = dict(prefill_chunk_tokens=CHUNK_TOKENS, max_prompt_len=MAX_PROMPT)
    if cp > 1:
        kw.update(cp_shards=cp, tp_devices=CP_DEVICES)

    def run(server):
        r = chunk_chain(server)
        r["exposition"] = parse_exposition(
            get(server.port, "/monitoring/prometheus/metrics"))
        return r

    r = serve(engine_cfg(**kw), run)
    want_chunks = -(-LONG_PROMPT // CHUNK_TOKENS) - 1
    lens = [len(x[0]) for x in r["results"]]
    if r["chunks"] != want_chunks or r["launches"] or \
            lens != [w for _, w in CHUNK_SHORT] + [MAX_NEW] or \
            r["status_1793"] != 413:
        raise AssertionError(f"(z1) cp={cp} chain: {r['chunks']} interior "
                             f"chunks, {r['launches']} paged launches (the "
                             f"gathered read takes none), tokens {lens}, "
                             f"status {r['status_1793']}")
    return {"cp_shards": cp, "interior_chunks": r["chunks"],
            "chunk_ms_mean": r["chunk_ms_mean"],
            "long_ttft_ms": 1e3 * r["results"][-1][1],
            "max_inter_token_gap_during_chain_ms": 1e3 * max(r["gaps"]),
            "decode_forwards": r["forwards"],
            "serving_cp_shards": r["exposition"]["serving_cp_shards"]}


def decoder_gate(dev, make, settings: dict, prompts: list) -> dict:
    """f32 greedy tokens of llama-1b at X_GATE_LAYERS layers, the prompts
    one at a time, through a decoder of each of ``settings`` (name ->
    decoder options) from ``make(options)``; each must equal the first
    setting's."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    model = get_model(MODEL, dtype=torch.float32, n_layers=X_GATE_LAYERS)
    params = model.init(model.config, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    toks = {}
    for name, kw in settings.items():
        dec = ContinuousDecoder(params, model.config, **make(kw))
        try:
            toks[name] = [dec.generate(r["tokens"], r["max_new_tokens"],
                                       timeout=600)["tokens"]
                          for r in prompts]
        finally:
            dec.stop()
            del dec
            torch.cuda.empty_cache()
    ref = next(iter(toks.values()))
    out = {name: compare_streams(t, ref) for name, t in toks.items()}
    for name, cmp in out.items():
        if not cmp["identical"]:
            raise AssertionError(f"(z) f32 gate {name}: {cmp}")
    del params
    torch.cuda.empty_cache()
    return out


def gate_prompts(long_len: int) -> list:
    """A ``long_len``-token prompt and a 40-token one, 16 new tokens
    each."""
    from kubeflow_tpu_torch.models.transformer import config

    vocab = config(MODEL).vocab_size
    rng = np.random.RandomState(23)
    return [{"tokens": rng.randint(0, vocab, size=long_len).tolist(),
             "max_new_tokens": 16},
            {"tokens": rng.randint(0, vocab, size=40).tolist(),
             "max_new_tokens": 16}]


def phase_cp_serving(smi: str) -> dict:
    """(z1) llama-1b, bf16, paged, gathered read, prefill_chunk_tokens
    128, max_prompt_len 1792: (o)'s 1500-token prompt while two streams
    decode, through a cp=2 ring on the card beside cp=1 (one chunk's ms,
    the long TTFT, ``serving_cp_shards``); the ring's span read at the
    chunk's shape against the gathered read (:func:`ring_span_check`);
    the f32 gate at 2 layers: cp=2 and cp=2 x tp=2 equal cp=1 on a
    300-token chain (chunks of 64) and a 40-token prompt."""
    dev = torch.device("cuda")
    runs = {f"cp{cp}": cp_serving_run(cp) for cp in (1, CP)}
    if runs[f"cp{CP}"]["serving_cp_shards"] != CP or \
            runs["cp1"]["serving_cp_shards"] != 1:
        raise AssertionError(f"(z1) serving_cp_shards: {runs}")
    ring = ring_span_check(dev)
    paged = dict(slots=SLOTS, prefill_len=MAX_SEQ, max_new_tokens=MAX_NEW,
                 kv_layout="paged", kv_block_size=BLOCK,
                 prefill_chunk_tokens=64, max_prompt_len=512)
    gates = decoder_gate(
        dev, lambda kw: {**paged, **kw},
        {"cp1": {}, f"cp{CP}": dict(cp_shards=CP, tp_devices=CP_DEVICES),
         f"cp{CP}xtp{TP}": dict(cp_shards=CP, tp_shards=TP,
                                tp_devices=("cuda:0",) * (CP * TP))},
        gate_prompts(300))
    out = {"gpu": smi, "model": MODEL, "cp_devices": list(CP_DEVICES),
           "serving": runs,
           "chunk_ms_ratio": runs[f"cp{CP}"]["chunk_ms_mean"]
           / runs["cp1"]["chunk_ms_mean"],
           "ring_span_read": ring, "f32_gates": gates}
    emit("z1_cp_serving", **out)
    return out


def stage_kv_bytes(dec) -> float:
    """KV bytes a token that stage 0 of ``dec`` holds: its part of the
    pool (or the dense rows), k and v, over the positions it backs."""
    from kubeflow_tpu_torch.models.decode import (
        _first,
        _kv_arr,
        _parts,
        _stage_list,
    )

    state = dec._state
    name = "pool" if "pool" in state else "cache"
    total = 0
    for side in ("k", "v"):
        for part in _parts(_stage_list(state[name][side])[0]):
            for t in (part.values() if isinstance(part, dict) else (part,)):
                total += t.numel() * t.element_size()
    arr = _kv_arr(_first(state[name]["k"]))
    return total / (arr.shape[1] * arr.shape[2])


def pp_serving_run(pp: int, layout: str) -> dict:
    """(d)'s requests over HTTP on a ``layout`` server of llama-1b (full
    size, bf16; the paged read gathered) of ``pp`` stages on PP_DEVICES:
    tokens/s, the streamed TTFT, ``serving_pp_stages``, the KV bytes a
    token a stage holds."""
    from kubeflow_tpu_torch.serving.server import ModelServer

    kw = {} if pp == 1 else dict(pp_stages=pp, tp_devices=PP_DEVICES)
    server = ModelServer(engine_cfg(kv_layout=layout, **kw), port=0)
    server.start()
    try:
        out = drive(server)
        samples = parse_exposition(get(server.port,
                                       "/monitoring/prometheus/metrics"))
        stage_bytes = stage_kv_bytes(server.decoder)
    finally:
        server.stop()
        del server
        torch.cuda.empty_cache()
    if out["decode_forwards"] <= 0 or out["launches"][
            "paged_decode_attention"]:
        raise AssertionError(f"(z2) pp={pp} {layout}: {out['launches']}, "
                             f"{out['decode_forwards']} decode forwards")
    return {**{k: out[k] for k in ("decode_forwards", "tokens", "wall_s",
                                   "decode_tokens_per_s",
                                   "ttft_streamed_ms")},
            "serving_pp_stages": samples["serving_pp_stages"],
            "kv_bytes_per_token_a_stage": stage_bytes}


def phase_pp_serving(smi: str) -> dict:
    """(z2) llama-1b, bf16, (d)'s six requests on servers of two pipeline
    stages (8 + 8 layers) on the card beside one, on the dense default
    layout and the paged gathered one: tokens/s, TTFT, the KV bytes a
    token a stage (half of one stage's); the f32 gate at 2 layers: pp=2
    equals pp=1 on the dense layout, paged, a 300-token chain (chunks of
    64) and at pp=2 x tp=2."""
    from kubeflow_tpu_torch.models.transformer import config

    dev = torch.device("cuda")
    runs = {f"{layout}_pp{pp}": pp_serving_run(pp, layout)
            for layout in ("dense", "paged") for pp in (1, PP)}
    for layout in ("dense", "paged"):
        one, two = runs[f"{layout}_pp1"], runs[f"{layout}_pp{PP}"]
        if two["serving_pp_stages"] != PP or \
                2 * two["kv_bytes_per_token_a_stage"] != \
                one["kv_bytes_per_token_a_stage"]:
            raise AssertionError(f"(z2) {layout}: {one} beside {two}")
    base = dict(slots=SLOTS, prefill_len=MAX_SEQ, max_new_tokens=MAX_NEW)
    paged = dict(kv_layout="paged", kv_block_size=BLOCK)
    pp_kw = dict(pp_stages=PP, tp_devices=PP_DEVICES)
    prompts = request_bodies(config(MODEL).vocab_size)
    gates = {
        "dense": decoder_gate(dev, lambda kw: {**base, **kw},
                              {"pp1": {}, f"pp{PP}": pp_kw}, prompts),
        "paged": decoder_gate(
            dev, lambda kw: {**base, **paged, **kw},
            {"pp1": {}, f"pp{PP}": pp_kw,
             f"pp{PP}xtp{TP}": dict(pp_stages=PP, tp_shards=TP,
                                    tp_devices=("cuda:0",) * (PP * TP))},
            prompts),
        "chunked": decoder_gate(
            dev, lambda kw: {**base, **paged, "prefill_chunk_tokens": 64,
                             "max_prompt_len": 512, **kw},
            {"pp1": {}, f"pp{PP}": pp_kw}, gate_prompts(300))}
    out = {"gpu": smi, "model": MODEL, "pp_devices": list(PP_DEVICES),
           "serving": runs,
           "tokens_per_s_ratio": {
               layout: runs[f"{layout}_pp{PP}"]["decode_tokens_per_s"]
               / runs[f"{layout}_pp1"]["decode_tokens_per_s"]
               for layout in ("dense", "paged")},
           "f32_gates": gates}
    emit("z2_pp_serving", **out)
    return out


def phase_long_axes(smi: str, stage_flash: dict) -> dict:
    """(z) the sequence and pipeline axes. (z1) :func:`phase_cp_serving`.
    (z2) :func:`phase_pp_serving`. (z3) :func:`gang_run`, a gloo gang of
    two over ``{"sequence": 2}`` on the card training flagship-1b with
    ``context_parallel`` at full width, Z3_LAYERS layers, bf16, 1 x 2048 rows
    (1024 positions a rank), 2 steps: each step's time, the ring's
    permutes and their bytes a step (no flash launch: the ring replaces
    it); the f32 gate at 2 layers (1 x 1024 rows) within 1e-6 of one
    process. (z4) a gang of two over ``{"pipeline": 2}`` training
    flagship-deep (16 layers, 8 a stage) at 4 x 2048 rows, 4
    microbatches, remat ``"llm"``, 2 steps: each step's time, each rank's
    peak of allocated memory, the flash launches a rank against the
    schedule's count (8 layers x 4 microbatches x 2 steps, the forward
    twice under remat), named in each rank's trace; the flash pair at a
    stage's microbatch shape (``stage_flash``, run at the start); the f32
    gate at 2 layers (4 x 512 rows) within 1e-6."""
    t_phase = time.perf_counter()
    z1 = phase_cp_serving(smi)
    z2 = phase_pp_serving(smi)
    cp_kw = {"context_parallel": True}
    z3 = gang_run(smi, f"z3_sequence{CP}", TRAIN_MODEL, {"sequence": CP},
                  Z_TRAIN_STEPS, 1, FLASH_TP_RANK["t"], 1, 1024, cp_kw,
                  1e-6, overrides=dict(cp_kw, n_layers=Z3_LAYERS),
                  want={"flash_attention_fwd": 0, "flash_attention_bwd": 0})
    per_stage = 16 // PP * Z_MICRO * Z_TRAIN_STEPS
    z4 = gang_run(smi, f"z4_pipeline{PP}", DEEP_MODEL, {"pipeline": PP},
                  Z_TRAIN_STEPS, 4, FLASH_DEEP["t"], 4, 512, PP_OVERRIDES,
                  1e-6, overrides=PP_OVERRIDES,
                  want={"flash_attention_fwd": 2 * per_stage,
                        "flash_attention_bwd": per_stage})
    z4["flash_stage_shape"] = rank_flash_timing(stage_flash)
    emit("z4_flash_pp_stage", **z4["flash_stage_shape"])
    out = {"z1": z1, "z2": z2, "z3": z3, "z4": z4,
           "phase_s": time.perf_counter() - t_phase}
    emit("z_phase_time", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# (aa) elastic training and the job entry points
# ---------------------------------------------------------------------------

ELASTIC_DIR = "build/chip_smoke/elastic"
# One live run a gang: its mesh shrinks at step AA_FLIP and grows back at
# 2 x AA_FLIP, of AA_STEPS.
AA_STEPS, AA_FLIP = 4, 1
# Its model: flagship-1b at full width, 1 of its 3 layers (about 2.2 GB
# of f32 masters to save and move against 4.52 GB at 3 layers; the cut
# pays for (cc)).
AA_OVERRIDES = {"n_layers": 1}
# The f32 gates' model: flagship-1b's architecture at 2 layers and a
# width a gang of four on one card moves in seconds through gloo (hd 128,
# the kv heads split over tensor 2).
AA_GATE_OVERRIDES = dict(dtype="float32", n_layers=2, d_model=512,
                         n_heads=4, n_kv_heads=2, d_ff=1024)
AA_GATE_OPT = dict(name="adafactor", warmup_steps=1, learning_rate=1e-2)
AA_GATE_MESHES = {"dp": {"data": -1}, "dp_fsdp2": {"data": -1, "fsdp": 2},
                  "dp_tp2": {"data": -1, "tensor": 2}}
# llama-1b's batch predict: 16 lines, one not JSON (5) and one instance
# the engine refuses (11: a token past the vocabulary).
BP_LINES, BP_BAD_JSON, BP_REFUSED = 16, 5, 11

# One rank of a gloo gang on cuda:0 running the loop's elastic runs. For
# each (name, mesh, [n0, n1, n2]) case a live run whose injected source
# names n0 ranks, then n1 from the poll before step ``flip`` (a shrink),
# then n2 from the poll before step 2 x ``flip`` (a grow); then, rank 0
# having hard-linked each reshard step's checkpoint into a directory of
# its own, the restore reference of each move: that step restored into a
# mesh of the new size and run with no resize to the next move's step
# (whose checkpoint the live run saved before moving) or to the end. Each
# run's result, rank 0's logged losses and the seconds from its start to
# its first step's log line (a restored run: init, restore, the step
# built and run once); the live run's flash launches (the counts set to
# 0 just before it) and, at each poll, this rank's allocated memory and
# the bytes reshard has moved to and from it; rank 0 holds each
# reference's final checkpoint bit for bit against the live run's
# checkpoint of that step, and keeps the live run's final checkpoint's
# path for the caller when ``keep`` is set.
ELASTIC_WORKER = """
import json, os, re, shutil, sys, time
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from kubeflow_tpu_torch import kernels
from kubeflow_tpu_torch.parallel import reshard
from kubeflow_tpu_torch.parallel.distributed import (barrier,
    initialize_from_env, shutdown)
from kubeflow_tpu_torch.train import checkpoint, loop
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig

a = json.loads(sys.argv[1])
info = initialize_from_env(device="cuda", backend="gloo", timeout_s=900)
r = info.process_id
dev = torch.device("cuda", 0)
opt = OptimizerConfig(**a["opt"])
flip = a["flip"]

def drive(ckpt_dir, mesh, sizes, steps):
    polls, lines = [], []

    def source():
        # The first mesh's poll, then one a step.
        step = len(polls) - 1
        torch.cuda.synchronize(dev)
        polls.append({"step": step, "allocated": torch.cuda.memory_allocated(
            dev), **reshard.MOVED})
        return sizes[min(max(step, 0) // flip, len(sizes) - 1)]

    cfg = loop.RunConfig(
        model=a["model"], model_overrides=a["overrides"], mesh=mesh,
        optimizer=opt, batch_size=a["rows"], seq_len=a["seq"],
        steps=steps, log_every=1, prefetch=2, graceful_shutdown=False,
        checkpoint_dir=ckpt_dir, checkpoint_every=10 ** 9, device="cuda")
    torch.cuda.synchronize(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    first = []

    def log(*x):
        lines.append(" ".join(map(str, x)))
        if lines[-1].startswith("step=") and not first:
            first.append(time.perf_counter() - t0)

    result = loop.run(cfg, log=log, mesh_source=source)
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    losses = {}
    for line in lines:
        m = re.match(r"step=(\\d+) loss=(\\S+)", line)
        if m:
            losses[int(m.group(1))] = m.group(2)
    return {"result": result, "losses": losses, "polls": polls,
            "launches": launches, "wall_s": time.perf_counter() - t0,
            "first_step_s": first[0] if first else None}

def same_files(x, y, step):
    x, y = os.path.join(x, str(step)), os.path.join(y, str(step))
    paths = [os.path.relpath(os.path.join(root, n), x)
             for root, _, names in os.walk(x) for n in names]
    return bool(paths) and all(np.array_equal(
        np.load(os.path.join(x, p), mmap_mode="r"),
        np.load(os.path.join(y, p), mmap_mode="r")) for p in paths)

out = {}
for name, mesh, sizes in a["cases"]:
    live = os.path.join(a["dir"], f"{name}-live")
    case = {"live": drive(live, mesh, sizes, a["steps"]), "refs": []}
    for move in (1, 2):
        at, end = move * flip, (move + 1) * flip if move == 1 else a["steps"]
        ref = os.path.join(a["dir"], f"{name}-ref{move}")
        barrier()
        if r == 0:
            shutil.copytree(os.path.join(live, str(at)),
                            os.path.join(ref, str(at)),
                            copy_function=os.link)
        barrier()
        done = drive(ref, mesh, [sizes[move]], end)
        if r == 0:
            done["checkpoint_equal"] = same_files(live, ref, end)
            shutil.rmtree(ref, ignore_errors=True)
        case["refs"].append(done)
    barrier()
    if r == 0:
        case["live_final"] = os.path.join(live, str(a["steps"]))
        if not a["keep"]:
            shutil.rmtree(live, ignore_errors=True)
    torch.cuda.empty_cache()
    out[name] = case
with open(a["out"] + f".{r}", "w") as f:
    json.dump(out, f)
shutdown()
"""


def elastic_gang(name: str, n: int, args: dict) -> list[dict]:
    """ELASTIC_WORKER in a gloo gang of ``n`` on the card; each rank's
    results."""
    from kubeflow_tpu_torch.parallel.launch import launch

    os.makedirs(ELASTIC_DIR, exist_ok=True)
    outp = os.path.join(ELASTIC_DIR, f"{name}.json")
    procs = launch([sys.executable, "-c", ELASTIC_WORKER, json.dumps(
        dict(args, dir=ELASTIC_DIR, out=outp, flip=AA_FLIP,
             steps=AA_STEPS))], n, timeout=900)
    for i, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"({name}) rank {i} exited {p.returncode}:"
                                 f"\n{p.stderr[-3000:]}")
    ranks = []
    for i in range(n):
        with open(f"{outp}.{i}") as f:
            ranks.append(json.load(f))
    return ranks


def _reference_problems(name: str, rank0: dict) -> list[str]:
    """Where the live run is not its restore references bit for bit after
    each move (the losses of every step to the next move or the end, the
    last loss, every file of the checkpoint there); empty when it is."""
    live, out = rank0["live"], []
    for move, ref in enumerate(rank0["refs"], 1):
        at = move * AA_FLIP
        tail = {s: v for s, v in live["losses"].items()
                if at < int(s) <= int(max(ref["losses"], key=int))}
        if tail != ref["losses"] or not tail or not ref["checkpoint_equal"] \
                or (move == 2 and live["result"]["loss"]
                    != ref["result"]["loss"]):
            out.append(f"({name} move {move}) the live reshard differs from "
                       f"the restore reference: {tail} vs {ref['losses']}, "
                       f"checkpoints equal {ref['checkpoint_equal']}")
    return out


def _moved(polls: list, step: int) -> dict:
    """A rank's allocated memory at the poll before ``step`` (before the
    move there) and at the next, and the bytes the move sent and
    received."""
    before, after = polls[step + 1], polls[step + 2]
    return {"allocated_gb_before": before["allocated"] / 1e9,
            "allocated_gb_after": after["allocated"] / 1e9,
            "received_bytes": after["received"] - before["received"],
            "sent_bytes": after["sent"] - before["sent"]}


def elastic_full_width(smi: str) -> dict:
    """(aa1) flagship-1b at full width and AA_OVERRIDES' depth, bf16,
    adafactor, 1 x 2048
    rows a rank, ``{"data": -1}``, in a gloo gang of two on cuda:0: one
    live run of AA_STEPS steps that shrinks 2 -> 1 at step AA_FLIP and
    grows 1 -> 2 at 2 x AA_FLIP, each move held bit for bit against its
    restore reference; the reshard's and the downtime's ms, the events'
    method, leaves and bytes, the bytes each rank received, each rank's
    allocated memory before and after each move, each rank's flash
    launches (n_layers x the steps it trained as a member), and the kill
    path's floor (the shrink's save, and its reference run's restart to
    its first step)."""
    from kubeflow_tpu_torch.models.registry import get_model

    layers = get_model(TRAIN_MODEL, **AA_OVERRIDES).config.n_layers
    sizes = [2, 1, 2]
    t0 = time.perf_counter()
    ranks = elastic_gang("aa1", 2, dict(
        model=TRAIN_MODEL, overrides=AA_OVERRIDES, rows=1, seq=TRAIN_SEQ,
        opt=dict(name="adafactor", warmup_steps=2), keep=False,
        cases=[["flagship", {"data": -1}, sizes]]))
    runs = [r["flagship"] for r in ranks]
    live = runs[0]["live"]
    out = {"gpu": smi, "model": TRAIN_MODEL, "overrides": AA_OVERRIDES,
           "rows_per_rank": 1, "seq": TRAIN_SEQ, "steps": AA_STEPS,
           "mesh_sizes": sizes,
           "transport": "gloo through the host (not NCCL)",
           "wall_s": time.perf_counter() - t0,
           "live_wall_s": live["wall_s"],
           "step_ms_p50": live["result"]["step_time_p50_ms"]}
    problems = _reference_problems("aa1", runs[0])
    events = live["result"]["reshards"]
    if [(e["direction"], e["step"], e["method"]) for e in events] != [
            ("shrink", AA_FLIP, "device"), ("grow", 2 * AA_FLIP, "device")]:
        problems.append(f"(aa1) events {events}")
    for move, (direction, event) in enumerate(zip(("shrink", "grow"),
                                                  events), 1):
        out[direction] = {
            f"elastic_reshard_{direction}_ms": 1e3 * event["seconds"],
            f"elastic_downtime_{direction}_ms":
                1e3 * event["downtime_seconds"],
            "event": event,
            "ranks": [_moved(r["live"]["polls"], move * AA_FLIP)
                      for r in runs],
            "bit_equal_to_restore_reference": not any(
                f"move {move})" in p for p in problems)}
    launched = []
    for i, r in enumerate(runs):
        got = {k: r["live"]["launches"][k] for k in (
            "flash_attention_fwd", "flash_attention_bwd")}
        want = layers * sum(1 for s in range(AA_STEPS)
                            if i < sizes[min(s // AA_FLIP, 2)])
        if set(got.values()) != {want}:
            problems.append(f"(aa1) rank {i} launched {got}, expected "
                            f"{want} of each flash kernel")
        if r["live"]["result"]["loss"] != live["result"]["loss"]:
            problems.append(f"(aa1) rank {i} returned another loss")
        launched.append(got)
    out["flash_launches_by_rank"] = launched
    # The rank that leaves frees its shards: the whole state here.
    leaving = out["shrink"]["ranks"][1]
    freed = leaving["allocated_gb_before"] - leaving["allocated_gb_after"]
    if freed < 0.9 * events[0]["bytes"] / 1e9:
        problems.append(f"(aa1) rank 1 kept its memory after leaving the "
                        f"mesh: {leaving}")
    # The kill path a live shrink replaces, priced as JAX's bench prices
    # it from the same primitives: the synchronous save of the full
    # mesh's state (the shrink's downtime less its move), then what a
    # restarted worker does on the target mesh (the shrink's reference
    # run: init, restore, step rebuilt and run once).
    save_ms = 1e3 * (events[0]["downtime_seconds"] - events[0]["seconds"])
    restart_ms = 1e3 * runs[0]["refs"][0]["first_step_s"]
    out["kill_floor"] = {"kill_ms": save_ms + restart_ms,
                         "save_ms": save_ms,
                         "restart_to_first_step_ms": restart_ms}
    out["shrink_downtime_vs_kill_floor"] = (
        out["shrink"]["elastic_downtime_shrink_ms"]
        / out["kill_floor"]["kill_ms"])
    emit("aa1_elastic_full_width", **out)
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def _one_process_gate(dev) -> tuple[list, dict, dict]:
    """The f32 gates' one process: the loop's first mesh-free run on the
    same rows (its seed-0 init on the card, the synthetic stream from
    seed 0), AA_STEPS steps; (losses, params, initial params)."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.train.data import place_batch, synthetic_stream
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.trainer import build_train_step, init_state
    from kubeflow_tpu_torch.weights import flatten

    model = get_model(TRAIN_MODEL, **AA_GATE_OVERRIDES)
    opt = OptimizerConfig(**AA_GATE_OPT)
    state = init_state(torch.Generator(device=dev).manual_seed(0), model,
                       opt, None, device=dev)
    init = {k: p.detach().clone() for k, p in flatten(state.params).items()}
    step = build_train_step(model, opt)
    stream = synthetic_stream(model, 1, 256, seed=0)
    losses = []
    for _ in range(AA_STEPS):
        state, met = step(state, place_batch(next(stream), dev))
        losses.append(float(met["loss"]))
    return losses, flatten(state.params), init


def elastic_gates(smi: str) -> dict:
    """(aa2) the f32 gates at 2 layers in a gloo gang of four on the card:
    over dp, dp x fsdp 2 and dp x tp 2 (JAX's three meshes) a live run
    that shrinks 4 -> 2 at step AA_FLIP and grows 2 -> 4 at 2 x AA_FLIP,
    each move bit for bit its restore reference, and the run within
    gang_run's limits of one process on the same rows (the final loss
    1e-5 relative, each step's logged loss at its 4 decimals, the final
    parameters 1e-4 relative + 1e-5, every matrix moved over 10x that
    limit)."""
    import shutil

    dev = torch.device("cuda")
    one_losses, one_params, init = _one_process_gate(dev)
    cases = [[name, mesh, [4, 2, 4]] for name, mesh in AA_GATE_MESHES.items()]
    t0 = time.perf_counter()
    ranks = elastic_gang("aa2", 4, dict(
        model=TRAIN_MODEL, overrides=AA_GATE_OVERRIDES, rows=1, seq=256,
        opt=AA_GATE_OPT, keep=True, cases=cases))
    gates, problems = {}, []
    try:
        for name, _, _ in cases:
            rank0 = ranks[0][name]
            moves = _reference_problems(f"aa2 {name}", rank0)
            problems += moves
            result = rank0["live"]["result"]
            if (result["reshard_count"], result["devices"]) != (2, 4):
                problems.append(f"(aa2 {name}) {result}")
            root = rank0["live_final"]
            params = {k: torch.from_numpy(np.load(os.path.join(
                root, "params", *k.split("/")) + ".npy")).to(dev)
                for k in one_params}
            excess = max(((params[k] - p).abs() - 1e-4 * p.abs()).max().item()
                         for k, p in one_params.items())
            moved = min(((p - init[k]).abs().max()
                         / (1e-4 * p.abs().max() + 1e-5)).item()
                        for k, p in one_params.items() if p.ndim >= 2)
            gates[name] = {
                "events": result["reshards"],
                "final_loss": result["loss"],
                "one_process_loss": one_losses[-1],
                "rel_err_final_loss": abs(result["loss"] - one_losses[-1])
                / abs(one_losses[-1]),
                "max_abs_err_logged_losses": max(
                    abs(float(rank0["live"]["losses"][str(s + 1)])
                        - one_losses[s]) for s in range(AA_STEPS)),
                "max_param_excess_over_1e-4_rel": excess,
                "min_matrix_update_over_tolerance": moved,
                "bit_equal_to_restore_references": not moves}
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    out = {"gpu": smi, "layers": AA_GATE_OVERRIDES["n_layers"],
           "overrides": AA_GATE_OVERRIDES, "gang": 4,
           "wall_s": time.perf_counter() - t0, "gates": gates}
    emit("aa2_elastic_f32_gates", **out)
    for name, g in gates.items():
        if g["rel_err_final_loss"] > 1e-5 or \
                g["max_abs_err_logged_losses"] > 1.5e-4 or \
                g["max_param_excess_over_1e-4_rel"] > 1e-5 or \
                g["min_matrix_update_over_tolerance"] < 10:
            problems.append(f"(aa2 {name}) the elastic gang differs from "
                            f"one process: {g}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def job_entry_points(smi: str) -> dict:
    """(aa3) the job entry points as a user runs them: the health probe
    in a gloo gang of two on cuda:0 (healthy, its all-reduce ms);
    ``tf_cnn --model resnet50 --steps 4`` alone (samples/s); and the
    batch predict of llama-1b over a JSONL of BP_LINES lines, one not
    JSON and one instance the engine refuses: the output's line numbers
    and errors, the flash forward's launches (n_layers x each predict
    batch: one for the first chunk of 8, one a good instance of the
    chunk with the refused one, which runs one at a time) and the ms an
    instance."""
    import shutil

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.parallel.launch import launch
    from kubeflow_tpu_torch.serving.batch_predict import run_batch_predict
    from kubeflow_tpu_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    procs = launch([sys.executable, "-m",
                    "kubeflow_tpu_torch.workloads.slice_health",
                    "--backend", "gloo", "--expect-devices", "2",
                    "--expect-local-devices", "1"], 2, timeout=300)
    health = []
    for i, p in enumerate(procs):
        report = json.loads(p.stdout.strip().splitlines()[-1])
        if p.returncode or not report["healthy"] or report["psum"] != 4.0 \
                or report["platform"] != "gpu":
            raise AssertionError(f"(aa3) slice_health rank {i} exited "
                                 f"{p.returncode}: {report}\n"
                                 f"{p.stderr[-2000:]}")
        health.append(report)
    cnn = module_json_lines("kubeflow_tpu_torch.workloads.tf_cnn",
                            "--model", "resnet50", "--steps", "4",
                            "--log-every", "1")[-1]
    if cnn["step"] != 4 or not np.isfinite(cnn["loss"]):
        raise AssertionError(f"(aa3) tf_cnn: {cnn}")

    engine = InferenceEngine(engine_cfg(kv_layout="dense"))
    vocab = engine.model.config.vocab_size
    rng = np.random.default_rng(11)
    os.makedirs(ELASTIC_DIR, exist_ok=True)
    src = os.path.join(ELASTIC_DIR, "instances.jsonl")
    dst = os.path.join(ELASTIC_DIR, "predictions.jsonl")
    with open(src, "w") as f:
        for i in range(BP_LINES):
            if i == BP_BAD_JSON:
                f.write('{"tokens": [1, 2\n')
                continue
            toks = rng.integers(0, vocab, int(rng.integers(4, MAX_SEQ)))
            toks = [int(t) for t in toks]
            if i == BP_REFUSED:
                toks[0] = vocab
            f.write(json.dumps({"tokens": toks}) + "\n")
    engine.predict_batch([{"tokens": [1, 2, 3]}])  # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_bp = time.perf_counter()
    summary = run_batch_predict(engine, src, dst, SLOTS, log=lambda *a: None)
    torch.cuda.synchronize()
    bp_s = time.perf_counter() - t_bp
    launches = dict(kernels.LAUNCHES)
    with open(dst) as f:
        rows = {json.loads(line)["line"]: json.loads(line) for line in f}
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    layers = engine.model.config.n_layers
    del engine
    torch.cuda.empty_cache()
    errors = sorted(k for k, v in rows.items() if "error" in v)
    good = BP_LINES - 2
    # The first chunk of SLOTS instances in one batch; the second, which
    # holds the refused one, one instance at a time.
    calls = 1 + (good - SLOTS)
    if sorted(rows) != list(range(BP_LINES)) or \
            errors != [BP_BAD_JSON, BP_REFUSED] or \
            summary["instances"] != BP_LINES - 1 or summary["errors"] != 2 \
            or launches["flash_attention_fwd"] != layers * calls or \
            not all(np.isfinite(v["logits"]).all() and len(v["logits"])
                    == vocab for k, v in rows.items() if k not in errors):
        raise AssertionError(f"(aa3) batch predict: {summary}, error lines "
                             f"{errors}, launches {launches}")
    out = {"gpu": smi,
           "slice_health": {"reports": health, "collective_ms": [
               r["collective_ms"] for r in health]},
           "tf_cnn": {k: cnn[k] for k in (
               "step", "loss", "samples_per_sec", "step_time_p50_ms",
               "devices")},
           "batch_predict": {
               "model": MODEL, "lines": BP_LINES, "summary": {
                   k: summary[k] for k in ("instances", "errors")},
               "error_lines": errors, "errors": {
                   k: rows[k]["error"] for k in errors},
               "flash_fwd_launches": launches["flash_attention_fwd"],
               "predict_batches": calls,
               "ms_per_instance": 1e3 * bp_s / summary["instances"],
               "wall_s": bp_s},
           "wall_s": time.perf_counter() - t0}
    emit("aa3_job_entry_points", **out)
    return out


def phase_elastic(smi: str) -> dict:
    """(aa) elastic training and the job entry points: (aa1)
    :func:`elastic_full_width`, (aa2) :func:`elastic_gates`, (aa3)
    :func:`job_entry_points`."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    try:
        aa1 = elastic_full_width(smi)
        aa2 = elastic_gates(smi)
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    aa3 = job_entry_points(smi)
    out = {"aa1": aa1, "aa2": aa2, "aa3": aa3,
           "phase_s": time.perf_counter() - t_phase}
    emit("aa_phase_time", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# (bb) The decoder fleet and its KV economy, the remote actor fleet, RL
# ---------------------------------------------------------------------------

# (bb1): (n)'s 160-token system prompt plus tails of BB_TAIL tokens (176 =
# 11 whole blocks). Replica a keeps two trie entries and a host tier that
# holds one such payload (11.5 MB at llama-1b's 64 KiB a token), so its
# evictions demote through the tier into the shared cold store; replica b
# keeps one entry, so the prefix it imports leaves it at its next publish.
BB_TAIL = 16
BB_HOST_BYTES = 16 << 20
BB_COLD_REF = "mem://chip-smoke-fleet?bytes=268435456"
BB_DIRECTORY = 256
# (bb3): the learner and its actors.
BB_RL = dict(model=MODEL, actors=2, batch_size=4, prompt_len=64,
             max_new_tokens=32, steps=4, push_every_steps=2,
             kv_block_size=BLOCK, kv_fused=True)
BB_RL_OPT = dict(name="adafactor", warmup_steps=2)
# (bb4): a target nothing listens on.
BB_DEAD = "127.0.0.1:1"


def short_preset(n_layers: int) -> str:
    """The name of llama-1b cut to ``n_layers`` layers (its width kept),
    registered as a preset of this process, so an in-process
    ``ModelServer`` serves it by name."""
    import dataclasses

    from kubeflow_tpu_torch.models import transformer

    name = f"{MODEL}-{n_layers}-layers"
    transformer.PRESETS.setdefault(name, dataclasses.replace(
        transformer.PRESETS[MODEL], n_layers=n_layers))
    return name


def fleet_replica(params, cfg, **kw):
    """A fleet replica as the smoke's servers run one: SLOTS slots, paged,
    the fused read (the paged kernel)."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    return ContinuousDecoder(params, cfg, **{**dict(
        slots=SLOTS, prefill_len=MAX_SEQ, max_new_tokens=MAX_NEW,
        kv_layout="paged", kv_block_size=BLOCK, kv_fused=True,
        stream_timeout_s=600.0), **kw})


def _event_ms(dec, rid: str, name: str) -> float:
    events = {e["name"]: e["t_ms"] for e in dec.trace.find(rid)[0]["events"]}
    if name not in events:
        raise AssertionError(f"{rid}: no {name!r} event: {events}")
    return events[name] - events["submit"]


def _hit(dec, prompt: list, rid: str, tier: str) -> dict:
    """One request on ``dec`` that should import its prefix from ``tier``:
    its TTFT, the import's ms (submit to the ``kv_import`` event: probe,
    fetch, envelope codec, scatter), the bytes and the prefill tokens."""
    key = "peer" if tier == "peer" else "cold"
    m0 = dec.metrics()
    res = dec.submit(prompt, MAX_NEW, request_id=rid).result(600)
    m = dec.metrics()
    out = {"ttft_ms": 1e3 * res["ttft_s"], "tokens": res["tokens"],
           "import_ms": _event_ms(dec, rid, "kv_import"),
           "import_bytes": (m[f"kv_{key}_import_bytes"]
                            - m0[f"kv_{key}_import_bytes"]),
           "prefill_tokens": m["prefill_tokens"] - m0["prefill_tokens"],
           "hits": m[f"kv_{key}_hits"] - m0[f"kv_{key}_hits"],
           "fetch_failures": (m["kv_peer_fetch_failures"]
                              - m0["kv_peer_fetch_failures"])}
    if out["hits"] != 1 or out["prefill_tokens"] != BB_TAIL:
        raise AssertionError(f"{rid}: a {tier} hit that prefilled "
                             f"{out['prefill_tokens']} tokens: {out}")
    return out


def _drained(decoders: dict) -> dict:
    """Every trie emptied (a host tier keeps what it demotes); each
    decoder's blocks in use after, which must be 0, as at its start."""
    out = {}
    for name, d in decoders.items():
        with d._prefix_lock:
            while d.prefix_cache is not None and \
                    d.prefix_cache.evict_lru():
                pass
        out[name] = d.metrics()["kv_blocks_in_use"]
    if any(out.values()):
        raise AssertionError(f"blocks left in use after the drain: {out}")
    return out


def fleet_economy(model, params) -> dict:
    """(bb1): three llama-1b replicas, bf16, paged, fused, sharing one
    ``KvDirectory`` and a ``mem://`` cold store behind a ``DecoderFleet``
    (whose in-process transport pulls a holder's ``export_prefix``). The
    system prompt is primed on a and served there; served on b, it is a
    peer hit; a serves three other prompts, which push both of its
    entries through the host tier into cold, and b one, which drops the
    imported entry; served on c, it probes both stale hints and is a
    cold hit. TTFT of each hit beside a cold prefill of the same prompt
    on a plain decoder; the paged kernel launches n_layers times per
    decode forward of every decoder; every block comes back."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.affinity import prefix_affinity_key
    from kubeflow_tpu_torch.serving.cold_store import cold_store_from_ref
    from kubeflow_tpu_torch.serving.fleet import DecoderFleet
    from kubeflow_tpu_torch.serving.kv_directory import KvDirectory

    cfg = model.config
    system, _ = prefix_requests(cfg.vocab_size)
    rng = np.random.RandomState(21)

    def prompt(head=None):
        head = system if head is None else head
        return head + rng.randint(0, cfg.vocab_size, size=BB_TAIL).tolist()

    def other():
        return rng.randint(0, cfg.vocab_size,
                           size=SYSTEM_LEN + BB_TAIL).tolist()

    directory = KvDirectory(BB_DIRECTORY)
    cold = cold_store_from_ref(BB_COLD_REF)
    econ = dict(kv_directory=directory, cold_store=cold)
    reps = {"a": fleet_replica(params, cfg, prefix_cache_slots=2,
                               host_kv_bytes=BB_HOST_BYTES,
                               replica_name="a", **econ),
            "b": fleet_replica(params, cfg, prefix_cache_slots=1,
                               replica_name="b", **econ),
            "c": fleet_replica(params, cfg, prefix_cache_slots=2,
                               replica_name="c", **econ)}
    plain = fleet_replica(params, cfg)
    fleet = DecoderFleet(reps)
    a, b, c = reps["a"], reps["b"], reps["c"]
    every = {**reps, "plain": plain}
    try:
        pa, pb, pc = prompt(), prompt(), prompt()
        steps0 = {n: d.steps for n, d in every.items()}
        kernels.reset_launches()
        plain.generate(other(), MAX_NEW, timeout=600)  # unmeasured
        cold_res = {k: plain.generate(p, MAX_NEW, timeout=600)
                    for k, p in (("peer", pb), ("cold", pc))}
        if not a.prime_prefix(system):
            raise AssertionError("(bb1) prime_prefix refused the prompt")
        a.generate(pa, MAX_NEW, timeout=600)
        hints = directory.lookup(prefix_affinity_key(pa))
        peer = _hit(b, pb, "bb-peer", "peer")
        for _ in range(3):
            a.generate(other(), 8, timeout=600)
        b.generate(other(), 8, timeout=600)
        cold_hit = _hit(c, pc, "bb-cold", "cold")
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = {n: d.steps - steps0[n] for n, d in every.items()}
        require_launches(launches, sum(forwards.values()), cfg.n_layers,
                         "(bb1) the economy")
        ma = a.metrics()
        if (ma["kv_cold_demotions"] < 1 or cold_hit["fetch_failures"] != 2
                or ma["kv_host_demotions"] < 2):
            raise AssertionError(f"(bb1) demotions {ma} / {cold_hit}")
        for k, hit in (("peer", peer), ("cold", cold_hit)):
            hit["cold_prefill_ttft_ms"] = 1e3 * cold_res[k]["ttft_s"]
            hit["tokens_equal_cold_prefill"] = sum(
                x == y for x, y in zip(hit.pop("tokens"),
                                       cold_res[k]["tokens"]))
        fm = fleet.metrics()
        out = {"model": MODEL, "dtype": "bfloat16", "replicas": 3,
               "prompt": len(pb), "shared_prefix": SYSTEM_LEN,
               "hints_after_publish": [(h.holder, h.prefix_len, h.tier)
                                       for h in hints],
               "peer": peer, "cold": cold_hit,
               "a_host_demotions": ma["kv_host_demotions"],
               "a_cold_demotions": ma["kv_cold_demotions"],
               "cold_store": fm["kv_cold_store"],
               "directory": fm["kv_directory"],
               "fleet_kv_peer_hits": fm["kv_peer_hits"],
               "fleet_kv_cold_hits": fm["kv_cold_hits"],
               "launches": launches, "decode_forwards": forwards,
               "n_layers": cfg.n_layers}
        out["blocks_in_use_after_drain"] = _drained(every)
    finally:
        fleet.stop()
        plain.stop()
        torch.cuda.empty_cache()
    emit("bb1_kv_economy", **out)
    return out


def fleet_churn(model, params) -> dict:
    """(bb2): one prefill replica and two decode replicas behind a
    ``DecoderFleet``: three prompts relayed (export on the prefill
    replica, import on the least-loaded decode replica, the decode
    submit's prefix hit); a ``broadcast_weights`` of a new bf16 tree to
    all three while a loader keeps streams live (each replica's place and
    swap ms, the peak of allocated memory, the largest inter-token gap of
    the streams during the push beside their median gap); a decode
    replica stopped under a live stream (the 502-coded error, its
    seconds) and the next submit on a survivor."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.fleet import (
        DecoderFleet,
        ReplicaUnavailableError,
    )
    from kubeflow_tpu_torch.weights import flatten

    cfg = model.config
    rng = np.random.RandomState(22)
    reps = {"p0": fleet_replica(params, cfg, role="prefill",
                                prefix_cache_slots=4),
            "d0": fleet_replica(params, cfg, role="decode",
                                prefix_cache_slots=4),
            "d1": fleet_replica(params, cfg, role="decode",
                                prefix_cache_slots=4)}
    fleet = DecoderFleet(reps)
    dev = torch.device("cuda")
    out = {"model": MODEL, "roles": {n: d.role for n, d in reps.items()}}
    try:
        steps0 = {n: d.steps for n, d in reps.items()}
        kernels.reset_launches()
        relayed = []
        for n in (176, 120, 200):
            t0 = time.perf_counter()
            h = fleet.submit(rng.randint(0, cfg.vocab_size, size=n)
                             .tolist(), MAX_NEW)
            res = h.result(600)
            relayed.append({"prompt": n, "replica": h.replica,
                            "ttft_ms": 1e3 * res["ttft_s"],
                            "wall_ms": 1e3 * (time.perf_counter() - t0),
                            "tokens": len(res["tokens"])})
        m = fleet.metrics()
        if m["handoffs"] != 3 or any(r["tokens"] != MAX_NEW
                                     for r in relayed):
            raise AssertionError(f"(bb2) relay: {m['handoffs']} {relayed}")
        out["relay"] = {"requests": relayed, "handoffs": m["handoffs"],
                        "handoff_fallbacks": m["handoff_fallbacks"]}
        # The push, under live streams.
        new = model.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        done, stamps, errors = threading.Event(), [], []

        def loader(seed):
            r = np.random.RandomState(seed)
            try:
                while not done.is_set():
                    h = fleet.submit(r.randint(0, cfg.vocab_size, size=40)
                                     .tolist(), MAX_NEW)
                    for _ in h.tokens(timeout=600):
                        stamps.append((seed, time.perf_counter()))
            except Exception as e:  # checked below
                errors.append(repr(e))

        threads = [threading.Thread(target=loader, args=(200 + i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 120
        while len(stamps) < 8 and time.perf_counter() < deadline:
            time.sleep(0.002)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fleet.broadcast_weights(new)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        time.sleep(0.5)  # streams decode on the new weights for a while
        done.set()
        for t in threads:
            t.join(timeout=600)
        if errors or res["installed"] != {n: 1 for n in reps} \
                or res["failed"]:
            raise AssertionError(f"(bb2) push: {res} {errors}")
        gaps, in_push = [], []
        for seed in (200, 201):
            ts = [t for s, t in stamps if s == seed]
            for x, y in zip(ts, ts[1:]):
                gaps.append(y - x)
                if y > t0 and x < t1:
                    in_push.append(y - x)
        per = {}
        for n, d in reps.items():
            ev = {e["name"]: e for e in
                  d.trace.find("weights-v1")[0]["events"]}
            per[n] = {"place_ms": ev["push"]["place_ms"],
                      "swap_ms": ev["swap"]["swap_ms"]}
        out["push"] = {
            "bytes": sum(t.numel() * t.element_size()
                         for t in flatten(new).values()),
            "push_ms": 1e3 * (t1 - t0), "replicas": per,
            "allocated_gb_before": mem0 / 1e9,
            "peak_allocated_gb": peak / 1e9,
            "stream_gap_median_ms": 1e3 * float(np.median(gaps)),
            "stream_gap_max_during_push_ms": (1e3 * max(in_push)
                                              if in_push else None),
            "stream_tokens": len(stamps)}
        del new
        # A decode replica stopped under a live stream.
        h = fleet.submit(rng.randint(0, cfg.vocab_size, size=40).tolist(),
                         MAX_NEW)
        it = h.tokens(timeout=600)
        next(it)
        victim = h.replica
        t0 = time.perf_counter()
        reps[victim].stop()
        try:
            for _ in it:
                pass
            raise AssertionError("(bb2) the stream outlived its replica")
        except ReplicaUnavailableError as e:
            code, fail_s = e.code, time.perf_counter() - t0
        nxt = fleet.submit(rng.randint(0, cfg.vocab_size, size=40)
                           .tolist(), 8)
        got = nxt.result(600)["tokens"]
        m = fleet.metrics()
        if code != 502 or nxt.replica == victim or len(got) != 8 \
                or m["dead"] != [victim]:
            raise AssertionError(f"(bb2) stop: {code} {nxt.replica} {m}")
        out["stop"] = {"victim": victim, "code": code,
                       "stream_failed_after_ms": 1e3 * fail_s,
                       "next_submit_on": nxt.replica, "dead": m["dead"]}
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = {n: d.steps - steps0[n] for n, d in reps.items()}
        require_launches(launches, sum(forwards.values()), cfg.n_layers,
                         "(bb2) the relay and the push")
        out.update(launches=launches, decode_forwards=forwards)
    finally:
        fleet.stop()
        torch.cuda.empty_cache()
    emit("bb2_fleet_churn", **out)
    return out


def fleet_rl(model) -> dict:
    """(bb3): ``run_rl`` at llama-1b, the learner's float32 masters and
    adafactor state beside two in-process actors (bf16, paged, fused) on
    the card, batch 4 of 64-token prompts and 32 new tokens, 4 steps, a
    push every 2; the learner's steps run the flash kernels (forward
    twice under llama-1b's remat), the actors' decode the paged kernel.
    Then the restart-per-update baseline at 2 steps of batch 1 (the
    restart's ms does not depend on the batch), for its
    ``restart_ms_avg``."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
    from kubeflow_tpu_torch.train.rl import RLConfig, build_actor_fleet, run_rl

    cfg = RLConfig(optimizer=OptimizerConfig(**BB_RL_OPT), **BB_RL)
    mc = model.config
    dev = torch.device("cuda")
    # The learner's seed-0 init (run_rl draws the same), cast to the
    # actors' serving tree.
    masters = model.init(mc, generator=torch.Generator(device=dev)
                         .manual_seed(cfg.seed), device=dev,
                         param_dtype=torch.float32)
    fleet = build_actor_fleet(masters, cfg, model)
    del masters
    torch.cuda.empty_cache()
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = run_rl(cfg, fleet=fleet, log=lambda *a: None)
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        fm = fleet.metrics()
    finally:
        fleet.stop()
        torch.cuda.empty_cache()
    forwards = sum(r["decode_steps"] for r in fm["replicas"].values())
    require_launches(launches["paged_decode_attention"], forwards,
                     mc.n_layers, "(bb3) the actors")
    per_step = mc.n_layers * (2 if mc.remat else 1)
    if (launches["flash_attention_fwd"] != per_step * cfg.steps
            or launches["flash_attention_bwd"] != mc.n_layers * cfg.steps
            or res["pushes"] != 1 or set(
                res["weights_installed"].values()) != {1}
            or not np.isfinite(res["loss"])):
        raise AssertionError(f"(bb3) {launches} {res}")
    restart_cfg = RLConfig(optimizer=OptimizerConfig(**BB_RL_OPT), **{
        **BB_RL, "steps": 2, "push_every_steps": 1, "batch_size": 1,
        "restart_per_update": True})
    restart = run_rl(restart_cfg, log=lambda *a: None)
    torch.cuda.empty_cache()
    if restart["pushes"] != 1 or restart["restart_ms_avg"] <= 0:
        raise AssertionError(f"(bb3) restart: {restart}")
    out = {"model": MODEL, **{k: v for k, v in BB_RL.items()
                              if k != "model"},
           "optimizer": BB_RL_OPT, "result": res,
           "learner_flash_launches": {
               k: launches[k] for k in ("flash_attention_fwd",
                                        "flash_attention_bwd")},
           "actor_paged_launches": launches["paged_decode_attention"],
           "actor_decode_forwards": forwards,
           "peak_allocated_gb": peak / 1e9,
           "restart_per_update": {k: restart[k] for k in (
               "restart_ms_avg", "rollout_tokens_per_sec", "elapsed_s",
               "loss")}}
    emit("bb3_rl", **out)
    return out


def fleet_remote() -> dict:
    """(bb4): a ``ModelServer`` at llama-1b's width and F32_GATE_LAYERS
    depth (bf16, paged, fused, the prefix cache, a directory) and a dead
    target behind a ``RemoteActorFleet``: rollouts over ``:predict`` (the
    dead target fails over and leaves the rotation); a broadcast of a new
    tree (seed 1) over ``:weights`` in 8 MiB chunks while a loader keeps
    four streams decoding on the server (the push's bytes, ms and MB/s,
    the swap's stall beside a decode dispatch's mean, the K/V entries
    flushed; the dead target fails); a ``fetch_kv`` over ``:kv``
    (envelope bytes and ms) and one for a prompt the server does not
    hold (None: a 404). The depth keeps the push inside the script's
    limit: the codec's rate, not the tree's size, is what it measures."""
    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving.remote_fleet import RemoteActorFleet
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.weights import flatten

    name = short_preset(F32_GATE_LAYERS)
    server = ModelServer(engine_cfg(model=name, kv_fused=True,
                                    prefix_cache_slots=4,
                                    kv_directory_size=BB_DIRECTORY), port=0)
    server.start()
    dev = torch.device("cuda")
    try:
        model = server.engine.model
        cfg = model.config
        port, dec = server.port, server.decoder
        live = f"127.0.0.1:{port}"
        fleet = RemoteActorFleet([BB_DEAD, live], name, timeout=600.0)
        rng = np.random.RandomState(23)
        prompts = [rng.randint(0, cfg.vocab_size, size=64).tolist()
                   for _ in range(4)]
        steps0 = dec.steps
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = [fleet.generate(p, MAX_NEW) for p in prompts]
        roll_s = time.perf_counter() - t0
        n_tok = sum(len(o["tokens"]) for o in outs)
        if n_tok != 4 * MAX_NEW or fleet.metrics()["dead"] != [BB_DEAD]:
            raise AssertionError(f"(bb4) rollouts {outs} {fleet.metrics()}")
        # The push, under live streams; one published prefix for the
        # flush to find.
        post(port, {"tokens": rng.randint(0, cfg.vocab_size,
                                          size=TIER_SYSTEM).tolist(),
                    "max_new_tokens": 8}, model=name)
        done = threading.Event()
        served, errors = [], []

        def loader(seed):
            r = np.random.RandomState(seed)
            try:
                while not done.is_set():
                    toks, _ = post(port, {"tokens": r.randint(
                        0, cfg.vocab_size, size=40).tolist(),
                        "max_new_tokens": MAX_NEW}, model=name)
                    served.append(len(toks))
            except Exception as e:  # checked below
                errors.append(repr(e))

        threads = [threading.Thread(target=loader, args=(100 + i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        new = model.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        nbytes = sum(t.numel() * t.element_size()
                     for t in flatten(new).values())
        deadline = time.perf_counter() + 120
        while (dec.metrics()["in_flight"] < 1
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        in_flight = dec.metrics()["in_flight"]
        t0 = time.perf_counter()
        res = fleet.broadcast_weights(new)
        push_ms = 1e3 * (time.perf_counter() - t0)
        done.set()
        for t in threads:
            t.join(timeout=600)
        del new
        launches = kernels.LAUNCHES["paged_decode_attention"]
        forwards = dec.steps - steps0
        require_launches(launches, forwards, cfg.n_layers,
                         "(bb4) the rollouts and the push")
        m = dec.metrics()
        if (res["installed"] != {live: 1} or BB_DEAD not in res["failed"]
                or m["weights_version"] != 1 or m["weight_pushes"] != 1
                or errors or in_flight < 1
                or any(n != MAX_NEW for n in served)):
            raise AssertionError(f"(bb4) push {res} {errors} {served}")
        smp = parse_exposition(get(port, "/monitoring/prometheus/metrics"))
        ev = {e["name"]: e for e in timeline(port, "weights-v1")["events"]
              if e["name"] in ("push", "swap", "flush")}
        dec_sum = smp['serving_dispatch_seconds_sum{kind="decode"}']
        dec_n = smp['serving_dispatch_seconds_count{kind="decode"}']
        held = prompts[0][:48] + rng.randint(0, cfg.vocab_size,
                                             size=8).tolist()
        fleet.generate(held, 8)  # on the new weights: published
        t0 = time.perf_counter()
        got = fleet.fetch_kv(live, held + [7, 7], version=1)
        fetch_ms = 1e3 * (time.perf_counter() - t0)
        miss = fleet.fetch_kv(live, rng.randint(0, cfg.vocab_size,
                                                size=40).tolist())
        if got is None or got["weights_version"] != 1 or miss is not None \
                or got["envelope"]["prefix_len"] != len(held):
            raise AssertionError(f"(bb4) fetch_kv {got and got.keys()}")
        out = {"model": name, "n_layers": cfg.n_layers,
               "rollouts": len(outs), "rollout_tokens": n_tok,
               "rollout_tokens_per_s": n_tok / roll_s,
               "dead_target": BB_DEAD,
               "push": {"bytes": nbytes, "push_ms": push_ms,
                        "push_mb_per_s": nbytes / 1e6 / (push_ms / 1e3),
                        "failed": sorted(res["failed"]),
                        "place_ms": ev["push"]["place_ms"],
                        "swap_ms": 1e3 * m["weight_swap_seconds_last"],
                        "decode_dispatch_mean_ms": 1e3 * dec_sum / dec_n,
                        "push_seconds_histogram_sum": smp[
                            "serving_weight_push_seconds_sum"],
                        "flushed": {k: ev.get("flush", {}).get(k, 0)
                                    for k in ("trie_entries",
                                              "tier_entries")},
                        "streams_during_push": len(served),
                        "in_flight_at_push": in_flight},
               "fetch_kv_ms": fetch_ms,
               "fetch_kv_envelope_bytes": len(json.dumps(got["envelope"])),
               "fetch_kv_prefix_len": got["envelope"]["prefix_len"],
               "fetch_kv_miss_is_none": miss is None,
               "launches": launches, "decode_forwards": forwards,
               "metrics": fleet.metrics()}
    finally:
        server.stop()
        torch.cuda.empty_cache()
    emit("bb4_remote_fleet", **out)
    return out


def fleet_f32_gates(dev=torch.device("cuda")) -> dict:
    """(bb5): float32, greedy, llama-1b's width at F32_GATE_LAYERS
    layers, every replica reading through the paged kernel: streams
    served through a fleet equal one plain decoder's when routed affine,
    when spilled under pressure, after a peer hit, after a cold hit and
    after a relay; three replicas decoding at once each equal themselves
    alone (the kernel's split-KV arrival counters are one buffer a
    device); an envelope made stale by a push between its fetch and its
    install is refused and counted (once for each holder probed), and the
    stream still equals the plain decoder's."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.cold_store import ColdKvStore
    from kubeflow_tpu_torch.serving.fleet import DecoderFleet
    from kubeflow_tpu_torch.serving.kv_directory import KvDirectory

    model = get_model(MODEL, dtype=torch.float32, n_layers=F32_GATE_LAYERS)
    cfg = model.config
    w0 = model.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    rng = np.random.RandomState(24)
    system = rng.randint(0, cfg.vocab_size, size=SYSTEM_LEN).tolist()
    shared = [system + rng.randint(0, cfg.vocab_size, size=BB_TAIL).tolist()
              for _ in range(4)]
    singles = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 40, 128, 200)]
    n_new = 16

    def rep(**kw):
        return fleet_replica(w0, cfg, prefix_cache_slots=4, **kw)

    plain = fleet_replica(w0, cfg)
    try:
        ref = {tuple(p): plain.generate(p, n_new, timeout=600)["tokens"]
               for p in shared + singles}
    finally:
        plain.stop()

    def gen(d, p):
        return d.generate(p, n_new, timeout=600)["tokens"]

    out, stopped = {}, []
    try:
        directory, cold = KvDirectory(64), ColdKvStore(256 << 20)
        econ = dict(kv_directory=directory, cold_store=cold)
        reps = {n: rep(replica_name=n, **econ) for n in ("a", "b", "c")}
        fleet = DecoderFleet(reps, pressure=1)
        stopped.append(fleet)
        got = [fleet.submit(p, n_new).result(600)["tokens"] for p in singles]
        out["affine"] = compare_streams(got, [ref[tuple(p)]
                                              for p in singles])
        # Spilled: the affine replica holds a live stream (depth 1 =
        # the pressure bound), so the next prompt of its key spills.
        home = fleet.route(singles[3])
        busy = reps[home].submit(singles[2], MAX_NEW)
        spilled0 = fleet.spilled
        h = fleet.submit(singles[3], n_new)
        got = h.result(600)["tokens"]
        busy.result(600)
        if fleet.spilled <= spilled0 or h.replica == home:
            raise AssertionError("(bb5) the pressure did not spill")
        out["spilled"] = compare_streams([got], [ref[tuple(singles[3])]])
        # A peer hit, then a cold hit whose only holder is gone.
        def count(name, key):
            return reps[name].metrics()[key]

        gen(reps["a"], shared[0])
        hits0 = count("b", "kv_peer_hits")
        got = gen(reps["b"], shared[1])
        if count("b", "kv_peer_hits") != hits0 + 1:
            raise AssertionError("(bb5) no peer hit")
        out["peer_hit"] = compare_streams([got], [ref[tuple(shared[1])]])
        h = reps["a"].export_prefix(shared[2])
        cold.put(h, version=h.pop("weights_version"))
        reps["c"]._peer_fetch = lambda *_a: None
        got = gen(reps["c"], shared[2])
        if count("c", "kv_cold_hits") != 1:
            raise AssertionError("(bb5) no cold hit")
        out["cold_hit"] = compare_streams([got], [ref[tuple(shared[2])]])
        # A push lands between a fetch and its install: refused, counted.
        inner = fleet._peer_fetch

        def racing(holder, tokens, version):
            got = inner(holder, tokens, version)
            reps["b"].update_weights(w0)
            return got

        reps["b"]._peer_fetch = racing
        hits0 = count("b", "kv_peer_hits")
        got = gen(reps["b"], shared[3])
        mb = reps["b"].metrics()
        if mb["kv_import_stale_refused"] < 1 or \
                mb["kv_peer_hits"] != hits0:
            raise AssertionError(f"(bb5) stale envelope: {mb}")
        out["stale_refused"] = {
            **compare_streams([got], [ref[tuple(shared[3])]]),
            "kv_import_stale_refused": mb["kv_import_stale_refused"]}
        # The relay.
        relay = {"p0": rep(role="prefill"), "d0": rep(role="decode"),
                 "d1": rep(role="decode")}
        rfleet = DecoderFleet(relay)
        stopped.append(rfleet)
        got = [rfleet.submit(p, n_new).result(600)["tokens"]
               for p in shared + singles[2:]]
        if rfleet.metrics()["handoffs"] < len(shared):
            raise AssertionError("(bb5) the relay handed nothing off")
        out["relay"] = compare_streams(
            got, [ref[tuple(p)] for p in shared + singles[2:]])
        # Three replicas at once, each against itself alone.
        trio = [rep() for _ in range(3)]
        stopped += trio
        prompts = shared[:2] + singles
        alone = [[gen(d, p) for p in prompts] for d in trio]
        for d in trio:
            with d._prefix_lock:
                while d.prefix_cache.evict_lru():
                    pass
        together: list = [None] * 3

        def run(i):
            hs = [trio[i].submit(p, n_new) for p in prompts]
            together[i] = [h.result(600)["tokens"] for h in hs]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        out["three_at_once"] = compare_streams(
            [s for r in together for s in r], [s for r in alone for s in r])
        out["alone_equal_plain"] = compare_streams(
            alone[0], [ref[tuple(p)] for p in prompts])
    finally:
        for f in stopped:
            f.stop()
        del w0
        torch.cuda.empty_cache()
    bad = [k for k, v in out.items() if not v["identical"]]
    emit("bb5_fleet_f32_gates", layers=F32_GATE_LAYERS, **out)
    if bad:
        raise AssertionError(f"(bb5) f32 greedy tokens differ: {bad}")
    return out


def phase_fleet(smi: str) -> dict:
    """(bb) the decoder fleet and its KV economy, the remote actor fleet
    and the RL learner: (bb1) :func:`fleet_economy`, (bb2)
    :func:`fleet_churn`, (bb3) :func:`fleet_rl`, (bb4)
    :func:`fleet_remote`, (bb5) :func:`fleet_f32_gates`. The paged
    kernel's launches of (bb1)-(bb4) and the learner's flash launches
    feed the kernel table."""
    from kubeflow_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    model = get_model(MODEL)
    dev = torch.device("cuda")
    params = model.init(model.config, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    try:
        bb1 = fleet_economy(model, params)
        bb2 = fleet_churn(model, params)
    finally:
        del params
        torch.cuda.empty_cache()
    bb3 = fleet_rl(model)
    bb4 = fleet_remote()
    bb5 = fleet_f32_gates()
    out = {"gpu": smi, "bb1": bb1, "bb2": bb2, "bb3": bb3, "bb4": bb4,
           "bb5": bb5, "paged_launches": {
               "economy": bb1["launches"], "churn": bb2["launches"],
               "rl_actors": bb3["actor_paged_launches"],
               "remote": bb4["launches"]},
           "phase_s": time.perf_counter() - t_phase}
    emit("bb_phase_time", gpu=smi, phase_s=out["phase_s"],
         paged_launches=out["paged_launches"])
    return out


# ---------------------------------------------------------------------------
# (cc) the serving scenario registry and its tuning trial; BERT and ResNet
# over the sequence and pipeline axes
# ---------------------------------------------------------------------------

# (cc1): decode-tps at its checked-in defaults and at one tuned setting.
CC_TUNED = {"slots": 8, "kv_block_size": 8, "prefill_len_buckets": 2}
# (cc2): the bench entries' arguments: quick, the bench's defaults for the
# rest (bench_serving.py's flags). They run llama-1b in f32 (its full
# width and depth, registered in this process by :func:`f32_preset`): at
# bf16 two paths that reduce in another order flip greedy tokens (the
# suffix-only prefill of a prefix hit diverged in 6 of 16 requests, the
# draft model's verify in 1 of 8, on an H100), so the benches' identity
# checks hold only in f32, as the script's other token gates do.
CC_ARGS = dict(quick=True, requests=200, seq_len=128, concurrency=16,
               max_new_tokens=64, prefix_len=96, speculative_k=4, seed=0,
               device="cuda")
SCENARIO_BENCHES = ("prefix-reuse", "speculative", "concurrency-sweep")
# ResNet has no kernel of the port: each of these launches 0 times.
CC_KERNELS = ("paged_decode_attention", "rms_norm", "flash_attention_fwd",
              "flash_attention_bwd")


def f32_preset() -> str:
    """The name of llama-1b in float32 (its shape kept), registered as a
    preset of this process, so the scenarios build it by name."""
    import dataclasses

    from kubeflow_tpu_torch.models import transformer

    name = f"{MODEL}-f32"
    transformer.PRESETS.setdefault(name, dataclasses.replace(
        transformer.PRESETS[MODEL], dtype=torch.float32))
    return name


def scenario_runs(smi: str) -> dict:
    """(cc1) the port's ``run_trial("decode-tps")`` at llama-1b, quick,
    bf16, at the defaults and at CC_TUNED: the objective vector and
    ``config`` of each, both drains at 0 blocks; ``synthetic-knobs``
    once. (cc2) the three bench entries at llama-1b in f32 with CC_ARGS:
    each dict, no ``regression`` marker, ``tokens_identical`` true. As
    JAX's scenarios, none sets ``kv_fused``: the launch counts must not
    move."""
    import types

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.serving import scenarios

    before = dict(kernels.LAUNCHES)
    cc1 = {}
    for tag, knobs in (("defaults", {}), ("tuned", CC_TUNED)):
        t0 = time.perf_counter()
        res = scenarios.run_trial("decode-tps", knobs, seed=0, model=MODEL,
                                  quick=True)
        res["wall_s"] = time.perf_counter() - t0
        emit(f"cc1_decode_tps_{tag}", gpu=smi, **res)
        if res["objectives"]["kv_blocks_in_use_after_drain"] != 0:
            raise AssertionError(f"(cc1) decode-tps {tag} leaked blocks: "
                                 f"{res}")
        cc1[tag] = res
    cc1["synthetic"] = scenarios.run_trial("synthetic-knobs", seed=0)
    emit("cc1_synthetic_knobs", **cc1["synthetic"])
    cc2 = {}
    for name in SCENARIO_BENCHES:
        t0 = time.perf_counter()
        res = scenarios.get_scenario(name).bench(
            types.SimpleNamespace(**CC_ARGS), f32_preset())
        res["wall_s"] = time.perf_counter() - t0
        emit(f"cc2_{name.replace('-', '_')}", gpu=smi, **res)
        if res["regression"] or not res["tokens_identical"]:
            raise AssertionError(f"(cc2) {name}: {res}")
        cc2[name] = res
    moved = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
             if v != before.get(k, 0)}
    if moved:
        raise AssertionError(f"(cc1, cc2) the scenarios launched {moved}")
    return {"cc1": cc1, "cc2": cc2}


def phase_scenarios_axes(smi: str) -> dict:
    """(cc) :func:`scenario_runs` (cc1, cc2); (cc3) :func:`gang_run`
    gangs of two on the card over gloo, whose ranks are replicas: bert-base
    over ``{"sequence": 2}`` (32 x 128 rows on both ranks, 2 steps, flash
    launches 12 layers x 2 steps a rank each way; its f32 gate at 2
    layers, 8 rows, sgd at lr 1, as (y4)) and resnet50 over ``{"pipeline":
    2}`` (batch 32 on both ranks, 2 steps, no kernel; its f32 gate at two
    bottleneck blocks, ``stage_sizes`` (1, 1), 8 images, sgd at lr 3,
    against one process over a mesh of itself, ``one_mesh``): each rank's
    step ms, the collectives' calls and bytes a step, and each rank's
    losses and final state against one process on the same batches.

    ResNet's gate reads its one process through the mesh path because at
    resnet50's width the gradient at initialisation is ill-conditioned:
    one process's ``torch.var_mean`` against the mesh path's two-pass
    sums moves some conv gradients by 6.7e-4 relative (stage (1, 1), 224
    px, on the CPU; reordering the batch alone moves them 1.9e-5), which
    an update that moves every matrix 10x the parameter limit carries
    past it (on an H100: 5.7e-6 over the limit at sgd lr 1 with the least
    matrix moved 3.05x; 2.4e-5 over at lr 3). Through one code path the
    ranks and the one process differ only by cuDNN's nondeterministic
    algorithms, which the gate turns off (6.1e-6 under the limit at lr
    3, the least matrix moved 12.7x, with them on)."""
    t_phase = time.perf_counter()
    out = scenario_runs(smi)
    out["cc3"] = {
        "bert": gang_run(smi, "cc3_bert_sequence2", BERT_MODEL,
                         {"sequence": 2}, Y_TRAIN_STEPS, BERT_BATCH,
                         BERT_SEQ, 8, BERT_SEQ, {}, 1e-5, "sgd", 1.0,
                         replicas=True),
        "resnet": gang_run(smi, "cc3_resnet_pipeline2", RESNET_MODEL,
                           {"pipeline": 2}, Y_TRAIN_STEPS, RESNET_BATCH, 0,
                           8, 0, {"stage_sizes": [1, 1]}, 1e-5, "sgd",
                           3.0, want=dict.fromkeys(CC_KERNELS, 0),
                           gate_layers=None, replicas=True, one_mesh=True)}
    out["phase_s"] = time.perf_counter() - t_phase
    emit("cc_phase_time", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# (dd) the port deployed and tuned as the platform does it: a server
# started from the rendered gpu-serving manifest, and a decode-tps
# Experiment through the port's controller
# ---------------------------------------------------------------------------

# The gpu-serving parameters of (dd1): llama-1b on the paged layout read
# by the paged decode kernel, one GPU. The server's other settings are its
# CLI's defaults (max_seq_len 128, 16 new tokens, 8 slots, block 16).
DD_PARAMS = {"name": "llama", "model_name": MODEL, "kv_layout": "paged",
             "kv_fused_attention": True, "num_gpus": 1}
# (prompt tokens, new tokens) of (dd1)'s requests.
DD_REQUESTS = [(5, 16), (40, 16), (128, 16), (17, 8), (96, 16), (64, 12)]
# (dd2): a decode-tps Experiment, tpe, at llama-1b.
DD_TRIALS, DD_SEED = 3, 7
KERNEL_FAMILY = 'serving_kernel_launches_total{kernel="paged_decode_attention"}'


def rendered_server(params: dict, rest: int, grpc_port: int):
    """The container of ``gpu-serving`` rendered on ``params``: its
    command and args, with ``python`` as this interpreter and the two
    ports (fixed in the pod, which has a network of its own) replaced by
    free ones on this host."""
    from kubeflow_tpu_torch.manifests import generate, images

    dep, _service = generate("gpu-serving", params)
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    if c["resources"]["limits"] != {images.GPU_RESOURCE: 1}:
        raise AssertionError(f"(dd1) rendered resources {c['resources']}")
    ports = {"--rest-port": rest, "--grpc-port": grpc_port}
    args = [f"{a.split('=')[0]}={ports[a.split('=')[0]]}"
            if a.split("=")[0] in ports else a for a in c["args"]]
    cmd = [sys.executable if x == "python" else x for x in c["command"]]
    return cmd + args, c["args"]


def manifest_server(smi: str) -> dict:
    """(dd1): the bf16 and the f32 renderings of DD_PARAMS started as their
    containers' commands, side by side, each timed from its start to
    /readyz; once both are ready this process serves the f32 rendering's
    own engine with the gathered plain read (``kv_fused`` off) on the same
    prompts one at a time. The bf16 server: a warm request, TTFT of three
    streamed requests, tokens/s of all six at once (a smoke reading: one
    window of 84 tokens, not a throughput measurement), a gRPC Predict
    equal to the REST body; its exposition
    lints clean (the port's lint) and its paged kernel launches over the
    window equal 16 x its decode forwards (its exposition's
    ``serving_kernel_launches_total`` and ``serving_decode_steps_total``).
    The f32 server: the six prompts one at a time, greedy tokens equal to
    the in-process reference's, its kernel launches likewise counted."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.observability.lint import lint
    from kubeflow_tpu_torch.serving.__main__ import build_parser, engine_config
    from kubeflow_tpu_torch.serving.grpc_server import client_stubs
    from kubeflow_tpu_torch.serving.server import ModelServer

    layers = get_model(MODEL).config.n_layers
    rng = np.random.RandomState(11)
    vocab = get_model(MODEL).config.vocab_size
    bodies = [{"tokens": rng.randint(0, vocab, size=n).tolist(),
               "max_new_tokens": m} for n, m in DD_REQUESTS]
    ports = {tag: (free_port(), free_port()) for tag in ("bf16", "f32")}
    os.makedirs("chiprun_out", exist_ok=True)
    procs, argv, boot = [], {}, {}
    out = {"gpu": smi, "model": MODEL, "params": DD_PARAMS}
    # /readyz is polled from each server's start on, in a thread each; the
    # in-process reference builds only once both are ready, so the boot
    # clock sees the two servers and nothing else on the card.
    booting = ThreadPoolExecutor(2)
    try:
        for tag, extra in (("bf16", {}), ("f32", {"dtype": "float32"})):
            cmd, argv[tag] = rendered_server({**DD_PARAMS, **extra},
                                             *ports[tag])
            log = open(f"chiprun_out/dd_{tag}_server.log", "w")
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT, text=True)
            proc.started = time.perf_counter()
            procs.append((proc, log))
            boot[tag] = booting.submit(wait_ready, proc, ports[tag][0])
        out["command"] = cmd[:3]
        out["boot_to_ready_s"] = {tag: f.result() for tag, f in boot.items()}
        ref_cfg = dataclasses.replace(
            engine_config(build_parser().parse_args(argv["f32"])),
            kv_fused=False)
        ref = ModelServer(ref_cfg, port=0)
        try:
            want = [ref.handle_predict(MODEL, {"instances": [b]})[
                "predictions"][0]["tokens"] for b in bodies]
        finally:
            ref.stop()
            del ref
            torch.cuda.empty_cache()

        rest, grpc_port = ports["bf16"]
        metrics_path = "/monitoring/prometheus/metrics"
        post(rest, bodies[0], rid="dd-warm")
        before = parse_exposition(get(rest, metrics_path))
        ttft = [post(rest, b, stream=True)[1] for b in bodies[:3]]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            got = list(pool.map(lambda b: post(rest, b)[0], bodies))
        wall = time.perf_counter() - t0
        if [len(t) for t in got] != [m for _, m in DD_REQUESTS]:
            raise AssertionError(f"(dd1) token counts {got}")
        rest_body = predict(rest, [bodies[1]])
        with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
            grpc_body = client_stubs(channel)[0](MODEL, [bodies[1]],
                                                 timeout=120)
        if grpc_body["predictions"] != rest_body:
            raise AssertionError(f"(dd1) gRPC {grpc_body} != REST "
                                 f"{rest_body}")
        text = get(rest, metrics_path)
        violations = lint(text)
        after = parse_exposition(text)
        launches = int(after[KERNEL_FAMILY] - before[KERNEL_FAMILY])
        forwards = int(after["serving_decode_steps_total"]
                       - before["serving_decode_steps_total"])
        out["bf16"] = {
            "ttft_ms": [x * 1e3 for x in ttft],
            "ttft_ms_median": float(np.median(ttft)) * 1e3,
            "tokens": sum(len(t) for t in got), "wall_s": wall,
            "tokens_per_s": sum(len(t) for t in got) / wall,
            "reading": "smoke: six requests in one window",
            "grpc_predict_equals_rest": True,
            "lint_violations": violations,
            "families": text.count("# TYPE "),
            "paged_launches": launches, "decode_forwards": forwards}
        if violations:
            raise AssertionError(f"(dd1) exposition lint: {violations}")
        if forwards <= 0 or launches != layers * forwards:
            raise AssertionError(f"(dd1) bf16 server: {launches} paged "
                                 f"launches for {forwards} decode forwards")

        rest32 = ports["f32"][0]
        before = parse_exposition(get(rest32, metrics_path))
        got32 = [post(rest32, b)[0] for b in bodies]
        after = parse_exposition(get(rest32, metrics_path))
        launches = int(after[KERNEL_FAMILY] - before[KERNEL_FAMILY])
        forwards = int(after["serving_decode_steps_total"]
                       - before["serving_decode_steps_total"])
        out["f32"] = {**compare_streams(got32, want),
                      "paged_launches": launches,
                      "decode_forwards": forwards}
        if forwards <= 0 or launches != layers * forwards:
            raise AssertionError(f"(dd1) f32 server: {launches} paged "
                                 f"launches for {forwards} decode forwards")
        if not out["f32"]["identical"]:
            raise AssertionError(f"(dd1) the rendered f32 server's tokens "
                                 f"differ from the in-process plain read: "
                                 f"{out['f32']}")
    finally:
        stop_procs(procs)
        booting.shutdown()
    emit("dd1_manifest_server", **out)
    return out


def manifest_experiment(smi: str) -> dict:
    """(dd2): a ``decode-tps`` Experiment (tpe, seed DD_SEED, DD_TRIALS
    trials) through the port's ``ExperimentController`` on the port's
    fake apiserver, each trial the port's ``run_trial`` at llama-1b on
    the card. It must end Succeeded, trial 0 the scenario's defaults,
    every trial's seed ``seed * 100003 + index`` and its drain at 0
    blocks; no kernel launches (decode-tps sets no ``kv_fused``). The
    controller runs each trial on the scenario's quick trace (24 requests,
    prompts of 4-11 tokens), so its tokens/s and improvement are smoke
    readings of the path, not a tuning result."""
    import functools

    from kubeflow_tpu_torch import kernels
    from kubeflow_tpu_torch.apis.experiment import experiment, experiment_crd
    from kubeflow_tpu_torch.k8s_fake import FakeApiServer
    from kubeflow_tpu_torch.operators.experiment import ExperimentController
    from kubeflow_tpu_torch.serving import scenarios

    api = FakeApiServer()
    api.ensure_namespace("kubeflow")
    api.apply(experiment_crd())
    api.create(experiment("dd2", "kubeflow", "decode-tps", algorithm="tpe",
                          max_trials=DD_TRIALS, seed=DD_SEED))
    ctrl = ExperimentController(api, run_trial=functools.partial(
        scenarios.run_trial, model=MODEL))
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(DD_TRIALS + 2):
        ctrl.reconcile_all()
        status = api.get("kubeflow-tpu.org/v1", "Experiment", "dd2",
                         "kubeflow")["status"]
        if status.get("state") in ("Succeeded", "Failed"):
            break
    trials = status.get("trials", [])
    out = {"gpu": smi, "model": MODEL, "state": status.get("state"),
           "wall_s": time.perf_counter() - t0,
           "trials": [{k: t.get(k) for k in (
               "index", "seed", "assignments", "state", "config")}
               | {"tokens_per_s": (t.get("objectives") or {}).get(
                   "tokens_per_sec"),
                  "drain": (t.get("objectives") or {}).get(
                      "kv_blocks_in_use_after_drain")} for t in trials],
           "best_tokens_per_s": status.get("bestObjectiveValue"),
           "best_assignments": status.get("bestAssignments"),
           "baseline_tokens_per_s": status.get("baselineObjectiveValue"),
           "improvement_percent": status.get("improvementPercent"),
           "reading": "smoke: each trial on the quick trace"}
    emit("dd2_experiment", **out)
    defaults = scenarios.get_scenario("decode-tps").defaults
    if (out["state"] != "Succeeded" or len(trials) != DD_TRIALS
            or trials[0]["assignments"] != defaults
            or [t["seed"] for t in trials]
            != [DD_SEED * 100_003 + i for i in range(DD_TRIALS)]
            or any(t["drain"] != 0 for t in out["trials"])):
        raise AssertionError(f"(dd2) the Experiment: {status}")
    if dict(kernels.LAUNCHES) != before:
        raise AssertionError("(dd2) decode-tps launched a kernel")
    return out


def phase_manifests(smi: str) -> dict:
    """(dd) :func:`manifest_server` (dd1) and :func:`manifest_experiment`
    (dd2)."""
    t_phase = time.perf_counter()
    out = {"dd1": manifest_server(smi), "dd2": manifest_experiment(smi)}
    out["phase_s"] = time.perf_counter() - t_phase
    emit("dd_phase_time", phase_s=out["phase_s"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kubeflow_tpu_torch import kernels
        from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton
    except ImportError as e:
        print("chip_smoke: the kubeflow_tpu_torch package is not beside "
              f"this script; run it from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # (a) the card, and the kernels built side by side: one nvcc per CUDA
    # source, in a thread, while Triton compiles at its first launch.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built: dict = {}

    def build_cuda():
        try:
            for name in ("paged_decode", "flash_attention"):
                kernels.library(name)
            built["cuda_s"] = time.perf_counter() - t0
        except Exception as e:  # re-raised below, in the main thread
            built["error"] = e

    nvcc = threading.Thread(target=build_cuda)
    nvcc.start()
    rms_norm_triton(torch.ones(8, 2048, device=dev, dtype=torch.bfloat16),
                    torch.ones(2048, device=dev), 1e-5)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    nvcc.join()
    if "error" in built:
        raise built["error"]
    print(kernels.build_log, file=sys.stderr)
    emit("a_device", gpu=smi, kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         cuda_build_s=built["cuda_s"], triton_build_s=triton_s,
         build_wall_s=time.perf_counter() - t0)

    # Each phase's seconds, printed before the kernel table: the script
    # must end within its 1200 s limit as it grows.
    seconds, last = {"a_build": time.perf_counter() - t0}, [
        time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    paged = phase_paged(dev, flush)
    rms = phase_rms(dev, flush)
    flash = phase_flash(dev, flush)
    flash_predict = phase_flash_predict(dev, flush)
    deep_flash = phase_model_flash(dev, flush, "deep", "splash",
                                   (FLASH_DEEP,))
    bert_flash = phase_model_flash(dev, flush, "bert", None,
                                   (FLASH_BERT, FLASH_BERT_LONG),
                                   masked=True, iters=(20, 10))
    moe_flash = phase_model_flash(dev, flush, "moe", None,
                                  (FLASH_MOE, FLASH_MOE_PREDICT))
    tp_checks = tp_kernel_checks(dev, flush, f"tp{TP}", PAGED_TP_SHARD,
                                 "splash", FLASH_TP_RANK)
    y_checks = tp_kernel_checks(dev, flush, f"moe_tp{TP}",
                                PAGED_MOE_TP_SHARD, None, FLASH_MOE_TP_RANK)
    y_checks += (
        phase_model_flash(dev, flush, f"moe_ep{TP}_rank", None,
                          (FLASH_MOE_EP_RANK,)),
        phase_model_flash(dev, flush, f"bert_tp{TP}_rank", None,
                          (FLASH_BERT_TP_RANK,), masked=True,
                          iters=(20, 10)))
    stage_flash = phase_model_flash(dev, flush, f"pp{PP}_stage", "splash",
                                    (FLASH_PP_STAGE,))
    del flush
    torch.cuda.empty_cache()
    mark("b_to_g_kernel_checks")
    main_path = phase_main_path()
    default = phase_default_server(main_path)
    mark("d_k_servers")
    phase_surfaces(default)
    mark("m_surfaces")
    prefix = phase_prefix_path()
    chunked = phase_chunked()
    mark("n_o_prefix_chunked")
    paged_f32 = phase_f32_parity()
    phase_f32_layouts(paged_f32["streams"])
    phase_f32_prefix_chunk_parity()
    mark("e_l_p_f32")
    spec = phase_speculation()
    mark("q_speculation")
    features = phase_serving_features(smi)
    mark("s_serving_features")
    train = phase_train(smi)
    phase_train_f32_parity()
    mark("h_i_train")
    deep = phase_deep_train(smi)
    phase_deep_gates()
    mark("r_deep")
    moe = phase_moe(smi)
    mark("t_moe")
    bert = phase_bert(smi)
    mark("u_bert")
    phase_resnet(smi)
    mark("v_resnet")
    mesh = phase_mesh(smi, train)
    mark("w_mesh")
    tp = phase_tensor_parallel(smi, *tp_checks)
    mark("x_tensor")
    moe_mesh = phase_moe_mesh(smi, *y_checks)
    mark("y_moe_mesh")
    long_axes = phase_long_axes(smi, stage_flash)
    mark("z_long_axes")
    elastic = phase_elastic(smi)
    mark("aa_elastic")
    fleet = phase_fleet(smi)
    mark("bb_fleet")
    axes = phase_scenarios_axes(smi)
    mark("cc_scenarios_axes")
    manifests = phase_manifests(smi)
    mark("dd_manifests")
    emit("phase_seconds", **seconds, total_s=time.perf_counter() - t0)

    p, r = paged["bf16"], rms[f"{SLOTS}x2048"]
    paged_paths = {
        "paged_smoke": main_path["launches"]["paged_decode_attention"],
        "prefix_path": prefix["launches"], "chunked": chunked["launches"],
        "speculation": spec["paged_launches"],
        "serving_features": features["launches"],
        "moe_paged": moe["paged"]["launches"]["paged_decode_attention"],
        "tp2_serving": tp["x1"]["serving"][f"tp{TP}"]["paged_launches"],
        "moe_tp2_serving": moe_mesh["y1"]["serving"][f"tp{TP}"][
            "paged_launches"],
        **{f"fleet_{k}": v for k, v in fleet["paged_launches"].items()},
        **{f"rendered_server_{tag}": manifests["dd1"][tag]["paged_launches"]
           for tag in ("bf16", "f32")}}
    table = [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "kubeflow_tpu_torch/csrc/paged_decode.cu",
         "replaces": "kubeflow_tpu/ops/attention.py:392",
         "launches": sum(paged_paths.values()),
         "launches_by_path": paged_paths,
         "max_abs_err": max(v["max_abs_err"] for v in paged.values()),
         "long_ms": paged["long_bf16"]["ms"],
         "busy_ms": paged["busy_bf16"]["ms"],
         "chunked_ms": paged["chunked_bf16"]["ms"],
         "chunked_bound_ms": paged["chunked_bf16"]["bound_ms"],
         "moe_shape": {kv: {k: paged[f"moe_{kv}"][k] for k in (
             "ms", "call_ms", "bound_ms", "bound_by", "max_abs_err")}
             for kv in ("bf16", "int8")},
         "tp_shard_shape": {kv: {k: tp["x1"]["paged_shard_shape"][
             f"tp{TP}_{kv}"][k] for k in (
             "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
             "max_abs_err")} for kv in ("bf16", "f32", "int8")},
         "moe_tp_shard_shape": {kv: {k: moe_mesh["y1"]["paged_shard_shape"][
             f"moe_tp{TP}_{kv}"][k] for k in (
             "ms", "call_ms", "bound_ms", "bound_by", "max_abs_err")}
             for kv in ("bf16", "f32", "int8")},
         "ms": p["ms"], "call_ms": p["call_ms"], "plain_ms": p["plain_ms"],
         "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
         "library_ms": None},
        {"name": "rms_norm", "route": "triton",
         "source": "kubeflow_tpu_torch/ops/rms_norm_triton.py",
         "replaces": "kubeflow_tpu/ops/norms.py:67",
         "launches": main_path["launches"]["rms_norm"],
         "max_abs_err": max(v["max_abs_err"] for v in rms.values()),
         "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]},
    ]
    # One set of kernels serves both TPU kernels' names; the main paths
    # ask for "splash" (training) and None (llama-1b's plain predict), so
    # the "pallas" rows launch 0 times there. The rows count every path:
    # flagship-1b's steps, flagship-deep's under each remat (the forward
    # again in the backward where it recomputes) and, forward only, the
    # default server's plain predict.
    predict_launches = default["dense"]["plain_launches"][
        "flash_attention_fwd"]
    fp = flash_predict
    for impl, line in (("splash", 239), ("pallas", 172)):
        for part in ("fwd", "bwd"):
            key = f"flash_attention_{part}"
            m = flash["timing"][part]
            row = {
                "name": key if impl == "splash" else f"{key}[pallas]",
                "route": "cuda",
                "source": "kubeflow_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"kubeflow_tpu/ops/attention.py:{line}",
                "launches": (train["launches"][key] if impl == "splash"
                             else 0),
                "max_abs_err": flash["max_abs_err"][impl][part],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], "f32_ms": m["f32_ms"]}
            if impl == "splash":
                by_path = {"train": row["launches"]}
                for policy, run in deep.items():
                    by_path[f"deep_{policy}"] = run["launches"][key]
                by_path["moe_train"] = moe["train"]["launches"][key]
                by_path["bert_train"] = bert["train"]["launches"][key]
                by_path["mesh_train"] = mesh["w1"]["launches"][key]
                by_path["tp2_train_rank0"] = tp["x2"]["rank_launches"][key]
                by_path["tp2_train_rank1"] = tp["x2"]["rank1_launches"][key]
                for run, res in (("moe_tp2", moe_mesh["y2"]["tensor"]),
                                 ("moe_ep2", moe_mesh["y2"]["expert"]),
                                 ("bert_tp2", moe_mesh["y4"])):
                    by_path[f"{run}_train_rank0"] = res["rank_launches"][key]
                    by_path[f"{run}_train_rank1"] = res["rank1_launches"][
                        key]
                z4 = long_axes["z4"]
                by_path[f"pp{PP}_train_rank0"] = z4["rank_launches"][key]
                by_path[f"pp{PP}_train_rank1"] = z4["rank1_launches"][key]
                for i, got in enumerate(
                        elastic["aa1"]["flash_launches_by_rank"]):
                    by_path[f"elastic_train_rank{i}"] = got[key]
                by_path["rl_learner"] = fleet["bb3"][
                    "learner_flash_launches"][key]
                bert_cc3 = axes["cc3"]["bert"]
                by_path["bert_sequence2_train_rank0"] = bert_cc3[
                    "rank_launches"][key]
                by_path["bert_sequence2_train_rank1"] = bert_cc3[
                    "rank1_launches"][key]
                if part == "fwd":
                    by_path["predict"] = predict_launches
                    by_path["moe_predict"] = moe["dense"][
                        "plain_launches"][key]
                    by_path["bert_predict"] = bert["predict"]["launches"][
                        key]
                    by_path["batch_predict"] = elastic["aa3"][
                        "batch_predict"]["flash_fwd_launches"]
                row["launches_by_path"] = by_path
                row["launches"] = sum(by_path.values())
                for name, res in (("deep", deep_flash), ("bert", bert_flash),
                                  ("moe", moe_flash)):
                    st = res["timing"][part]
                    row[f"{name}_shape"] = {
                        **{k: st[k] for k in (
                            "ms", "call_ms", "plain_ms", "library_ms",
                            "library_device_ms", "bound_ms", "bound_by")},
                        "max_abs_err": res["max_abs_err"][part]}
                row["tp_rank_shape"] = tp["x2"]["flash_rank_shape"][part]
                row["moe_tp_rank_shape"] = moe_mesh["y2"][
                    "flash_rank_shape"][part]
                row["moe_ep_rank_shape"] = moe_mesh["y2"][
                    "flash_ep_rank_shape"][part]
                row["bert_tp_rank_shape"] = moe_mesh["y4"][
                    "flash_rank_shape"][part]
                row["pp_stage_shape"] = long_axes["z4"][
                    "flash_stage_shape"][part]
            if impl == "splash" and part == "fwd":
                row["predict_shape"] = {
                    kind: {k: fp[kind][k] for k in (
                        "device_ms", "call_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by")}
                    | {"max_abs_err": fp[kind]["max_abs_err"]["out"]}
                    for kind in fp}
            table.append(row)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        GANG.stop()
    sys.exit(rc)
