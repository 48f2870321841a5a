"""Named serving scenarios; counterpart of
``kubeflow_tpu/serving/scenarios.py``.

One registry for the bench, the CI scripts and the tuning trials. A
:class:`Scenario` couples

- a **bench** entry (``fn(args, model) -> dict``, the bench contract:
  ``metric``/``value``/``unit``/``config`` keys plus a ``regression``
  marker) and
- a **trial** entry (``fn(assignments, *, seed, model, quick, device) ->
  dict``) for the tuning loop: knob overrides in, objectives out. A trial
  drives the port's continuous decoder and reads its objectives from the
  decoder's histogram exposition through the autoscaler's
  ``scrape_signals`` reduction (``operators/inference.py``).

Every stochastic choice a trial makes (traffic mix, prompt lengths,
decode lengths) is drawn from one ``np.random.default_rng(seed)``, so a
re-run with the recorded seed observes the same trace. Each scenario
declares its knob search space (katib-style parameter dicts) and the
checked-in defaults, the baseline an experiment must beat. Names,
spaces, defaults, objectives, ``config`` strings and returned keys are
JAX's.

Weights come from the model registry's ``init`` with a torch generator
seeded 0 (JAX's ``PRNGKey(0)`` draws other values). Trials and
``run_trial`` take ``device`` (default ``"cuda"``, which raises without
CUDA; ``"cpu"`` runs the plain PyTorch paths); the bench entries read
``args.device``. The decoders run with JAX's settings: no scenario sets
``kv_fused``, so the paged runs read the cache through the gathered path.

``python -m kubeflow_tpu_torch.serving.scenarios --scenario S --seed N
[--quick] --assignments JSON [--device cuda|cpu]`` is the trial CLI a
job-mode Experiment trial runs (``operators/experiment.py``), the
counterpart of ``bench_serving.py --scenario``: ``llama-1b`` on the card
unless ``--quick``, else ``lm-test-tiny``; empty assignments run the
scenario's bench entry where it has one. It prints the result as one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.observability.metrics import render_prometheus
from kubeflow_tpu_torch.operators.inference import (  # noqa: F401
    _parse_exposition,
    scrape_signals,
)
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder


def percentile(sorted_vals, p):
    """Nearest-rank percentile over an ascending list: the value at rank
    ``ceil(p/100 * n)`` (1-based)."""
    rank = math.ceil(len(sorted_vals) * p / 100)
    return sorted_vals[max(rank, 1) - 1]


def decode_burst_tps(d, gen, n_thr=8, rounds=3) -> float:
    """Decode-heavy tokens/s of ``n_thr`` concurrent full-length
    generations, best of ``rounds`` after an untimed warm burst (it warms
    the allocator and the cuBLAS handles; the best round is the steady
    state two paths are compared at)."""
    def one(i):
        return len(d.submit([3 + (i % 7)] * 8, gen).result()["tokens"])

    with ThreadPoolExecutor(n_thr) as pool:
        list(pool.map(one, range(n_thr)))
    best = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_thr) as pool:
            emitted = sum(pool.map(one, range(n_thr)))
        best = max(best, emitted / (time.perf_counter() - t0))
    return best


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One named workload. ``bench`` is the CLI/CI entry (args-driven,
    full regression gates); ``trial`` is the tuning entry (knob
    assignments in, objective vector out). Either may be None."""

    name: str
    description: str
    bench: Callable | None = None
    trial: Callable | None = None
    # Knob search space and the checked-in defaults those knobs hold:
    # the experiment's baseline.
    parameters: list = field(default_factory=list)
    defaults: dict = field(default_factory=dict)
    objective: str = "tokens_per_sec"
    optimization: str = "maximize"


_REGISTRY: dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available {sorted(_REGISTRY)}")


def all_scenarios() -> dict[str, Scenario]:
    return dict(_REGISTRY)


def run_trial(name: str, assignments: Mapping | None = None, *,
              seed: int = 0, model: str = "lm-test-tiny",
              quick: bool = True, device: str = "cuda") -> dict:
    """Run one tuning trial of ``name`` with knob ``assignments`` over
    the scenario's checked-in defaults. Returns the trial dict:
    ``objectives``, ``seed``, ``assignments``, and the
    ``config``/``tokens_per_sec_per_chip`` pair a throughput book
    ingests."""
    sc = get_scenario(name)
    if sc.trial is None:
        raise ValueError(f"scenario {name!r} has no trial entry")
    return sc.trial(dict(assignments or {}), seed=int(seed), model=model,
                    quick=bool(quick), device=device)


def _init_params(spec, device: str):
    """The model's weights from the registry's init, generator seeded 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return spec.init(spec.config, generator=gen, device=dev)


# ---------------------------------------------------------------------------
# Objective plumbing: exposition text -> signal vector
# ---------------------------------------------------------------------------


def decoder_exposition(decoder) -> str:
    """The continuous decoder's metrics as one exposition page: the
    families the model server serves on its metrics route (histograms
    from the decoder's own registry, KV and queue gauges from its counter
    snapshot)."""
    m = decoder.metrics()
    return decoder.registry.render() + render_prometheus({
        "serving_requests_total": m.get("requests_admitted", 0),
        "serving_errors_total": 0,
        "serving_tokens_emitted_total": m.get("tokens_emitted", 0),
        "serving_queued": m.get("queued", 0),
        "serving_kv_bytes_in_use": m.get("kv_bytes_in_use", 0),
        "serving_kv_bytes_total": m.get("kv_bytes_total", 0),
    })


def trial_objectives(decoder, tokens_emitted: int, wall_s: float) -> dict:
    """Reduce a finished trial's decoder to the objective vector: the
    scrape_signals p99s (TTFT, inter-token, queue wait), KV fill, plus
    throughput and peak KV bytes."""
    sig = scrape_signals(decoder_exposition(decoder))
    m = decoder.metrics()
    block_bytes = (m.get("kv_bytes_per_token", 0)
                   * m.get("kv_block_size", 0))
    return {
        "tokens_per_sec": round(tokens_emitted / max(wall_s, 1e-9), 2),
        "ttft_p99_s": round(sig["ttft_p99_s"], 6),
        "inter_token_p99_s": round(sig["inter_token_p99_s"], 6),
        "queue_wait_p99_s": round(sig["queue_wait_p99_s"], 6),
        "kv_utilization": round(sig["kv_utilization"], 4),
        "kv_bytes_peak": int(m.get("kv_blocks_peak", 0) * block_bytes),
        "kv_blocks_in_use_after_drain": int(m.get("kv_blocks_in_use", 0)),
    }


# ---------------------------------------------------------------------------
# decode-tps: the fast-path trial scenario
# ---------------------------------------------------------------------------

# The checked-in defaults (the baseline a tuner must beat): the paged
# pool is sized for 16 worst-case sequences and held constant across
# trials, so tuning reapportions a fixed KV budget (slots admitted
# against it, block granularity, prefill bucketing) and never buys more
# memory.
DECODE_TPS_DEFAULTS = {
    "slots": 4,
    "kv_block_size": 16,
    "prefill_len_buckets": 0,
}

DECODE_TPS_PARAMETERS = [
    {"name": "slots", "parameterType": "int",
     "feasibleSpace": {"min": 2, "max": 16}},
    {"name": "kv_block_size", "parameterType": "int",
     "feasibleSpace": {"min": 4, "max": 24}},
    {"name": "prefill_len_buckets", "parameterType": "int",
     "feasibleSpace": {"min": 0, "max": 4}},
]

_POOL_SEQ_EQUIV = 16  # fixed pool: blocks for 16 worst-case sequences


def _decode_tps_trial(assignments: dict, *, seed: int = 0,
                      model: str = "lm-test-tiny", quick: bool = True,
                      device: str = "cuda") -> dict:
    """Mixed-length decode throughput at a fixed KV pool budget. Knobs
    reapportion the pool; seeded traffic makes a re-run observe the same
    trace."""
    knobs = {**DECODE_TPS_DEFAULTS, **assignments}
    slots = max(1, int(knobs["slots"]))
    buckets = max(0, int(knobs["prefill_len_buckets"]))

    spec = get_model(model)
    params = _init_params(spec, device)
    gen = 8
    prefill_len = 40
    total = prefill_len + gen
    # The paged layout needs block | total: snap down to the nearest
    # divisor, so neighbouring proposals land on the same legal plateau
    # rather than erroring out of the search.
    want_block = max(1, int(knobs["kv_block_size"]))
    block = max(b for b in range(1, want_block + 1) if total % b == 0)
    pool_blocks = _POOL_SEQ_EQUIV * (total // block)
    n = 24 if quick else 96
    offered = min(n, 16)

    rng = np.random.default_rng(seed)
    requests = [
        ([int(3 + rng.integers(7))] * int(rng.integers(4, 12)),
         int(rng.integers(2, gen + 1)))
        for _ in range(n)
    ]

    d = ContinuousDecoder(
        params, spec.config, slots=slots, prefill_len=prefill_len,
        max_new_tokens=gen, prefill_len_buckets=buckets,
        kv_layout="paged", kv_block_size=block,
        kv_pool_blocks=pool_blocks, stream_timeout_s=300.0)
    try:
        def one(req):
            toks, want = req
            return len(d.submit(toks, want).result(timeout=300)["tokens"])

        # Untimed warm pass over the same trace: it warms the caching
        # allocator and the cuBLAS handles at every admission batch this
        # setting hits, so the timed pass measures the steady state each
        # setting is compared at.
        with ThreadPoolExecutor(offered) as pool:
            list(pool.map(one, requests))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(offered) as pool:
            emitted = sum(pool.map(one, requests))
        wall = time.perf_counter() - t0
        objectives = trial_objectives(d, emitted, wall)
    finally:
        d.stop()

    return {
        "scenario": "decode-tps",
        "seed": int(seed),
        "assignments": dict(assignments),
        "objectives": objectives,
        # A throughput book's ingest contract: the profile name is the
        # first whitespace token of ``config``.
        "config": (f"decode-tps slots{slots} block{block} "
                   f"buckets{buckets} pool{pool_blocks} n{n} seed{seed}"),
        "tokens_per_sec_per_chip": objectives["tokens_per_sec"],
    }


def _decode_tps_bench(args, model) -> dict:
    """CLI entry: the trial at the checked-in defaults, reported in the
    bench contract."""
    res = _decode_tps_trial({}, seed=getattr(args, "seed", 0), model=model,
                            quick=args.quick,
                            device=getattr(args, "device", "cuda"))
    obj = res["objectives"]
    return {
        "metric": "serving_decode_tps_trial_tokens_per_sec",
        "value": obj["tokens_per_sec"],
        "unit": "tokens/s",
        "vs_baseline": 1.0,
        "ttft_p99_ms": round(obj["ttft_p99_s"] * 1e3, 2),
        "queue_wait_p99_ms": round(obj["queue_wait_p99_s"] * 1e3, 2),
        "kv_bytes_peak": obj["kv_bytes_peak"],
        "kv_blocks_in_use_after_drain":
            obj["kv_blocks_in_use_after_drain"],
        "regression": obj["kv_blocks_in_use_after_drain"] != 0,
        "config": res["config"],
    }


# ---------------------------------------------------------------------------
# synthetic-knobs: closed-form trial for CI sweeps and policy tests
# ---------------------------------------------------------------------------

SYNTHETIC_DEFAULTS = {"slots": 4, "kv_block_size": 16}

SYNTHETIC_PARAMETERS = [
    {"name": "slots", "parameterType": "int",
     "feasibleSpace": {"min": 2, "max": 16}},
    {"name": "kv_block_size", "parameterType": "int",
     "feasibleSpace": {"min": 4, "max": 32}},
]


def _synthetic_trial(assignments: dict, *, seed: int = 0,
                     model: str = "", quick: bool = True,
                     device: str = "cuda") -> dict:
    """Closed-form objective surface over the decode-tps knob space: a
    smooth unimodal ridge whose optimum sits away from the checked-in
    defaults, plus a small seed-deterministic noise term. It runs nothing
    on a device (``device`` is accepted for the trial signature) and is
    exactly reproducible."""
    knobs = {**SYNTHETIC_DEFAULTS, **assignments}
    u_slots = (float(knobs["slots"]) - 2.0) / 14.0
    u_block = (float(knobs["kv_block_size"]) - 4.0) / 28.0
    ridge = math.exp(-((u_slots - 0.75) ** 2
                       + (u_block - 0.40) ** 2) / 0.18)
    noise = float(np.random.default_rng(
        seed * 1_000_003 + int(knobs["slots"]) * 31
        + int(knobs["kv_block_size"])).normal(0.0, 0.003))
    tps = round(100.0 * ridge + noise, 4)
    return {
        "scenario": "synthetic-knobs",
        "seed": int(seed),
        "assignments": dict(assignments),
        "objectives": {
            "tokens_per_sec": tps,
            "ttft_p99_s": round(0.05 / (0.2 + ridge), 6),
            "inter_token_p99_s": round(0.01 / (0.2 + ridge), 6),
            "queue_wait_p99_s": 0.0,
            "kv_utilization": round(min(u_slots + 0.1, 1.0), 4),
            "kv_bytes_peak": int(4096 * (1 + u_block)),
            "kv_blocks_in_use_after_drain": 0,
        },
        "config": (f"synthetic-knobs slots{knobs['slots']} "
                   f"block{knobs['kv_block_size']} seed{seed}"),
        "tokens_per_sec_per_chip": tps,
    }


# ---------------------------------------------------------------------------
# Bench scenarios
# ---------------------------------------------------------------------------


def bench_prefix_reuse(args, model) -> dict:
    """Prefix reuse: N concurrent requests sharing an S-token system
    prompt, decoded greedily with the prefix cache on and off. Reports
    TTFT, prefill dispatch and token volume, and the cache counters; the
    tokens must be identical both ways (``regression`` flags a mismatch
    or a volume win under 2x)."""
    spec = get_model(model)
    params = _init_params(spec, getattr(args, "device", "cuda"))
    n = 16 if args.quick else max(16, args.requests // 8)
    gen = min(args.max_new_tokens, 8)
    system = list(range(3, 3 + args.prefix_len))  # the shared prefix
    prompts = [system + [200 + i, 17, 11 + (i % 5)] for i in range(n)]
    prefill_len = max(args.seq_len, args.prefix_len + 8)

    runs = {}
    for label, cache_slots in (("off", 0), ("on", 8)):
        d = ContinuousDecoder(
            params, spec.config, slots=8, prefill_len=prefill_len,
            max_new_tokens=gen, prefix_cache_slots=cache_slots,
            prefix_cache_min_len=16, prefill_len_buckets=3)
        try:
            if cache_slots:
                # Preload the shared system prompt (what a deployment
                # does at startup) so every request hits.
                d.prime_prefix(system)
            # Warm the allocator and the cuBLAS handles outside the
            # timed burst.
            d.generate(prompts[0][:4], 1)

            def one(p):
                h = d.submit(p, gen)
                res = h.result(timeout=300)
                return res["tokens"], h.ttft_s * 1e3
            with ThreadPoolExecutor(args.concurrency) as pool:
                results = list(pool.map(one, prompts))
            m = d.metrics()
        finally:
            d.stop()
        runs[label] = {
            "tokens": [t for t, _ in results],
            "ttft_p50_ms": round(percentile(
                sorted(ms for _, ms in results), 50), 2),
            "prefill_dispatches": m["prefill_dispatches"],
            "prefill_tokens": m["prefill_tokens"],
            "prefix_hits": m["prefix_hits"],
            "prefix_tokens_reused": m["prefix_tokens_reused"],
        }

    identical = runs["on"]["tokens"] == runs["off"]["tokens"]
    ratio = runs["off"]["prefill_tokens"] / max(
        runs["on"]["prefill_tokens"], 1)
    return {
        "metric": "serving_prefix_reuse_ttft_p50_ms",
        "value": runs["on"]["ttft_p50_ms"],
        "unit": "ms",
        "vs_baseline": 1.0,
        "ttft_off_p50_ms": runs["off"]["ttft_p50_ms"],
        "prefill_tokens_off": runs["off"]["prefill_tokens"],
        "prefill_tokens_on": runs["on"]["prefill_tokens"],
        "prefill_volume_ratio": round(ratio, 2),
        "prefill_dispatches_off": runs["off"]["prefill_dispatches"],
        "prefill_dispatches": runs["on"]["prefill_dispatches"],
        "prefix_hits": runs["on"]["prefix_hits"],
        "prefix_tokens_reused": runs["on"]["prefix_tokens_reused"],
        "tokens_identical": identical,
        "regression": (not identical) or ratio < 2.0,
        "config": f"{model} prefix{args.prefix_len} n{n} gen{gen} "
                  f"prefill{prefill_len} c{args.concurrency}",
    }


def bench_speculative(args, model) -> dict:
    """Speculative decoding: N concurrent greedy requests with
    speculation off, n-gram and draft-model. Tokens must be identical in
    every mode (speculation may only change cost); the draft-model run
    (the same weights, so acceptance is structural) must clear 1.5
    accepted tokens a verify dispatch."""
    spec = get_model(model)
    params = _init_params(spec, getattr(args, "device", "cuda"))
    n = 8 if args.quick else max(8, args.requests // 16)
    gen = min(args.max_new_tokens, 16)
    k = args.speculative_k
    # Mildly repetitive prompts: the n-gram proposer finds something
    # without rigging the model's own continuations.
    prompts = [([3 + i, 17, 29, 3 + i, 17] * 3)[:12] for i in range(n)]

    runs = {}
    modes = (("off", {}),
             ("ngram", {"speculative_k": k, "draft_mode": "ngram"}),
             ("draft_model", {"speculative_k": k,
                              "draft_mode": f"model:{model}"}))
    for label, kw in modes:
        d = ContinuousDecoder(params, spec.config, slots=8, prefill_len=32,
                              max_new_tokens=gen, **kw)
        try:
            d.generate(prompts[0][:4], 1)  # warm the allocator

            def one(p):
                h = d.submit(p, gen)
                return h.result(timeout=300)["tokens"]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(args.concurrency) as pool:
                tokens = list(pool.map(one, prompts))
            wall = time.perf_counter() - t0
            m = d.metrics()
        finally:
            d.stop()
        runs[label] = {
            "tokens": tokens,
            "wall_s": wall,
            "decode_dispatches": m["decode_dispatches"],
            "spec_drafted_tokens": m["spec_drafted_tokens"],
            "spec_accepted_tokens": m["spec_accepted_tokens"],
            "spec_verify_dispatches": m["spec_verify_dispatches"],
            "spec_draft_dispatches": m["spec_draft_dispatches"],
            "spec_acceptance_rate": round(m["spec_acceptance_rate"], 3),
        }

    identical = (runs["ngram"]["tokens"] == runs["off"]["tokens"]
                 and runs["draft_model"]["tokens"] == runs["off"]["tokens"])
    dm = runs["draft_model"]
    accepted_per_dispatch = (dm["spec_accepted_tokens"]
                             / max(dm["spec_verify_dispatches"], 1))
    return {
        "metric": "serving_spec_accepted_tokens_per_dispatch",
        "value": round(accepted_per_dispatch, 2),
        "unit": "tokens/dispatch",
        "vs_baseline": 1.0,
        "acceptance_rate": dm["spec_acceptance_rate"],
        "ngram_acceptance_rate": runs["ngram"]["spec_acceptance_rate"],
        "ngram_accepted_tokens": runs["ngram"]["spec_accepted_tokens"],
        "drafted_tokens": dm["spec_drafted_tokens"],
        "accepted_tokens": dm["spec_accepted_tokens"],
        "verify_dispatches": dm["spec_verify_dispatches"],
        "draft_dispatches": dm["spec_draft_dispatches"],
        "decode_dispatches_off": runs["off"]["decode_dispatches"],
        "decode_dispatches_on": dm["decode_dispatches"],
        "tokens_identical": identical,
        "regression": (not identical) or accepted_per_dispatch <= 1.5,
        "config": f"{model} k{k} n{n} gen{gen} c{args.concurrency}",
    }


def bench_concurrency_sweep(args, model) -> dict:
    """Dense against paged KV at equal total pool bytes under an
    offered-concurrency ladder of mixed-length greedy requests.

    The dense decoder reserves ``slots * total_len`` positions, so its
    in-flight ceiling is ``slots`` however short the requests are. The
    paged decoder gets the same pool bytes (``slots * total_len /
    block_size`` blocks) and 4x the slots: admission is bounded by tokens
    resident, so the mixed-length load packs more concurrent requests
    into the same KV budget. A sequential probe pins identical greedy
    outputs between layouts; ``regression`` flags divergence, a paged
    in-flight peak under 2x dense, or blocks leaked after the drain."""
    spec = get_model(model)
    params = _init_params(spec, getattr(args, "device", "cuda"))
    gen = min(args.max_new_tokens, 16)
    prefill_len = 32
    block = 8
    total = prefill_len + gen
    dense_slots = 4
    pool_blocks = dense_slots * (total // block)  # equal KV bytes
    cfg = spec.config
    bytes_per_token = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                       * cfg.dtype.itemsize)
    ladder = [4, 16] if args.quick else [4, 16, 64]

    def request(i):
        plen = (4, 6, 8, 10)[i % 4]
        want = (2, 3, 4, gen // 2)[i % 4]
        return [3 + (i % 7)] * plen, want

    probes = [[1, 2, 3], [7, 5], [9, 9, 9, 9, 2]]
    runs = {}
    for layout in ("dense", "paged"):
        kw = (dict(kv_layout="paged", kv_block_size=block,
                   kv_pool_blocks=pool_blocks)
              if layout == "paged" else {})
        slots = dense_slots * 4 if layout == "paged" else dense_slots
        d = ContinuousDecoder(params, spec.config, slots=slots,
                              prefill_len=prefill_len, max_new_tokens=gen,
                              prefill_len_buckets=2,
                              stream_timeout_s=300.0, **kw)
        try:
            # Sequential parity probe (it also warms the allocator): the
            # layout must never change tokens.
            probe_out = [d.generate(p, 4)["tokens"] for p in probes]
            levels = {}
            for n in ladder:
                t0 = time.perf_counter()

                def one(i):
                    toks, want = request(i)
                    return len(d.submit(toks, want).result()["tokens"])
                with ThreadPoolExecutor(n) as pool:
                    emitted = sum(pool.map(one, range(n)))
                wall = time.perf_counter() - t0
                levels[n] = round(emitted / wall, 1)
            m = d.metrics()
        finally:
            d.stop()
        runs[layout] = {
            "tokens": probe_out,
            "levels": levels,
            "peak_in_flight": m["peak_in_flight"],
            "kv_blocks_peak": m["kv_blocks_peak"],
            "kv_blocks_in_use": m["kv_blocks_in_use"],
            "defer_admissions": m["kv_defer_admissions"],
            "kv_peak_bytes": (
                m["kv_blocks_peak"] * block * bytes_per_token
                if layout == "paged"
                else slots * total * bytes_per_token),
        }

    identical = runs["paged"]["tokens"] == runs["dense"]["tokens"]
    leak = runs["paged"]["kv_blocks_in_use"]
    dense_peak = runs["dense"]["peak_in_flight"]
    paged_peak = runs["paged"]["peak_in_flight"]
    top = ladder[-1]
    return {
        "metric": "serving_paged_peak_in_flight",
        "value": paged_peak,
        "unit": "requests",
        "vs_baseline": 1.0,
        "dense_peak_in_flight": dense_peak,
        "concurrency_ratio": round(paged_peak / max(dense_peak, 1), 2),
        "tokens_per_sec_dense": runs["dense"]["levels"],
        "tokens_per_sec_paged": runs["paged"]["levels"],
        "pool_bytes": pool_blocks * block * bytes_per_token,
        "kv_peak_bytes_dense": runs["dense"]["kv_peak_bytes"],
        "kv_peak_bytes_paged": runs["paged"]["kv_peak_bytes"],
        "defer_admissions": runs["paged"]["defer_admissions"],
        "kv_blocks_in_use_after_drain": leak,
        "tokens_identical": identical,
        "regression": ((not identical) or leak != 0
                       or paged_peak < 2 * dense_peak),
        "config": f"{model} ladder{ladder} gen{gen} "
                  f"prefill{prefill_len} block{block} "
                  f"pool{pool_blocks} slots{dense_slots}v"
                  f"{dense_slots * 4} top{top}",
    }


# ---------------------------------------------------------------------------
# Registrations
# ---------------------------------------------------------------------------

register(Scenario(
    name="decode-tps",
    description="Mixed-length decode throughput at a fixed KV pool "
                "budget; knobs reapportion the pool (slots, block size, "
                "prefill bucketing).",
    bench=_decode_tps_bench,
    trial=_decode_tps_trial,
    parameters=DECODE_TPS_PARAMETERS,
    defaults=dict(DECODE_TPS_DEFAULTS),
    objective="tokens_per_sec",
    optimization="maximize",
))

register(Scenario(
    name="synthetic-knobs",
    description="Closed-form objective over the decode-tps knob space; "
                "instant and seed-deterministic (policy-economy gates "
                "and CI sweeps are judged here).",
    trial=_synthetic_trial,
    parameters=SYNTHETIC_PARAMETERS,
    defaults=dict(SYNTHETIC_DEFAULTS),
    objective="tokens_per_sec",
    optimization="maximize",
))

register(Scenario(
    name="prefix-reuse",
    description="Shared-system-prompt TTFT and prefill volume, prefix "
                "cache on vs off (byte-identical tokens required).",
    bench=bench_prefix_reuse,
))

register(Scenario(
    name="speculative",
    description="Speculative decoding off / n-gram / draft-model: "
                "acceptance economy at byte-identical greedy tokens.",
    bench=bench_speculative,
))

register(Scenario(
    name="concurrency-sweep",
    description="Dense vs paged KV at equal pool bytes under an "
                "offered-concurrency ladder.",
    bench=bench_concurrency_sweep,
))


_BENCH_DEFAULTS = dict(requests=200, seq_len=128, concurrency=16,
                       max_new_tokens=64, prefix_len=96, speculative_k=4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.serving.scenarios",
        description="Run one scenario trial (or its bench entry) and print "
                    "the result as JSON.")
    p.add_argument("--scenario", required=True,
                   help=f"one of {sorted(_REGISTRY)}")
    p.add_argument("--seed", type=int, default=0,
                   help="trial seed (the scenario's traffic draws from it)")
    p.add_argument("--assignments", default="",
                   help="JSON knob assignments; empty = the checked-in "
                        "defaults (the bench entry, where there is one)")
    p.add_argument("--quick", action="store_true",
                   help="lm-test-tiny and the quick traffic")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    # The bench entries read bench_serving.py's traffic flags at its defaults.
    args = argparse.Namespace(**vars(args), **_BENCH_DEFAULTS)
    model = ("llama-1b" if args.device == "cuda" and not args.quick
             else "lm-test-tiny")
    try:
        sc = get_scenario(args.scenario)
        assignments = json.loads(args.assignments) if args.assignments else {}
    except ValueError as e:
        p.error(str(e))
    if sc.bench is not None and not assignments:
        result = sc.bench(args, model)
    else:
        result = run_trial(args.scenario, assignments, seed=args.seed,
                           model=model, quick=args.quick, device=args.device)
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
