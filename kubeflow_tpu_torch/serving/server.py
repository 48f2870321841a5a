"""Model server; counterpart of ``kubeflow_tpu/serving/server.py``.

The REST surface of the JAX server, with the same request and response
bodies:

- ``POST /v1/models/<name>:predict``  ``{"instances": [...]}`` →
  ``{"predictions": [...]}``. An instance with ``"max_new_tokens": n``
  generates: through the continuous decoder in ``decode_mode
  "continuous"``, with ``"stream": true`` as chunked JSON lines, one per
  token, then a terminal ``{"done": true, ...}`` record. A plain instance
  (the last logits of ``transformer.apply``, BERT's pooled output,
  ResNet's class probabilities), and every instance in ``decode_mode
  "lockstep"``, coalesces in the dynamic batcher into one
  ``InferenceEngine.predict_batch`` call. Only language models generate.
- ``GET  /v1/models/<name>``          model metadata + availability
- ``GET  /healthz`` ``GET /readyz``   liveness/readiness
- ``GET  /monitoring/prometheus/metrics`` the server's request counters
  and latency histogram, the decoder's registry (TTFT, inter-token gap,
  queue wait, dispatch time, occupancy, chunk counters) and its counter
  snapshot, under the JAX server's family names
- ``GET  /debug/requests`` the decoder's request timelines (``?id=<rid>``
  filters, ``?format=chrome`` exports a trace-event file)

- ``POST /v1/models/<name>:prefill``  ``{"instances": [one], "handoff_to":
  "host:port"}``: the prompt's KV exported (``export_prompt``) and pushed
  as a handoff envelope to that decode server's ``:import``, or handed
  back as ``"envelope"`` without ``handoff_to``
- ``POST /v1/models/<name>:import``   a handoff envelope →
  ``{"imported": bool}``; the prompt's predict then hits the prefix
- ``POST /v1/models/<name>:kv``       ``{"tokens": [...]}`` → the deepest
  cached prefix as ``{"envelope", "weights_version", "prefix_len"}`` (the
  fleet KV economy's peer pull; 404 when nothing is cached)
- ``POST /v1/models/<name>:weights``  one chunk of a weight push
  (``serving/weights.py``); the last chunk of an epoch installs the tree
  (``update_weights``) → ``{"installed": bool, "weights_version": v}``
- ``POST /v1/models/<name>:pull``     ``{"seq": k}`` → chunk ``k`` of this
  server's current weights, for a replica booting from its peers

Every response carries ``X-Request-ID`` (the caller's, or a fresh one),
and a generation's id keys its timeline. A predict's ``X-Tenant``,
``X-Priority`` and ``X-Deadline-Ms`` headers reach the decoder's QoS; a
tenant over its rate gets 429 with ``Retry-After``, a request shed past
its deadline 503. gRPC on ``grpc_port`` (:9000 by convention;
``serving/grpc_server.py``) shares the engine, the batcher and the
decoder.

With ``kv_directory_size`` the decoder keeps a prefix->holder directory
and advertises itself as ``<model>:<port>``; ``cold_store_ref`` names a
shared cold store (``serving/cold_store.py``). The transport to pull a
peer's prefix is the wrapping fleet's (``DecoderFleet`` in process,
``RemoteActorFleet.fetch_kv`` over ``:kv``).
"""

from __future__ import annotations

import json
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kubeflow_tpu_torch.observability.metrics import (
    MetricRegistry,
    render_prometheus,
)
from kubeflow_tpu_torch.observability.tracing import (
    REQUEST_ID_HEADER,
    gen_request_id,
    render_debug,
)
from kubeflow_tpu_torch.serving.batcher import DynamicBatcher
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousDecoder,
    PromptTooLong,
)
from kubeflow_tpu_torch.serving import handoff as handoff_mod
from kubeflow_tpu_torch.serving import weights as weights_mod
from kubeflow_tpu_torch.serving.cold_store import cold_store_from_ref
from kubeflow_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from kubeflow_tpu_torch.serving.kv_directory import KvDirectory
from kubeflow_tpu_torch.serving.qos import QosPolicy, QosRejected


class _Metrics:
    """Server-level request metrics on their own registry: request and
    error counters, a latency histogram, and the boot surface (weight
    source, birth phase seconds) — the JAX server's families."""

    def __init__(self) -> None:
        self.registry = MetricRegistry()
        self._requests = self.registry.counter(
            "serving_requests_total", "HTTP requests handled")
        self._errors = self.registry.counter(
            "serving_errors_total", "HTTP requests that failed")
        self._latency = self.registry.histogram(
            "serving_latency_seconds", "End-to-end request latency")
        self._weight_pulls = self.registry.counter(
            "serving_weight_pulls_total",
            "Boot weight installs by source (peer = pulled from a "
            "serving donor over :pull; checkpoint = restored from the "
            "store; init = fresh random init)", labels=("source",))
        self._cold_start = self.registry.gauge(
            "serving_cold_start_seconds",
            "Birth phase durations: weights (install), compile "
            "(dispatch-set warm), first_token (boot to serving-ready)",
            labels=("phase",))

    def observe(self, seconds: float, error: bool) -> None:
        self._requests.inc()
        if error:
            self._errors.inc()
        self._latency.observe(seconds)

    def record_weight_pull(self, source: str) -> None:
        self._weight_pulls.labels(source or "init").inc()

    def record_cold_start(self, phases: dict) -> None:
        for phase, seconds in phases.items():
            self._cold_start.labels(phase).set(float(seconds))

    def render(self) -> str:
        return self.registry.render()


def _decoder_exposition(d: dict) -> str:
    """The decoder's counter snapshot under the JAX route's names
    (counters by ``_total`` suffix, gauges otherwise)."""
    return render_prometheus({
        "serving_decode_steps_total": d["decode_steps"],
        "serving_decode_dispatches_total": d["decode_dispatches"],
        "serving_prefill_dispatches_total": d["prefill_dispatches"],
        "serving_prefill_tokens_total": d["prefill_tokens"],
        "serving_requests_admitted_total": d["requests_admitted"],
        "serving_tokens_emitted_total": d["tokens_emitted"],
        "serving_ttft_avg_seconds": d["ttft_avg_s"],
        "serving_prefix_hits_total": d["prefix_hits"],
        "serving_prefix_misses_total": d["prefix_misses"],
        "serving_prefix_evictions_total": d["prefix_evictions"],
        "serving_prefix_tokens_reused_total": d["prefix_tokens_reused"],
        "serving_prefix_suffix_tokens_total": d["prefix_suffix_tokens"],
        "serving_prefix_entries": d["prefix_entries"],
        "serving_spec_drafted_tokens_total": d["spec_drafted_tokens"],
        "serving_spec_accepted_tokens_total": d["spec_accepted_tokens"],
        "serving_spec_verify_dispatches_total": d["spec_verify_dispatches"],
        "serving_spec_draft_dispatches_total": d["spec_draft_dispatches"],
        "serving_spec_acceptance_rate": d["spec_acceptance_rate"],
        "serving_kv_blocks_total": d["kv_blocks_total"],
        "serving_kv_blocks_in_use": d["kv_blocks_in_use"],
        "serving_kv_bytes_per_token": d["kv_bytes_per_token"],
        "serving_kv_bytes_in_use": d["kv_bytes_in_use"],
        "serving_kv_bytes_total": d["kv_bytes_total"],
        "serving_kv_dtype_int8": int(d["kv_dtype"] == "int8"),
        "serving_kv_cow_copies_total": d["kv_cow_copies"],
        "serving_kv_shared_blocks_total": d["kv_shared_blocks"],
        "serving_kv_defer_admissions_total": d["kv_defer_admissions"],
        "serving_kv_handoff_exports_total": d["kv_handoff_exports"],
        "serving_kv_handoff_imports_total": d["kv_handoff_imports"],
        "serving_kv_handoff_tokens_total": d["kv_handoff_tokens"],
        "serving_kv_host_tier_bytes": d["kv_host_tier_bytes"],
        "serving_kv_host_tier_bytes_total": d["kv_host_tier_bytes_total"],
        "serving_kv_host_tier_pinned_bytes": d["kv_host_tier_pinned_bytes"],
        "serving_kv_host_tier_entries": d["kv_host_tier_entries"],
        "serving_kv_host_demotions_total": d["kv_host_demotions"],
        "serving_kv_host_promotions_total": d["kv_host_promotions"],
        "serving_kv_host_evictions_total": d["kv_host_evictions"],
        "serving_kv_host_tier_high_water_bytes":
            d["kv_host_tier_high_water_bytes"],
        "serving_kv_peer_hits_total": d["kv_peer_hits"],
        "serving_kv_peer_misses_total": d["kv_peer_misses"],
        "serving_kv_peer_import_bytes_total": d["kv_peer_import_bytes"],
        "serving_kv_peer_fetch_failures_total": d["kv_peer_fetch_failures"],
        "serving_kv_cold_hits_total": d["kv_cold_hits"],
        "serving_kv_cold_demotions_total": d["kv_cold_demotions"],
        "serving_kv_cold_import_bytes_total": d["kv_cold_import_bytes"],
        "serving_kv_import_stale_refused_total":
            d["kv_import_stale_refused"],
        "serving_kv_import_skipped_crossover_total":
            d["kv_import_skipped_crossover"],
        "serving_kv_directory_publishes_total": d["kv_directory_publishes"],
        "serving_suspends_total": d["kv_suspends"],
        "serving_resumes_total": d["kv_resumes"],
        "serving_deadline_shed_total": d["qos_deadline_shed"],
        "serving_hol_bypasses_total": d["hol_bypasses"],
        "serving_qos_enabled": int(d["qos_enabled"]),
        "serving_weights_stale_refused_total": d["weights_stale_refused"],
        "serving_compile_cache_hits_total": d["compile_cache_hits"],
        "serving_compile_cache_misses_total": d["compile_cache_misses"],
        "serving_warming": int(d["warming"]),
        "serving_in_flight": d["in_flight"],
        "serving_queued": d["queued"],
    })


class ModelServer:
    """REST on ``port`` (:8500 by convention; 0 binds an ephemeral port)
    and gRPC on ``grpc_port`` (:9000 by convention; None disables it, 0
    binds an ephemeral port) over one engine, its dynamic batcher
    (``batch_timeout_ms``) and, in ``decode_mode "continuous"``, one
    continuous decoder. ``params`` (a numpy tree in the JAX layout)
    replaces the seeded random init."""

    def __init__(self, engine_cfg: EngineConfig, *, port: int = 8500,
                 grpc_port: int | None = None, params=None,
                 batch_timeout_ms: float = 5.0):
        self._t_boot = time.perf_counter()
        self.engine = InferenceEngine(engine_cfg, params=params)
        self.metrics = _Metrics()
        self.port = port
        self.grpc_port = grpc_port
        self._httpd: ThreadingHTTPServer | None = None
        self._grpc = None
        # Live weight pushes (:weights): chunk assembly, serialized so
        # concurrent chunks interleave safely. The :pull export: the
        # current epoch's flattened host tree, chunk-planned once per
        # epoch (its leaf lock guards only the cached tuple).
        self._weights_assembler = None
        self._weights_lock = threading.Lock()
        self._export_cache = None
        self._export_lock = threading.Lock()
        # The decoder is built at once (the JAX server builds it at the
        # first request), so a bad option fails here rather than at the
        # first request. None unless generation rides it: a language
        # model, continuous decoding (JAX's decoder property); BERT and
        # ResNet serve plain predicts only.
        cfg = engine_cfg
        continuous = (self.engine.model.family == "transformer"
                      and cfg.max_new_tokens > 0
                      and cfg.decode_mode == "continuous")
        qos = (QosPolicy(cfg.qos_tenants, aging_seconds=cfg.qos_aging_s)
               if cfg.qos_tenants else None)
        self.decoder = None if not continuous else ContinuousDecoder(
            self.engine.params, self.engine.model.config,
            slots=cfg.batch_size,
            prefill_len=cfg.max_seq_len,
            max_new_tokens=cfg.max_new_tokens,
            top_k=cfg.top_k,
            eos_id=cfg.eos_id,
            chunk_size=cfg.decode_chunk,
            prefix_cache_slots=cfg.prefix_cache_slots,
            prefix_cache_min_len=cfg.prefix_cache_min_len,
            prefill_len_buckets=cfg.prefill_len_buckets,
            speculative_k=cfg.speculative_k,
            draft_mode=cfg.draft_mode,
            kv_layout=cfg.kv_layout,
            kv_block_size=cfg.kv_block_size,
            kv_pool_blocks=cfg.kv_pool_blocks,
            kv_dtype=cfg.kv_dtype,
            kv_fused=cfg.kv_fused,
            stream_timeout_s=cfg.stream_timeout_s,
            prefill_chunk_tokens=cfg.prefill_chunk_tokens,
            max_prompt_len=cfg.max_prompt_len,
            role=cfg.serving_role,
            tp_shards=cfg.tp_shards,
            cp_shards=cfg.cp_shards,
            pp_stages=cfg.pp_stages,
            tp_devices=self.engine.tp_devices(),
            qos=qos,
            host_kv_bytes=cfg.host_kv_bytes,
            # The fleet KV economy: a sized directory makes the local
            # tiers fleet-visible; replicas resolving the same mem:// ref
            # in one process share one cold store.
            kv_directory=(KvDirectory(cfg.kv_directory_size)
                          if cfg.kv_directory_size > 0 else None),
            cold_store=cold_store_from_ref(cfg.cold_store_ref),
            kv_import_crossover_tokens=cfg.kv_import_crossover_tokens,
            replica_name=f"{cfg.model}:{port}",
            boot_weights_version=self.engine.boot_weights_version,
        )
        self.batcher = DynamicBatcher(self.engine.predict_batch,
                                      cfg.batch_size, batch_timeout_ms)

    # ------------------------------------------------------------------

    def handle_predict(self, name: str, body: dict,
                       request_id: str | None = None,
                       qos: dict | None = None) -> dict:
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        instances = body.get("instances")
        if not isinstance(instances, list) or not instances:
            raise ValueError("body must contain non-empty 'instances'")
        for inst in instances:
            self.engine.validate_instance(inst)
        # Generation goes to the continuous decoder (a short request
        # returns as soon as ITS tokens are done); plain predicts, and
        # lockstep generation, coalesce in the dynamic batcher. Every
        # instance is queued before any is collected.
        handles = []
        for i, inst in enumerate(instances):
            if inst.get("max_new_tokens") and self.decoder is not None:
                # One request id; later instances of a body suffix their
                # index so each stream's timeline stays unique.
                rid = (request_id if request_id and i == 0
                       else f"{request_id}-{i}" if request_id else None)
                handles.append(("gen", inst, self.decoder.submit(
                    inst["tokens"], inst["max_new_tokens"],
                    float(inst.get("temperature", 0.0)), request_id=rid,
                    **(qos or {}))))
            else:
                handles.append(("batch", inst,
                                self.batcher.submit_async(inst)))
        preds = []
        for kind, inst, h in handles:
            if kind == "gen":
                preds.append(self._gen_prediction(inst, h.result(
                    with_logits=bool(inst.get("return_logits")) or None)))
            else:
                preds.append(self.batcher.collect(h))
        return {"predictions": preds}

    @staticmethod
    def _gen_prediction(inst: dict, res: dict) -> dict:
        """The JAX server's generation schema."""
        toks = res["tokens"]
        pred = {
            "next_token": int(toks[0]) if toks
            else int(np.argmax(res["prefill_logits"])),
            "tokens": toks,
            "finish_reason": res["finish_reason"],
        }
        if not toks or inst.get("return_logits"):
            pred["logits"] = res["prefill_logits"].tolist()
        return pred

    def handle_predict_stream(self, name: str, body: dict,
                              request_id: str | None = None,
                              qos: dict | None = None):
        """Streaming generation: yields JSON-line dicts, one per token, then
        a terminal ``{"done": true, ...}`` record. Exactly one instance."""
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        instances = body.get("instances")
        if not isinstance(instances, list) or len(instances) != 1:
            raise ValueError("streaming needs exactly one instance")
        inst = instances[0]
        self.engine.validate_instance(inst)
        if not inst.get("max_new_tokens"):
            raise ValueError("streaming needs 'max_new_tokens' > 0")
        if self.decoder is None:
            raise ValueError("streaming needs decode_mode 'continuous'")
        handle = self.decoder.submit(
            inst["tokens"], inst["max_new_tokens"],
            float(inst.get("temperature", 0.0)), request_id=request_id,
            **(qos or {}))

        # Validation above runs before the HTTP 200 goes out; only the
        # token iteration is deferred.
        def _records():
            index = 0
            for tok in handle.tokens():
                yield {"token": tok, "index": index}
                index += 1
            res = handle.result()
            yield {
                "done": True,
                "tokens": res["tokens"],
                "finish_reason": res["finish_reason"],
                "ttft_ms": round(1000 * (res["ttft_s"] or 0.0), 3),
            }

        return _records()

    # -- the prefill/decode handoff --------------------------------------

    def _check_model(self, name: str) -> None:
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        if self.decoder is None:
            raise ValueError("model does not support generation")

    def handle_prefill(self, name: str, body: dict,
                       request_id: str | None = None) -> dict:
        """``:prefill``: export the one instance's prompt KV; push the
        packed envelope to ``handoff_to``'s ``:import`` (server to
        server), or hand it back without a destination."""
        self._check_model(name)
        instances = body.get("instances")
        if not isinstance(instances, list) or len(instances) != 1:
            raise ValueError("prefill handoff needs exactly one instance")
        inst = instances[0]
        self.engine.validate_instance(inst)
        h = self.decoder.export_prompt(inst["tokens"])
        env = handoff_mod.pack(h)
        target = str(body.get("handoff_to", "") or "")
        if target:
            pushed = self._push_handoff(name, target, env, request_id)
            return {"handoff": pushed, "prefix_len": h["prefix_len"]}
        return {"handoff": False, "prefix_len": h["prefix_len"],
                "envelope": env}

    def _push_handoff(self, name: str, target: str, env: dict,
                      request_id: str | None = None) -> bool:
        """POST the envelope at the decode server's ``:import``. Any
        failure returns False: the decode server then prefills the
        prompt itself (slower, never wrong)."""
        host, _, port_s = target.partition(":")
        data = json.dumps(env).encode()
        headers = {"Content-Type": "application/json"}
        if request_id:
            headers[REQUEST_ID_HEADER] = request_id
        try:
            conn = HTTPConnection(host, int(port_s or 80), timeout=30.0)
            try:
                conn.request("POST", f"/v1/models/{name}:import",
                             body=data, headers=headers)
                resp = conn.getresponse()
                out = json.loads(resp.read() or b"{}")
                return resp.status == 200 and bool(out.get("imported"))
            finally:
                conn.close()
        except (OSError, ValueError):
            return False

    def handle_import(self, name: str, body: dict) -> dict:
        """``:import``: a handoff envelope into this decoder's trie."""
        self._check_model(name)
        h = handoff_mod.unpack(body)  # ValueError on garbage -> 400
        return {"imported": bool(self.decoder.import_prompt(h))}

    def handle_kv(self, name: str, body: dict) -> dict:
        """``:kv``, the fleet KV economy's pull: the deepest cached prefix
        of the posted prompt as a packed handoff envelope, with the
        weights epoch that computed it (the requester refuses a stale or
        mismatched one). A prefix this server no longer caches is a
        ``KeyError`` (404): the requester withdraws its hint and falls
        through to the cold tier or a plain prefill."""
        self._check_model(name)
        toks = body.get("tokens")
        if not isinstance(toks, list) or not toks:
            raise ValueError("kv pull needs non-empty 'tokens'")
        h = self.decoder.export_prefix(toks)  # KeyError -> 404 on a miss
        ver = h.pop("weights_version", 0)
        return {"envelope": handoff_mod.pack(h), "weights_version": ver,
                "prefix_len": h["prefix_len"]}

    # -- live weight pushes -----------------------------------------------

    def handle_weights(self, name: str, body: dict) -> dict:
        """``:weights``: one chunk of a push. Chunks assemble per weights
        epoch; the tree installs only when its last chunk lands, so a
        torn or abandoned push never reaches the decoder."""
        self._check_model(name)
        decoder = self.decoder
        if decoder is None:
            raise ValueError("model does not support generation")
        chunk = weights_mod.unpack_chunk(body)  # ValueError -> 400
        with self._weights_lock:
            if self._weights_assembler is None:
                self._weights_assembler = weights_mod.WeightChunkAssembler()
            done = self._weights_assembler.add(chunk)
            pending = self._weights_assembler.pending
        if done is None:
            return {"installed": False, "pending": pending,
                    "weights_version": chunk["weights_version"]}
        leaves, has_draft = done
        model_leaves, draft_leaves = weights_mod.split_namespaces(leaves)
        params = weights_mod.unflatten_params(model_leaves,
                                              decoder.weights_template())
        draft = None
        if has_draft:
            spec = decoder._spec
            if spec is None or not hasattr(spec, "params"):
                raise ValueError(
                    "push carries draft weights but no draft-model "
                    "proposer is configured")
            draft = weights_mod.unflatten_params(draft_leaves, spec.params)
        installed = decoder.update_weights(
            params, version=chunk["weights_version"], draft_params=draft)
        return {"installed": True, "weights_version": installed}

    def handle_weights_pull(self, name: str, body: dict) -> dict:
        """``:pull``: chunk ``seq`` of this server's CURRENT weights epoch
        as a push envelope, for a replica booting from its peers. The
        flattened host tree is chunk-planned once per epoch; a push that
        swaps epochs mid-pull changes the version the next chunk carries,
        and the puller restarts. A ``seq`` beyond the plan is a KeyError
        (404)."""
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        seq = int(body.get("seq", 0))
        if self.decoder is not None:
            params, version = self.decoder.weights_snapshot()
        else:
            params = self.engine.params
            version = self.engine.boot_weights_version
        with self._export_lock:
            cache = self._export_cache
        if cache is None or cache[0] != version:
            # Flattened and planned outside the lock: a racing pull just
            # builds the same plan.
            groups = weights_mod.plan_chunks(
                weights_mod.flatten_namespaced(params))
            cache = (version, groups)
            with self._export_lock:
                self._export_cache = cache
        version, groups = cache
        if not 0 <= seq < len(groups):
            raise KeyError(f"weights chunk {seq} beyond plan "
                           f"({len(groups)} chunks at epoch {version})")
        return weights_mod.pack_chunk(groups[seq], version, seq,
                                      len(groups), False)

    def handle_metadata(self, name: str) -> dict:
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        meta = self.engine.metadata()
        meta["state"] = "AVAILABLE" if self.engine.ready else "LOADING"
        return meta

    def render_metrics(self) -> str:
        """The ``/monitoring/prometheus/metrics`` exposition: the server's
        families, then the decoder's registry and counter snapshot."""
        text = self.metrics.render()
        if self.decoder is not None:
            d = self.decoder.metrics()
            text += self.decoder.registry.render()
            text += _decoder_exposition(d)
        return text

    # ------------------------------------------------------------------

    def _make_handler(server: "ModelServer"):
        class Handler(BaseHTTPRequestHandler):
            # Chunked transfer-encoding needs HTTP/1.1 on the status line.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict | str,
                      content_type: str = "application/json") -> None:
                body = (payload if isinstance(payload, str)
                        else json.dumps(payload)).encode()
                self.send_response(code)
                self.send_header(REQUEST_ID_HEADER, self._request_id)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _chunk(self, rec: dict) -> None:
                data = (json.dumps(rec) + "\n").encode()
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            def _send_stream(self, records) -> None:
                """One JSON line per chunk. Once the 200 is out this owns
                the connection: a decoder failure mid-stream becomes an
                error record and a clean terminal chunk."""
                self.send_response(200)
                self.send_header(REQUEST_ID_HEADER, self._request_id)
                self.send_header("Content-Type", "application/jsonlines")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for rec in records:
                        self._chunk(rec)
                except Exception as e:
                    self._chunk({"error": str(e), "done": True})
                finally:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()

            def _qos_headers(self) -> dict:
                """Tenant, priority and shed deadline from the headers; a
                malformed number is a client error (400)."""
                qos = {}
                tenant = self.headers.get("X-Tenant")
                if tenant:
                    qos["tenant"] = tenant
                prio = self.headers.get("X-Priority")
                if prio:
                    try:
                        qos["priority"] = int(prio)
                    except ValueError:
                        raise ValueError(
                            f"malformed X-Priority {prio!r}") from None
                deadline = self.headers.get("X-Deadline-Ms")
                if deadline:
                    try:
                        qos["deadline_ms"] = float(deadline)
                    except ValueError:
                        raise ValueError(
                            f"malformed X-Deadline-Ms {deadline!r}"
                        ) from None
                return qos

            def _send_429(self, e: QosRejected) -> None:
                """Over-rate: backpressure the client can act on."""
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(429)
                self.send_header(REQUEST_ID_HEADER, self._request_id)
                self.send_header("Retry-After",
                                 str(max(1, int(e.retry_after_s + 0.999))))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _take_request_id(self) -> None:
                # Honor the caller's id, mint one otherwise; echoed on the
                # response and keyed into the decoder's timeline.
                self._request_id = (self.headers.get(REQUEST_ID_HEADER)
                                    or gen_request_id())

            def do_GET(self):
                self._take_request_id()
                route, _, query = self.path.partition("?")
                if self.path in ("/healthz", "/livez"):
                    self._send(200, {"status": "ok"})
                elif self.path == "/readyz":
                    ready = server.engine.ready
                    self._send(200 if ready else 503, {"ready": ready})
                elif self.path == "/monitoring/prometheus/metrics":
                    self._send(200, server.render_metrics(),
                               content_type="text/plain")
                elif route == "/debug/requests":
                    if server.decoder is None:
                        self._send(200, {"open": [], "finished": []})
                    else:
                        body, ctype = render_debug(server.decoder.trace,
                                                   query)
                        self._send(200, body.decode(), content_type=ctype)
                elif self.path.startswith("/v1/models/"):
                    try:
                        self._send(200, server.handle_metadata(
                            self.path[len("/v1/models/"):]))
                    except KeyError as e:
                        self._send(404, {"error": str(e)})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                t0 = time.perf_counter()
                error = False
                self._take_request_id()
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    model, _, verb = self.path.removeprefix(
                        "/v1/models/").rpartition(":")
                    routes = {
                        "prefill": lambda: server.handle_prefill(
                            model, body, request_id=self._request_id),
                        "import": lambda: server.handle_import(model, body),
                        "kv": lambda: server.handle_kv(model, body),
                        "weights": lambda: server.handle_weights(
                            model, body),
                        "pull": lambda: server.handle_weights_pull(
                            model, body),
                    }
                    if not self.path.startswith("/v1/models/") or not (
                            verb == "predict" or verb in routes):
                        error = True
                        self._send(404, {"error": f"no route {self.path}"})
                        return
                    if verb != "predict":
                        self._send(200, routes[verb]())
                        return
                    qos = self._qos_headers()
                    if body.get("stream"):
                        self._send_stream(server.handle_predict_stream(
                            model, body, request_id=self._request_id,
                            qos=qos))
                    else:
                        self._send(200, server.handle_predict(
                            model, body, request_id=self._request_id,
                            qos=qos))
                except KeyError as e:
                    error = True
                    self._send(404, {"error": str(e)})
                except QosRejected as e:
                    error = True
                    self._send_429(e)
                except TimeoutError as e:
                    # A deadline shed (DeadlineExceeded is a TimeoutError)
                    # lands here too: the answer's window has passed.
                    error = True
                    self._send(503, {"error": str(e)
                                     or "generation timed out"})
                except PromptTooLong as e:
                    # Before ValueError: PromptTooLong subclasses it.
                    error = True
                    self._send(413, {"error": str(e)})
                except ValueError as e:
                    error = True
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    error = True
                    self._send(500, {"error": str(e)})
                finally:
                    server.metrics.observe(time.perf_counter() - t0, error)

        return Handler

    def _start_grpc(self) -> None:
        if self.grpc_port is None:
            return
        from kubeflow_tpu_torch.serving.grpc_server import (
            GrpcPredictionService,
        )

        self._grpc = GrpcPredictionService(self, port=self.grpc_port)
        self.grpc_port = self._grpc.bound_port  # resolve port 0
        self._grpc.start()

    def warm(self) -> None:
        """Warm the engine (the first call builds the kernels on the
        card; ``/readyz`` answers 503 until then) and publish the birth
        phases and the weights' source."""
        t0 = time.perf_counter()
        self.engine.warmup()
        self.engine.cold_start["compile"] = time.perf_counter() - t0
        self.engine.cold_start["first_token"] = (time.perf_counter()
                                                 - self._t_boot)
        self.metrics.record_cold_start(self.engine.cold_start)
        self.metrics.record_weight_pull(self.engine.weight_pull_source)

    def start(self) -> None:
        """Bind gRPC and REST, serve on background threads (tests, smoke
        runs), then warm."""
        self._start_grpc()
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        if self.decoder is not None:
            # The directory names this replica by its bound port.
            self.decoder.replica_name = f"{self.engine.cfg.model}:{self.port}"
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        self.warm()

    def serve_forever(self) -> None:
        self._start_grpc()
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port),
                                          self._make_handler())
        # Warm on a side thread: the accept loop answers probes meanwhile.
        threading.Thread(target=self.warm, daemon=True).start()
        self._httpd.serve_forever()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._grpc is not None:
            self._grpc.stop()
        self.batcher.stop()
        if self.decoder is not None:
            self.decoder.stop()
