"""REST model server; counterpart of ``kubeflow_tpu/serving/server.py``.

The REST surface of the JAX server, with the same request and response
bodies:

- ``POST /v1/models/<name>:predict``  generation instances
  ``{"tokens": [...], "max_new_tokens": n}`` → ``{"predictions": [...]}``;
  with ``"stream": true`` chunked JSON lines, one per token, then a
  terminal ``{"done": true, ...}`` record
- ``GET  /v1/models/<name>``          model metadata + availability
- ``GET  /healthz`` ``GET /readyz``   liveness/readiness

A predict without ``max_new_tokens`` (the plain forward of
``transformer.apply``), gRPC, metrics and the fleet endpoints are not yet
ported.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kubeflow_tpu_torch.serving.continuous import (
    ContinuousDecoder,
    PromptTooLong,
)
from kubeflow_tpu_torch.serving.engine import EngineConfig, InferenceEngine


class ModelServer:
    """REST on ``port`` (:8500 by convention; 0 binds an ephemeral port)
    over one engine and one continuous decoder. ``params`` (a numpy tree
    in the JAX layout) replaces the seeded random init."""

    def __init__(self, engine_cfg: EngineConfig, *, port: int = 8500,
                 params=None):
        self.engine = InferenceEngine(engine_cfg, params=params)
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        # Built at once (the JAX server builds it at the first request):
        # the port serves only language models, and an option that is not
        # yet ported fails here rather than at the first request.
        cfg = engine_cfg
        self.decoder = None if cfg.max_new_tokens <= 0 else ContinuousDecoder(
            self.engine.params, self.engine.model.config,
            slots=cfg.batch_size,
            prefill_len=cfg.max_seq_len,
            max_new_tokens=cfg.max_new_tokens,
            top_k=cfg.top_k,
            eos_id=cfg.eos_id,
            chunk_size=cfg.decode_chunk,
            prefill_len_buckets=cfg.prefill_len_buckets,
            kv_layout=cfg.kv_layout,
            kv_block_size=cfg.kv_block_size,
            kv_pool_blocks=cfg.kv_pool_blocks,
            kv_dtype=cfg.kv_dtype,
            kv_fused=cfg.kv_fused,
            stream_timeout_s=cfg.stream_timeout_s,
        )

    # ------------------------------------------------------------------

    def _generation_decoder(self, inst: dict) -> ContinuousDecoder:
        decoder = self.decoder
        if not inst.get("max_new_tokens") or decoder is None:
            raise ValueError(
                "a predict without 'max_new_tokens' > 0 (the plain forward "
                "of transformer.apply) is not yet ported to the PyTorch "
                "package")
        return decoder

    def handle_predict(self, name: str, body: dict) -> dict:
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        instances = body.get("instances")
        if not isinstance(instances, list) or not instances:
            raise ValueError("body must contain non-empty 'instances'")
        for inst in instances:
            self.engine.validate_instance(inst)
        decoders = [self._generation_decoder(inst) for inst in instances]
        handles = [d.submit(inst["tokens"], inst["max_new_tokens"],
                            float(inst.get("temperature", 0.0)))
                   for d, inst in zip(decoders, instances)]
        return {"predictions": [
            self._gen_prediction(inst, h.result(
                with_logits=bool(inst.get("return_logits")) or None))
            for inst, h in zip(instances, handles)]}

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

    def handle_predict_stream(self, name: str, body: dict):
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
        handle = self._generation_decoder(inst).submit(
            inst["tokens"], inst["max_new_tokens"],
            float(inst.get("temperature", 0.0)))

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

    def handle_metadata(self, name: str) -> dict:
        if name != self.engine.cfg.model:
            raise KeyError(f"model {name!r} not served")
        meta = self.engine.metadata()
        meta["state"] = "AVAILABLE" if self.engine.ready else "LOADING"
        return meta

    # ------------------------------------------------------------------

    def _make_handler(server: "ModelServer"):
        class Handler(BaseHTTPRequestHandler):
            # Chunked transfer-encoding needs HTTP/1.1 on the status line.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
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

            def do_GET(self):
                if self.path in ("/healthz", "/livez"):
                    self._send(200, {"status": "ok"})
                elif self.path == "/readyz":
                    ready = server.engine.ready
                    self._send(200 if ready else 503, {"ready": ready})
                elif self.path.startswith("/v1/models/"):
                    try:
                        self._send(200, server.handle_metadata(
                            self.path[len("/v1/models/"):]))
                    except KeyError as e:
                        self._send(404, {"error": str(e)})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not (self.path.startswith("/v1/models/")
                            and self.path.endswith(":predict")):
                        self._send(404, {"error": f"no route {self.path}"})
                        return
                    name = self.path[len("/v1/models/"):-len(":predict")]
                    if body.get("stream"):
                        self._send_stream(
                            server.handle_predict_stream(name, body))
                    else:
                        self._send(200, server.handle_predict(name, body))
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except TimeoutError as e:
                    self._send(503, {"error": str(e)
                                     or "generation timed out"})
                except PromptTooLong as e:
                    # Before ValueError: PromptTooLong subclasses it.
                    self._send(413, {"error": str(e)})
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": str(e)})

        return Handler

    def start(self) -> None:
        """Bind and serve on a background thread (tests, smoke runs)."""
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def serve_forever(self) -> None:
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port),
                                          self._make_handler())
        self._httpd.serve_forever()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self.decoder is not None:
            self.decoder.stop()
