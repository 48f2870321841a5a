"""gRPC prediction service, the :9000 half of the serving contract;
counterpart of ``kubeflow_tpu/serving/grpc_server.py``.

The service rides grpc's generic handlers over UTF-8 JSON message bodies
(the REST predict schema), so no generated stubs are needed:

    service kubeflow.tpu.serving.PredictionService {
      rpc Predict (bytes json)          returns (bytes json);
      rpc PredictStream (bytes json)    returns (stream bytes json);
      rpc GetModelMetadata (bytes json) returns (bytes json);
    }

Predict request: ``{"model": "<name>", "instances": [...]}`` →
``{"predictions": [...]}``, the body ``/v1/models/<m>:predict`` returns.
The ``x-request-id`` metadata is honored (or minted) and echoed, as the
REST header is.

``grpc`` is imported only when the service is built or a stub is made:
this module imports without grpcio, and a host without it fails where
gRPC is asked for (the CLI exits 2 naming ``--grpc-port -1``).
"""

from __future__ import annotations

import json
import time
from concurrent import futures

from kubeflow_tpu_torch.observability.tracing import (
    REQUEST_ID_HEADER,
    gen_request_id,
)

SERVICE = "kubeflow.tpu.serving.PredictionService"
DEFAULT_GRPC_PORT = 9000

_RID_KEY = REQUEST_ID_HEADER.lower()  # grpc metadata keys are lowercase


def _request_id(context) -> str:
    """X-Request-ID for a gRPC call: the caller's metadata value, or a
    fresh one, echoed on the initial metadata."""
    import grpc

    rid = ""
    for key, value in context.invocation_metadata() or ():
        if key.lower() == _RID_KEY and value:
            rid = value
            break
    rid = rid or gen_request_id()
    try:
        context.send_initial_metadata(((_RID_KEY, rid),))
    except (grpc.RpcError, ValueError):  # pragma: no cover — echo only
        pass
    return rid


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


class GrpcPredictionService:
    """Serves a :class:`~kubeflow_tpu_torch.serving.server.ModelServer`
    over gRPC. Shares the server's batcher and decoder, so REST and gRPC
    requests coalesce into the same batches and decode rounds."""

    # Big batches of full-vocab logits overflow grpc's 4MB default.
    MAX_MESSAGE_BYTES = 64 * 1024 * 1024

    def __init__(self, model_server, *, port: int = DEFAULT_GRPC_PORT,
                 max_workers: int = 16):
        import grpc

        self.model_server = model_server
        self.port = port
        self._grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", self.MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", self.MAX_MESSAGE_BYTES),
                # grpc sets SO_REUSEPORT by default on Linux, so a second
                # server would share a taken port and take some of its
                # calls: refuse the port instead.
                ("grpc.so_reuseport", 0),
            ],
        )
        self._grpc_server.add_generic_rpc_handlers(
            (_Handler(self.model_server),))
        try:
            self.bound_port = self._grpc_server.add_insecure_port(
                f"0.0.0.0:{port}")
        except RuntimeError as e:  # newer grpc raises on a bind failure
            raise OSError(f"could not bind gRPC port {port}") from e
        if self.bound_port == 0 and port != 0:
            # older grpc reports it by returning port 0: surface it.
            raise OSError(f"could not bind gRPC port {port}")

    def start(self) -> None:
        self._grpc_server.start()

    def stop(self, grace: float | None = 1.0) -> None:
        self._grpc_server.stop(grace)


class _Handler:
    """The generic handler grpc asks for each call's method (grpc takes
    any object with ``service``; no base class, so this module imports
    without grpcio)."""

    def __init__(self, model_server):
        self.model_server = model_server

    def service(self, handler_call_details):
        import grpc

        method = handler_call_details.method
        if method == f"/{SERVICE}/Predict":
            return grpc.unary_unary_rpc_method_handler(
                self._predict, request_deserializer=bytes,
                response_serializer=bytes)
        if method == f"/{SERVICE}/PredictStream":
            return grpc.unary_stream_rpc_method_handler(
                self._predict_stream, request_deserializer=bytes,
                response_serializer=bytes)
        if method == f"/{SERVICE}/GetModelMetadata":
            return grpc.unary_unary_rpc_method_handler(
                self._metadata, request_deserializer=bytes,
                response_serializer=bytes)
        return None

    # ------------------------------------------------------------------

    def _parse(self, request: bytes, context) -> dict:
        import grpc

        try:
            body = json.loads(request or b"{}")
        except ValueError:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "request body is not valid JSON")
        if not isinstance(body, dict):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "request body must be a JSON object")
        return body

    def _predict(self, request: bytes, context) -> bytes:
        import grpc

        server = self.model_server
        t0 = time.perf_counter()
        error = True  # aborts raise out of the try
        try:
            body = self._parse(request, context)
            name = body.get("model") or server.engine.cfg.model
            try:
                result = server.handle_predict(
                    name, body, request_id=_request_id(context))
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except (ValueError, TimeoutError) as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            error = False
            return _json_bytes(result)
        finally:
            # The REST counters, so the metrics route sees :9000 too.
            server.metrics.observe(time.perf_counter() - t0, error)

    def _predict_stream(self, request: bytes, context):
        """Server-streaming generation: one JSON message per token, then a
        terminal ``{"done": true}`` record."""
        import grpc

        server = self.model_server
        t0 = time.perf_counter()
        error = True
        try:
            body = self._parse(request, context)
            name = body.get("model") or server.engine.cfg.model
            try:
                records = server.handle_predict_stream(
                    name, body, request_id=_request_id(context))
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except (ValueError, TimeoutError) as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            for rec in records:
                yield _json_bytes(rec)
            error = False
        finally:
            server.metrics.observe(time.perf_counter() - t0, error)

    def _metadata(self, request: bytes, context) -> bytes:
        import grpc

        server = self.model_server
        body = self._parse(request, context)
        name = body.get("model") or server.engine.cfg.model
        try:
            return _json_bytes(server.handle_metadata(name))
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))


# ---------------------------------------------------------------------------
# Client helpers (tests, smoke runs)
# ---------------------------------------------------------------------------


def client_stubs(channel):
    """Returns (predict, metadata) callables over an open channel;
    ``predict`` takes ``metadata=`` (e.g. the request id) and, with
    ``with_call=True``, returns (response, the call's initial
    metadata)."""
    predict = channel.unary_unary(
        f"/{SERVICE}/Predict", request_serializer=bytes,
        response_deserializer=bytes)
    metadata = channel.unary_unary(
        f"/{SERVICE}/GetModelMetadata", request_serializer=bytes,
        response_deserializer=bytes)

    def do_predict(model: str, instances: list, timeout: float = 30.0,
                   metadata=None, with_call: bool = False):
        body = _json_bytes({"model": model, "instances": instances})
        if with_call:
            resp, call = predict.with_call(body, timeout=timeout,
                                           metadata=metadata)
            return json.loads(resp), dict(call.initial_metadata())
        return json.loads(predict(body, timeout=timeout,
                                  metadata=metadata))

    def do_metadata(model: str, timeout: float = 10.0):
        resp = metadata(_json_bytes({"model": model}), timeout=timeout)
        return json.loads(resp)

    return do_predict, do_metadata


def stream_stub(channel):
    """Returns a callable yielding decoded records from PredictStream."""
    predict_stream = channel.unary_stream(
        f"/{SERVICE}/PredictStream", request_serializer=bytes,
        response_deserializer=bytes)

    def do_stream(model: str, instance: dict, timeout: float = 60.0,
                  metadata=None):
        for msg in predict_stream(
                _json_bytes({"model": model, "instances": [instance]}),
                timeout=timeout, metadata=metadata):
            yield json.loads(msg)

    return do_stream
