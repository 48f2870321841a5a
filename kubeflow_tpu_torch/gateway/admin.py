"""The admin/ops surface: /routes, /upstreams, /metrics, /metricsz,
/debug/requests, and the send-feedback analogue (POST
/routes/<name>/feedback) steering epsilon-greedy routes; a copy of
``kubeflow_tpu/gateway/admin.py`` over the port's renderers.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler

from kubeflow_tpu_torch.observability.metrics import render_prometheus
from kubeflow_tpu_torch.observability.tracing import render_debug


def make_admin_handler(gw):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/routes":
                routes = gw.table.snapshot()
                for r in routes:
                    if r.get("strategy") == "epsilon-greedy":
                        r["bandit"] = gw.bandit.snapshot(r["name"])
                    if r.get("outlier_threshold"):
                        r["outliers"] = gw.outliers.snapshot(r["name"])
                body = json.dumps(routes).encode()
                ctype = "application/json"
            elif self.path == "/upstreams":
                # Upstream health + circuit state, per backend (the
                # envoy clusters/outlier admin surface), plus the
                # in-flight depth the prefix-affine spill reads.
                snap = gw.health.snapshot()
                for svc, depth in gw.load.snapshot().items():
                    snap.setdefault(svc, {})["in_flight"] = depth
                # Last-scraped KV fill (None = no signal) alongside the
                # depth, so operators see both spill inputs in one view.
                for svc, fill in gw.kv_fill.snapshot().items():
                    snap.setdefault(svc, {})["kv_fill"] = fill
                body = json.dumps(snap).encode()
                ctype = "application/json"
            elif self.path == "/metrics":
                # Counters through the shared dict renderer (typed by
                # the _total suffix), histograms (per-route upstream
                # latency) through the gateway's registry — one
                # exposition renderer for the whole platform.
                body = (render_prometheus({
                    "gateway_requests_total": gw.requests_total,
                    "gateway_errors_total": gw.errors_total,
                    "gateway_upgrade_tunnels_total": gw.tunnels_total,
                    "gateway_shadow_requests_total": gw.shadow_total,
                    "gateway_retries_total": gw.retries_total,
                    "gateway_affine_spills_total": gw.affine_spills,
                    "gateway_directory_hits_total": gw.directory_hits,
                    "gateway_qos_shed_total": gw.qos_shed_total,
                    "gateway_body_rejected_total":
                        gw.body_rejected_total,
                    "gateway_handoffs_total": gw.handoffs_total,
                    "gateway_handoff_failures_total":
                        gw.handoff_failures,
                    "gateway_kv_scrapes_total": gw.kv_fill.scrapes,
                    "gateway_kv_scrape_failures_total":
                        gw.kv_fill.scrape_failures,
                    "gateway_outliers_total": gw.outliers.totals()[0],
                    "gateway_outlier_scored_total":
                        gw.outliers.totals()[1],
                    "gateway_jwt_verified_total":
                        getattr(gw.jwt_verifier, "verified_total", 0),
                    "gateway_jwt_rejected_total":
                        getattr(gw.jwt_verifier, "rejected_total", 0),
                }) + gw.registry.render()).encode()
                ctype = "text/plain"
            elif self.path == "/metricsz":
                # Fleet rollup (JSON, not prometheus exposition): the
                # per-route affinity outcome counters — affine hits vs
                # pressure spills vs directory-steered spills — plus
                # the prefix-directory stats and the per-backend
                # depth/KV-fill the spill decisions read. One curl
                # answers "is locality holding, and when it breaks,
                # does the directory catch the spill?" — previously
                # spills were only visible per-replica.
                with gw._affinity_lock:
                    routes = {name: dict(per)
                              for name, per in gw.route_affinity.items()}
                totals = {"affine": 0, "spill": 0, "directory": 0}
                for per in routes.values():
                    for k in totals:
                        totals[k] += per.get(k, 0)
                upstreams = {}
                for svc, depth in gw.load.snapshot().items():
                    upstreams.setdefault(svc, {})["in_flight"] = depth
                for svc, fill in gw.kv_fill.snapshot().items():
                    upstreams.setdefault(svc, {})["kv_fill"] = fill
                body = json.dumps({
                    "routes": routes,
                    "totals": totals,
                    "affine_spills_total": gw.affine_spills,
                    "directory_hits_total": gw.directory_hits,
                    "directory": gw.kv_directory.stats(),
                    "upstreams": upstreams,
                }).encode()
                ctype = "application/json"
            elif self.path.partition("?")[0] == "/debug/requests":
                body, ctype = render_debug(gw.trace,
                                           self.path.partition("?")[2])
            elif self.path in ("/healthz", "/readyz"):
                body, ctype = b'{"status":"ok"}', "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            """POST /routes/<name>/feedback {"service", "reward"} —
            the seldon /send-feedback analogue: callers grade a
            variant's answer (0..1) after the fact, steering the
            epsilon-greedy router beyond what status codes reveal."""
            parts = self.path.strip("/").split("/")
            if (len(parts) != 3 or parts[0] != "routes"
                    or parts[2] != "feedback"):
                self.send_response(404)
                self.end_headers()
                return
            route = gw.table.find(parts[1])
            if route is None:
                body = json.dumps(
                    {"error": f"no route {parts[1]!r}"}).encode()
                self.send_response(404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                service = payload["service"]
                reward = float(payload["reward"])
                if not 0.0 <= reward <= 1.0:
                    raise ValueError("reward must be in [0, 1]")
                # Only the route's real variants are gradeable — a
                # typo'd service must not 200-and-steer-nothing, and
                # validation bounds the stats table to routes×backends.
                variants = {b[0] for b in route.backends}
                if service not in variants:
                    raise ValueError(
                        f"service {service!r} is not a variant of "
                        f"route {parts[1]!r}")
            except (ValueError, KeyError, TypeError) as e:
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            gw.bandit.record(parts[1], service, reward)
            body = json.dumps(
                {"ok": True,
                 "stats": gw.bandit.snapshot(parts[1])}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler

