"""Gateway entrypoint: ``python -m kubeflow_tpu_torch.gateway --port=8080
--admin-port=8877 --namespace=kubeflow``, with the flags of ``python -m
kubeflow_tpu.gateway``. The route table is refreshed from the apiserver's
Services every ``--refresh-seconds``."""

from __future__ import annotations

import argparse
import logging
import sys
import time

from kubeflow_tpu_torch.gateway import Gateway, RouteTable
from kubeflow_tpu_torch.k8s_client import ApiError
from kubeflow_tpu_torch.operators.certificates import ACME_CHALLENGE_CONFIGMAP
from kubeflow_tpu_torch.runtime import (
    add_client_args,
    client_from_args,
    strip_glog_args,
)

log = logging.getLogger(__name__)


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="kubeflow-tpu API gateway")
    add_client_args(p)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--admin-port", type=int, default=8877)
    p.add_argument("--auth-url", default="",
                   help="forward-auth check endpoint (gatekeeper /auth); "
                        "empty = no auth")
    p.add_argument("--refresh-seconds", type=float, default=15.0)
    p.add_argument("--tls-cert", default="",
                   help="PEM cert chain for TLS termination (the "
                        "iap/cert-manager ingress role); empty = HTTP")
    p.add_argument("--tls-key", default="", help="PEM private key")
    p.add_argument("--watch-certs", type=float, default=5.0,
                   help="seconds between cert-file freshness checks; the "
                        "certificate controller's rotations hot-reload "
                        "without dropping connections (0 disables)")
    p.add_argument("--redirect-port", type=int, default=None,
                   help="plain-HTTP port 301ing to the HTTPS entrypoint "
                        "(components/https-redirect analogue)")
    p.add_argument("--redirect-target-port", type=int, default=None,
                   help="externally advertised HTTPS port for redirect "
                        "Locations (default: omitted = 443); required "
                        "when the public port differs from the bind port")
    p.add_argument("--serve-acme-challenges", action="store_true",
                   help="serve /.well-known/acme-challenge/<token> from "
                        "the certificate controller's published tokens")
    p.add_argument("--jwt-issuer", default="",
                   help="require bearer id-tokens with this iss claim "
                        "(the envoy jwt-auth filter role); empty = no "
                        "token requirement")
    p.add_argument("--jwt-audience", default="kubeflow-tpu",
                   help="required aud claim on bearer tokens")
    p.add_argument("--jwks-uri", default="",
                   help="where to fetch verification keys (the "
                        "gatekeeper's /.well-known/jwks.json)")
    p.add_argument("--jwt-bypass", default="",
                   help="JSON bypass list, e.g. "
                        '[{"http_method":"GET","path_exact":"/healthz"}]')
    p.add_argument("--jwt-skew", type=float, default=60.0,
                   help="clock-skew allowance in seconds")
    p.add_argument("--max-body-bytes", type=int, default=0,
                   help="reject request bodies larger than this with "
                        "413 before reading them (0 = unbounded)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    client = client_from_args(args)
    table = RouteTable()
    challenge_lookup = None
    if args.serve_acme_challenges:
        def challenge_lookup(token: str) -> str | None:
            try:
                cm = client.get("v1", "ConfigMap",
                                ACME_CHALLENGE_CONFIGMAP, args.namespace)
            except ApiError as e:
                if e.code != 404:
                    # RBAC/addressing problems must be debuggable, not
                    # silent 404s on every challenge.
                    log.warning("acme challenge lookup failed: %s", e)
                return None
            # HTTP-01 body is the token itself (key-authorization
            # simplified to the platform's in-cluster validation).
            return token if token in (cm.get("data") or {}).values() \
                else None

    jwt_verifier = None
    if args.jwt_issuer:
        if not args.jwks_uri:
            p.error("--jwt-issuer requires --jwks-uri")
        from kubeflow_tpu_torch.gateway.jwt_auth import (
            JwtVerifier,
            bypass_from_specs,
        )

        jwt_verifier = JwtVerifier(
            args.jwks_uri, issuer=args.jwt_issuer,
            audience=args.jwt_audience,
            bypass=bypass_from_specs(args.jwt_bypass),
            skew_seconds=args.jwt_skew,
        )
    gw = Gateway(table, port=args.port, admin_port=args.admin_port,
                 auth_url=args.auth_url, certfile=args.tls_cert,
                 keyfile=args.tls_key,
                 cert_reload_seconds=args.watch_certs,
                 redirect_port=args.redirect_port,
                 redirect_target_port=args.redirect_target_port,
                 challenge_lookup=challenge_lookup,
                 jwt_verifier=jwt_verifier,
                 max_body_bytes=args.max_body_bytes)
    gw.start()
    log.info("gateway on :%d (admin :%d)", args.port, args.admin_port)
    try:
        while True:
            try:
                n = table.refresh(client, args.namespace)
                log.debug("route table refreshed: %d routes", n)
            except Exception as e:  # keep serving on apiserver blips
                log.warning("route refresh failed: %s", e)
            time.sleep(args.refresh_seconds)
    except KeyboardInterrupt:
        gw.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
