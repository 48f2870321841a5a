"""Identity tokens: ES256 JWTs + JWKS; a copy of
``kubeflow_tpu/auth/tokens.py`` (the gateway's ``jwt_auth`` verifies
through it).

- :class:`SigningKeyRing`: ES256 (P-256) keypairs with stable ``kid``s,
  zero-downtime rotation (retired keys stay published in the JWKS until
  every token they signed has expired), and short-lived id-token
  issuance.
- :func:`verify`: signature against a JWKS, issuer/audience/expiry with
  clock skew, algorithm pinned to ES256 (an ``alg: none`` or HMAC
  downgrade is rejected before any crypto runs).

Uses the ``cryptography`` package, imported inside the functions that
sign or verify, so importing this module needs only the standard
library.
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
import time
from typing import Callable, Mapping

ALG = "ES256"
# Longest token TTL the issuer will grant — also how long a retired
# signing key must stay published before it can be pruned from the JWKS.
MAX_TTL_SECONDS = 24 * 3600


class TokenError(Exception):
    """Verification failure; str() is a short machine-greppable reason."""


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


def _int_to_b64url(n: int) -> str:
    return _b64url(n.to_bytes(32, "big"))


class SigningKeyRing:
    """ES256 signing keys with JWKS publication and rotation.

    ``rotate()`` makes a fresh key active; previous keys are retired but
    remain in the JWKS until ``prune()`` observes that every token they
    could have signed has expired (retire time + MAX_TTL). Verifiers that
    re-fetch the JWKS on an unknown ``kid`` therefore see no outage at
    any point in the rotation.
    """

    def __init__(self, issuer: str, *, clock: Callable[[], float] = time.time):
        self.issuer = issuer
        self.clock = clock
        self._lock = threading.Lock()
        self._keys: dict[str, object] = {}     # kid -> EC private key
        self._retired_at: dict[str, float] = {}
        self._active_kid = ""
        self.rotate()

    # -- key lifecycle ------------------------------------------------------

    def rotate(self) -> str:
        """Generate + activate a new signing key; returns its kid."""
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ec

        key = ec.generate_private_key(ec.SECP256R1())
        spki = key.public_key().public_bytes(
            serialization.Encoding.DER,
            serialization.PublicFormat.SubjectPublicKeyInfo,
        )
        kid = hashlib.sha256(spki).hexdigest()[:16]
        with self._lock:
            if self._active_kid:
                self._retired_at[self._active_kid] = self.clock()
            self._keys[kid] = key
            self._active_kid = kid
        return kid

    def prune(self) -> list[str]:
        """Drop retired keys no live token can still reference."""
        cutoff = self.clock() - MAX_TTL_SECONDS
        with self._lock:
            dead = [kid for kid, t in self._retired_at.items()
                    if t < cutoff]
            for kid in dead:
                del self._keys[kid]
                del self._retired_at[kid]
        return dead

    @property
    def active_kid(self) -> str:
        with self._lock:
            return self._active_kid

    def jwks(self) -> dict:
        """Public keys as an RFC 7517 key set (active + retired)."""
        with self._lock:
            keys = []
            for kid, key in self._keys.items():
                nums = key.public_key().public_numbers()
                keys.append({
                    "kty": "EC", "crv": "P-256", "alg": ALG, "use": "sig",
                    "kid": kid,
                    "x": _int_to_b64url(nums.x),
                    "y": _int_to_b64url(nums.y),
                })
            return {"keys": keys}

    # -- issuance -----------------------------------------------------------

    def issue(self, subject: str, audience: str | list[str], *,
              ttl_seconds: int = 3600, claims: Mapping | None = None) -> str:
        """Sign a short-lived id-token for ``subject``/``audience``."""
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec, utils

        ttl = max(1, min(int(ttl_seconds), MAX_TTL_SECONDS))
        now = int(self.clock())
        payload = dict(claims or {})
        payload.update({
            "iss": self.issuer, "sub": subject, "aud": audience,
            "iat": now, "exp": now + ttl,
        })
        with self._lock:
            kid = self._active_kid
            key = self._keys[kid]
        header = {"alg": ALG, "typ": "JWT", "kid": kid}
        signing_input = (
            _b64url(json.dumps(header, separators=(",", ":")).encode())
            + "."
            + _b64url(json.dumps(payload, separators=(",", ":")).encode())
        )
        der = key.sign(signing_input.encode("ascii"),
                       ec.ECDSA(hashes.SHA256()))
        r, s = utils.decode_dss_signature(der)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        return signing_input + "." + _b64url(sig)


def _public_key_from_jwk(jwk: Mapping):
    from cryptography.hazmat.primitives.asymmetric import ec

    if jwk.get("kty") != "EC" or jwk.get("crv") != "P-256":
        raise TokenError("unsupported-key")
    x = int.from_bytes(_unb64url(jwk["x"]), "big")
    y = int.from_bytes(_unb64url(jwk["y"]), "big")
    return ec.EllipticCurvePublicNumbers(
        x, y, ec.SECP256R1()
    ).public_key()


def decode_unverified(token: str) -> tuple[dict, dict]:
    """Parse (header, payload) WITHOUT verification — for kid routing
    only; never trust the result for authorization."""
    parts = token.split(".")
    if len(parts) != 3:
        raise TokenError("malformed")
    try:
        header = json.loads(_unb64url(parts[0]))
        payload = json.loads(_unb64url(parts[1]))
    except (ValueError, UnicodeDecodeError):
        raise TokenError("malformed") from None
    if not isinstance(header, dict) or not isinstance(payload, dict):
        raise TokenError("malformed")
    return header, payload


def verify(token: str, jwks: Mapping, *, issuer: str, audience: str,
           now: float | None = None, skew_seconds: float = 60.0) -> dict:
    """Verify signature + claims; returns the payload or raises TokenError.

    The algorithm is pinned: only ES256 against an EC/P-256 JWKS key is
    accepted, so ``alg: none`` and HMAC-with-public-key downgrades fail
    as ``bad-alg`` before any signature math.
    """
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec, utils

    header, payload = decode_unverified(token)
    if header.get("alg") != ALG:
        raise TokenError("bad-alg")
    kid = header.get("kid", "")
    jwk = next((k for k in jwks.get("keys", []) if k.get("kid") == kid),
               None)
    if jwk is None:
        raise TokenError("unknown-kid")
    try:
        sig = _unb64url(token.rsplit(".", 1)[1])
    except ValueError:
        raise TokenError("bad-signature") from None
    if len(sig) != 64:
        raise TokenError("bad-signature")
    der = utils.encode_dss_signature(
        int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    )
    signing_input = token.rsplit(".", 1)[0].encode("ascii")
    try:
        _public_key_from_jwk(jwk).verify(der, signing_input,
                                         ec.ECDSA(hashes.SHA256()))
    except InvalidSignature:
        raise TokenError("bad-signature") from None

    if payload.get("iss") != issuer:
        raise TokenError("bad-issuer")
    aud = payload.get("aud")
    if not (aud == audience or (isinstance(aud, list) and audience in aud)):
        raise TokenError("bad-audience")
    t = time.time() if now is None else now
    try:
        exp = float(payload["exp"])
    except (KeyError, TypeError, ValueError):
        raise TokenError("no-expiry") from None
    if t > exp + skew_seconds:
        raise TokenError("expired")
    nbf = payload.get("nbf", payload.get("iat"))
    if nbf is not None:
        try:
            if t < float(nbf) - skew_seconds:
                raise TokenError("not-yet-valid")
        except (TypeError, ValueError):
            raise TokenError("malformed") from None
    return payload
