"""X.509 issuance for the port's certificate controllers; a copy of
``kubeflow_tpu/auth/pki.py``.

A self-signed CA for each Issuer CR, and leaf certificates signed by it:
EC P-256 keys, SHA-256 signatures, the CA's ``BasicConstraints`` (path
length 0) and ``KeyUsage``, the leaf's ``SubjectAlternativeName``,
``BasicConstraints`` (not a CA) and ``ExtendedKeyUsage`` (server auth),
as in JAX. The rotation state machine that calls these lives in
:mod:`kubeflow_tpu_torch.operators.certificates`.

Uses the ``cryptography`` package, imported inside each function: this
module imports with the standard library alone, and where the package is
missing the first call raises ``ImportError`` (no certificate is ever
skipped quietly).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

_EC_CURVE = "secp256r1"  # small keys, fast issuance; every TLS stack has it


@dataclass(frozen=True)
class KeyCert:
    """PEM-encoded private key and certificate, and the issuing CA's."""

    key_pem: str
    cert_pem: str
    ca_pem: str = ""

    @property
    def chain_pem(self) -> str:
        """The leaf followed by its CA: what a TLS server presents."""
        return self.cert_pem + self.ca_pem


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.generate_private_key(ec.SECP256R1())


def _key_pem(key) -> str:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ).decode()


def _cert_pem(cert) -> str:
    from cryptography.hazmat.primitives import serialization

    return cert.public_bytes(serialization.Encoding.PEM).decode()


def make_ca(common_name: str, *, days: int = 3650) -> KeyCert:
    """A self-signed CA: an Issuer CR's root of trust."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import NameOID

    key = _new_key()
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )
    now = datetime.now(timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - timedelta(minutes=5))
        .not_valid_after(now + timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    pem = _cert_pem(cert)
    return KeyCert(key_pem=_key_pem(key), cert_pem=pem, ca_pem=pem)


def issue(
    ca: KeyCert,
    dns_names: list[str],
    *,
    duration_seconds: int,
    common_name: str | None = None,
) -> KeyCert:
    """A leaf certificate for ``dns_names`` signed by ``ca``."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key,
    )
    from cryptography.x509.oid import (
        ExtendedKeyUsageOID,
        NameOID,
    )

    if not dns_names:
        raise ValueError("certificate needs at least one dnsName")
    ca_key = load_pem_private_key(ca.key_pem.encode(), password=None)
    ca_cert = x509.load_pem_x509_certificate(ca.cert_pem.encode())
    key = _new_key()
    now = datetime.now(timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(
            NameOID.COMMON_NAME, common_name or dns_names[0])]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - timedelta(minutes=5))
        .not_valid_after(now + timedelta(seconds=duration_seconds))
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.DNSName(n) for n in dns_names]),
            critical=False,
        )
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(
            x509.ExtendedKeyUsage([ExtendedKeyUsageOID.SERVER_AUTH]),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    return KeyCert(key_pem=_key_pem(key), cert_pem=_cert_pem(cert),
                   ca_pem=ca.cert_pem)


def cert_info(cert_pem: str) -> dict:
    """The expiry and identity facts the rotation state machine reads."""
    from cryptography import x509
    from cryptography.x509.oid import ExtensionOID

    cert = x509.load_pem_x509_certificate(cert_pem.encode())
    try:
        san = cert.extensions.get_extension_for_oid(
            ExtensionOID.SUBJECT_ALTERNATIVE_NAME
        ).value
        dns_names = san.get_values_for_type(x509.DNSName)
    except x509.ExtensionNotFound:
        dns_names = []
    return {
        "serial": format(cert.serial_number, "x"),
        "not_before": cert.not_valid_before_utc,
        "not_after": cert.not_valid_after_utc,
        "dns_names": list(dns_names),
        "issuer": cert.issuer.rfc4514_string(),
    }
