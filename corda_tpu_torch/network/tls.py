"""Mutual-TLS identity for the TCP messaging plane.

Reference parity: ArtemisTcpTransport's pinned-TLS transport with mutual
authentication (node-api ArtemisTcpTransport.kt:1-86), dev-mode certificate
autogeneration (AbstractNode.configureWithDevSSLCertificate) and the
X509Utilities CA-chain model (X509Utilities.kt:1-233): a development root CA
issues each node a certificate whose common name is the node's X.500 name,
and every TCP connection requires CA-signed certificates on *both* sides.

Trust model: possession of a certificate chained to the shared CA admits a
peer to the plane (the reference's cert-role policies map onto the CN, which
``peer_common_name`` exposes for higher-level checks). TLS version/suites
are whatever Python's ``ssl`` defaults negotiate (TLS 1.2+; the reference
pins its own suite list at the same layer).

The dev CA lives in a shared directory (one per test network / deployment);
creation is atomic across processes so concurrently booting nodes race
safely (driver DSL parity).
"""
from __future__ import annotations

import datetime
import os
import ssl
import time
from dataclasses import dataclass

CA_CERT = "tls-ca.crt"
CA_KEY = "tls-ca.key"


def _x509_modules():
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    return x509, hashes, serialization, ec


def _make_cert(subject_cn: str, issuer_name, signing_key, public_key,
               is_ca: bool):
    x509, hashes, _, _ = _x509_modules()
    name = x509.Name([x509.NameAttribute(x509.NameOID.COMMON_NAME, subject_cn)])
    now = datetime.datetime.now(datetime.timezone.utc)
    builder = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(issuer_name if issuer_name is not None else name)
        .public_key(public_key)
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(x509.BasicConstraints(ca=is_ca, path_length=None),
                       critical=True)
    )
    return builder.sign(signing_key, hashes.SHA256()), name


def ensure_dev_ca(directory: str) -> tuple[str, str]:
    """Create (once, atomically) or load the dev root CA in ``directory``.
    Returns (ca_cert_path, ca_key_path)."""
    x509, hashes, serialization, ec = _x509_modules()
    os.makedirs(directory, exist_ok=True)
    cert_path = os.path.join(directory, CA_CERT)
    key_path = os.path.join(directory, CA_KEY)
    if os.path.exists(cert_path):
        return cert_path, key_path
    # exclusive-create a lock marker: exactly one process generates the CA
    lock_path = cert_path + ".lock"
    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        for _ in range(100):             # another process is generating
            if os.path.exists(cert_path):
                return cert_path, key_path
            time.sleep(0.1)
        raise TimeoutError(f"dev CA generation stalled in {directory}")
    try:
        key = ec.generate_private_key(ec.SECP256R1())
        cert, _ = _make_cert("corda-tpu dev CA", None, key, key.public_key(),
                             is_ca=True)
        with open(key_path, "wb") as f:
            f.write(key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))
        tmp = cert_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))
        os.replace(tmp, cert_path)       # atomic publish: cert appears last
        return cert_path, key_path
    finally:
        os.close(fd)
        os.unlink(lock_path)


def issue_node_certificate(node_directory: str, common_name: str,
                           ca_directory: str) -> tuple[str, str]:
    """Issue (or reuse) this node's CA-signed TLS certificate.
    Returns (cert_path, key_path)."""
    x509, hashes, serialization, ec = _x509_modules()
    os.makedirs(node_directory, exist_ok=True)
    cert_path = os.path.join(node_directory, "tls-node.crt")
    key_path = os.path.join(node_directory, "tls-node.key")
    if os.path.exists(cert_path):
        return cert_path, key_path
    ca_cert_path, ca_key_path = ensure_dev_ca(ca_directory)
    with open(ca_key_path, "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), password=None)
    with open(ca_cert_path, "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    key = ec.generate_private_key(ec.SECP256R1())
    cert, _ = _make_cert(common_name, ca_cert.subject, ca_key,
                         key.public_key(), is_ca=False)
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return cert_path, key_path


def _context(purpose, ca_cert: str, cert: str, key: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER if purpose == "server"
                         else ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cert, key)
    ctx.load_verify_locations(ca_cert)
    ctx.verify_mode = ssl.CERT_REQUIRED   # mutual auth on both directions
    ctx.check_hostname = False            # identity = CA chain + CN, not DNS
    return ctx


@dataclass(frozen=True)
class TlsConfig:
    """The pair of SSL contexts a messaging endpoint needs."""

    server_ctx: ssl.SSLContext
    client_ctx: ssl.SSLContext

    @staticmethod
    def dev(node_directory: str, common_name: str,
            ca_directory: str) -> "TlsConfig":
        """Dev-mode: auto-provision CA + node cert and build both contexts
        (configureWithDevSSLCertificate analog)."""
        ca_cert, _ = ensure_dev_ca(ca_directory)
        cert, key = issue_node_certificate(node_directory, common_name,
                                           ca_directory)
        return TlsConfig(_context("server", ca_cert, cert, key),
                         _context("client", ca_cert, cert, key))


def peer_common_name(ssl_object) -> str | None:
    """CN of the peer's certificate on an established TLS connection — the
    hook for role policies above the transport."""
    cert = ssl_object.getpeercert()
    if not cert:
        return None
    for rdn in cert.get("subject", ()):
        for k, v in rdn:
            if k == "commonName":
                return v
    return None
