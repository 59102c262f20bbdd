"""CSR enrolment — the production certificate path (doorman registration).

Reference parity: node/utilities/registration/NetworkRegistrationHelper.kt
:1-148 — the node generates a keypair, builds a PKCS#10 certificate signing
request for its X.500 name, submits it to the network's DOORMAN, polls by
request id until the signed chain arrives (the doorman may hold requests
for manual approval), and installs the chain where the transport expects
it. Dev mode (network.tls TlsConfig.dev) self-provisions instead; this
module is the non-dev path.

The doorman here is an in-process service object (run it behind the HTTP
gateway or any transport you like — the protocol is submit/poll by id,
exactly the reference's `/certificate` endpoints); `NetworkRegistrationHelper`
drives it and writes ``tls-node.key`` / ``tls-node.crt`` / ``tls-ca.crt``
into the node directory — the same files the dev provisioning produces, so
a registered node's TlsConfig loads identically.
"""
from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field


class RegistrationError(Exception):
    pass


def _modules():
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    return x509, hashes, serialization, ec


def build_csr(common_name: str, key) -> bytes:
    """PKCS#10 CSR PEM for ``common_name`` signed by ``key``."""
    x509, hashes, serialization, _ = _modules()
    csr = (x509.CertificateSigningRequestBuilder()
           .subject_name(x509.Name([
               x509.NameAttribute(x509.NameOID.COMMON_NAME, common_name)]))
           .sign(key, hashes.SHA256()))
    return csr.public_bytes(serialization.Encoding.PEM)


@dataclass
class DoormanService:
    """The network operator's signing service: validates CSRs, optionally
    holds them for approval, signs with the network CA.

    ``auto_approve=False`` models the reference's manual-approval flow: the
    request stays pending until ``approve(request_id)`` is called."""

    ca_directory: str
    auto_approve: bool = True
    #: X.500-ish names already enrolled (one cert per name, like the
    #: reference doorman's identity checks)
    _issued_names: set = field(default_factory=set)
    _pending: dict = field(default_factory=dict)   # id -> (cn, csr_pem)
    _signed: dict = field(default_factory=dict)    # id -> [cert_pem, ca_pem]

    def submit_request(self, csr_pem: bytes) -> str:
        x509, hashes, serialization, _ = _modules()
        try:
            csr = x509.load_pem_x509_csr(csr_pem)
        except Exception as e:
            raise RegistrationError(f"malformed CSR: {e}")
        if not csr.is_signature_valid:
            raise RegistrationError("CSR signature is invalid")
        cns = csr.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)
        if len(cns) != 1 or not cns[0].value.strip():
            raise RegistrationError("CSR must carry exactly one common name")
        common_name = cns[0].value
        # IDEMPOTENT submission: re-submitting the identical CSR (same name,
        # same key — e.g. a node that crashed between submitting and
        # persisting its request id) returns the ORIGINAL request id instead
        # of an error, so enrolment can always resume
        for rid, (cn, pem) in self._pending.items():
            if cn == common_name and pem == csr_pem:
                return rid
        pending_names = {cn for cn, _ in self._pending.values()}
        if common_name in self._issued_names or common_name in pending_names:
            raise RegistrationError(
                f"a certificate for {common_name!r} was already "
                f"issued or requested")
        request_id = uuid.uuid4().hex
        self._pending[request_id] = (common_name, csr_pem)
        if self.auto_approve:
            self.approve(request_id)
        return request_id

    def approve(self, request_id: str) -> None:
        """Sign a pending request with the network CA."""
        from .tls import ensure_dev_ca
        x509, hashes, serialization, _ = _modules()
        if request_id not in self._pending:
            raise RegistrationError(f"unknown request {request_id!r}")
        # leave the request pending until the chain is published: a poller
        # racing this signing must see "pending", never "unknown"
        common_name, csr_pem = self._pending[request_id]
        csr = x509.load_pem_x509_csr(csr_pem)
        ca_cert_path, ca_key_path = ensure_dev_ca(self.ca_directory)
        with open(ca_key_path, "rb") as f:
            ca_key = serialization.load_pem_private_key(f.read(),
                                                        password=None)
        with open(ca_cert_path, "rb") as f:
            ca_pem = f.read()
        ca_cert = x509.load_pem_x509_certificate(ca_pem)
        import datetime
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (x509.CertificateBuilder()
                .subject_name(csr.subject)
                .issuer_name(ca_cert.subject)
                .public_key(csr.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(days=3650))
                .add_extension(
                    x509.BasicConstraints(ca=False, path_length=None),
                    critical=True)
                .sign(ca_key, hashes.SHA256()))
        self._issued_names.add(common_name)
        self._signed[request_id] = [
            cert.public_bytes(serialization.Encoding.PEM), ca_pem]
        self._pending.pop(request_id, None)

    def retrieve(self, request_id: str):
        """None while pending; [node_cert_pem, ca_cert_pem] once signed."""
        if request_id in self._pending:
            return None
        chain = self._signed.get(request_id)
        if chain is None:
            raise RegistrationError(f"unknown request {request_id!r}")
        return chain


class NetworkRegistrationHelper:
    """The node-side enrolment driver (NetworkRegistrationHelper.kt:1-148):
    generate the TLS key, build + submit the CSR, poll until signed, install
    the chain into the node directory."""

    def __init__(self, node_directory: str, common_name: str,
                 doorman: DoormanService, poll_interval_s: float = 0.2,
                 max_polls: int = 50):
        self.node_directory = node_directory
        self.common_name = common_name
        self.doorman = doorman
        self.poll_interval_s = poll_interval_s
        self.max_polls = max_polls

    def register(self) -> tuple[str, str]:
        """Run the enrolment; returns (cert_path, key_path). Idempotent:
        an already-installed certificate short-circuits (the reference
        helper's keystore check), and an in-flight request — key + request
        id persisted BEFORE polling — is RESUMED by a later register()
        instead of re-submitted, so a poll timeout followed by late
        operator approval still enrols (NetworkRegistrationHelper's
        requestIdStore)."""
        import json
        _, _, serialization, ec = _modules()
        os.makedirs(self.node_directory, exist_ok=True)
        cert_path = os.path.join(self.node_directory, "tls-node.crt")
        key_path = os.path.join(self.node_directory, "tls-node.key")
        pending_path = os.path.join(self.node_directory,
                                    "enrolment-request.json")
        if os.path.exists(cert_path):
            return cert_path, key_path
        if os.path.exists(pending_path):
            # resume: the key (and possibly the request id) persisted before
            # any submission, so every crash window replays deterministically
            with open(pending_path) as f:
                saved = json.load(f)
            key = serialization.load_pem_private_key(
                saved["key_pem"].encode(), password=None)
            request_id = saved.get("request_id")
        else:
            key = ec.generate_private_key(ec.SECP256R1())
            key_pem = key.private_bytes(
                serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()).decode()
            # persist the key BEFORE submitting: the doorman's idempotent
            # submission returns the same id for the same (name, key) CSR,
            # so a crash in either order cannot strand the name
            with open(pending_path, "w") as f:
                json.dump({"key_pem": key_pem}, f)
            request_id = None
        if request_id is None:
            request_id = self.doorman.submit_request(
                build_csr(self.common_name, key))
            with open(pending_path) as f:
                saved = json.load(f)
            saved["request_id"] = request_id
            with open(pending_path, "w") as f:
                json.dump(saved, f)
        chain = None
        for _ in range(self.max_polls):
            try:
                chain = self.doorman.retrieve(request_id)
            except RegistrationError:
                # the doorman no longer knows this id (e.g. it restarted
                # with in-memory state): discard the stale pending request
                # and start a fresh enrolment instead of being stuck forever
                os.remove(pending_path)
                return self.register()
            if chain is not None:
                break
            time.sleep(self.poll_interval_s)
        if chain is None:
            raise RegistrationError(
                f"certificate for {self.common_name!r} not signed after "
                f"{self.max_polls} polls (pending approval? re-run "
                f"register() to resume request {request_id})")
        node_pem, ca_pem = chain
        with open(key_path, "wb") as f:
            f.write(key.private_bytes(
                serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))
        with open(cert_path, "wb") as f:
            f.write(node_pem)
        with open(os.path.join(self.node_directory, "tls-ca.crt"),
                  "wb") as f:
            f.write(ca_pem)
        os.remove(pending_path)
        return cert_path, key_path
