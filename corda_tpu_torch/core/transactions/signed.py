"""SignaturesMissingException — copy of corda_tpu.core.transactions.signed's.

The verifier service raises it when a transaction's required signers are not
all covered. ``id`` is duck-typed (anything with ``prefix_chars()``), so the
service can check transactions built by either package."""
from __future__ import annotations

from ..crypto.signatures import SignatureException


class SignaturesMissingException(SignatureException):
    def __init__(self, missing, descriptions: list[str], id):
        super().__init__(f"Missing signatures for {descriptions} on transaction "
                         f"{id.prefix_chars()}")
        self.missing = missing
        self.id = id
