"""Transaction verification/resolution exception taxonomy.

Reference parity: core/.../contracts/TransactionVerification.kt:100-128.
Every exception carries the offending transaction id so failures are attributable
across the async verifier boundary.
"""
from __future__ import annotations

from ..crypto.secure_hash import SecureHash


class FlowException(Exception):
    """Base for errors that propagate across flow sessions to the counterparty
    (reference: core/.../flows/FlowException.kt)."""


class TransactionVerificationException(FlowException):
    def __init__(self, tx_id: SecureHash, message: str):
        super().__init__(f"{message}, transaction: {tx_id}")
        self.tx_id = tx_id


class ContractRejection(TransactionVerificationException):
    def __init__(self, tx_id: SecureHash, contract, cause: Exception):
        super().__init__(tx_id, f"Contract verification failed: {cause}, contract: {contract}")
        self.contract = contract
        self.cause = cause


class MoreThanOneNotary(TransactionVerificationException):
    def __init__(self, tx_id: SecureHash):
        super().__init__(tx_id, "More than one notary")


class SignersMissing(TransactionVerificationException):
    def __init__(self, tx_id: SecureHash, missing: list):
        super().__init__(tx_id, f"Signers missing: {', '.join(str(m) for m in missing)}")
        self.missing = missing


class DuplicateInputStates(TransactionVerificationException):
    def __init__(self, tx_id: SecureHash, duplicates: set):
        super().__init__(tx_id, f"Duplicate inputs: {', '.join(str(d) for d in duplicates)}")
        self.duplicates = duplicates


class InvalidNotaryChange(TransactionVerificationException):
    def __init__(self, tx_id: SecureHash):
        super().__init__(tx_id, "Detected a notary change. Outputs must use the same notary as inputs")


class NotaryChangeInWrongTransactionType(TransactionVerificationException):
    def __init__(self, tx_id: SecureHash, tx_notary, output_notary):
        super().__init__(tx_id, f"Found unexpected notary change in transaction. "
                                f"Tx notary: {tx_notary}, found: {output_notary}")


class TransactionMissingEncumbranceException(TransactionVerificationException):
    INPUT = "input"
    OUTPUT = "output"

    def __init__(self, tx_id: SecureHash, missing: int, in_out: str):
        super().__init__(tx_id, f"Missing required encumbrance {missing} in {in_out}")


class TransactionResolutionException(FlowException):
    def __init__(self, hash_not_found: SecureHash):
        super().__init__(f"Transaction resolution failure for {hash_not_found}")
        self.hash = hash_not_found


class AttachmentResolutionException(FlowException):
    def __init__(self, hash_not_found: SecureHash):
        super().__init__(f"Attachment resolution failure for {hash_not_found}")
        self.hash = hash_not_found
