"""Transaction-layer names the verifier service raises."""
from .signed import SignaturesMissingException

__all__ = ["SignaturesMissingException"]
