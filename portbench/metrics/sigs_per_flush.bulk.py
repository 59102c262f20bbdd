"""Signatures a batcher flush carried in the window: the
``verifier_batch_size`` histogram's total over its count."""
KIND = "per_layer"
UNIT = "sigs"


def read(run):
    count, total = run["readings"]["verifier_batch_size"]
    return total / count if count else None
