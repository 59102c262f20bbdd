"""Host prep of the device batches in the window: the
``verifier_prep_seconds`` histogram's total over the signatures the
device batches checked, in ms per thousand signatures."""
KIND = "per_layer"
UNIT = "ms/ksig"


def read(run):
    _, prep_s = run["readings"]["verifier_prep_seconds"]
    sigs = run["readings"]["device_checked"]
    return prep_s * 1e6 / sigs if sigs else None
