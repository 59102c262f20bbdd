"""The Ed25519 verify kernels' share of their roofline: the signatures the
card verified in the window times the least IMAD count of one Ed25519
verification, over the IMAD peak times the kernels' summed device time.
The batcher counts the signatures it checked on the card, not their
schemes, so the share is read only where the configuration's every key is
Ed25519."""
from harness.inputs import ED25519
from harness.yardsticks import (IMAD_PER_S, LEAST_IMAD_PER_SIG,
                                VERIFY_KERNELS)

KIND = "per_layer"
UNIT = "%"


def read(run):
    trace = run["device"]
    config = run["config"]
    schemes = set(config["owner_schemes"]) | {config["notary_scheme"]}
    if trace is None or schemes != {ED25519}:
        return None
    kernel_s = trace.seconds_of(VERIFY_KERNELS["ed25519"])
    sigs = run["readings"]["device_checked"]
    if kernel_s <= 0 or sigs <= 0:
        return None
    return 100.0 * sigs * LEAST_IMAD_PER_SIG["ed25519"] / (
        IMAD_PER_S * kernel_s)
