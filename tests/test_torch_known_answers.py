"""The known-answer batches that a freshly loaded B2 or B4 library must pass
before its first verdict (corda_tpu_torch/ops/known_answers.py), on the CPU:
the batches hold valid, tampered and precheck-failed items whose masked
verdicts equal the host oracle's, and the check passes a kernel equal to the
plain version and refuses one that differs on a single raw verdict. On the
card the same check runs against the built kernels (tests/test_torch_cuda.py).
"""
import pytest
import torch

torch.set_num_threads(2)

from corda_tpu_torch import _build  # noqa: E402
from corda_tpu_torch.core.crypto import ecmath  # noqa: E402
from corda_tpu_torch.ops import ed25519 as ed  # noqa: E402
from corda_tpu_torch.ops import known_answers as ka  # noqa: E402
from corda_tpu_torch.ops import weierstrass as wc  # noqa: E402

CPU = torch.device("cpu")


def test_ed25519_batch_masked_verdicts_equal_the_host_oracle():
    items = list(ka.ed25519_items())
    *wire, precheck = ed.prepare_batch_split(items)
    raw = ed.verify_core_split_plain(*ed.wire_to_device(*wire, device=CPU),
                                     *ed.split_tables(CPU)).numpy()
    want = [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()


def test_r1_batch_masked_verdicts_equal_the_host_oracle():
    curve = ecmath.SECP256R1
    items = list(ka.r1_items())
    *wire, precheck, forced = wc.prepare_batch_r1_split(curve, items)
    raw = wc.verify_core_r1_split_plain(*wc.wire_to_device(wire, CPU),
                                        *wc.r1_split_tables(CPU)).numpy()
    want = [pub is not None and ecmath.ecdsa_verify(curve, pub, msg, r, s)
            for pub, msg, r, s in items]
    assert list((raw & precheck) | forced) == want
    assert 0 < sum(want) < len(items) and not precheck.all()


def _memo_plain(plain):
    """A stand-in kernel: the plain version, computed once."""
    memo = []

    def run(args):
        if not memo:
            memo.append(plain(*args))
        return memo[0].clone()
    return run


@pytest.mark.parametrize("target", ["ed25519_split", "secp256r1_split"])
def test_check_passes_the_plain_version_and_refuses_one_wrong_verdict(
        target):
    if target == "ed25519_split":
        kernel = _memo_plain(ed.verify_core_split_plain)

        def check(flip_lanes):
            def launch(args, n, lanes):
                ok = kernel(args)
                if lanes == flip_lanes:
                    ok[n - 1] = ~ok[n - 1]
                return ok
            ka.check_ed25519_split(launch, CPU)
        wrong = [1, 2]
    else:
        kernel = _memo_plain(wc.verify_core_r1_split_plain)

        def check(flip_lanes):
            def launch(args, n):
                ok = kernel(args)
                if flip_lanes == 2:
                    ok[0] = ~ok[0]
                return ok
            ka.check_r1_split(launch, CPU)
        wrong = [2]
    check(None)
    for lanes in wrong:
        with pytest.raises(_build.BuildError,
                           match=f"{target}.*1 of .* known-answer rows"):
            check(lanes)
