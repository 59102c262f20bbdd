"""The known-answer batches that a freshly loaded B2, B3, B4, B5, B7 or B8
library must pass before its first verdict
(corda_tpu_torch/ops/known_answers.py), on the CPU: the batches hold valid,
tampered and precheck-failed items (and x(R) = r + n signatures for B3 and
B5, keys G and -G for B5 and B8) whose masked verdicts equal the host
oracle's, and the check passes a kernel equal to the plain version and
refuses one that differs on a single raw verdict. On the card the same
check runs against the built kernels (tests/test_torch_cuda.py).
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


def _ecdsa_oracle(curve, items):
    return [pub is not None and ecmath.ecdsa_verify(curve, pub, msg, r, s)
            for pub, msg, r, s in items]


def test_k1_batch_masked_verdicts_equal_the_host_oracle():
    """B3's batch: its x(R) = r + n rows carry rn_ok, and the valid one is
    accepted through the r + n candidate."""
    curve = ecmath.SECP256K1
    items = list(ka.k1_items())
    *wire, precheck = wc.prepare_batch_hybrid_wide(items)
    raw = wc.verify_core_hybrid_wide_plain(
        *wc.wire_to_device(wire, CPU), *wc.hybrid_tables(CPU)).numpy()
    want = _ecdsa_oracle(curve, items)
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()
    rn_ok = (wire[0][0] >> 18) & 1
    assert rn_ok[-2:].all() and want[-2:] == [True, False]
    assert all(r + curve.n < curve.p for _, _, r, _ in items[-2:])


@pytest.mark.parametrize("curve_name", ["secp256k1", "secp256r1"])
def test_shamir_batches_masked_verdicts_equal_the_host_oracle(curve_name):
    """B8's batches, one a curve, with valid signatures under the keys G
    (G + Q = 2G) and -G (G + Q = O)."""
    curve = wc.CURVES[curve_name]
    items = list(ka.k1_items() if curve_name == "secp256k1"
                 else ka.r1_items())
    *wire, precheck = wc.prepare_batch(curve, items)
    raw = wc.verify_core_plain(*wc.wire_to_device(wire, CPU),
                               curve_name).numpy()
    want = _ecdsa_oracle(curve, items)
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()
    keys = [pub for pub, *_ in items]
    assert curve.g in keys and curve.mul(curve.n - 1, curve.g) in keys


def test_ed25519_shamir_batch_masked_verdicts_equal_the_host_oracle():
    """B7 Shamir's known-answer batch through its own prep."""
    items = list(ka.ed25519_items())
    *wire, precheck = ed.prepare_batch(items)
    raw = ed.verify_core_plain(*ed.b7_to_device(wire, CPU)).numpy()
    want = [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()


@pytest.mark.parametrize("curve_name", ["secp256k1", "secp256r1"])
def test_windowed_batches_masked_verdicts_equal_the_host_oracle(curve_name):
    """B5's batches, one a curve, through the windowed prep: keys G and -G
    among them, and for secp256k1 the x(R) = r + n pair (rn_ok set), whose
    valid signature is accepted through the r + n candidate."""
    curve = wc.CURVES[curve_name]
    items = list(ka.k1_items() if curve_name == "secp256k1"
                 else ka.r1_items())
    *wire, precheck = wc.prepare_batch_windowed_single(curve, items)
    raw = wc.verify_core_windowed_single_plain(
        *wc.wire_to_device(wire, CPU), *wc.windowed_tables(curve, CPU),
        curve_name).numpy()
    want = _ecdsa_oracle(curve, items)
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()
    if curve_name == "secp256k1":
        assert wire[5][-2:].all() and want[-2:] == [True, False]


def _memo_plain(plain):
    """A stand-in kernel: the plain version, computed once for each first
    argument's shape."""
    memo = {}

    def run(args, *extra):
        key = tuple(args[0].shape) + extra
        if key not in memo:
            memo[key] = plain(*args, *extra)
        return memo[key].clone()
    return run


def _shamir_plain(*args):
    """B7 Shamir's plain version on the launcher's eight flat tensors."""
    return ed.verify_core_plain(args[0], args[1], args[2:6], args[6:8])


def _windowed_plain(*args):
    """B7 windowed's plain version on the launcher's eleven flat
    tensors."""
    return ed.verify_core_windowed_plain(args[0], args[1], args[2:6],
                                         *args[6:])


def test_glv_batch_masked_verdicts_equal_the_host_oracle():
    """B8 GLV's batch: the secp256k1 items through the GLV prep, the x(R) =
    r + n pair among them (the valid one accepted through r')."""
    curve = ecmath.SECP256K1
    items = list(ka.k1_items())
    *wire, precheck = wc.prepare_batch_glv(items)
    raw = wc.verify_core_glv_plain(*wc.wire_to_device(wire, CPU)).numpy()
    want = _ecdsa_oracle(curve, items)
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()
    assert want[-2:] == [True, False]


def test_ed25519_windowed_batch_masked_verdicts_equal_the_host_oracle():
    """B7 windowed's known-answer batch through its own prep."""
    items = list(ka.ed25519_items())
    *wire, precheck = ed.prepare_batch_windowed(items, device_tables=False)
    raw = ed.verify_core_windowed_plain(*ed.b7_to_device(wire, CPU),
                                        *ed.windowed_table(CPU)).numpy()
    want = [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert list(raw & precheck) == want
    assert 0 < sum(want) < len(items) and not precheck.all()


@pytest.mark.parametrize("target", ["ed25519_split", "secp256r1_split",
                                    "secp256k1_hybrid", "weierstrass_shamir",
                                    "ed25519_shamir", "weierstrass_windowed",
                                    "ed25519_windowed", "secp256k1_glv"])
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
    elif target == "secp256r1_split":
        kernel = _memo_plain(wc.verify_core_r1_split_plain)

        def check(flip_lanes):
            def launch(args, n):
                ok = kernel(args)
                if flip_lanes == 2:
                    ok[0] = ~ok[0]
                return ok
            ka.check_r1_split(launch, CPU)
        wrong = [2]
    elif target == "secp256k1_hybrid":
        kernel = _memo_plain(wc.verify_core_hybrid_wide_plain)

        def check(flip):
            def launch(args, n):
                ok = kernel(args)
                if flip:
                    ok[n - 2] = ~ok[n - 2]
                return ok
            ka.check_hybrid(launch, CPU)
        wrong = [True]
    elif target == "secp256k1_glv":
        kernel = _memo_plain(wc.verify_core_glv_plain)

        def check(flip):
            def launch(args, n):
                ok = kernel(args)
                if flip:
                    ok[n - 2] = ~ok[n - 2]
                return ok
            ka.check_glv(launch, CPU)
        wrong = [True]
    elif target in ("ed25519_shamir", "ed25519_windowed"):
        kernel = _memo_plain(_shamir_plain if target == "ed25519_shamir"
                             else _windowed_plain)
        held = (ka.check_ed25519_shamir if target == "ed25519_shamir"
                else ka.check_ed25519_windowed)

        def check(flip_lanes):
            def launch(args, n, lanes):
                ok = kernel(args)
                if lanes == flip_lanes:
                    ok[n // 2] = ~ok[n // 2]
                return ok
            held(launch, CPU)
        wrong = [1, 2]
    else:
        names = ("secp256k1", "secp256r1")
        if target == "weierstrass_shamir":
            kernel, held = _memo_plain(wc.verify_core_plain), ka.check_shamir
        else:
            kernel = _memo_plain(wc.verify_core_windowed_single_plain)
            held = ka.check_windowed

        def check(flip_curve):
            def launch(args, n, curve_id):
                ok = kernel(args, names[curve_id])
                if curve_id == flip_curve:
                    ok[n - 1] = ~ok[n - 1]
                return ok
            held(launch, CPU)
        wrong = [0, 1]
    check(None)
    for flip in wrong:
        with pytest.raises(_build.BuildError,
                           match=f"{target}.*1 of .* known-answer rows"):
            check(flip)
