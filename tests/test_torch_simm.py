"""The port's SIMM margin (kernel B10's device half) against the JAX
package's (corda_tpu.samples.simm_valuation), on the CPU.

Books are the reference's ``demo_portfolio`` and seeded books of up to
1024 trades (and two larger ones for the summation order). Cents are held
to within 2 cents of the JAX function's, the bound tests/test_simm.py holds
the JAX device to against numpy. The port's plain version rounds each
float32 operation in the order of the reference's compiled CPU program, so
its float32 margin is also checked bit for bit against the JAX function's.
The model's constants and the fixed-point codec must be exact.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from corda_tpu.samples import simm_valuation as jsimm
from corda_tpu_torch.samples import simm_valuation as tsimm

BOOKS = [(16, 7), (1, 3), (64, 1), (300, 11), (1024, 5)]


def exact_cents(book) -> float:
    """The margin of the float32 book computed in float64."""
    ws = (jsimm.RISK_WEIGHTS.astype(np.float64)
          * np.asarray(book, dtype=np.float64).sum(axis=0))
    return 100 * float(np.sqrt(ws @ jsimm.correlation_matrix().astype(
        np.float64) @ ws))


@pytest.fixture(scope="module")
def jax_margin():
    return jsimm._margin_fn()


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_model_constants_are_the_references():
    assert tsimm.TENORS == jsimm.TENORS
    assert tsimm.AGREEMENT_TOLERANCE_CENTS == jsimm.AGREEMENT_TOLERANCE_CENTS
    assert tsimm.RISK_WEIGHTS.dtype == np.float32
    assert np.array_equal(tsimm.RISK_WEIGHTS, jsimm.RISK_WEIGHTS)
    for theta in (0.03, 0.1, 0.0):
        got, want = (tsimm.correlation_matrix(theta),
                     jsimm.correlation_matrix(theta))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(16, 7), (1, 3), (300, 11), (1024, 5)])
def test_demo_portfolio_and_codec_are_exact(n, seed):
    got, want = tsimm.demo_portfolio(n, seed), jsimm.demo_portfolio(n, seed)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    q = tsimm.quantize(got)
    assert q.dtype == np.int64 and np.array_equal(q, jsimm.quantize(got))
    d = tsimm.dequantize(q)
    assert d.dtype == np.float32
    assert np.array_equal(d, jsimm.dequantize(q))


@pytest.mark.parametrize("n,seed", BOOKS)
def test_margin_cents_within_two_cents_of_jax(n, seed):
    book = tsimm.demo_portfolio(n, seed)
    got = tsimm.compute_margin_cents(book, device="cpu")
    want = jsimm.compute_margin_cents(book)
    assert isinstance(got, int) and got > 0
    assert abs(got - want) <= 2
    # and within two float32 ulps of the margin computed in float64
    ulp = float(np.spacing(np.float32(got / 100)))
    assert abs(got - exact_cents(book)) <= 2 * 100 * ulp + 0.5


@pytest.mark.parametrize("n,seed", BOOKS + [(4039, 62), (65536, 1)])
def test_plain_margin_is_the_jax_margin_bit_for_bit(jax_margin, n, seed):
    """The windowed trade sum, the fused multiply-adds of the quadratic
    form and the square root round as the reference's program does."""
    book = tsimm.demo_portfolio(n, seed)
    rw, corr = tsimm.model_tensors("cpu")
    got = tsimm.margin_plain(torch.from_numpy(book), rw, corr)
    want = np.asarray(jax_margin(book, jsimm.RISK_WEIGHTS,
                                 jsimm.correlation_matrix()))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


def test_fma32_rounds_once():
    """_fma32 is a·b + c rounded once to float32, on seeded values over
    seven decades."""
    rng = np.random.default_rng(0)
    a, b, c = ((rng.normal(size=2000) * 10.0 ** rng.integers(-3, 4, 2000)
                ).astype(np.float32) for _ in range(3))
    got = tsimm._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for g, x, y, z in zip(got, a, b, c):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.nextafter(g, np.float32(-np.inf))
        hi = np.nextafter(g, np.float32(np.inf))
        err = abs(Fraction(float(g)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)


def test_margin_of_the_wire_round_trip():
    """Both counterparties compute from the dequantized wire form."""
    wire = tsimm.quantize(tsimm.demo_portfolio())
    got = tsimm.compute_margin_cents(tsimm.dequantize(wire), device="cpu")
    want = jsimm.compute_margin_cents(jsimm.dequantize(wire))
    assert abs(got - want) <= 2


def test_demo_portfolio_margin_within_two_cents_of_jax():
    book = tsimm.demo_portfolio()
    got = tsimm.compute_margin_cents(book, device="cpu")
    assert abs(got - jsimm.compute_margin_cents(book)) <= 2


def test_offsetting_trades_net_the_margin_down():
    """tests/test_simm.py's subadditivity check: a book and its exact
    offset net to a margin no larger than the book's."""
    book = tsimm.demo_portfolio()
    got = tsimm.compute_margin_cents(book, device="cpu")
    offset = np.concatenate([book, -book])
    assert tsimm.compute_margin_cents(offset, device="cpu") <= got
    assert tsimm.compute_margin_cents(offset, device="cpu") == 0


def test_plain_margin_is_float32_and_matches_numpy():
    book = tsimm.demo_portfolio(64, 2)
    rw, corr = tsimm.model_tensors("cpu")
    out = tsimm.margin(torch.from_numpy(book), rw, corr)
    assert out.dtype == torch.float32 and out.shape == ()
    ws = tsimm.RISK_WEIGHTS * book.sum(axis=0)
    want = np.sqrt(ws @ tsimm.correlation_matrix() @ ws)
    assert abs(float(out) - float(want)) <= 1e-5 * float(want)


def test_margin_wrapper_never_falls_back_off_the_cpu():
    from corda_tpu_torch import _build
    meta = torch.empty((8, 12), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tsimm.margin(meta, meta[0], meta[:12])
    if _build.nvcc_path() is None:
        with pytest.raises(_build.BuildError):
            _build.build_all(["simm_margin"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsimm.compute_margin_cents(tsimm.demo_portfolio())
    assert tsimm.margin.launches == 0 or torch.cuda.is_available()
