"""SIMM valuation: the device-computed portfolio margin (kernel B10).

Port of the device half of corda_tpu/samples/simm_valuation.py. Margin
model (SIMM delta-IR shape, simplified single-currency):

    WS = rw ⊙ Σ_trades s        risk-weighted net sensitivities, (T,)
    K  = sqrt(WSᵀ · C · WS)     correlated tenor aggregation

Sensitivities travel as integer centi-units (``quantize``/``dequantize``)
and the margin as integer cents, so both counterparties compute from the
same inputs and agree within ``AGREEMENT_TOLERANCE_CENTS``.

``margin`` is the kernel's wrapper: for CPU tensors it runs the plain
PyTorch version (``margin_plain``: float32, each operation rounded in the
order of the reference's program compiled for the CPU, so the two margins
agree bit for bit); for CUDA tensors it launches the hand-written kernel
``csrc/simm_margin.cu``, which rounds in the same order (built at first
use), or raises — it never falls back. ``margin.launches``
counts the launches. The reference's flows (``SimmRevaluationFlow``, its
handler and ``main``) need the flow framework, which the port does not have
yet.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from .. import _build
from ..device import resolve_device
from ..ops import _cuda as cu
from ..ops import field as F

TENORS = ("2w", "1m", "3m", "6m", "1y", "2y", "3y", "5y", "10y", "15y",
          "20y", "30y")
#: SIMM-style delta risk weights per tenor (bp of sensitivity).
RISK_WEIGHTS = np.array([113, 113, 98, 69, 56, 52, 51, 51, 51, 53, 56, 64],
                        dtype=np.float32)
AGREEMENT_TOLERANCE_CENTS = 100  # counterparties must agree within $1


def correlation_matrix(theta: float = 0.03) -> np.ndarray:
    """Inter-tenor correlation exp(−θ·|i − j|) (the SIMM sub-curve
    correlation shape), float32."""
    idx = np.arange(len(TENORS))
    return np.exp(-theta * np.abs(idx[:, None] - idx[None, :])
                  ).astype(np.float32)


def quantize(sens) -> np.ndarray:
    """Float sensitivities → wire-safe integer centi-units."""
    return np.rint(np.asarray(sens, dtype=np.float64) * 100).astype(np.int64)


def dequantize(q) -> np.ndarray:
    return (np.asarray(q, dtype=np.float64) / 100).astype(np.float32)


def demo_portfolio(n_trades: int = 16, seed: int = 7) -> np.ndarray:
    """Deterministic random swap book: per-trade tenor delta ladders."""
    rng = np.random.default_rng(seed)
    notionals = rng.integers(1, 50, size=n_trades)[:, None]
    ladder = rng.normal(0.0, 1.0, size=(n_trades, len(TENORS)))
    return (notionals * ladder).astype(np.float32)


# ---------------------------------------------------------------------------
# The margin: plain version and CUDA kernel wrapper
# ---------------------------------------------------------------------------

#: The width of the windows the trade sum is taken over (see _column_sums).
SUM_WINDOW = 32


def _column_sums(sens: torch.Tensor) -> torch.Tensor:
    """Σ over trades of ``sens`` (n, 12), float32, rounded in the order of
    the reference's compiled reduction: while more than 32 rows remain,
    the rows padded with zeros to a multiple of 32 (half the padding before
    them) are summed in windows of 32 in row order; then the rest in
    order."""
    x = sens
    while x.shape[0] > SUM_WINDOW:
        pad = -x.shape[0] % SUM_WINDOW
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = x.reshape(-1, SUM_WINDOW, x.shape[1])
        acc = torch.zeros_like(x[:, 0])
        for k in range(SUM_WINDOW):
            acc = acc + x[:, k]
        x = acc
    acc = torch.zeros(sens.shape[1], dtype=sens.dtype, device=sens.device)
    for row in x:
        acc = acc + row
    return acc


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c for float32 tensors, rounded once to float32 as a fused
    multiply-add rounds it, on any device: a·b is exact in float64, the
    float64 sum is rounded to odd (TwoSum gives its error), and rounding
    that to float32 is then the single rounding of the exact value."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def margin_plain(sens: torch.Tensor, rw: torch.Tensor,
                 corr: torch.Tensor) -> torch.Tensor:
    """sqrt((rw ⊙ Σ sens) · C · (rw ⊙ Σ sens)) in float32, on any device,
    every operation rounded as the reference's compiled program rounds it:
    the windowed trade sum, v = ws · C with one fused multiply-add a term
    (i ascending), and v · ws as eight one-term lanes summed in lane order
    with the last four terms fused on after them."""
    ws = rw * _column_sums(sens)
    v = torch.zeros_like(ws)
    for i in range(len(TENORS)):
        v = _fma32(ws[i], corr[i], v)
    q = torch.zeros((), dtype=ws.dtype, device=ws.device)
    for lane in v[:8] * ws[:8]:
        q = q + lane
    for c in range(8, len(TENORS)):
        q = _fma32(v[c], ws[c], q)
    # the float64 root of a float32 rounds to the float32 root (torch's own
    # float32 sqrt on the CPU can be an ulp off)
    return torch.sqrt(q.double()).float()


_LAUNCH_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def load_kernel():
    """The margin kernel's library, built from ``csrc/`` at first use.
    Raises :class:`BuildError` when it cannot be built."""
    lib = _build.load("simm_margin")
    lib.simm_margin.restype = ctypes.c_int
    lib.simm_margin.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_void_p]
    lib.simm_margin_scratch.restype = ctypes.c_int64
    lib.simm_margin_scratch.argtypes = [ctypes.c_int64]
    cu.bind_error_string(lib, "simm_margin")
    return lib


def margin_cuda(sens: torch.Tensor, rw: torch.Tensor,
                corr: torch.Tensor) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B10 (its passes) on the
    current stream of the arguments' device; returns the margin, a ()
    float32 tensor, without synchronising. Raises when the kernel does not
    build or the launch is refused."""
    t = len(TENORS)
    n = int(sens.shape[0])
    spec = (("sens", torch.float32, (n, t)), ("rw", torch.float32, (t,)),
            ("corr", torch.float32, (t, t)))
    cu.check_args(spec, (sens, rw, corr), sens.device)
    lib = load_kernel()
    scratch = torch.empty(lib.simm_margin_scratch(n), dtype=torch.float32,
                          device=sens.device)
    out = torch.empty((), dtype=torch.float32, device=sens.device)
    with torch.cuda.device(sens.device):
        stream = torch.cuda.current_stream(sens.device).cuda_stream
        rc = lib.simm_margin(sens.data_ptr(), rw.data_ptr(), corr.data_ptr(),
                             scratch.data_ptr(), out.data_ptr(), n, stream)
    cu.raise_on_error(lib, "simm_margin", rc, "simm_margin")
    with _LAUNCH_LOCK:
        margin.launches += 1
    return out


def margin(sens: torch.Tensor, rw: torch.Tensor,
           corr: torch.Tensor) -> torch.Tensor:
    """The margin of ``sens`` (n_trades, 12) float32 under risk weights
    ``rw`` (12,) and correlation ``corr`` (12, 12): a () float32 tensor.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if sens.device.type == "cpu":
        return margin_plain(sens, rw, corr)
    if sens.device.type == "cuda":
        return margin_cuda(sens, rw, corr)
    raise ValueError(f"unsupported device {sens.device}")


margin.launches = 0
margin.build_count = lambda: _build.build_count("simm_margin")


def model_tensors(device="cuda") -> tuple:
    """(RISK_WEIGHTS, correlation_matrix()) as float32 tensors cached on
    ``device``."""
    return F.device_table_cache(
        ("simm", "rw", "corr"),
        lambda: (RISK_WEIGHTS, correlation_matrix()), resolve_device(device))


def compute_margin_cents(sensitivities, device="cuda") -> int:
    """Portfolio delta sensitivities (n_trades, len(TENORS)) in dollars per
    bp → SIMM-style initial margin, integer cents, computed on ``device``
    (default the card; raises without CUDA)."""
    dev = resolve_device(device)
    sens = torch.from_numpy(np.ascontiguousarray(sensitivities,
                                                 dtype=np.float32))
    rw, corr = model_tensors(dev)
    out = margin(sens.to(dev), rw, corr)
    return int(round(float(out) * 100))
