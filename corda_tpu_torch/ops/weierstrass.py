"""Batched ECDSA verification over secp256k1 and secp256r1 (kernels B3, B4,
B5 and B8).

Port of corda_tpu/ops/weierstrass.py: every verify mode of the reference,
with its host prep, constant-G tables and entry points. Host/device split:

- host: structural prechecks (r/s ranges with the low-s rule, on-curve
  keys), e/w/u1/u2, and per mode the scalar layout — bit planes (plain),
  GLV splits (glv, hybrid), windows (windowed) or the half-gcd split with
  the [v2]R comparand (halfgcd) — in native ``scalarmath``
  (``ops/scalarprep.py``) where the reference has a native prep, with
  bit-identical Python versions; and the affine constant-G tables, built
  once per process and cached per device;
- device: the ladders over projective (X:Y:Z) points with the complete
  formulas of Renes, Costello and Batina (EUROCRYPT 2016) and a projective
  accept X == x·Z.

The kernels:

- B3 ``verify_core_hybrid_wide`` (secp256k1): [a]G + [b]φ(G) + [c]Qc +
  [d]Qd over 128-bit GLV halves, G legs from a 2^18-row affine table, Q
  legs from a 16-entry per-item table; accept X == r·Z or, where r + n < p
  (``rn_ok``), X == (r + n)·Z.
- B4 ``verify_core_r1_split`` (secp256r1): [t_lo]G + [t_hi]G′ + [|v1|](±Q)
  with G′ = [2^128]G and every scalar below 2^128; accept X == x_D·Z with
  x_D = x([v2]R) from the host.
- B5 ``verify_core_windowed_single`` (both curves): [u1]G + [u2]Q, u1 in
  sixteen 16-bit windows over a 2^16-row affine G table, u2 in 4-bit
  windows over a 16-entry per-item {0..15}Q table; accept as B3.
- B8 ``verify_core`` (both curves): the 256-bit interleaved Shamir ladder
  over {O, G, Q, G + Q}; accept X == r·Z or X == r′·Z for the two host
  candidates r and r′ = r + n (where r + n < p, else r).
- B8 ``verify_core_glv`` (secp256k1): the 128-bit joint ladder over the
  16-entry subset sums of ±G, ±φ(G), ±Q, ±φ(Q); accept as B8.

Each kernel has three functions: ``*_plain`` (plain PyTorch, 16-bit limbs in
int64 lanes, any device), ``*_cuda`` (the hand-written Hopper kernel in
``csrc/``, built at first use, counted in ``<kernel>.launches``) and the
dispatcher, which runs the plain version for CPU tensors and the kernel for
CUDA tensors, never falling back. The plain formulas are the same RCB
algorithms as the kernels (the JAX kernels use column-fused variants of the
same mathematics): projective representatives may differ between the
packages, verdicts and affine points may not.

``verify_batch`` modes: ``auto`` (``hybrid`` for secp256k1, ``halfgcd`` for
secp256r1), ``hybrid``, ``halfgcd``, ``windowed``, ``plain`` and ``glv``.
"""
from __future__ import annotations

import functools
import hashlib
import threading
import time as _time

import numpy as np
import torch

from .. import _build
from ..core.crypto.ecmath import (SECP256K1, SECP256K1_BETA, SECP256R1,
                                  WeierstrassCurve, _bits2int, glv_decompose)
from ..device import resolve_device
from ..observability.profiling import get_profiler
from . import _cuda as cu
from . import field as F
from . import scalarprep as sp
from .staging import get_staging_pool

CURVES = {"secp256k1": SECP256K1, "secp256r1": SECP256R1}
#: The curve argument of the two-curve kernels' C launchers.
_CURVE_IDS = {"secp256k1": 0, "secp256r1": 1}

#: Constant-G window width of the secp256k1 hybrid kernel: the table has
#: 2^(2w+2) = 2^18 affine rows and 128 = 16 x 8 bits divide exactly
#: (128 doublings, 64 Q adds, 16 G adds).
HYBRID_G_WINDOW = 8
#: GLV halves are below 2^128 (Babai rounding bounds).
GLV_BITS = 128
#: Constant-G window width of the secp256r1 split kernel (two 2^16-row
#: tables, G and G′ = [2^128]G) and of the windowed kernel (one 2^16-row G
#: table a curve), and their per-item Q window (4-bit digits over the
#: 16-entry {0..15}Q table).
R1_G_WINDOW = 16
R1_Q_WINDOW = 4

#: The verify modes of ``verify_batch`` and the curves each accepts (None:
#: any curve with a = 0 or a = -3).
MODES = {"hybrid": "secp256k1", "glv": "secp256k1", "halfgcd": "secp256r1",
         "windowed": None, "plain": None}


# ---------------------------------------------------------------------------
# Helpers shared with ed25519.py
# ---------------------------------------------------------------------------

def select_tree(table, idx: torch.Tensor):
    """16-way batched point select over a 16-entry table of coordinate
    tuples: fold by index bit (LSB first) — a binary tree of 15 two-way
    selects per coordinate. ``idx``: (B,) integer tensor in [0, 16)."""
    level = list(table)
    for j in range(4):
        b = ((idx >> j) & 1).bool().unsqueeze(-1)
        level = [tuple(torch.where(b, hi_c, lo_c)
                       for lo_c, hi_c in zip(lo, hi))
                 for lo, hi in zip(level[0::2], level[1::2])]
    return level[0]


def _batch_modinv(values, n: int):
    """Montgomery's trick: invert many nonzero values mod prime n with ONE
    modpow + 3(B-1) modmuls."""
    if not values:
        return []
    prefix, acc = [], 1
    for v in values:
        acc = acc * v % n
        prefix.append(acc)
    inv = pow(acc, n - 2, n)
    out = [0] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = inv * prefix[i - 1] % n
        inv = inv * values[i] % n
    out[0] = inv
    return out


def _bits_to_windows(bits: np.ndarray) -> np.ndarray:
    """(nbits, B) MSB-first bit array → (nbits/2, B) 2-bit digits, MSB-first
    (a leading zero bit is prepended when nbits is odd)."""
    if bits.shape[0] % 2:
        bits = np.concatenate(
            [np.zeros((1,) + bits.shape[1:], bits.dtype), bits])
    return bits[0::2] * 2 + bits[1::2]


def _bits_to_w_windows(bits: np.ndarray, w: int) -> np.ndarray:
    """(nbits, B) MSB-first bits → (nbits//w, B) w-bit digits, MSB-first."""
    n_w = bits.shape[0] // w
    grouped = bits[: n_w * w].reshape(n_w, w, *bits.shape[1:])
    weights = (1 << np.arange(w - 1, -1, -1, dtype=np.uint32))
    return np.tensordot(weights, grouped.astype(np.uint32), axes=([0], [1]))


# ---------------------------------------------------------------------------
# Complete projective formulas (plain PyTorch, int64 limb tensors)
# ---------------------------------------------------------------------------

def identity(shape, device="cpu") -> tuple:
    """Projective identity (0 : 1 : 0)."""
    z = torch.zeros(tuple(shape) + (F.NLIMB,), dtype=torch.int64,
                    device=device)
    one = z.clone()
    one[..., 0] = 1
    return (z, one, z.clone())


def _add_k1(Pt, Qt, p: int, b3: int):
    """Complete addition for a = 0 (RCB16 Algorithm 7): 12 products and two
    small-constant multiplies by b3."""
    X1, Y1, Z1 = Pt
    X2, Y2, Z2 = Qt
    t0 = F.mul(X1, X2, p)
    t1 = F.mul(Y1, Y2, p)
    t2 = F.mul(Z1, Z2, p)
    t3 = F.sub(F.mul(F.add(X1, Y1, p), F.add(X2, Y2, p), p),
               F.add(t0, t1, p), p)
    t4 = F.sub(F.mul(F.add(Y1, Z1, p), F.add(Y2, Z2, p), p),
               F.add(t1, t2, p), p)
    y3 = F.sub(F.mul(F.add(X1, Z1, p), F.add(X2, Z2, p), p),
               F.add(t0, t2, p), p)
    return _k1_tail(p, b3, t0, t1, t2, t3, t4, y3)


def _k1_tail(p, b3, t0, t1, t2, t3, t4, y3):
    """Shared tail of the a = 0 addition and mixed addition (Algorithms 7
    and 8 from step 19 on)."""
    t0 = F.mul_const(t0, 3, p)
    t2 = F.mul_const(t2, b3, p)
    z3 = F.add(t1, t2, p)
    t1 = F.sub(t1, t2, p)
    y3 = F.mul_const(y3, b3, p)
    X3 = F.sub(F.mul(t3, t1, p), F.mul(t4, y3, p), p)
    Y3 = F.add(F.mul(t1, z3, p), F.mul(y3, t0, p), p)
    Z3 = F.add(F.mul(z3, t4, p), F.mul(t0, t3, p), p)
    return (X3, Y3, Z3)


def _madd_k1(Pt, Qa, p: int, b3: int):
    """Complete mixed addition (Z2 = 1) for a = 0 (RCB16 Algorithm 8): 11
    products. Complete for every projective P1; NOT valid for an identity
    addend — the constant-G table carries a validity flag and the ladder
    keeps the accumulator for flagged-identity rows."""
    X1, Y1, Z1 = Pt
    X2, Y2 = Qa
    t0 = F.mul(X1, X2, p)
    t1 = F.mul(Y1, Y2, p)
    t3 = F.sub(F.mul(F.add(X2, Y2, p), F.add(X1, Y1, p), p),
               F.add(t0, t1, p), p)
    t4 = F.add(F.mul(Y2, Z1, p), Y1, p)
    y3 = F.add(F.mul(X2, Z1, p), X1, p)
    return _k1_tail(p, b3, t0, t1, Z1, t3, t4, y3)


def _dbl_k1(Pt, p: int, b3: int):
    """Complete doubling for a = 0 (RCB16 Algorithm 9): 6 products and 2
    squarings; complete for every input including the identity."""
    X, Y, Z = Pt
    t0 = F.sqr(Y, p)
    z3 = F.mul_const(t0, 8, p)
    t1 = F.mul(Y, Z, p)
    t2 = F.mul_const(F.sqr(Z, p), b3, p)
    x3 = F.mul(t2, z3, p)
    y3 = F.add(t0, t2, p)
    Z3 = F.mul(t1, z3, p)
    t0 = F.sub(t0, F.mul_const(t2, 3, p), p)
    Y3 = F.add(x3, F.mul(t0, y3, p), p)
    X3 = F.mul_const(F.mul(t0, F.mul(X, Y, p), p), 2, p)
    return (X3, Y3, Z3)


def _m3_tail(p, bc, t0, t1, t2, t3, t4, y3):
    """Shared tail of the a = -3 addition and mixed addition (Algorithms 4
    and 5 from step 19 on): the b·x products take the full-width b."""
    x3 = F.sub(y3, F.mul(bc, t2, p), p)
    x3 = F.mul_const(x3, 3, p)
    z3 = F.sub(t1, x3, p)
    x3 = F.add(t1, x3, p)
    t2 = F.mul_const(t2, 3, p)
    y3 = F.sub(F.sub(F.mul(bc, y3, p), t2, p), t0, p)
    y3 = F.mul_const(y3, 3, p)
    t0 = F.sub(F.mul_const(t0, 3, p), t2, p)
    Y3 = F.add(F.mul(x3, z3, p), F.mul(t0, y3, p), p)
    X3 = F.sub(F.mul(t3, x3, p), F.mul(t4, y3, p), p)
    Z3 = F.add(F.mul(t4, z3, p), F.mul(t3, t0, p), p)
    return (X3, Y3, Z3)


def _add_m3(Pt, Qt, p: int, b: int):
    """Complete addition for a = -3, general b (RCB16 Algorithm 4): 12
    products and 2 by b."""
    X1, Y1, Z1 = Pt
    X2, Y2, Z2 = Qt
    bc = F.const(b, X1.device, p)
    t0 = F.mul(X1, X2, p)
    t1 = F.mul(Y1, Y2, p)
    t2 = F.mul(Z1, Z2, p)
    t3 = F.sub(F.mul(F.add(X1, Y1, p), F.add(X2, Y2, p), p),
               F.add(t0, t1, p), p)
    t4 = F.sub(F.mul(F.add(Y1, Z1, p), F.add(Y2, Z2, p), p),
               F.add(t1, t2, p), p)
    y3 = F.sub(F.mul(F.add(X1, Z1, p), F.add(X2, Z2, p), p),
               F.add(t0, t2, p), p)
    return _m3_tail(p, bc, t0, t1, t2, t3, t4, y3)


def _madd_m3(Pt, Qa, p: int, b: int):
    """Complete mixed addition (Z2 = 1) for a = -3 (RCB16 Algorithm 5): 11
    products and 2 by b; not valid for an identity addend."""
    X1, Y1, Z1 = Pt
    X2, Y2 = Qa
    bc = F.const(b, X1.device, p)
    t0 = F.mul(X1, X2, p)
    t1 = F.mul(Y1, Y2, p)
    t3 = F.sub(F.mul(F.add(X2, Y2, p), F.add(X1, Y1, p), p),
               F.add(t0, t1, p), p)
    t4 = F.add(F.mul(Y2, Z1, p), Y1, p)
    y3 = F.add(F.mul(X2, Z1, p), X1, p)
    return _m3_tail(p, bc, t0, t1, Z1, t3, t4, y3)


def _dbl_m3(Pt, p: int, b: int):
    """Complete doubling for a = -3, general b (RCB16 Algorithm 6): 8
    products, 2 by b and 3 squarings; complete for every input including
    the identity."""
    X, Y, Z = Pt
    bc = F.const(b, X.device, p)
    t0 = F.sqr(X, p)
    t1 = F.sqr(Y, p)
    t2 = F.sqr(Z, p)
    t3 = F.mul_const(F.mul(X, Y, p), 2, p)
    z3 = F.mul_const(F.mul(X, Z, p), 2, p)
    y3 = F.mul_const(F.sub(F.mul(bc, t2, p), z3, p), 3, p)
    x3 = F.sub(t1, y3, p)
    y3 = F.mul(x3, F.add(t1, y3, p), p)
    x3 = F.mul(x3, t3, p)
    t2 = F.mul_const(t2, 3, p)
    z3 = F.sub(F.sub(F.mul(bc, z3, p), t2, p), t0, p)
    z3 = F.mul_const(z3, 3, p)
    t0 = F.sub(F.mul_const(t0, 3, p), t2, p)
    Y3 = F.add(y3, F.mul(t0, z3, p), p)
    t0 = F.mul_const(F.mul(Y, Z, p), 2, p)
    X3 = F.sub(x3, F.mul(t0, z3, p), p)
    Z3 = F.mul_const(F.mul(t0, t1, p), 4, p)
    return (X3, Y3, Z3)


def _madd_w(Pt, Qa, curve: WeierstrassCurve):
    """Complete mixed (Z2 = 1) addition on ``curve`` (a = 0 or a = -3)."""
    p = curve.p
    if curve.a % p == 0:
        return _madd_k1(Pt, Qa, p, 3 * curve.b % p)
    if curve.a % p == p - 3:
        return _madd_m3(Pt, Qa, p, curve.b % p)
    raise NotImplementedError(f"curve {curve.name}: a must be 0 or -3")


def dbl(Pt, curve: WeierstrassCurve):
    """Complete projective doubling on ``curve`` (a = 0 or a = -3)."""
    p = curve.p
    if curve.a % p == 0:
        return _dbl_k1(Pt, p, 3 * curve.b % p)
    if curve.a % p == p - 3:
        return _dbl_m3(Pt, p, curve.b % p)
    raise NotImplementedError(f"curve {curve.name}: a must be 0 or -3")


def add(Pt, Qt, curve: WeierstrassCurve):
    """Complete projective addition on ``curve`` (a = 0 or a = -3)."""
    p = curve.p
    if curve.a % p == 0:
        return _add_k1(Pt, Qt, p, 3 * curve.b % p)
    if curve.a % p == p - 3:
        return _add_m3(Pt, Qt, p, curve.b % p)
    raise NotImplementedError(f"curve {curve.name}: a must be 0 or -3")


# ---------------------------------------------------------------------------
# Constant-G tables (host-built, cached per device)
# ---------------------------------------------------------------------------

_G_TABLES_WIDE: dict[tuple, tuple] = {}
_G_TABLES_1S: dict[tuple, tuple] = {}
_TABLES_LOCK = threading.Lock()


def _g_window_table_wide(curve: WeierstrassCurve, w: int):
    """AFFINE constant-G window table: u16 X/Y limb arrays of shape
    (2^(2w+2), 16) plus a u8 validity flag, indexed by
    ``wa + 2^w·wb + 2^(2w)·sa + 2^(2w+1)·sb``: entry = wa·(sa ? -G : G) +
    wb·(sb ? -φ(G) : φ(G)) for w-bit digits wa, wb. Identity entries
    (wa = wb = 0) carry flag 0. Every chord denominator is inverted with
    ONE modpow (Montgomery's trick); wa·G = ±wb·φ(G) is impossible for
    nonzero digits, so every chord add is generic — asserted. Byte-identical
    to the JAX package's table."""
    key = (curve.name, w)
    with _TABLES_LOCK:
        if key in _G_TABLES_WIDE:
            return _G_TABLES_WIDE[key]
        p, g = curve.p, curve.g
        phi = (SECP256K1_BETA * g[0] % p, g[1])
        span = 1 << w

        def multiples(base):
            out = [None] * span          # None = identity
            acc = None
            for i in range(1, span):
                acc = base if acc is None else curve.add(acc, base)
                out[i] = acc
            return out
        g_mult = multiples(g)
        phi_mult = multiples(phi)

        # one chord denominator per (wa, wb) pair, shared by both
        # relative-sign grids (x(-P) = x(P))
        dens = []
        for wb in range(1, span):
            xb = phi_mult[wb][0]
            for wa in range(1, span):
                d = (xb - g_mult[wa][0]) % p
                assert d != 0, "G/phi(G) multiples can never share an x"
                dens.append(d)
        invs = iter(_batch_modinv(dens, p))

        # grid_pp[wb][wa] = wa·G + wb·φ(G); grid_pm: wa·G - wb·φ(G)
        grid_pp = [[None] * span for _ in range(span)]
        grid_pm = [[None] * span for _ in range(span)]
        grid_pp[0] = list(g_mult)
        grid_pm[0] = list(g_mult)
        for wb in range(1, span):
            xb, yb = phi_mult[wb]
            grid_pp[wb][0] = (xb, yb)
            grid_pm[wb][0] = (xb, (p - yb) % p)
            for wa in range(1, span):
                xa, ya = g_mult[wa]
                inv = next(invs)
                for grid, y2 in ((grid_pp, yb), (grid_pm, p - yb)):
                    lam = (y2 - ya) * inv % p
                    x3 = (lam * lam - xa - xb) % p
                    grid[wb][wa] = (x3, (lam * (xa - x3) - ya) % p)

        xs, ys, flags = [], [], []
        for sb in (False, True):
            for sa in (False, True):
                # negate-both maps (+,+)↔(-,-) and (+,-)↔(-,+)
                grid, flip = ((grid_pp, sa) if sa == sb else (grid_pm, sa))
                for wb in range(span):
                    for wa in range(span):
                        pt = grid[wb][wa]
                        if pt is None:               # wa = wb = 0
                            xs.append(0)
                            ys.append(0)
                            flags.append(0)
                        else:
                            x, y = pt
                            xs.append(x)
                            ys.append((p - y) % p if flip and y else y)
                            flags.append(1)
        tab = (F.to_limbs(xs).astype(np.uint16),
               F.to_limbs(ys).astype(np.uint16),
               np.asarray(flags, dtype=np.uint8))
        _G_TABLES_WIDE[key] = tab
        return tab


def _g_window_table_single(curve: WeierstrassCurve, w: int, shift: int = 0):
    """Single-scalar constant-G window table (secp256r1): u16 affine X/Y
    arrays of shape (2^w, 16) plus a u8 validity flag (row 0 = identity).
    Entry wa = wa·B with B = [2^shift]G — shift 0 is the G table, shift 128
    the G′ table of the split ladder. Built as a Jacobian host chain landed
    affine by ONE Montgomery batch inversion; byte-identical to the JAX
    package's table."""
    key = (curve.name, w, shift)
    with _TABLES_LOCK:
        if key in _G_TABLES_1S:
            return _G_TABLES_1S[key]
        p = curve.p
        a = curve.a % p
        gx, gy = curve.mul(1 << shift, curve.g) if shift else curve.g
        span = 1 << w

        def jac_dbl(X1, Y1, Z1):
            """General-a Jacobian doubling (dbl-2007-bl), for 2·B."""
            A = X1 * X1 % p
            B = Y1 * Y1 % p
            C = B * B % p
            D = 2 * ((X1 + B) * (X1 + B) - A - C) % p
            E = (3 * A + a * pow(Z1, 4, p)) % p
            Fv = E * E % p
            X3 = (Fv - 2 * D) % p
            Y3 = (E * (D - X3) - 8 * C) % p
            Z3 = 2 * Y1 * Z1 % p
            return X3, Y3, Z3

        def jac_madd(X1, Y1, Z1):
            """(X1:Y1:Z1) Jacobian + B affine (madd-2007-bl); from 3·B on
            the chain never hits an exceptional case."""
            Z1Z1 = Z1 * Z1 % p
            U2 = gx * Z1Z1 % p
            S2 = gy * Z1 % p * Z1Z1 % p
            H = (U2 - X1) % p
            assert H != 0, "chain hit an exceptional mixed add"
            HH = H * H % p
            I = 4 * HH % p
            J = H * I % p
            r = 2 * (S2 - Y1) % p
            V = X1 * I % p
            X3 = (r * r - J - 2 * V) % p
            Y3 = (r * (V - X3) - 2 * Y1 * J) % p
            Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
            return X3, Y3, Z3

        chain = [None, (gx, gy, 1)]
        if span > 2:
            chain.append(jac_dbl(*chain[1]))
        for _ in range(3, span):
            chain.append(jac_madd(*chain[-1]))
        zinvs = iter(_batch_modinv([c[2] for c in chain[1:]], p))
        xs, ys, flags = [0], [0], [0]          # identity row
        for X, Y, Z in chain[1:]:
            zi = next(zinvs)
            zi2 = zi * zi % p
            xs.append(X * zi2 % p)
            ys.append(Y * zi2 % p * zi % p)
            flags.append(1)
        tab = (F.to_limbs(xs).astype(np.uint16),
               F.to_limbs(ys).astype(np.uint16),
               np.asarray(flags, dtype=np.uint8))
        _G_TABLES_1S[key] = tab
        return tab


def g_window_table_device(curve: WeierstrassCurve, w: int = HYBRID_G_WINDOW,
                          device="cuda") -> tuple:
    """The hybrid kernel's affine G table (x, y, ok) as tensors cached on
    ``device`` (built on the host once per process, copied once)."""
    return F.device_table_cache(("g_hybrid", curve.name, w),
                                lambda: _g_window_table_wide(curve, w),
                                resolve_device(device))


def g_window_table_single_device(curve: WeierstrassCurve,
                                 w: int = R1_G_WINDOW, shift: int = 0,
                                 device="cuda") -> tuple:
    """A single-scalar affine G table (x, y, ok) cached on ``device``."""
    return F.device_table_cache(
        ("g_single", curve.name, w, shift),
        lambda: _g_window_table_single(curve, w, shift),
        resolve_device(device))


def hybrid_tables(device="cuda") -> tuple:
    """The three table arguments of the secp256k1 hybrid kernel."""
    return g_window_table_device(SECP256K1, HYBRID_G_WINDOW, device)


def r1_split_tables(device="cuda") -> tuple:
    """The six table arguments of the secp256r1 split kernel: the G
    table's (x, y, ok), then G′ = [2^128]G's."""
    return (*g_window_table_single_device(SECP256R1, R1_G_WINDOW, 0, device),
            *g_window_table_single_device(SECP256R1, R1_G_WINDOW, 128,
                                          device))


def windowed_tables(curve: WeierstrassCurve, device="cuda") -> tuple:
    """The three table arguments of the windowed kernel: the 2^16-row
    single-scalar G table of ``curve`` (for secp256r1 the very tensors of
    the split kernel's G table, which has the same cache key)."""
    return g_window_table_single_device(curve, R1_G_WINDOW, 0, device)


def _check_tables(tabs, rows: int) -> list:
    tabs = [np.ascontiguousarray(t) for t in tabs]
    for k, t in enumerate(tabs):
        want = ((rows, F.NLIMB), np.uint16) if k % 3 < 2 else ((rows,),
                                                               np.uint8)
        if (t.shape, t.dtype) != want:
            raise ValueError(f"table {k}: expected {want[1].__name__} "
                             f"{want[0]}, got {t.dtype} {t.shape}")
    return tabs


def load_hybrid_tables_from_numpy(tabs, device="cuda") -> tuple:
    """Install the hybrid kernel's G table built elsewhere (three numpy
    arrays: x, y (2^18, 16) u16 and ok (2^18,) u8 — e.g. the JAX package's
    ``_g_window_table_wide(SECP256K1, 8)``) as this package's device-cached
    table, and return it as tensors."""
    tabs = _check_tables(tabs, 1 << (2 * HYBRID_G_WINDOW + 2))
    if len(tabs) != 3:
        raise ValueError("expected three arrays: x, y, ok")
    return F.install_device_tables(("g_hybrid", "secp256k1", HYBRID_G_WINDOW),
                                   tabs, resolve_device(device))


def load_r1_split_tables_from_numpy(tabs, device="cuda") -> tuple:
    """Install the split kernel's two G tables built elsewhere (six numpy
    arrays: G's x, y, ok, then G′'s — e.g. the JAX package's
    ``_g_window_table_single(SECP256R1, 16, 0) + (..., 128)``) and return
    them as tensors."""
    tabs = _check_tables(tabs, 1 << R1_G_WINDOW)
    if len(tabs) != 6:
        raise ValueError("expected six arrays: G's x, y, ok, then G′'s")
    dev = resolve_device(device)
    lo = F.install_device_tables(("g_single", "secp256r1", R1_G_WINDOW, 0),
                                 tabs[:3], dev)
    hi = F.install_device_tables(("g_single", "secp256r1", R1_G_WINDOW, 128),
                                 tabs[3:], dev)
    return (*lo, *hi)


def load_windowed_tables_from_numpy(tabs, device="cuda") -> dict:
    """Install windowed-kernel G tables built elsewhere: ``tabs`` maps a
    curve name to three numpy arrays x, y (2^16, 16) u16 and ok (2^16,) u8
    (e.g. the JAX package's ``_g_window_table_single(curve, 16)``). Returns
    {curve name: tensors}. The secp256r1 table is also the split kernel's
    G table."""
    dev = resolve_device(device)
    out = {}
    for name, arrs in tabs.items():
        if name not in CURVES:
            raise ValueError(f"unknown curve {name!r}")
        arrs = _check_tables(arrs, 1 << R1_G_WINDOW)
        if len(arrs) != 3:
            raise ValueError("expected three arrays: x, y, ok")
        out[name] = F.install_device_tables(
            ("g_single", name, R1_G_WINDOW, 0), arrs, dev)
    return out


# ---------------------------------------------------------------------------
# Per-item Q tables and the ladders (plain versions)
# ---------------------------------------------------------------------------

def _q_window_table(Qc, Qd, curve: WeierstrassCurve):
    """16-entry per-item table T[i + 4j] = [i]Qc + [j]Qd from affine Qc, Qd:
    2 doublings + 11 mixed adds."""
    one = F.one_like(Qc[0])
    T = [identity(Qc[0].shape[:-1], Qc[0].device)] * 16
    T[1] = (Qc[0], Qc[1], one)
    T[2] = dbl(T[1], curve)
    T[3] = _madd_w(T[2], Qc, curve)
    T[4] = (Qd[0], Qd[1], one)
    T[8] = dbl(T[4], curve)
    T[12] = _madd_w(T[8], Qd, curve)
    for j in (4, 8, 12):
        T[j + 1] = _madd_w(T[j], Qc, curve)
        T[j + 2] = _madd_w(T[j + 1], Qc, curve)
        T[j + 3] = _madd_w(T[j + 2], Qc, curve)
    return T


def _q_table_single(Q, curve: WeierstrassCurve):
    """16-entry per-item table T[i] = [i]Q from affine Q: 7 doublings + 7
    mixed adds."""
    one = F.one_like(Q[0])
    T = [identity(Q[0].shape[:-1], Q[0].device)] * 16
    T[1] = (Q[0], Q[1], one)
    for i in range(2, 16):
        T[i] = (dbl(T[i // 2], curve) if i % 2 == 0
                else _madd_w(T[i - 1], Q, curve))
    return T


def _g_add(acc, gi, tab, curve: WeierstrassCurve):
    """Gather the affine G addend of row ``gi`` and mixed-add it; identity
    rows (flag 0) keep the accumulator. ``tab``: int64 (x, y, ok) copies
    (CUDA indexing has no uint16 kernel)."""
    tab_x, tab_y, tab_ok = tab
    added = _madd_w(acc, (tab_x[gi], tab_y[gi]), curve)
    ok = tab_ok[gi].bool().unsqueeze(-1)
    return tuple(torch.where(ok, n, a) for n, a in zip(added, acc))


def hybrid_ladder_wide(g_idx, q_bits, Qc, Qd, gtab,
                       curve: WeierstrassCurve = SECP256K1):
    """Per outer step: 4 × (2 doublings + 1 Q add from the joint table),
    then ONE mixed G add gathered from the affine table. The first step is
    peeled: the accumulator starts at its first Q addend. ``g_idx``
    (16, B) int64 (masked), ``q_bits`` (16, 4, B) int64, ``gtab`` int64
    (x, y, ok)."""
    table = _q_window_table(Qc, Qd, curve)
    acc = None
    for s in range(g_idx.shape[0]):
        for k in range(q_bits.shape[1]):
            addend = select_tree(table, q_bits[s, k])
            if acc is None:
                acc = addend
            else:
                acc = add(dbl(dbl(acc, curve), curve), addend, curve)
        acc = _g_add(acc, g_idx[s], gtab, curve)
    return acc


def r1_split_ladder(g_idx, q_digits, Q, gtab_lo, gtab_hi,
                    curve: WeierstrassCurve = SECP256R1):
    """W2 = [t_lo]G + [t_hi]G′ + [|v1|](±Q): per outer step, 4 × (4
    doublings + 1 Q add), then the G′ add (t_hi window) and the G add
    (t_lo window). The first step is peeled. ``g_idx`` (8, 2, B) int64,
    ``q_digits`` (8, 4, B) int64, tables int64."""
    table = _q_table_single(Q, curve)
    acc = None
    for s in range(g_idx.shape[0]):
        for k in range(q_digits.shape[1]):
            addend = select_tree(table, q_digits[s, k])
            if acc is None:
                acc = addend
            else:
                for _ in range(4):
                    acc = dbl(acc, curve)
                acc = add(acc, addend, curve)
        acc = _g_add(acc, g_idx[s, 0], gtab_hi, curve)
        acc = _g_add(acc, g_idx[s, 1], gtab_lo, curve)
    return acc


def _accept_rn(X, Z, r, rn_ok, p: int, n: int):
    """ECDSA accept on the projective result: Z ≠ 0 and X ≡ r·Z or, where
    ``rn_ok`` (r + n < p), X ≡ (r + n)·Z; X is canonicalised once."""
    nonzero = ~F.is_zero(Z, p)
    rn = F.add(r, F.const(n, r.device, p).expand_as(r), p)
    cx = F.canon(X, p)
    ok_r = ((cx == F.canon(F.mul(r, Z, p), p)).all(dim=-1)
            | (rn_ok & (cx == F.canon(F.mul(rn, Z, p), p)).all(dim=-1)))
    return nonzero & ok_r


def _select4(idx, points):
    """4-way batched point select: ``idx`` (B,) in [0, 4) over four
    projective triples (idx values outside pick the first)."""
    c = (idx == 3, idx == 2, idx == 1)
    return tuple(torch.where(c[0].unsqueeze(-1), c3, torch.where(
        c[1].unsqueeze(-1), c2, torch.where(c[2].unsqueeze(-1), c1, c0)))
        for c0, c1, c2, c3 in zip(*points))


def shamir_ladder(bits1, bits2, P1, P2, curve: WeierstrassCurve):
    """[k1]P1 + [k2]P2: the interleaved double-and-add over complete
    additions, 256 steps of one doubling and one addition of a selected
    {O, P1, P2, P1 + P2}. ``bits1``, ``bits2``: (nbits, B) int64, MSB
    first."""
    P3 = add(P1, P2, curve)
    Pid = identity(P1[0].shape[:-1], P1[0].device)
    acc = Pid
    for b1, b2 in zip(bits1, bits2):
        acc = add(dbl(acc, curve), _select4(b1 + 2 * b2, (Pid, P1, P2, P3)),
                  curve)
    return acc


def glv_ladder(bits4, pts4, curve: WeierstrassCurve):
    """[a]P0 + [b]P1 + [c]P2 + [d]P3 over the (nbits, B, 4) MSB-first bit
    planes ``bits4``: the 16-entry subset-sum table (11 complete adds), then
    one doubling and one addition of the selected subset sum a bit."""
    Pid = identity(pts4[0][0].shape[:-1], pts4[0][0].device)
    table = [Pid] * 16
    for t in range(1, 16):
        low = t & -t                      # lowest set bit
        rest = t ^ low
        pt = pts4[low.bit_length() - 1]
        table[t] = pt if rest == 0 else add(table[rest], pt, curve)
    acc = Pid
    for bits in bits4:
        idx = sum((bits[:, j] != 0).to(torch.int64) << j for j in range(4))
        acc = add(dbl(acc, curve), select_tree(table, idx), curve)
    return acc


def windowed_ladder_single(g_idx, q_digits, Q, gtab,
                           curve: WeierstrassCurve):
    """[u1]G + [u2]Q: per outer step, 4 × (4 doublings + 1 Q add from the
    16-entry {0..15}Q table), then ONE mixed G add gathered from the
    2^16-row affine table (flag-0 rows keep the accumulator). The first
    step is peeled: the accumulator starts at its first Q addend.
    ``g_idx`` (16, B) int64 (masked), ``q_digits`` (16, 4, B) int64,
    ``gtab`` int64 (x, y, ok)."""
    table = _q_table_single(Q, curve)
    acc = None
    for s in range(g_idx.shape[0]):
        for k in range(q_digits.shape[1]):
            addend = select_tree(table, q_digits[s, k])
            if acc is None:
                acc = addend
            else:
                for _ in range(4):
                    acc = dbl(acc, curve)
                acc = add(acc, addend, curve)
        acc = _g_add(acc, g_idx[s], gtab, curve)
    return acc


def _accept(X, Z, r_cands, p: int):
    """ECDSA accept on the projective result with two host candidates:
    Z ≠ 0 and X ≡ r_cands[0]·Z or X ≡ r_cands[1]·Z."""
    cx = F.canon(X, p)
    ok = ((cx == F.canon(F.mul(r_cands[0], Z, p), p)).all(dim=-1)
          | (cx == F.canon(F.mul(r_cands[1], Z, p), p)).all(dim=-1))
    return ~F.is_zero(Z, p) & ok


def _int64(*ts):
    return tuple(t.to(torch.int64) for t in ts)


# ---------------------------------------------------------------------------
# Kernel B3: secp256k1 hybrid-GLV verify
# ---------------------------------------------------------------------------

def verify_core_hybrid_wide_plain(g_idx, q_bits, pts, r_limbs,
                                  tab_x, tab_y, tab_ok) -> torch.Tensor:
    """Plain PyTorch version of the hybrid verifier (same wire form and
    ladder as the CUDA kernel and the JAX kernel), on any device."""
    g_idx, q_bits, pts, r = _int64(g_idx, q_bits, pts, r_limbs)
    rn_ok = ((g_idx[0] >> 18) & 1).bool()
    g_idx = g_idx & ((1 << (2 * HYBRID_G_WINDOW + 2)) - 1)
    X, _, Z = hybrid_ladder_wide(g_idx, q_bits, (pts[:, 0], pts[:, 1]),
                                 (pts[:, 2], pts[:, 3]),
                                 _int64(tab_x, tab_y, tab_ok))
    return _accept_rn(X, Z, r, rn_ok, SECP256K1.p, SECP256K1.n)


_LAUNCH_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def load_hybrid_kernel():
    """The hybrid kernel's library, built from ``csrc/`` at first use and
    held against the plain version on known answers on the current CUDA
    device (:mod:`.known_answers`). Raises :class:`BuildError` when it
    cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("secp256k1_hybrid", 7)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_hybrid(
        lambda args, n: cu.launch_verify(lib, "secp256k1_hybrid_verify",
                                         args, n, device), device)
    return lib


def verify_core_hybrid_wide_cuda(g_idx, q_bits, pts, r_limbs,
                                 tab_x, tab_y, tab_ok) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B3; returns ok (B,) bool
    without synchronising. Raises when the kernel does not build or the
    launch is refused."""
    n = int(g_idx.shape[-1])
    rows = 1 << (2 * HYBRID_G_WINDOW + 2)
    spec = (("g_idx", torch.int32, (16, n)),
            ("q_bits", torch.uint8, (16, 4, n)),
            ("pts", torch.uint16, (n, 4, F.NLIMB)),
            ("r_limbs", torch.uint16, (n, F.NLIMB)),
            ("tab_x", torch.uint16, (rows, F.NLIMB)),
            ("tab_y", torch.uint16, (rows, F.NLIMB)),
            ("tab_ok", torch.uint8, (rows,)))
    args = (g_idx, q_bits, pts, r_limbs, tab_x, tab_y, tab_ok)
    cu.check_args(spec, args, g_idx.device)
    ok = cu.launch_verify(load_hybrid_kernel(), "secp256k1_hybrid_verify",
                          args, n, g_idx.device)
    with _LAUNCH_LOCK:
        verify_core_hybrid_wide.launches += 1
    return ok


def verify_core_hybrid_wide(g_idx, q_bits, pts, r_limbs, tab_x, tab_y,
                            tab_ok, g_w: int = HYBRID_G_WINDOW
                            ) -> torch.Tensor:
    """secp256k1 hybrid verify over the consolidated wire form: ``g_idx``
    (16, B) i32 (18-bit indices, ``rn_ok`` at bit 18 of row 0); ``q_bits``
    (16, 4, B) u8 joint digits wc | wd << 2; ``pts`` (B, 4, 16) u16 =
    (Qc x, Qc y, Qd x, Qd y); ``r_limbs`` (B, 16) u16; the G table
    (2^18, 16) u16 x, y and (2^18,) u8 ok. Returns ok (B,) bool.
    ``g_w``: the JAX function's G window, HYBRID_G_WINDOW only.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    cu.require_fixed("g_w", g_w, HYBRID_G_WINDOW)
    args = (g_idx, q_bits, pts, r_limbs, tab_x, tab_y, tab_ok)
    if g_idx.device.type == "cpu":
        return verify_core_hybrid_wide_plain(*args)
    if g_idx.device.type == "cuda":
        return verify_core_hybrid_wide_cuda(*args)
    raise ValueError(f"unsupported device {g_idx.device}")


#: Kernel launches through the wrapper (the CPU path launches nothing).
verify_core_hybrid_wide.launches = 0
verify_core_hybrid_wide.build_count = lambda: _build.build_count(
    "secp256k1_hybrid")


# ---------------------------------------------------------------------------
# Kernel B4: secp256r1 half-gcd split verify
# ---------------------------------------------------------------------------

def verify_core_r1_split_plain(g_idx, q_digits, q_x, q_y, xd_limbs,
                               lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok
                               ) -> torch.Tensor:
    """Plain PyTorch version of the split verifier, on any device: W2 ≠ ∞
    and x(W2) == x_D, checked projectively (X == x_D·Z)."""
    g_idx, q_digits, q_x, q_y, xd = _int64(g_idx, q_digits, q_x, q_y,
                                           xd_limbs)
    X, _, Z = r1_split_ladder(g_idx & 0xFFFF, q_digits, (q_x, q_y),
                              _int64(lo_x, lo_y, lo_ok),
                              _int64(hi_x, hi_y, hi_ok))
    p = SECP256R1.p
    same = (F.canon(X, p) == F.canon(F.mul(xd, Z, p), p)).all(dim=-1)
    return ~F.is_zero(Z, p) & same


@functools.lru_cache(maxsize=1)
def load_r1_split_kernel():
    """The split kernel's library, built from ``csrc/`` at first use and
    held against the plain version on known answers on the current CUDA
    device (:mod:`.known_answers`). Raises :class:`BuildError` when it
    cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("secp256r1_split", 11)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_r1_split(
        lambda args, n: cu.launch_verify(lib, "secp256r1_split_verify", args,
                                         n, device), device)
    return lib


def verify_core_r1_split_cuda(g_idx, q_digits, q_x, q_y, xd_limbs,
                              lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok
                              ) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B4; returns ok (B,) bool
    without synchronising. Raises when the kernel does not build or the
    launch is refused."""
    n = int(g_idx.shape[-1])
    rows = 1 << R1_G_WINDOW
    limbs = (n, F.NLIMB)
    spec = (("g_idx", torch.int32, (8, 2, n)),
            ("q_digits", torch.uint8, (8, 4, n)),
            ("q_x", torch.uint16, limbs), ("q_y", torch.uint16, limbs),
            ("xd_limbs", torch.uint16, limbs),
            *((name, dt, shape) for half in ("lo", "hi")
              for name, dt, shape in (
                  (f"{half}_x", torch.uint16, (rows, F.NLIMB)),
                  (f"{half}_y", torch.uint16, (rows, F.NLIMB)),
                  (f"{half}_ok", torch.uint8, (rows,)))))
    args = (g_idx, q_digits, q_x, q_y, xd_limbs,
            lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok)
    cu.check_args(spec, args, g_idx.device)
    ok = cu.launch_verify(load_r1_split_kernel(), "secp256r1_split_verify",
                          args, n, g_idx.device)
    with _LAUNCH_LOCK:
        verify_core_r1_split.launches += 1
    return ok


def verify_core_r1_split(g_idx, q_digits, q_x, q_y, xd_limbs,
                         lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok,
                         curve_name: str = "secp256r1",
                         w: int = R1_G_WINDOW) -> torch.Tensor:
    """secp256r1 split verify: ``g_idx`` (8, 2, B) i32 ([:, 0] t_hi
    windows for the G′ table, [:, 1] t_lo windows for the G table);
    ``q_digits`` (8, 4, B) u8; ``q_x``, ``q_y`` (B, 16) u16 (y
    sign-adjusted); ``xd_limbs`` (B, 16) u16 = x([v2]R); the G and G′
    tables (2^16, 16) u16 x, y and (2^16,) u8 ok. The JAX function's ``Q``
    pair is passed as ``q_x, q_y``. Returns ok (B,) bool. ``curve_name``
    and ``w``: the JAX function's static arguments, "secp256r1" and
    R1_G_WINDOW only.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    cu.require_fixed("curve_name", curve_name, "secp256r1")
    cu.require_fixed("w", w, R1_G_WINDOW)
    args = (g_idx, q_digits, q_x, q_y, xd_limbs,
            lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok)
    if g_idx.device.type == "cpu":
        return verify_core_r1_split_plain(*args)
    if g_idx.device.type == "cuda":
        return verify_core_r1_split_cuda(*args)
    raise ValueError(f"unsupported device {g_idx.device}")


verify_core_r1_split.launches = 0
verify_core_r1_split.build_count = lambda: _build.build_count(
    "secp256r1_split")


def _curve_of(curve_name: str) -> WeierstrassCurve:
    curve = CURVES.get(curve_name)
    if curve is None:
        raise ValueError(f"unknown curve {curve_name!r}: the kernels take "
                         f"{sorted(CURVES)}")
    return curve


# ---------------------------------------------------------------------------
# Kernel B8: the Shamir ladder (plain mode)
# ---------------------------------------------------------------------------

def verify_core_plain(u1_bits, u2_bits, q_pts, r_cands,
                      curve_name: str) -> torch.Tensor:
    """Plain PyTorch version of the Shamir verifier, on any device:
    X = [u1]G + [u2]Q ≠ ∞ and x(X) ∈ {r_cands[0], r_cands[1]}, checked
    projectively."""
    curve = _curve_of(curve_name)
    u1, u2, q, rc = _int64(u1_bits, u2_bits, q_pts, r_cands)
    base = tuple(F.const(v, q.device, curve.p).expand_as(q[0])
                 for v in (curve.gx, curve.gy, 1))
    X, _, Z = shamir_ladder(u1, u2, base, (q[0], q[1], q[2]), curve)
    return _accept(X, Z, rc, curve.p)


@functools.lru_cache(maxsize=1)
def load_shamir_kernel():
    """The Shamir kernel's library (both curves), built from ``csrc/`` at
    first use and held against the plain version on known answers on the
    current CUDA device (:mod:`.known_answers`). Raises
    :class:`BuildError` when it cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("weierstrass_shamir", 4, with_int=True)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_shamir(
        lambda args, n, curve_id: cu.launch_verify(
            lib, "weierstrass_shamir_verify", args, n, device, curve_id),
        device)
    return lib


def verify_core_cuda(u1_bits, u2_bits, q_pts, r_cands,
                     curve_name: str) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B8 (Shamir); returns ok (B,)
    bool without synchronising. Raises when the kernel does not build or
    the launch is refused."""
    _curve_of(curve_name)
    n = int(q_pts.shape[1])
    spec = (("u1_bits", torch.uint8, (256, n)),
            ("u2_bits", torch.uint8, (256, n)),
            ("q_pts", torch.uint16, (3, n, F.NLIMB)),
            ("r_cands", torch.uint16, (2, n, F.NLIMB)))
    args = (u1_bits, u2_bits, q_pts, r_cands)
    cu.check_args(spec, args, q_pts.device)
    ok = cu.launch_verify(load_shamir_kernel(), "weierstrass_shamir_verify",
                          args, n, q_pts.device, _CURVE_IDS[curve_name])
    with _LAUNCH_LOCK:
        verify_core.launches += 1
    return ok


def verify_core(u1_bits, u2_bits, q_pts, r_cands,
                curve_name: str) -> torch.Tensor:
    """secp256k1/secp256r1 Shamir verify: ``u1_bits``, ``u2_bits`` (256, B)
    u8 MSB-first bit planes; ``q_pts`` (3, B, 16) u16 = Q's projective
    (X, Y, Z) (the JAX function's ``q_pts`` triple, stacked); ``r_cands``
    (2, B, 16) u16 = r and r + n (or r again). Returns ok (B,) bool.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    args = (u1_bits, u2_bits, q_pts, r_cands, curve_name)
    if q_pts.device.type == "cpu":
        return verify_core_plain(*args)
    if q_pts.device.type == "cuda":
        return verify_core_cuda(*args)
    raise ValueError(f"unsupported device {q_pts.device}")


verify_core.launches = 0
verify_core.build_count = lambda: _build.build_count("weierstrass_shamir")


# ---------------------------------------------------------------------------
# Kernel B8: the GLV joint ladder (glv mode, secp256k1)
# ---------------------------------------------------------------------------

def verify_core_glv_plain(bits4, pts4, r_cands) -> torch.Tensor:
    """Plain PyTorch version of the GLV verifier, on any device:
    [a]P0 + [b]P1 + [c]P2 + [d]P3 ≠ ∞ with x in the two candidates."""
    curve = SECP256K1
    bits4, pts4, rc = _int64(bits4, pts4, r_cands)
    X, _, Z = glv_ladder(bits4, [tuple(pt) for pt in pts4], curve)
    return _accept(X, Z, rc, curve.p)


@functools.lru_cache(maxsize=1)
def load_glv_kernel():
    """The GLV kernel's library, built from ``csrc/`` at first use and held
    against the plain version on known answers on the current CUDA device
    (:mod:`.known_answers`). Raises :class:`BuildError` when it cannot be
    built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("secp256k1_glv", 3)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_glv(
        lambda args, n: cu.launch_verify(lib, "secp256k1_glv_verify", args,
                                         n, device), device)
    return lib


def verify_core_glv_cuda(bits4, pts4, r_cands) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B8 (GLV); returns ok (B,) bool
    without synchronising. Raises when the kernel does not build or the
    launch is refused."""
    n = int(pts4.shape[2])
    spec = (("bits4", torch.uint8, (GLV_BITS, n, 4)),
            ("pts4", torch.uint16, (4, 3, n, F.NLIMB)),
            ("r_cands", torch.uint16, (2, n, F.NLIMB)))
    args = (bits4, pts4, r_cands)
    cu.check_args(spec, args, pts4.device)
    ok = cu.launch_verify(load_glv_kernel(), "secp256k1_glv_verify", args,
                          n, pts4.device)
    with _LAUNCH_LOCK:
        verify_core_glv.launches += 1
    return ok


def verify_core_glv(bits4, pts4, r_cands) -> torch.Tensor:
    """secp256k1 GLV verify: ``bits4`` (128, B, 4) u8 MSB-first bit planes
    of |a|, |b|, |c|, |d|; ``pts4`` (4, 3, B, 16) u16 = the sign-adjusted
    G, φ(G), Q, φ(Q) in projective (X, Y, Z) (the JAX function's ``pts4``,
    stacked); ``r_cands`` (2, B, 16) u16. Returns ok (B,) bool.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    args = (bits4, pts4, r_cands)
    if pts4.device.type == "cpu":
        return verify_core_glv_plain(*args)
    if pts4.device.type == "cuda":
        return verify_core_glv_cuda(*args)
    raise ValueError(f"unsupported device {pts4.device}")


verify_core_glv.launches = 0
verify_core_glv.build_count = lambda: _build.build_count("secp256k1_glv")


# ---------------------------------------------------------------------------
# Kernel B5: the single-scalar windowed ladder (windowed mode)
# ---------------------------------------------------------------------------

def verify_core_windowed_single_plain(g_idx, q_digits, q_x, q_y, r_limbs,
                                      rn_ok, tab_x, tab_y, tab_ok,
                                      curve_name: str) -> torch.Tensor:
    """Plain PyTorch version of the windowed verifier, on any device."""
    curve = _curve_of(curve_name)
    g_idx, q_digits, q_x, q_y, r = _int64(g_idx, q_digits, q_x, q_y,
                                          r_limbs)
    X, _, Z = windowed_ladder_single(g_idx & 0xFFFF, q_digits,
                                     (q_x, q_y), _int64(tab_x, tab_y, tab_ok),
                                     curve)
    return _accept_rn(X, Z, r, rn_ok.bool(), curve.p, curve.n)


@functools.lru_cache(maxsize=1)
def load_windowed_kernel():
    """The windowed kernel's library (both curves), built from ``csrc/`` at
    first use and held against the plain version on known answers on the
    current CUDA device (:mod:`.known_answers`). Raises
    :class:`BuildError` when it cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("weierstrass_windowed", 9, with_int=True)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_windowed(
        lambda args, n, curve_id: cu.launch_verify(
            lib, "weierstrass_windowed_verify", args, n, device, curve_id),
        device)
    return lib


def verify_core_windowed_single_cuda(g_idx, q_digits, q_x, q_y, r_limbs,
                                     rn_ok, tab_x, tab_y, tab_ok,
                                     curve_name: str) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B5 (w = 16); returns ok (B,)
    bool without synchronising. Raises when the kernel does not build or
    the launch is refused."""
    _curve_of(curve_name)
    n = int(g_idx.shape[-1])
    rows = 1 << R1_G_WINDOW
    limbs = (n, F.NLIMB)
    spec = (("g_idx", torch.int32, (256 // R1_G_WINDOW, n)),
            ("q_digits", torch.uint8, (256 // R1_G_WINDOW,
                                       R1_G_WINDOW // R1_Q_WINDOW, n)),
            ("q_x", torch.uint16, limbs), ("q_y", torch.uint16, limbs),
            ("r_limbs", torch.uint16, limbs),
            ("rn_ok", torch.uint8, (n,)),
            ("tab_x", torch.uint16, (rows, F.NLIMB)),
            ("tab_y", torch.uint16, (rows, F.NLIMB)),
            ("tab_ok", torch.uint8, (rows,)))
    args = (g_idx, q_digits, q_x, q_y, r_limbs, rn_ok, tab_x, tab_y, tab_ok)
    cu.check_args(spec, args, g_idx.device)
    ok = cu.launch_verify(load_windowed_kernel(),
                          "weierstrass_windowed_verify", args, n,
                          g_idx.device, _CURVE_IDS[curve_name])
    with _LAUNCH_LOCK:
        verify_core_windowed_single.launches += 1
    return ok


def verify_core_windowed_single(g_idx, q_digits, q_x, q_y, r_limbs, rn_ok,
                                tab_x, tab_y, tab_ok, curve_name: str,
                                w: int = R1_G_WINDOW) -> torch.Tensor:
    """secp256k1/secp256r1 windowed verify: ``g_idx`` (16, B) i32 16-bit
    windows of u1; ``q_digits`` (16, 4, B) u8 4-bit windows of u2, both MSB
    first; ``q_x``, ``q_y`` (B, 16) u16 (the JAX function's ``Q`` pair);
    ``r_limbs`` (B, 16) u16; ``rn_ok`` (B,) u8; the curve's G table
    (2^16, 16) u16 x, y and (2^16,) u8 ok. Returns ok (B,) bool. ``w``:
    the JAX function's G window, R1_G_WINDOW only.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    cu.require_fixed("w", w, R1_G_WINDOW)
    args = (g_idx, q_digits, q_x, q_y, r_limbs, rn_ok, tab_x, tab_y, tab_ok,
            curve_name)
    if g_idx.device.type == "cpu":
        return verify_core_windowed_single_plain(*args)
    if g_idx.device.type == "cuda":
        return verify_core_windowed_single_cuda(*args)
    raise ValueError(f"unsupported device {g_idx.device}")


verify_core_windowed_single.launches = 0
verify_core_windowed_single.build_count = lambda: _build.build_count(
    "weierstrass_windowed")


def load_kernels() -> None:
    """Build (or load) the service path's ECDSA kernels (B3, B4), the two
    nvcc runs at once; raises BuildError. The other modes' kernels build at
    their first call."""
    _build.build_all(["secp256k1_hybrid", "secp256r1_split"])
    load_hybrid_kernel()
    load_r1_split_kernel()


# ---------------------------------------------------------------------------
# Host prep
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=65536)
def _is_on_curve_memo(curve_name: str, pub) -> bool:
    """Memoized on-curve check: a node verifies the same signers' keys over
    and over."""
    return CURVES[curve_name].is_on_curve(pub)


def _precheck_and_scalars(curve: WeierstrassCurve, items):
    """Shared ECDSA acceptance policy of the Python preps: structural checks
    (r/s ranges incl. the low-s rule, on-curve key), e/w/u1/u2 with one
    batched s-inversion, the neutral substitution for invalid items, and
    the r / r+n x-candidates. Returns (precheck, pubs, u1s, u2s, r0, r1)."""
    precheck = np.ones(len(items), dtype=bool)
    pubs, rs, es, ss = [], [], [], []
    for i, (pub, msg, r, s) in enumerate(items):
        ok = (1 <= r < curve.n and 1 <= s <= curve.n // 2
              and pub is not None and _is_on_curve_memo(curve.name, pub))
        if ok:
            es.append(_bits2int(hashlib.sha256(msg).digest(), curve.n)
                      % curve.n)
            ss.append(s)
        else:
            precheck[i] = False
            pub, r = curve.g, 0
            es.append(0)
            ss.append(1)   # placeholder: batch inversion needs nonzero
        pubs.append(pub)
        rs.append(r)
    ws = _batch_modinv(ss, curve.n)
    u1s = [e * w % curve.n for e, w in zip(es, ws)]
    u2s = [r * w % curve.n for r, w in zip(rs, ws)]
    for i in range(len(items)):
        if not precheck[i]:
            u1s[i] = u2s[i] = 0
    r1 = [r + curve.n if r + curve.n < curve.p else r for r in rs]
    return precheck, pubs, u1s, u2s, rs, r1


def _items_to_words(items):
    """(pub, msg, r, s) items → (e, r, s, pub) LE u64 word arrays for the
    native preps. Out-of-range values (negative, ≥ 2^256) are clamped to
    encodings the native precheck rejects, so a malformed item yields a
    per-item False verdict, never a batch-level exception."""
    digests = [hashlib.sha256(msg).digest() for _, msg, _, _ in items]
    e_words = sp.digests_to_words(digests, 4)

    def in_range(v):
        return 0 <= v < (1 << 256)

    r_words = sp.ints_to_words([r if in_range(r) else 0
                                for _, _, r, _ in items])
    s_words = sp.ints_to_words([s if in_range(s) else 0
                                for _, _, _, s in items])
    pub_buf = b"".join(
        (pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little"))
        if (pt is not None and in_range(pt[0]) and in_range(pt[1]))
        else bytes(64)
        for pt, _, _, _ in items)
    pub_words = np.frombuffer(pub_buf, dtype="<u8").reshape(len(items), 8)
    return e_words, r_words, s_words, pub_words


def _prepare_hybrid_native_words(e_words, r_words, s_words, pub_words):
    """Word-form native hybrid prep: (B, ·) LE u64 rows → (g_idx (16,B)
    i32 with rn_ok at bit 18 of row 0, q_bits (16,4,B) u8, pts (B,4,16)
    u16, r_limbs (B,16) u16, precheck (B,) bool), byte-identical to the JAX
    package's wire arrays."""
    n = len(e_words)
    (g_idx, q_packed, qc_x, qc_y, qd_x, qd_y, r_limbs,
     rn_ok, precheck) = sp.k1_prep(e_words, r_words, s_words, pub_words)
    q_bits = q_packed.reshape(128 // HYBRID_G_WINDOW, HYBRID_G_WINDOW // 2, n)
    g_idx[0] |= rn_ok.astype(np.int32) << 18      # consolidated wire form
    pts = np.stack([qc_x, qc_y, qd_x, qd_y], axis=1)     # (B, 4, 16)
    return g_idx, q_bits, pts, r_limbs, precheck


def _prepare_hybrid_python(items):
    """Pure-Python hybrid prep, bit-identical to the native one."""
    g_w = HYBRID_G_WINDOW
    curve = SECP256K1
    p = curve.p
    precheck, pubs, u1s, u2s, r0, _ = _precheck_and_scalars(curve, items)
    nbits = -(-GLV_BITS // g_w) * g_w          # pad to a g_w multiple
    sa, sb, abs_a, abs_b = [], [], [], []
    cs, ds, qc_pts, qd_pts = [], [], [], []
    for pub, u1, u2 in zip(pubs, u1s, u2s):
        a, b = glv_decompose(u1)
        c, d = glv_decompose(u2)
        sa.append(a < 0)
        sb.append(b < 0)
        abs_a.append(abs(a))
        abs_b.append(abs(b))
        phi_q = (SECP256K1_BETA * pub[0] % p, pub[1])
        for k, pt, ks, kpts in ((c, pub, cs, qc_pts), (d, phi_q, ds, qd_pts)):
            if k < 0:
                k, pt = -k, (pt[0], (p - pt[1]) % p)
            ks.append(k)
            kpts.append(pt)
    wa = _bits_to_w_windows(F.scalars_to_bits(abs_a, nbits), g_w)
    wb = _bits_to_w_windows(F.scalars_to_bits(abs_b, nbits), g_w)
    g_idx = (wa + (wb << g_w)
             + (np.asarray(sa, dtype=np.uint32)[None, :] << (2 * g_w))
             + (np.asarray(sb, dtype=np.uint32)[None, :] << (2 * g_w + 1))
             ).astype(np.int32)
    wc = _bits_to_windows(F.scalars_to_bits(cs, nbits))
    wd = _bits_to_windows(F.scalars_to_bits(ds, nbits))
    q_packed = (wc | (wd << 2)).astype(np.uint8)           # (nbits/2, B)
    q_bits = q_packed.reshape(nbits // g_w, g_w // 2, *q_packed.shape[1:])
    r_limbs = F.to_limbs(r0).astype(np.uint16)
    rn_ok = np.asarray([r + curve.n < curve.p for r in r0], dtype=np.int32)
    g_idx[0] |= rn_ok << 18                       # consolidated wire form
    pts = np.stack([F.to_limbs(xs_).astype(np.uint16)
                    for col in (qc_pts, qd_pts)
                    for xs_ in ([p_[0] for p_ in col],
                                [p_[1] for p_ in col])], axis=1)
    return g_idx, q_bits, pts, r_limbs, precheck


def prepare_batch_hybrid_wide(items, g_w: int = HYBRID_G_WINDOW):
    """Host prep for the hybrid kernel: (pub, msg, r, s) items → (g_idx,
    q_bits, pts, r_limbs, precheck) numpy arrays; native scalar layer when
    libscalarmath is available, the bit-identical Python one otherwise.
    ``g_w``: the JAX function's G window, HYBRID_G_WINDOW only."""
    cu.require_fixed("g_w", g_w, HYBRID_G_WINDOW)
    if sp.available():
        return _prepare_hybrid_native_words(*_items_to_words(items))
    return _prepare_hybrid_python(items)


# -- secp256r1 half-gcd split ----------------------------------------------
#
# Antipa et al. (SAC 2005): extended Euclid on (n, u2), stopped at the first
# remainder below 2^128, yields v1, v2 < 2^128 with u2·v2 ≡ ±v1 (mod n).
# Multiplying X = [u1]G + [u2]Q by v2 gives [t]G ± [v1]Q = [v2]X with
# t = v2·u1 mod n, split at 2^128 against G′ = [2^128]G. The host computes
# x_D = x([v2]R); the device accepts iff x(W2) == x_D projectively. Items
# where the split cannot stand in for the two-candidate check (r + n < p,
# r not an x-coordinate, a degenerate split) fall back to the host oracle
# per item (hg_ok = 0, verdict in ``forced``).

_R1_HG_STATS = {"items": 0, "fallback": 0}
_R1_HG_LOCK = threading.Lock()


def _record_hg_stats(items: int, fallback: int) -> None:
    with _R1_HG_LOCK:
        _R1_HG_STATS["items"] += int(items)
        _R1_HG_STATS["fallback"] += int(fallback)


def r1_split_stats(reset: bool = False) -> dict:
    """Process-cumulative half-gcd counters: items prepped through the
    split path and how many fell back to the host oracle (hg_ok = 0)."""
    with _R1_HG_LOCK:
        out = dict(_R1_HG_STATS)
        if reset:
            _R1_HG_STATS["items"] = 0
            _R1_HG_STATS["fallback"] = 0
    return out


def _r1_host_verify_scalars(curve: WeierstrassCurve, pub, e_raw: int,
                            r: int, s: int) -> bool:
    """ecmath.ecdsa_verify from the already-hashed digest int (the words
    path never sees the message)."""
    n = curve.n
    if not (1 <= r < n and 1 <= s <= n // 2):
        return False
    if pub is None or not curve.is_on_curve(pub):
        return False
    e = e_raw % n
    w = pow(s, n - 2, n)
    X = curve.add(curve.mul(e * w % n, curve.g),
                  curve.mul(r * w % n, pub))
    if X is None:
        return False
    return X[0] % n == r


def _r1_split_pack(g_idx, q_digits, q_x, q_y, xd_limbs, hg_ok, precheck,
                   forced):
    """Shared tail of both split preps: fallback accounting and window
    reshapes. Returns (g_idx (8,2,B), q_digits (8,4,B), q_x, q_y, xd_limbs,
    precheck_eff, forced)."""
    B = len(precheck)
    hg = np.asarray(hg_ok, dtype=bool)
    _record_hg_stats(B, int((precheck & ~hg).sum()))
    w = R1_G_WINDOW
    return (g_idx.reshape(128 // w, 2, B),
            q_digits.reshape(128 // w, w // 4, B),
            q_x, q_y, xd_limbs, precheck & hg, forced)


def _words_row_int(words, i: int) -> int:
    return int.from_bytes(np.ascontiguousarray(words[i]).tobytes(), "little")


def _prepare_r1_split_native_words(e_words, r_words, s_words, pub_words):
    """Word-form native half-gcd prep (``sm_r1_prep_hg``) plus the host
    oracle for the fallback items; byte-identical to the JAX package's."""
    curve = SECP256R1
    (g_idx, q_digits, q_x, q_y, xd_limbs, hg_ok,
     precheck) = sp.r1_prep_hg(e_words, r_words, s_words, pub_words)
    forced = np.zeros(len(precheck), dtype=bool)
    for i in np.nonzero(precheck & ~hg_ok.astype(bool))[0]:
        row = np.ascontiguousarray(pub_words[i]).tobytes()
        pub = (int.from_bytes(row[:32], "little"),
               int.from_bytes(row[32:], "little"))
        forced[i] = _r1_host_verify_scalars(
            curve, pub, _words_row_int(e_words, i),
            _words_row_int(r_words, i), _words_row_int(s_words, i))
    return _r1_split_pack(g_idx, q_digits, q_x, q_y, xd_limbs, hg_ok,
                          precheck, forced)


def _prepare_r1_split_python(curve: WeierstrassCurve, items):
    """Pure-Python mirror of ``sm_r1_prep_hg``: the same substitutions,
    zeroing, window layout and sign handling, bit for bit."""
    w = R1_G_WINDOW
    p, n, b = curve.p, curve.n, curve.b
    precheck, pubs, u1s, u2s, r0, _ = _precheck_and_scalars(curve, items)
    B = len(items)
    g_idx = np.zeros((2 * (128 // w), B), dtype=np.int32)
    q_digits = np.zeros((128 // R1_Q_WINDOW, B), dtype=np.uint8)
    hg_ok = np.ones(B, dtype=np.uint8)
    qys, xds = [], []
    mask16 = (1 << w) - 1
    for i, (pub, u1, u2, r) in enumerate(zip(pubs, u1s, u2s, r0)):
        hg, neg1, v1, v2, tt, y_r = True, False, 0, 0, 0, None
        if precheck[i]:
            dec = sp.r1_halfgcd_py(u2)
            if dec is None:
                hg = False
            else:
                neg1, v1, v2 = dec
                tt = v2 * u1 % n
            if r + n < p:
                hg = False
            if hg:
                z = (r * r % p * r - 3 * r + b) % p
                y_r = pow(z, (p + 1) // 4, p)
                if y_r * y_r % p != z:
                    hg = False
        emit = bool(precheck[i]) and hg
        hg_ok[i] = 1 if hg else 0
        if emit:
            t_hi, t_lo = tt >> 128, tt & ((1 << 128) - 1)
            for j in range(128 // w):
                sh = w * (128 // w - 1 - j)
                g_idx[2 * j, i] = (t_hi >> sh) & mask16
                g_idx[2 * j + 1, i] = (t_lo >> sh) & mask16
            for j in range(128 // R1_Q_WINDOW):
                q_digits[j, i] = (v1 >> (4 * (31 - j))) & 0xF
            xds.append(curve.mul(v2, (r, y_r))[0])
        else:
            xds.append(0)
        qys.append((p - pub[1]) % p if (emit and neg1) else pub[1])
    q_x = F.to_limbs([q[0] for q in pubs]).astype(np.uint16)
    q_y = F.to_limbs(qys).astype(np.uint16)
    xd_limbs = F.to_limbs(xds).astype(np.uint16)
    forced = np.zeros(B, dtype=bool)
    for i in np.nonzero(precheck & ~hg_ok.astype(bool))[0]:
        # precheck already validated the item: the oracle verdict is
        # X = [u1]G + [u2]Q ≠ ∞ and x(X) ≡ r (mod n)
        X = curve.add(curve.mul(u1s[i], curve.g),
                      curve.mul(u2s[i], pubs[i]))
        forced[i] = X is not None and X[0] % n == r0[i]
    return _r1_split_pack(g_idx, q_digits, q_x, q_y, xd_limbs, hg_ok,
                          precheck, forced)


def prepare_batch_r1_split(curve: WeierstrassCurve, items,
                           w: int = R1_G_WINDOW):
    """Host prep for the split kernel: (pub, msg, r, s) items →
    (g_idx, q_digits, q_x, q_y, xd_limbs, precheck_eff, forced) numpy
    arrays; callers combine verdicts as ``(dev & precheck_eff) | forced``.
    ``w``: the JAX function's G window, R1_G_WINDOW only."""
    if curve.name != "secp256r1":
        raise ValueError("the split prep is for secp256r1")
    cu.require_fixed("w", w, R1_G_WINDOW)
    if sp.available():
        return _prepare_r1_split_native_words(*_items_to_words(items))
    return _prepare_r1_split_python(curve, items)


# -- plain (Shamir), glv and windowed --------------------------------------

def _points_to_limbs_affine(col):
    """Affine host points [(x, y)] → (X, Y) u16 limb arrays (B, 16)."""
    return (F.to_limbs([pt[0] for pt in col]).astype(np.uint16),
            F.to_limbs([pt[1] for pt in col]).astype(np.uint16))


def _points_to_limbs(col):
    """Affine host points [(x, y)] → projective (X, Y, Z = 1) u16 limb
    arrays (B, 16)."""
    px, py = _points_to_limbs_affine(col)
    pz = np.zeros_like(px)
    pz[..., 0] = 1
    return (px, py, pz)


def _r_cands(r0, r1) -> np.ndarray:
    return np.stack([F.to_limbs(r0), F.to_limbs(r1)]).astype(np.uint16)


def prepare_batch(curve: WeierstrassCurve, items):
    """Host prep for the Shamir kernel: (pub, msg, r, s) items →
    (u1_bits (256, B) u8, u2_bits (256, B) u8, q_pts (3, B, 16) u16,
    r_cands (2, B, 16) u16, precheck (B,) bool), byte-identical to the JAX
    package's (whose q_pts triple is stacked here)."""
    precheck, q_pts, u1s, u2s, r0, r1 = _precheck_and_scalars(curve, items)
    return (F.scalars_to_bits(u1s), F.scalars_to_bits(u2s),
            np.stack(_points_to_limbs(q_pts)), _r_cands(r0, r1), precheck)


def prepare_batch_glv(items):
    """Host prep for the GLV kernel: (pub, msg, r, s) items → (bits4
    (128, B, 4) u8 MSB-first bit planes of |a|, |b|, |c|, |d|, pts4
    (4, 3, B, 16) u16, r_cands (2, B, 16) u16, precheck (B,) bool). Each
    scalar is GLV-split (u1 = a + bλ, u2 = c + dλ); a negative half flips
    its base point on the host. Every half must fit 128 bits (Babai
    rounding bounds them below 2^127.4): ``scalars_to_bits`` raises
    otherwise."""
    curve = SECP256K1
    p = curve.p
    precheck, pubs, u1s, u2s, r0, r1 = _precheck_and_scalars(curve, items)
    pts_cols = [[] for _ in range(4)]
    scalars = [[] for _ in range(4)]

    def phi(pt):
        return (SECP256K1_BETA * pt[0] % p, pt[1])
    for pub, u1, u2 in zip(pubs, u1s, u2s):
        a, b = glv_decompose(u1)
        c, d = glv_decompose(u2)
        g = curve.g
        for j, (k, pt) in enumerate(((a, g), (b, phi(g)), (c, pub),
                                     (d, phi(pub)))):
            if k < 0:
                k, pt = -k, (pt[0], (p - pt[1]) % p)
            scalars[j].append(k)
            pts_cols[j].append(pt)
    bits4 = np.stack([F.scalars_to_bits(scalars[j], GLV_BITS)
                      for j in range(4)], axis=-1)
    pts4 = np.stack([np.stack(_points_to_limbs(col)) for col in pts_cols])
    return bits4, pts4, _r_cands(r0, r1), precheck


def _prepare_windowed_single_native_words(e_words, r_words, s_words,
                                          pub_words):
    """Word-form native windowed prep (secp256r1, w = 16, ``sm_r1_prep``):
    (g_idx (16, B) i32, q_digits (16, 4, B) u8, q_x, q_y, r_limbs (B, 16)
    u16, rn_ok (B,) u8, precheck (B,) bool), byte-identical to the JAX
    package's."""
    (g_idx, q_digits, q_x, q_y, r_limbs, rn_ok,
     precheck) = sp.r1_prep(e_words, r_words, s_words, pub_words)
    w = R1_G_WINDOW
    q_digits = q_digits.reshape(256 // w, w // R1_Q_WINDOW, len(e_words))
    return g_idx, q_digits, q_x, q_y, r_limbs, rn_ok, precheck


def _prepare_windowed_single_python(curve: WeierstrassCurve, items):
    """Pure-Python windowed prep, any curve (bit-identical to the native
    secp256r1 one)."""
    w = R1_G_WINDOW
    precheck, pubs, u1s, u2s, r0, _ = _precheck_and_scalars(curve, items)
    g_idx = _bits_to_w_windows(F.scalars_to_bits(u1s), w).astype(np.int32)
    digs = _bits_to_w_windows(F.scalars_to_bits(u2s),
                              R1_Q_WINDOW).astype(np.uint8)
    q_digits = digs.reshape(256 // w, w // R1_Q_WINDOW, *digs.shape[1:])
    q_x, q_y = _points_to_limbs_affine(pubs)
    r_limbs = F.to_limbs(r0).astype(np.uint16)
    rn_ok = np.asarray([r + curve.n < curve.p for r in r0], dtype=np.uint8)
    return g_idx, q_digits, q_x, q_y, r_limbs, rn_ok, precheck


def prepare_batch_windowed_single(curve: WeierstrassCurve, items,
                                  w: int = R1_G_WINDOW):
    """Host prep for the windowed kernel (w = 16): (pub, msg, r, s) items →
    (g_idx, q_digits, q_x, q_y, r_limbs, rn_ok, precheck) numpy arrays;
    native for secp256r1 when libscalarmath is available, Python otherwise
    (as in the reference). The G table is the caller's
    (:func:`windowed_tables`). ``w``: the JAX function's G window,
    R1_G_WINDOW only."""
    cu.require_fixed("w", w, R1_G_WINDOW)
    if curve.name == "secp256r1" and sp.available():
        return _prepare_windowed_single_native_words(*_items_to_words(items))
    return _prepare_windowed_single_python(curve, items)


# ---------------------------------------------------------------------------
# Batch entry points (the service path)
# ---------------------------------------------------------------------------

class PendingBatch:
    """An in-flight batch: the device verdicts, the host precheck, the
    host-forced verdicts of the r1 fallbacks (or None), the live count, the
    launching kernel's name and (on CUDA) the event behind the kernel."""

    __slots__ = ("ok", "precheck", "forced", "n", "name", "event")

    def __init__(self, ok, precheck, n, forced=None, name="weierstrass",
                 event=None):
        self.ok = ok
        self.precheck = precheck
        self.forced = forced
        self.n = n
        self.name = name
        self.event = event


def wire_to_device(arrays, device="cuda", non_blocking: bool = False
                   ) -> tuple:
    """Wire arrays (numpy, in the JAX package's dtypes and shapes) as
    contiguous tensors on ``device``."""
    dev = resolve_device(device)
    out = []
    for a in arrays:
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = np.array(a, order="C")
        out.append(torch.from_numpy(a).to(dev, non_blocking=non_blocking))
    return tuple(out)


def _route(curve: WeierstrassCurve, mode: str, dev: torch.device):
    """(profiler name, dispatcher, table tensors, keyword arguments) of a
    checked ``mode``."""
    if mode == "hybrid":
        return ("weierstrass.hybrid_k1", verify_core_hybrid_wide,
                hybrid_tables(dev), {})
    if mode == "halfgcd":
        return ("weierstrass.r1_split", verify_core_r1_split,
                r1_split_tables(dev), {})
    if mode == "glv":
        return "weierstrass.glv", verify_core_glv, (), {}
    kw = {"curve_name": curve.name}
    if mode == "windowed":
        return ("weierstrass.windowed", verify_core_windowed_single,
                windowed_tables(curve, dev), kw)
    return "weierstrass.plain", verify_core, (), kw


def _prepare(curve: WeierstrassCurve, mode: str, items):
    """The host prep of a checked ``mode``: (wire arrays, precheck,
    forced or None)."""
    if mode == "hybrid":
        *wire, precheck = prepare_batch_hybrid_wide(items)
        return wire, precheck, None
    if mode == "halfgcd":
        *wire, precheck, forced = prepare_batch_r1_split(curve, items)
        return wire, precheck, forced
    if mode == "windowed":
        *wire, precheck = prepare_batch_windowed_single(curve, items)
    elif mode == "glv":
        *wire, precheck = prepare_batch_glv(items)
    else:
        *wire, precheck = prepare_batch(curve, items)
    return wire, precheck, None


def _dispatch(curve: WeierstrassCurve, mode: str, wire, precheck, forced,
              n: int, capacity: int, dev: torch.device, pool,
              lease) -> PendingBatch:
    """Copy the wire arrays, launch the mode's kernel through the flight
    recorder and record the batch's event; the staging lease rides the
    pending handle until ``finish_batch``."""
    cuda = dev.type == "cuda"
    name, fn, tables, kw = _route(curve, mode, dev)
    args = wire_to_device(wire, dev, non_blocking=cuda)
    prof = get_profiler()
    ok = prof.call(name, fn, *args, *tables, live=n, capacity=capacity,
                   scheme=curve.name, **kw)
    event = None
    if cuda:
        ok_dev = ok
        ok = ok_dev.to("cpu", non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        prof.note_pending(ok, prof.pending_name(ok_dev, name))
    pending = PendingBatch(ok, precheck, n, forced, name, event)
    if lease is not None:
        pool.attach(pending, lease)
    return pending


def _check_mode(curve: WeierstrassCurve, mode: str) -> str:
    """The mode ``verify_batch`` runs for ``mode`` on ``curve`` ("auto":
    hybrid for secp256k1, halfgcd for secp256r1, windowed otherwise), or
    the reference's ValueError."""
    if mode == "auto":
        mode = {"secp256k1": "hybrid", "secp256r1": "halfgcd"}.get(
            curve.name, "windowed")
    if mode not in MODES:
        raise ValueError(f"unknown verify mode {mode!r}")
    if MODES[mode] is not None and curve.name != MODES[mode]:
        raise ValueError(f"mode {mode!r} requires {MODES[mode]}")
    return mode


def verify_batch(curve: WeierstrassCurve,
                 items: list[tuple[tuple[int, int] | None, bytes, int, int]],
                 mode: str = "auto", device="cuda") -> np.ndarray:
    """Batched ECDSA verify: [(pub_affine, msg, r, s)] → bool verdicts (B,).
    Pads to a power-of-two bucket (replicating the last item). ``mode``:

    - "auto": "hybrid" for secp256k1, "halfgcd" for secp256r1;
    - "hybrid": the GLV half-length ladder with the constant-G table (B3);
    - "halfgcd": the half-gcd split ladder with the host [v2]R comparand
      and per-item host fallback (B4);
    - "windowed": single-scalar 16-bit constant-G windows and 4-bit Q
      windows (B5);
    - "glv": the all-select GLV ladder (B8, secp256k1);
    - "plain": the 256-bit two-scalar Shamir ladder (B8)."""
    return finish_batch(verify_batch_async(curve, items, device=device,
                                           mode=mode))


def verify_batch_async(curve: WeierstrassCurve, items, device="cuda",
                       mode: str = "auto"):
    """Prep and launch without waiting; returns a PendingBatch for
    :func:`finish_batch`. "auto" runs secp256k1 on the hybrid kernel,
    secp256r1 on the split kernel and any other curve on the windowed
    one; the kernels know secp256k1 and secp256r1 (another curve raises
    ValueError)."""
    mode = _check_mode(curve, mode)
    _curve_of(curve.name)
    dev = resolve_device(device)
    n = len(items)
    if n == 0:
        return PendingBatch(None, np.zeros(0, dtype=bool), 0)
    padded = items + [items[-1]] * (F.bucket_size(n) - n)
    wire, precheck, forced = _prepare(curve, mode, padded)
    return _dispatch(curve, mode, wire, precheck, forced, n, len(padded),
                     dev, None, None)


def words_prep_available(curve: WeierstrassCurve) -> bool:
    """True when the word-form fast path (:func:`verify_batch_async_words`)
    covers ``curve``: native scalar prep present, curve secp256k1/r1."""
    return sp.available() and curve.name in CURVES


def pad_word_rows(arrays, m: int, staging=None, tags=None):
    """Pad each (B, ·) word-row array to m rows by replicating the last row
    (a repeated valid row verifies identically and is sliced off by
    finish_batch). With a staging lease the padded rows land in reused
    pool buffers, one per tag."""
    n = len(arrays[0])
    if staging is None:
        if m <= n:
            return arrays
        return tuple(np.concatenate([a, np.repeat(a[-1:], m - n, axis=0)])
                     for a in arrays)
    out = []
    for a, tag in zip(arrays, tags):
        buf = staging.take(tag, (m,) + a.shape[1:], a.dtype)
        buf[:n] = a
        if m > n:
            buf[n:] = a[-1]
        out.append(buf)
    return tuple(out)


def verify_batch_async_words(curve: WeierstrassCurve, e_words, r_words,
                             s_words, pub_words, device="cuda"):
    """Word-form async dispatch — the batcher's ECDSA path: items arrive as
    the native preps' LE u64 rows (per-signer pub rows from
    ``keys.sec1_pub_row_cached``, r/s from the batched DER parse, e from
    ``digests_to_words``). Padding goes through reused staging buffers,
    released by ``finish_batch`` once the batch's event has completed;
    callers gate on :func:`words_prep_available`."""
    if not words_prep_available(curve):
        raise ValueError(f"no word-form prep for {curve.name} (needs the "
                         "native scalar prep and secp256k1 or secp256r1)")
    dev = resolve_device(device)
    n = len(e_words)
    if n == 0:
        return PendingBatch(None, np.zeros(0, dtype=bool), 0)
    capacity = F.bucket_size(n)
    pool = get_staging_pool()
    # on an exception below the lease is dropped, never released: a partial
    # dispatch may still read the buffers
    lease = pool.lease()
    tags = tuple(f"{curve.name}.{t}" for t in ("e", "r", "s", "pub"))
    words = pad_word_rows((e_words, r_words, s_words, pub_words), capacity,
                          staging=lease, tags=tags)
    if curve.name == "secp256k1":
        mode, forced = "hybrid", None
        *wire, precheck = _prepare_hybrid_native_words(*words)
    else:
        mode = "halfgcd"
        *wire, precheck, forced = _prepare_r1_split_native_words(*words)
    return _dispatch(curve, mode, wire, precheck, forced, n, capacity, dev,
                     pool, lease)


def finish_batch(pending: PendingBatch) -> np.ndarray:
    """Wait for a batch's verdicts (a GIL-releasing CUDA event wait), free
    its staging lease, and combine: (ok & precheck) | forced."""
    if pending.n == 0:
        return np.zeros(0, dtype=bool)
    prof = get_profiler()
    name = prof.pending_name(pending.ok, pending.name)
    t0 = _time.perf_counter()
    if pending.event is not None:
        try:
            pending.event.synchronize()
        except RuntimeError as exc:
            # the kernel (or a copy behind it) faulted on the card
            raise _build.LaunchError(
                f"{pending.name} failed on the card: {exc}") from exc
    ok = pending.ok.numpy().astype(bool)
    prof.device_wait(name, _time.perf_counter() - t0)
    # on a failed wait the lease stays attached and is evicted, never reused
    get_staging_pool().release_for(pending)
    ok = ok & pending.precheck
    if pending.forced is not None:
        ok = ok | pending.forced
    return ok[:pending.n]
