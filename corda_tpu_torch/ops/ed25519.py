"""Batched Ed25519 signature verification: the split-k path (kernel B2)
and the Shamir and windowed ladders (kernel B7).

Port of corda_tpu/ops/ed25519.py. Host/device split of the split path (the
service path):

- host: per-signer (−A, −A′) rows from a decompression + [2^128]A cache,
  SHA-512 challenges (hashlib), scalar windows from native scalarmath
  (Python fallback bit-identical), range checks, limb packing into pinned
  staging buffers;
- device: [s_lo]B + [s_hi]B′ + [k_lo](−A) + [k_hi](−A′) over 128-bit scalar
  halves with two constant Niels tables (B and B′ = [2^128]B), then RFC 8032
  re-encoding acceptance against the wire R.

The two B7 verifiers run the whole 256-bit scalars: ``verify_core`` (the
Shamir ladder over MSB-first bit planes, projective acceptance against the
host-decoded R; prep ``prepare_batch``) and ``verify_core_windowed`` (w = 16
windows of s over B's Niels table, 2-bit digits of k over {O, −A, −2A,
−3A}, re-encoding acceptance; prep ``prepare_batch_windowed``). Both
kernels read k as 4-bit windows over a cached {0..15}(−A) table and run
lane pairs up to a batch-size threshold, one lane above, counted in
``.launches_by_lanes``. They are the per-shard work of the sharded path
(``corda_tpu_torch.parallel``).

Each dispatcher (``verify_core_split``, ``verify_core``,
``verify_core_windowed``) runs its plain PyTorch version (16-bit limbs in
int64 lanes) for tensors on the CPU and launches its hand-written kernel
(``csrc/ed25519_split.cu``, ``csrc/ed25519_shamir.cu``,
``csrc/ed25519_windowed.cu``, built at first use) for CUDA tensors, or
raises — it never falls back. ``.launches`` counts each one's kernel
launches.

Verification equation: accept iff [s]B == R + [k]A ⟺ [s]B + [k](−A) == R.
"""
from __future__ import annotations

import functools
import hashlib
import threading
import time as _time

import numpy as np
import torch

from .. import _build
from ..core.crypto import ecmath
from ..device import resolve_device
from ..observability.profiling import get_profiler
from . import _cuda as cu
from . import field as F
from . import scalarprep as sp
from .staging import get_staging_pool
from .weierstrass import (_batch_modinv, _bits_to_w_windows, _bits_to_windows,
                          select_tree)

P = F.P25519
_D2 = ecmath.ED_D2

#: Constant-base window width of the split ladder (128 = 8 x 16: 8 outer
#: steps of 16 doublings + 8 joint A adds + 1 B + 1 B′ add).
SPLIT_B_WINDOW = 16

#: Constant-base window width of the windowed ladder (256 = 16 x 16: 16
#: outer steps of 8 x (2 doublings + an A add) and one B add). Its table is
#: the split ladder's low table (the same cache entry).
B_WINDOW = 16


# ---------------------------------------------------------------------------
# Point arithmetic (plain PyTorch; extended coordinates, int64 limb tensors)
# ---------------------------------------------------------------------------

def identity(shape, device="cpu") -> tuple:
    z = torch.zeros(tuple(shape) + (F.NLIMB,), dtype=torch.int64,
                    device=device)
    one = z.clone()
    one[..., 0] = 1
    return (z, one, one.clone(), z.clone())


def add(Pt, Qt):
    """Unified extended addition (add-2008-hwcd-3, a = −1); complete for
    ed25519's square a / non-square d. Mirrors ecmath.ed_point_add."""
    x1, y1, z1, t1 = Pt
    x2, y2, z2, t2 = Qt
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, F.const(_D2, t1.device)), t2)
    d = F.mul_const(F.mul(z1, z2), 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double(Pt):
    """dbl-2008-hwcd (valid for all inputs; mirrors ecmath.ed_point_double)."""
    x1, y1, z1, _ = Pt
    a = F.sqr(x1)
    b = F.sqr(y1)
    c = F.mul_const(F.sqr(z1), 2)
    h = F.add(a, b)
    e = F.sub(h, F.sqr(F.add(x1, y1)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def madd_niels(Pt, tab_p, tab_m, tab_td):
    """Mixed add of a precomputed Niels point (y+x, y−x, 2dxy), Z2 = 1 —
    7 products. Complete for every accumulator, identity rows (1, 1, 0)
    included."""
    x1, y1, z1, t1 = Pt
    a = F.mul(F.sub(y1, x1), tab_m)
    b = F.mul(F.add(y1, x1), tab_p)
    c = F.mul(t1, tab_td)
    d = F.mul_const(z1, 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def negate(Pt):
    """−P in extended coordinates: (−X, Y, Z, −T)."""
    x, y, z, t = Pt
    zero = torch.zeros_like(x)
    return (F.sub(zero, x), y, z, F.sub(zero, t))


def _select4(idx, P0, P1, P2, P3):
    """Branchless 4-way point select by ``idx`` (B,) in {0, 1, 2, 3}."""
    idx = idx.unsqueeze(-1)

    def pick(c0, c1, c2, c3):
        return torch.where(idx == 3, c3, torch.where(
            idx == 2, c2, torch.where(idx == 1, c1, c0)))
    return tuple(pick(*cs) for cs in zip(P0, P1, P2, P3))


# ---------------------------------------------------------------------------
# Constant-base Niels tables
# ---------------------------------------------------------------------------

_B_TABLES: dict[tuple, tuple] = {}
_B_TABLES_LOCK = threading.Lock()


def _shift_base(k: int):
    """[2^k]B as an affine point (host chain)."""
    ext = ecmath.ed_to_extended(ecmath.ED_B)
    for _ in range(k):
        ext = ecmath.ed_point_double(ext)
    zi = pow(ext[2], P - 2, P)
    return (ext[0] * zi % P, ext[1] * zi % P)


def _b_window_table(w: int, shift: int = 0):
    """(2^w, 16) u16 arrays (y+x, y−x, 2d·x·y) of wa·[2^shift]B — the Niels
    form the mixed add consumes. Row 0 (the identity) is (1, 1, 0). Built
    host-side with one Montgomery batch inversion for all the Z's;
    byte-identical to the JAX package's table."""
    key = (w, shift)
    tab = _B_TABLES.get(key)
    if tab is not None:
        return tab
    with _B_TABLES_LOCK:
        if key in _B_TABLES:
            return _B_TABLES[key]
        span = 1 << w
        base = ecmath.ED_B if shift == 0 else _shift_base(shift)
        ext = [None] * span
        ext[1] = ecmath.ed_to_extended(base)
        for wa in range(2, span):
            ext[wa] = ecmath.ed_point_add(ext[wa - 1], ext[1])
        zinvs = iter(_batch_modinv([e[2] for e in ext[1:]], P))
        ps, ms, tds = [1], [1], [0]   # identity row: (1, 1, 0)
        for e in ext[1:]:
            zi = next(zinvs)
            x = e[0] * zi % P
            y = e[1] * zi % P
            ps.append((y + x) % P)
            ms.append((y - x) % P)
            tds.append(ecmath.ED_D2 * x % P * y % P)
        tab = tuple(F.to_limbs(v).astype(np.uint16) for v in (ps, ms, tds))
        _B_TABLES[key] = tab
        return tab


def b_table_device(w: int = SPLIT_B_WINDOW, shift: int = 0, device="cuda"):
    """The Niels base table as tensors cached on ``device`` (kernel
    arguments, copied to the device once per process)."""
    dev = resolve_device(device)
    return F.device_table_cache(("niels_b", w, shift),
                                lambda: _b_window_table(w, shift), dev)


def split_tables(device="cuda") -> tuple:
    """The six split-kernel tables: B's (y+x, y−x, 2dxy), then B′'s."""
    return (*b_table_device(SPLIT_B_WINDOW, 0, device),
            *b_table_device(SPLIT_B_WINDOW, 128, device))


def windowed_table(device="cuda") -> tuple:
    """The windowed kernel's Niels table of B, (y+x, y−x, 2dxy) as three
    (65536, 16) u16 tensors on ``device``: the split kernel's low table, one
    cached copy per device for both kernels."""
    return b_table_device(B_WINDOW, 0, device)


def load_windowed_table_from_numpy(tabs, device="cuda") -> tuple:
    """Install the windowed kernel's Niels table built elsewhere (three
    (65536, 16) u16 numpy arrays, e.g. the JAX package's
    ``_b_window_table(16, 0)``) as this package's device-cached table (the
    split kernel's low table too), and return it as tensors."""
    dev = resolve_device(device)
    tabs = [np.ascontiguousarray(t, dtype=np.uint16) for t in tabs]
    if len(tabs) != 3 or any(t.shape != (1 << B_WINDOW, F.NLIMB)
                             for t in tabs):
        raise ValueError("expected three (65536, 16) u16 Niels tables")
    return F.install_device_tables(("niels_b", B_WINDOW, 0), tabs, dev)


def load_tables_from_numpy(tabs, device="cuda") -> tuple:
    """Install Niels tables built elsewhere (six (65536, 16) u16 numpy
    arrays: B's three, then B′'s — e.g. the JAX package's
    ``_b_window_table(16, 0) + _b_window_table(16, 128)``) as this
    package's device-cached tables, and return them as tensors."""
    dev = resolve_device(device)
    tabs = [np.ascontiguousarray(t, dtype=np.uint16) for t in tabs]
    if len(tabs) != 6 or any(t.shape != (1 << SPLIT_B_WINDOW, F.NLIMB)
                             for t in tabs):
        raise ValueError("expected six (65536, 16) u16 Niels tables")
    lo = F.install_device_tables(("niels_b", SPLIT_B_WINDOW, 0), tabs[:3], dev)
    hi = F.install_device_tables(("niels_b", SPLIT_B_WINDOW, 128), tabs[3:],
                                 dev)
    return (*lo, *hi)


def wire_to_device(bb_idx, a_packed, rows, r_packed, device="cuda",
                   non_blocking: bool = False) -> tuple:
    """The four wire arrays (numpy, in the JAX package's dtypes and shapes)
    as contiguous tensors on ``device``."""
    dev = resolve_device(device)
    out = []
    for arr, dt in ((bb_idx, np.int32), (a_packed, np.uint8),
                    (rows, np.uint16), (r_packed, np.uint16)):
        if isinstance(arr, torch.Tensor):
            out.append(arr.to(dev, non_blocking=non_blocking).contiguous())
            continue
        host = np.asarray(arr)
        if host.dtype != dt or not host.flags.c_contiguous \
                or not host.flags.writeable:
            host = np.array(host, dtype=dt, order="C")
        host = torch.from_numpy(host)
        out.append(host.to(dev, non_blocking=non_blocking))
    return tuple(out)


# ---------------------------------------------------------------------------
# The split-k verifier: plain version and CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _joint_a_table(neg_a, neg_a2):
    """16-entry per-item table T[i + 4j] = [i](−A) + [j](−A′) from affine
    (x, y, t) triples: 2 doublings + 11 unified adds."""
    ax, ay, at = neg_a
    a2x, a2y, a2t = neg_a2
    one = F.one_like(ax)
    T = [identity(ax.shape[:-1], ax.device)] * 16
    T[1] = (ax, ay, one, at)
    T[2] = double(T[1])
    T[3] = add(T[2], T[1])
    T[4] = (a2x, a2y, one, a2t)
    T[8] = double(T[4])
    T[12] = add(T[8], T[4])
    for j in (4, 8, 12):
        T[j + 1] = add(T[j], T[1])
        T[j + 2] = add(T[j + 1], T[1])
        T[j + 3] = add(T[j + 2], T[1])
    return T


def _niels_rows(tabs, idx: torch.Tensor):
    return tuple(t[idx & 0xFFFF] for t in tabs)


def verify_core_split_plain(bb_idx, a_packed, rows, r_packed,
                            tab_p, tab_m, tab_td, tab2_p, tab2_m, tab2_td,
                            w: int = SPLIT_B_WINDOW) -> torch.Tensor:
    """Plain PyTorch version of the split-k verifier (same wire form and
    same ladder as the CUDA kernel and the JAX kernel), on any device."""
    if w != SPLIT_B_WINDOW:
        raise ValueError("the split verifier uses 16-bit windows")
    rows = rows.to(torch.int64)
    r_packed = r_packed.to(torch.int64)
    a_packed = a_packed.to(torch.int64) & 15
    bb_idx = bb_idx.to(torch.int64)
    neg_a = tuple(rows[:, j] for j in range(3))
    neg_a2 = tuple(rows[:, 3 + j] for j in range(3))
    table = _joint_a_table(neg_a, neg_a2)
    # int64 copies: CUDA indexing has no uint16 kernel
    btab = tuple(t.to(torch.int64) for t in (tab_p, tab_m, tab_td))
    b2tab = tuple(t.to(torch.int64) for t in (tab2_p, tab2_m, tab2_td))
    acc = select_tree(table, a_packed[0, 0])
    for s in range(1, 64):
        j, m = divmod(s, 8)
        if m == 0:
            acc = madd_niels(acc, *_niels_rows(btab, bb_idx[j - 1]))
            acc = madd_niels(acc, *_niels_rows(b2tab, bb_idx[8 + j - 1]))
        acc = add(double(double(acc)), select_tree(table, a_packed[j, m]))
    acc = madd_niels(acc, *_niels_rows(btab, bb_idx[7]))
    acc = madd_niels(acc, *_niels_rows(b2tab, bb_idx[15]))
    x, y, z, _ = acc
    zi = F.inv25519(z)
    x_aff = F.canon(F.mul(x, zi))
    y_aff = F.canon(F.mul(y, zi))
    r_sign = r_packed[:, 15] >> 15
    r_y = r_packed.clone()
    r_y[:, 15] &= 0x7FFF
    ok_y = (y_aff == r_y).all(dim=-1)
    ok_sign = (x_aff[:, 0] & 1) == r_sign
    return ok_y & ok_sign


_LAUNCH_LOCK = threading.Lock()


def _launch_by_lanes(lib, target: str, args, n: int, device,
                     counter) -> torch.Tensor:
    """Launch ``<target>_verify`` on the lanes a signature
    ``<target>_lanes(n)`` picks and count the launch on ``counter`` (the
    dispatcher), in all and under those lanes."""
    lanes = cu.lanes_for(lib, target, n)
    ok = cu.launch_verify(lib, f"{target}_verify", args, n, device, lanes)
    with _LAUNCH_LOCK:
        counter.launches += 1
        counter.launches_by_lanes[lanes] += 1
    return ok


@functools.lru_cache(maxsize=1)
def load_kernel():
    """The split-k kernel's library, built from ``csrc/`` at first use and
    held against the plain version on known answers on the current CUDA
    device (:mod:`.known_answers`). Raises :class:`BuildError` when it
    cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("ed25519_split", 10, with_int=True)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_ed25519_split(
        lambda args, n, lanes: cu.launch_verify(
            lib, "ed25519_split_verify", args, n, device, lanes), device)
    return lib


def verify_core_split_cuda(bb_idx, a_packed, rows, r_packed,
                           tab_p, tab_m, tab_td, tab2_p, tab2_m, tab2_td
                           ) -> torch.Tensor:
    """Launch the hand-written Hopper kernel on the current stream of the
    arguments' device; returns ok (B,) bool without synchronising. Raises
    when the kernel does not build or the launch is refused."""
    args = (bb_idx, a_packed, rows, r_packed,
            tab_p, tab_m, tab_td, tab2_p, tab2_m, tab2_td)
    n = int(bb_idx.shape[-1])
    table = (1 << SPLIT_B_WINDOW, F.NLIMB)
    spec = (("bb_idx", torch.int32, (16, n)),
            ("a_packed", torch.uint8, (8, 8, n)),
            ("rows", torch.uint16, (n, 6, F.NLIMB)),
            ("r_packed", torch.uint16, (n, F.NLIMB)),
            *((f"table {k}", torch.uint16, table) for k in range(6)))
    cu.check_args(spec, args, bb_idx.device)
    return _launch_by_lanes(load_kernel(), "ed25519_split", args, n,
                            bb_idx.device, verify_core_split)


def verify_core_split(bb_idx, a_packed, rows, r_packed,
                      tab_p, tab_m, tab_td, tab2_p, tab2_m, tab2_td,
                      w: int = SPLIT_B_WINDOW) -> torch.Tensor:
    """Split-k verify over the consolidated wire form: ``bb_idx`` (16, B)
    i32 = b_idx ‖ b2_idx; ``a_packed`` (8, 8, B) u8 joint digits k_lo |
    k_hi << 2; ``rows`` (B, 6, 16) u16 = (−A x, y, t, −A′ x, y, t);
    ``r_packed`` (B, 16) u16 wire y with the sign bit at limb 15 bit 15;
    six (65536, 16) u16 Niels tables. Returns ok (B,) bool.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if w != SPLIT_B_WINDOW:
        raise ValueError("the split verifier uses 16-bit windows")
    if bb_idx.device.type == "cpu":
        return verify_core_split_plain(bb_idx, a_packed, rows, r_packed,
                                       tab_p, tab_m, tab_td,
                                       tab2_p, tab2_m, tab2_td)
    if bb_idx.device.type == "cuda":
        return verify_core_split_cuda(bb_idx, a_packed, rows, r_packed,
                                      tab_p, tab_m, tab_td,
                                      tab2_p, tab2_m, tab2_td)
    raise ValueError(f"unsupported device {bb_idx.device}")


#: Kernel launches through the wrapper (the CPU path launches nothing), in
#: all and by lanes a signature: 1 the one-lane kernel, 2 the lane pairs.
verify_core_split.launches = 0
verify_core_split.launches_by_lanes = {1: 0, 2: 0}
verify_core_split.build_count = lambda: _build.build_count("ed25519_split")


# ---------------------------------------------------------------------------
# Kernel B7: the Shamir and windowed ladders (plain versions and wrappers)
# ---------------------------------------------------------------------------

def _base_point(like: torch.Tensor) -> tuple:
    """B in extended coordinates, broadcast to ``like``'s (B, 16) shape."""
    bx, by = ecmath.ED_B
    return tuple(F.const(v, like.device).expand_as(like).clone()
                 for v in (bx, by, 1, bx * by % P))


def shamir_ladder(bits1, bits2, P1, P2):
    """[k1]P1 + [k2]P2 by interleaved double-and-add over (256, B)
    MSB-first bit planes: one doubling and one complete addition of
    {O, P1, P2, P1 + P2} per bit."""
    P3 = add(P1, P2)
    Pid = identity(P1[0].shape[:-1], P1[0].device)
    acc = Pid
    for b1, b2 in zip(bits1, bits2):
        acc = add(double(acc), _select4(b1 + 2 * b2, Pid, P1, P2, P3))
    return acc


def verify_core_plain(s_bits, k_bits, neg_a, r_affine) -> torch.Tensor:
    """Plain PyTorch version of the Shamir verifier (same wire form and
    ladder as the CUDA kernel and the JAX kernel), on any device:
    X = [s]B + [k](−A), accepted when X == Rx·Z and Y == Ry·Z."""
    neg_a = tuple(c.to(torch.int64) for c in neg_a)
    rx, ry = (c.to(torch.int64) for c in r_affine)
    x, y, z, _ = shamir_ladder(s_bits.to(torch.int64),
                               k_bits.to(torch.int64),
                               _base_point(neg_a[0]), neg_a)
    ok_x = (F.canon(x) == F.canon(F.mul(rx, z))).all(dim=-1)
    ok_y = (F.canon(y) == F.canon(F.mul(ry, z))).all(dim=-1)
    return ok_x & ok_y


def windowed_ladder(b_idx, a_digits, neg_a, btab):
    """[s]B + [k](−A): per outer step 8 × (2 doublings + an addition of
    {O, −A, −2A, −3A} by a 2-bit digit of k), then one Niels mixed addition
    of B's table row ``b_idx[step]``; step 0 starts from its first digit's
    addend. ``b_idx`` (16, B), ``a_digits`` (16, 8, B), int64."""
    Pid = identity(neg_a[0].shape[:-1], neg_a[0].device)
    a2 = double(neg_a)
    a_tab = (Pid, neg_a, a2, add(a2, neg_a))
    acc = _select4(a_digits[0, 0], *a_tab)
    for step in range(b_idx.shape[0]):
        for m in range(1 if step == 0 else 0, B_WINDOW // 2):
            acc = add(double(double(acc)),
                      _select4(a_digits[step, m], *a_tab))
        acc = madd_niels(acc, *_niels_rows(btab, b_idx[step]))
    return acc


def verify_core_windowed_plain(b_idx, a_digits, neg_a, r_y, r_sign,
                               tab_p, tab_m, tab_td) -> torch.Tensor:
    """Plain PyTorch version of the windowed verifier, on any device: one
    Fermat inversion, then canonical y == ``r_y`` and x's parity ==
    ``r_sign``."""
    neg_a = tuple(c.to(torch.int64) for c in neg_a)
    # int64 copies: CUDA indexing has no uint16 kernel
    btab = tuple(t.to(torch.int64) for t in (tab_p, tab_m, tab_td))
    x, y, z, _ = windowed_ladder(b_idx.to(torch.int64),
                                 a_digits.to(torch.int64), neg_a, btab)
    zi = F.inv25519(z)
    x_aff = F.canon(F.mul(x, zi))
    y_aff = F.canon(F.mul(y, zi))
    ok_y = (y_aff == r_y.to(torch.int64)).all(dim=-1)
    ok_sign = (x_aff[:, 0] & 1) == r_sign.to(torch.int64)
    return ok_y & ok_sign


@functools.lru_cache(maxsize=1)
def load_shamir_kernel():
    """The Shamir kernels' library (one lane and lane pairs), built from
    ``csrc/`` at first use and held against the plain version on known
    answers on the current CUDA device (:mod:`.known_answers`). Raises
    :class:`BuildError` when it cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("ed25519_shamir", 8, with_int=True)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_ed25519_shamir(
        lambda args, n, lanes: cu.launch_verify(
            lib, "ed25519_shamir_verify", args, n, device, lanes),
        device)
    return lib


@functools.lru_cache(maxsize=1)
def load_windowed_kernel():
    """The windowed kernels' library (one lane and lane pairs), built from
    ``csrc/`` at first use and held against the plain version on known
    answers on the current CUDA device (:mod:`.known_answers`). Raises
    :class:`BuildError` when it cannot be built or gives a wrong answer."""
    from . import known_answers
    lib = cu.bind_verify("ed25519_windowed", 11, with_int=True)
    device = torch.device("cuda", torch.cuda.current_device())
    known_answers.check_ed25519_windowed(
        lambda args, n, lanes: cu.launch_verify(
            lib, "ed25519_windowed_verify", args, n, device, lanes),
        device)
    return lib


def verify_core_cuda(s_bits, k_bits, neg_a, r_affine) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B7 (Shamir) on the current
    stream of the arguments' device, on the lanes a signature
    ``ed25519_shamir_lanes(n)`` picks; returns ok (B,) bool without
    synchronising. Raises when the kernel does not build or the launch is
    refused."""
    n = int(s_bits.shape[-1])
    limbs = (n, F.NLIMB)
    args = (s_bits, k_bits, *neg_a, *r_affine)
    spec = (("s_bits", torch.uint8, (256, n)),
            ("k_bits", torch.uint8, (256, n)),
            *((f"neg_a[{j}]", torch.uint16, limbs) for j in range(4)),
            *((f"r_affine[{j}]", torch.uint16, limbs) for j in range(2)))
    if len(args) != 8:
        raise ValueError("neg_a takes 4 coordinates, r_affine 2")
    cu.check_args(spec, args, s_bits.device)
    return _launch_by_lanes(load_shamir_kernel(), "ed25519_shamir", args, n,
                            s_bits.device, verify_core)


def verify_core(s_bits, k_bits, neg_a, r_affine) -> torch.Tensor:
    """Shamir verify: ``s_bits``, ``k_bits`` (256, B) u8 MSB-first bit
    planes; ``neg_a`` 4 × (B, 16) u16 = −A in extended coordinates;
    ``r_affine`` 2 × (B, 16) u16 = R affine (host-decoded). Returns ok (B,)
    bool: [s]B + [k](−A) == R.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if s_bits.device.type == "cpu":
        return verify_core_plain(s_bits, k_bits, neg_a, r_affine)
    if s_bits.device.type == "cuda":
        return verify_core_cuda(s_bits, k_bits, neg_a, r_affine)
    raise ValueError(f"unsupported device {s_bits.device}")


#: Kernel launches through the wrapper (the CPU path launches nothing), in
#: all and by lanes a signature: 1 the one-lane kernel, 2 the lane pairs.
verify_core.launches = 0
verify_core.launches_by_lanes = {1: 0, 2: 0}
verify_core.build_count = lambda: _build.build_count("ed25519_shamir")


def verify_core_windowed_cuda(b_idx, a_digits, neg_a, r_y, r_sign,
                              tab_p, tab_m, tab_td) -> torch.Tensor:
    """Launch the hand-written Hopper kernel B7 (windowed) on the current
    stream of the arguments' device, on the lanes a signature
    ``ed25519_windowed_lanes(n)`` picks; returns ok (B,) bool without
    synchronising. Raises when the kernel does not build or the launch is
    refused."""
    n = int(b_idx.shape[-1])
    limbs = (n, F.NLIMB)
    rows = (1 << B_WINDOW, F.NLIMB)
    args = (b_idx, a_digits, *neg_a, r_y, r_sign, tab_p, tab_m, tab_td)
    spec = (("b_idx", torch.int32, (16, n)),
            ("a_digits", torch.uint8, (16, 8, n)),
            *((f"neg_a[{j}]", torch.uint16, limbs) for j in range(4)),
            ("r_y", torch.uint16, limbs), ("r_sign", torch.uint8, (n,)),
            *((name, torch.uint16, rows)
              for name in ("tab_p", "tab_m", "tab_td")))
    if len(args) != 11:
        raise ValueError("neg_a takes 4 coordinates")
    cu.check_args(spec, args, b_idx.device)
    return _launch_by_lanes(load_windowed_kernel(), "ed25519_windowed", args,
                            n, b_idx.device, verify_core_windowed)


def verify_core_windowed(b_idx, a_digits, neg_a, r_y, r_sign,
                         tab_p, tab_m, tab_td, w: int = B_WINDOW
                         ) -> torch.Tensor:
    """Windowed verify: ``b_idx`` (16, B) i32 w = 16 windows of s;
    ``a_digits`` (16, 8, B) u8 2-bit digits of k; ``neg_a`` 4 × (B, 16)
    u16; ``r_y`` (B, 16) u16 wire y; ``r_sign`` (B,) u8; B's Niels table
    3 × (65536, 16) u16. Returns ok (B,) bool: compress([s]B + [k](−A)) ==
    the wire R. ``w``: the JAX function's B window, B_WINDOW only.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    cu.require_fixed("w", w, B_WINDOW)
    args = (b_idx, a_digits, neg_a, r_y, r_sign, tab_p, tab_m, tab_td)
    if b_idx.device.type == "cpu":
        return verify_core_windowed_plain(*args)
    if b_idx.device.type == "cuda":
        return verify_core_windowed_cuda(*args)
    raise ValueError(f"unsupported device {b_idx.device}")


#: Kernel launches through the wrapper (the CPU path launches nothing), in
#: all and by lanes a signature: 1 the one-lane kernel, 2 the lane pairs.
verify_core_windowed.launches = 0
verify_core_windowed.launches_by_lanes = {1: 0, 2: 0}
verify_core_windowed.build_count = lambda: _build.build_count(
    "ed25519_windowed")


def b7_to_device(arrays, device="cuda"):
    """A B7 prep's arrays (numpy, point coordinates as tuples) as the same
    structure of contiguous tensors on ``device``."""
    dev = resolve_device(device)

    def one(a):
        if isinstance(a, (tuple, list)):
            return tuple(one(c) for c in a)
        if isinstance(a, torch.Tensor):
            return a.to(dev).contiguous()
        a = np.asarray(a)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = np.array(a, order="C")
        return torch.from_numpy(a).to(dev)
    return tuple(one(a) for a in arrays)


def b7_flat(args) -> tuple:
    """A B7 prep's tensors (point coordinates as tuples) as the launchers
    take them: the coordinates spread out."""
    return tuple(t for a in args
                 for t in (a if isinstance(a, tuple) else (a,)))


# ---------------------------------------------------------------------------
# Host prep
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=65536)
def _decompress_a(pub: bytes):
    """Per-signer decompression cache: a node verifies the same signers'
    keys over and over."""
    return ecmath.ed_point_decompress(pub)


def _row_from_affine(A) -> np.ndarray:
    """Affine A → the split kernel's packed per-signer row: (−A, −A′) as two
    affine (x, y, t) limb triples in one (6, 16) u16 array, A′ = [2^128]A."""
    x, y = A
    ext = ecmath.ed_to_extended(A)
    for _ in range(128):
        ext = ecmath.ed_point_double(ext)
    zi = pow(ext[2], P - 2, P)
    x2, y2 = ext[0] * zi % P, ext[1] * zi % P
    nx, nx2 = (P - x) % P, (P - x2) % P
    vals = [nx, y, nx * y % P, nx2, y2, nx2 * y2 % P]
    return F.to_limbs(vals).astype(np.uint16)


@functools.lru_cache(maxsize=65536)
def _signer_row(pub: bytes):
    """Per-signer cache of the split kernel's (−A, −A′) limb row (None for
    an invalid key): a cold signer costs ~0.5 ms of host bigints once."""
    A = _decompress_a(pub)
    return None if A is None else _row_from_affine(A)


@functools.lru_cache(maxsize=1)
def _substitute_row() -> np.ndarray:
    """Row substituted for structurally-invalid items (the base point;
    verdict masked by precheck)."""
    return _row_from_affine(ecmath.ED_B)


def _pack_point_ext(pts) -> tuple:
    """Affine (x, y) points → extended-coordinate (X, Y, Z = 1, T = x·y)
    limb arrays, four (B, 16) u16 (canonical 16-bit limbs; the kernels
    widen them)."""
    xs = F.to_limbs([p[0] for p in pts]).astype(np.uint16)
    ys = F.to_limbs([p[1] for p in pts]).astype(np.uint16)
    zs = np.zeros_like(xs)
    zs[..., 0] = 1
    ts = F.to_limbs([p[0] * p[1] % P for p in pts]).astype(np.uint16)
    return (xs, ys, zs, ts)


def _precheck_items(items, decompress_r: bool):
    """The structural checks and scalar derivation of both B7 preps.
    ``decompress_r=True`` (Shamir) also decodes R as a point (a modular
    square root, ~0.3 ms of host bigints an item); the windowed kernel
    re-encodes its result instead, so its prep only range-checks the raw y.
    Failed items get A = R = B, s = k = 0 (verdict masked by precheck).
    Returns (precheck, A points, R points or None, R y ints, R sign bits,
    s scalars, k scalars)."""
    n = len(items)
    precheck = np.ones(n, dtype=bool)
    a_pts, r_pts, r_ys, r_signs, ss, ks = [], [], [], [], [], []
    for i, (pub, sig, msg) in enumerate(items):
        ok = len(sig) == 64
        R = None
        if ok:
            r_enc = int.from_bytes(sig[:32], "little")
            r_y = r_enc & ((1 << 255) - 1)
            r_sign = r_enc >> 255
            s = int.from_bytes(sig[32:], "little")
            A = _decompress_a(bytes(pub))
            # non-canonical y (>= p) rejects like a failed decompression
            ok = A is not None and r_y < P and s < ecmath.ED_L
            if ok and decompress_r:
                R = ecmath.ed_point_decompress(sig[:32])
                ok = R is not None
        if not ok:
            precheck[i] = False
            A, R, r_y, r_sign, s, k = ecmath.ED_B, ecmath.ED_B, 1, 0, 0, 0
        else:
            h = hashlib.sha512(sig[:32] + pub + msg).digest()
            k = int.from_bytes(h, "little") % ecmath.ED_L
        a_pts.append(A)
        r_pts.append(R)
        r_ys.append(r_y)
        r_signs.append(r_sign)
        ss.append(s)
        ks.append(k)
    return precheck, a_pts, r_pts, r_ys, r_signs, ss, ks


def prepare_batch(items: list[tuple[bytes, bytes, bytes]]):
    """Host prep for the Shamir kernel: (pub32, sig64, msg) triples →
    (s_bits (256, B) u8, k_bits (256, B) u8 MSB-first, neg_a 4 × (B, 16)
    u16, r_affine 2 × (B, 16) u16, precheck (B,) bool), numpy arrays
    byte-identical to the JAX package's."""
    precheck, a_pts, r_pts, _, _, ss, ks = _precheck_items(
        items, decompress_r=True)
    neg_a = _pack_point_ext([(P - x, y) for x, y in a_pts])
    rx = F.to_limbs([p[0] for p in r_pts]).astype(np.uint16)
    ry = F.to_limbs([p[1] for p in r_pts]).astype(np.uint16)
    return (F.scalars_to_bits(ss), F.scalars_to_bits(ks), neg_a, (rx, ry),
            precheck)


def prepare_batch_windowed(items: list[tuple[bytes, bytes, bytes]],
                           w: int = B_WINDOW, device_tables: bool = True,
                           device="cuda"):
    """Host prep for the windowed kernel: (pub32, sig64, msg) triples →
    (b_idx (256/w, B) i32 w-bit windows of s, a_digits (256/w, w/2, B) u8
    2-bit digits of k, neg_a 4 × (B, 16) u16, r_y (B, 16) u16 wire y,
    r_sign (B,) u8, [the Niels table on ``device``,] precheck (B,) bool),
    numpy arrays byte-identical to the JAX package's. w = 16 takes the
    native scalar prep when it is built; other widths (and a missing
    library) the Python windows. With ``device_tables=False`` the table is
    left out (mesh callers hold one copy per device)."""
    precheck, a_pts, _, r_ys, r_signs, ss, ks = _precheck_items(
        items, decompress_r=False)
    neg_a = _pack_point_ext([(P - x, y) for x, y in a_pts])
    r_y = F.to_limbs(r_ys).astype(np.uint16)
    r_sign = np.asarray(r_signs, dtype=np.uint8)
    if w == B_WINDOW and sp.available():
        # the k scalars are already reduced: feed them as 256-bit digests
        h_words = np.zeros((len(items), 8), dtype=np.uint64)
        h_words[:, :4] = sp.ints_to_words(ks)
        b_idx, a_flat, _ = sp.ed_prep_plain(h_words, sp.ints_to_words(ss))
        a_digits = a_flat.reshape(256 // w, w // 2, len(items))
    else:
        b_idx = _bits_to_w_windows(F.scalars_to_bits(ss), w).astype(
            np.int32)
        digs = _bits_to_windows(F.scalars_to_bits(ks)).astype(np.uint8)
        a_digits = digs.reshape(256 // w, w // 2, *digs.shape[1:])
    head = (b_idx, a_digits, neg_a, r_y, r_sign)
    if device_tables:
        return (*head, *b_table_device(w, 0, device), precheck)
    return (*head, precheck)


def prepare_batch_split(items: list[tuple[bytes, bytes, bytes]],
                        w: int = SPLIT_B_WINDOW, device_tables: bool = False,
                        staging=None):
    """Host prep for the split-k kernel: (pub32, sig64, msg) triples →
    (bb_idx (16,B) i32, a_packed (8,8,B) u8, rows (B,6,16) u16,
    r_packed (B,16) u16, precheck (B,) bool), as numpy arrays byte-identical
    to the JAX package's wire arrays with ``device_tables=False``: the B
    tables are the caller's (:func:`split_tables`), so True is refused.
    ``staging`` (ops.staging.StagingLease) supplies the reused (pinned) host
    buffer for ``rows``."""
    if w != SPLIT_B_WINDOW:
        raise ValueError("split prep emits 16-bit constant-base windows")
    cu.require_fixed("device_tables", device_tables, False)
    n = len(items)
    rows = (staging.take("ed.rows", (n, 6, F.NLIMB), np.uint16)
            if staging is not None
            else np.empty((n, 6, F.NLIMB), dtype=np.uint16))
    precheck = np.ones(n, dtype=bool)
    digests: list[bytes] = []
    sub = _substitute_row()
    sig_ok = np.fromiter((len(sig) == 64 for _, sig, _ in items),
                         dtype=bool, count=n)
    if sig_ok.all():
        sig_mat = np.frombuffer(b"".join(sig for _, sig, _ in items),
                                dtype=np.uint8).reshape(n, 64)
    else:
        sig_mat = np.zeros((n, 64), dtype=np.uint8)
        for i, (_, sig, _) in enumerate(items):
            if sig_ok[i]:
                sig_mat[i] = np.frombuffer(sig, dtype=np.uint8)
    for i, (pub, sig, msg) in enumerate(items):
        row = _signer_row(bytes(pub)) if sig_ok[i] else None
        if row is None:
            precheck[i] = False
            rows[i] = sub
            digests.append(bytes(64))   # k := 0 (verdict is masked anyway)
        else:
            rows[i] = row
            digests.append(hashlib.sha512(sig[:32] + pub + msg).digest())
    r_packed = sig_mat[:, :32].copy().view("<u2")       # (n, 16) wire y
    y15 = r_packed[:, 15] & 0x7FFF
    # non-canonical y (>= p = 2^255-19) rejects like a failed decompression
    ge_p = ((r_packed[:, 0] >= 0xFFED) & (y15 == 0x7FFF)
            & (r_packed[:, 1:15] == 0xFFFF).all(axis=1))
    precheck &= ~ge_p
    s_words = sig_mat[:, 32:].copy().view("<u8")        # (n, 4)
    if sp.available():
        h_words = sp.le_digests_to_words(digests, 8)
        b_idx, b2_idx, a_packed, s_ok = sp.ed_prep(h_words, s_words)
    else:
        b_idx, b2_idx, a_packed, s_ok = _split_windows_python(
            digests, s_words)
    precheck &= s_ok
    a_digits = a_packed.reshape(128 // w, w // 2, n)
    return (np.concatenate([b_idx, b2_idx]), a_digits, rows, r_packed,
            precheck)


def _split_windows_python(digests: list[bytes], s_words: np.ndarray):
    """Pure-Python version of scalarprep.ed_prep (bit-identical; used when
    libscalarmath cannot be built)."""
    n = len(digests)
    mask128 = (1 << 128) - 1
    s_ints = [int.from_bytes(s_words[i].tobytes(), "little")
              for i in range(n)]
    s_ok = np.array([s < ecmath.ED_L for s in s_ints], dtype=bool)
    ss = [s if ok else 0 for s, ok in zip(s_ints, s_ok)]
    ks = [int.from_bytes(d, "little") % ecmath.ED_L if ok else 0
          for d, ok in zip(digests, s_ok)]
    b_idx = _bits_to_w_windows(
        F.scalars_to_bits([s & mask128 for s in ss], 128), 16).astype(
            np.int32)
    b2_idx = _bits_to_w_windows(
        F.scalars_to_bits([s >> 128 for s in ss], 128), 16).astype(np.int32)
    klo = _bits_to_windows(F.scalars_to_bits([k & mask128 for k in ks], 128))
    khi = _bits_to_windows(F.scalars_to_bits([k >> 128 for k in ks], 128))
    a_packed = (klo | (khi << 2)).astype(np.uint8)
    return b_idx, b2_idx, a_packed, s_ok


# ---------------------------------------------------------------------------
# Batch entry points (the service path)
# ---------------------------------------------------------------------------

class PendingBatch:
    """An in-flight batch: the device verdicts, the host precheck, the live
    count, and (on CUDA) the event recorded behind the kernel."""

    __slots__ = ("ok", "precheck", "n", "event")

    def __init__(self, ok, precheck, n, event=None):
        self.ok = ok
        self.precheck = precheck
        self.n = n
        self.event = event


def verify_batch(items: list[tuple[bytes, bytes, bytes]],
                 device="cuda") -> np.ndarray:
    """Batched Ed25519 verify: [(pub32, sig64, msg)] → bool verdicts (B,).
    Pads the batch to a power-of-two bucket (replicating the last item)."""
    return finish_batch(verify_batch_async(items, device=device))


def verify_batch_async(items: list[tuple[bytes, bytes, bytes]],
                       device="cuda") -> PendingBatch:
    """Prep and launch without waiting: the device computes while the caller
    preps the next batch. The prepped host buffers are leased from the
    staging pool and copied with ``non_blocking=True`` on the current
    stream; the lease is released by ``finish_batch`` after the event
    recorded behind the kernel has completed. Launches go through the
    kernel flight recorder (observability.profiling)."""
    dev = resolve_device(device)
    n = len(items)
    if n == 0:
        return PendingBatch(None, np.zeros(0, dtype=bool), 0)
    padded = items + [items[-1]] * (F.bucket_size(n) - n)
    pool = get_staging_pool()
    lease = pool.lease()
    *wire, precheck = prepare_batch_split(padded, SPLIT_B_WINDOW,
                                          staging=lease)
    tables = split_tables(dev)
    cuda = dev.type == "cuda"
    args = wire_to_device(*wire, device=dev, non_blocking=cuda)
    prof = get_profiler()
    ok = prof.call("ed25519.split", verify_core_split,
                   *args, *tables, live=n, capacity=len(padded),
                   scheme="ed25519")
    event = None
    if cuda:
        ok_dev = ok
        ok = ok_dev.to("cpu", non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        prof.note_pending(ok, prof.pending_name(ok_dev, "ed25519.split"))
    pending = PendingBatch(ok, precheck, n, event)
    # the lease rides the pending handle: finish_batch releases it once the
    # event shows the copies out of the staged memory are done
    pool.attach(pending, lease)
    return pending


def finish_batch(pending: PendingBatch) -> np.ndarray:
    """Wait for a batch's verdicts (a GIL-releasing CUDA event wait), free
    its staging lease, and AND the verdicts with the host precheck."""
    if pending.n == 0:
        return np.zeros(0, dtype=bool)
    prof = get_profiler()
    name = prof.pending_name(pending.ok, "ed25519.split")
    t0 = _time.perf_counter()
    if pending.event is not None:
        try:
            pending.event.synchronize()
        except RuntimeError as exc:
            # the kernel (or a copy behind it) faulted on the card
            raise _build.LaunchError(
                f"ed25519_split_verify failed on the card: {exc}") from exc
    ok = pending.ok.numpy().astype(bool)
    prof.device_wait(name, _time.perf_counter() - t0)
    # the event completed → no copy reads the staged host buffers any more
    # (on a failed wait the lease stays attached and is evicted, never
    # reused — a crash cannot corrupt a later batch)
    get_staging_pool().release_for(pending)
    return (ok & pending.precheck)[:pending.n]
