"""Batched Ed25519 signature verification: the split-k path (kernel B2).

Port of the split path of corda_tpu/ops/ed25519.py. Host/device split:

- host: per-signer (−A, −A′) rows from a decompression + [2^128]A cache,
  SHA-512 challenges (hashlib), scalar windows from native scalarmath
  (Python fallback bit-identical), range checks, limb packing into pinned
  staging buffers;
- device: [s_lo]B + [s_hi]B′ + [k_lo](−A) + [k_hi](−A′) over 128-bit scalar
  halves with two constant Niels tables (B and B′ = [2^128]B), then RFC 8032
  re-encoding acceptance against the wire R.

``verify_core_split`` is the kernel's wrapper: for tensors on the CPU it runs
the plain PyTorch version (``verify_core_split_plain``, 16-bit limbs in
int64 lanes); for CUDA tensors it launches the hand-written kernel
``csrc/ed25519_split.cu`` (built at first use) or raises — it never falls
back. ``verify_core_split.launches`` counts the kernel launches.

Verification equation: accept iff [s]B == R + [k]A ⟺ [s]B + [k](−A) == R,
compared by re-encoding the computed point (canonical y and x's parity).
"""
from __future__ import annotations

import ctypes
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


@functools.lru_cache(maxsize=1)
def load_kernel():
    """The split-k kernel's library, built from ``csrc/`` at first use.
    Raises :class:`BuildError` when it cannot be built."""
    lib = _build.load("ed25519_split")
    lib.ed25519_split_verify.restype = ctypes.c_int
    lib.ed25519_split_verify.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int64, ctypes.c_void_p]
    lib.ed25519_split_error_string.restype = ctypes.c_char_p
    lib.ed25519_split_error_string.argtypes = [ctypes.c_int]
    return lib


_WIRE_SPEC = (("bb_idx", torch.int32), ("a_packed", torch.uint8),
              ("rows", torch.uint16), ("r_packed", torch.uint16))


def _check_cuda_args(args, n: int, device: torch.device) -> None:
    shapes = ((16, n), (8, 8, n), (n, 6, F.NLIMB), (n, F.NLIMB))
    for (name, dtype), shape, t in zip(_WIRE_SPEC, shapes, args[:4]):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for k, t in enumerate(args[4:]):
        if t.dtype != torch.uint16 or tuple(t.shape) != (65536, F.NLIMB):
            raise ValueError(f"table {k}: expected uint16 (65536, 16), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in args:
        if t.device != device:
            raise ValueError(f"all arguments must be on {device}, got "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("arguments must be contiguous and 16-byte "
                             "aligned")


def verify_core_split_cuda(bb_idx, a_packed, rows, r_packed,
                           tab_p, tab_m, tab_td, tab2_p, tab2_m, tab2_td
                           ) -> torch.Tensor:
    """Launch the hand-written Hopper kernel on the current stream of the
    arguments' device; returns ok (B,) bool without synchronising. Raises
    when the kernel does not build or the launch is refused."""
    args = (bb_idx, a_packed, rows, r_packed,
            tab_p, tab_m, tab_td, tab2_p, tab2_m, tab2_td)
    device = bb_idx.device
    n = int(bb_idx.shape[-1])
    _check_cuda_args(args, n, device)
    lib = load_kernel()
    ok = torch.empty(n, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ed25519_split_verify(*(t.data_ptr() for t in args),
                                      ok.data_ptr(), n, stream)
    if rc != 0:
        msg = lib.ed25519_split_error_string(rc).decode()
        raise _build.LaunchError(f"ed25519_split_verify launch failed: "
                                 f"{msg} (cudaError {rc})")
    with _LAUNCH_LOCK:
        verify_core_split.launches += 1
    return ok


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


#: Kernel launches through the wrapper (the CPU path launches nothing).
verify_core_split.launches = 0
verify_core_split.build_count = lambda: _build.build_count("ed25519_split")


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


def prepare_batch_split(items: list[tuple[bytes, bytes, bytes]],
                        w: int = SPLIT_B_WINDOW, staging=None):
    """Host prep for the split-k kernel: (pub32, sig64, msg) triples →
    (bb_idx (16,B) i32, a_packed (8,8,B) u8, rows (B,6,16) u16,
    r_packed (B,16) u16, precheck (B,) bool), as numpy arrays byte-identical
    to the JAX package's wire arrays. ``staging`` (ops.staging.StagingLease)
    supplies the reused (pinned) host buffer for ``rows``."""
    if w != SPLIT_B_WINDOW:
        raise ValueError("split prep emits 16-bit constant-base windows")
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
