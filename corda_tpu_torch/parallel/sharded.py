"""Mesh-sharded device verification over a list of devices (B9).

Port of corda_tpu/parallel/sharded.py. The reference runs one SPMD program
(``shard_map``) over a JAX ``Mesh`` of chips; here one process and one host
thread issue to every shard of a :class:`Mesh` — an ordered tuple of
``torch.device``s, each shard with a CUDA stream the mesh owns:

- signature verification is embarrassingly parallel → every batch-axis
  argument is cut into ``mesh.size`` contiguous slices, each copied to its
  shard's device and verified there by the scheme's kernel (B2-B4, B7, B8)
  on the shard's stream, with the constant tables replicated once per
  device; the verdicts are gathered onto ``mesh.devices[0]`` in shard order;
- Merkle rooting is a reduction → each shard roots its contiguous slice of
  leaves (B6), the local roots are gathered onto ``mesh.devices[0]`` (a
  device-to-device copy of 32 bytes a shard, after an event wait on each
  shard's stream) and the top log2(size) levels are one more root there.

Several shards may sit on one device (on a card: several streams of one
card); the tests run ``[torch.device("cpu")] * 4``, where the shards run
one after the other on the plain versions. The callables return without
synchronising; the batch-level wrappers (``sharded_verify_batch_*``)
resolve synchronously. Multi-process meshes (``torch.distributed``) are not
part of this module.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import _build
from ..device import resolve_device
from ..ops import ed25519 as ed_ops
from ..ops import field as F
from ..ops import sha256 as sha_ops
from ..ops import weierstrass as wc_ops
from ..ops.staging import get_staging_pool


class Mesh:
    """An ordered tuple of devices (``devices``), one shard each, with a
    CUDA stream per shard owned by the mesh (``streams``; None on the
    CPU). ``size`` is the number of shards."""

    def __init__(self, devices):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.streams = tuple(torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible "
                           "(torch.cuda.is_available() is False); pass "
                           "devices= to build a mesh of other devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device; raises without CUDA unless ``devices`` is given)."""
    if devices is None:
        devices = _visible_devices()
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def shard_devices(n_shards: int, devices=None) -> list:
    """Contiguous split of the devices (default: the visible CUDA devices)
    into ``n_shards`` non-empty groups. Remainder devices go to the LOW
    shards, so capacities differ by at most one."""
    if devices is None:
        devices = _visible_devices()
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > len(devices):
        raise ValueError(f"need {n_shards} devices for {n_shards} shards, "
                         f"have {len(devices)}")
    base, extra = divmod(len(devices), n_shards)
    out, i = [], 0
    for s in range(n_shards):
        k = base + (1 if s < extra else 0)
        out.append(list(devices[i:i + k]))
        i += k
    return out


def make_shard_mesh(shard_index: int, n_shards: int, devices=None) -> Mesh:
    """Mesh over group ``shard_index`` of :func:`shard_devices` — a fleet
    worker's private mesh."""
    shards = shard_devices(n_shards, devices)
    if not 0 <= shard_index < n_shards:
        raise ValueError(f"shard_index {shard_index} out of range "
                         f"[0, {n_shards})")
    return make_mesh(devices=shards[shard_index])


def _check_batch(b: int, mesh: Mesh, what: str) -> None:
    n = mesh.size
    if b % n:
        raise ValueError(f"{what} batch {b} not divisible by mesh size {n} "
                         "(pad to a bucket first)")


def _pad_to_mesh_bucket(n: int, mesh: Mesh) -> int:
    """Bucket size that is mesh-divisible with a power-of-two per-shard
    count: pow2(ceil(n/d))·d, for any device count."""
    d = mesh.size
    return F.bucket_size(-(-n // d)) * d


# ---------------------------------------------------------------------------
# Shard machinery: split, issue on each shard's stream, gather
# ---------------------------------------------------------------------------

def _on_shard(stream):
    """The shard's stream (and its device) as the current one on CUDA;
    nothing on the CPU."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _join_callers(mesh: Mesh) -> None:
    """Order every shard stream after the caller's current stream on its
    device, so inputs the caller produced there are complete."""
    for dev, stream in zip(mesh.devices, mesh.streams):
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))


def _slice_to(x, axis: int, start: int, length: int, dev, stream):
    """``x[..., start:start + length, ...]`` along ``axis`` as a contiguous,
    16-byte-aligned tensor on ``dev`` (issued on the current stream, which
    is the shard's)."""
    if isinstance(x, torch.Tensor):
        part = x.narrow(axis, start, length).to(dev, non_blocking=True)
        part = part.contiguous()
        if part.device.type == "cuda":
            if part.data_ptr() % 16:
                part = part.clone()
            part.record_stream(stream)
        return part
    idx = [slice(None)] * np.ndim(x)
    idx[axis] = slice(start, start + length)
    host = np.ascontiguousarray(np.asarray(x)[tuple(idx)])
    if not host.flags.writeable:
        host = host.copy()
    return torch.from_numpy(host).to(dev, non_blocking=True)


def _split_args(args, specs, start, length, dev, stream):
    """Slice every argument by its spec: an int is the batch axis of an
    array; a tuple of ints, the axes of a tuple of arrays."""
    out = []
    for a, spec in zip(args, specs):
        if isinstance(spec, tuple):
            out.append(tuple(_slice_to(c, ax, start, length, dev, stream)
                             for c, ax in zip(a, spec)))
        else:
            out.append(_slice_to(a, spec, start, length, dev, stream))
    return out


def _gather(mesh: Mesh, parts: list, stack: bool = False) -> torch.Tensor:
    """The shards' results on ``mesh.devices[0]``, concatenated (or stacked)
    in shard order, ordered on that device's current stream after every
    shard's work: each part is copied there on its shard's stream, then an
    event recorded behind the copy is waited on."""
    dev0 = mesh.devices[0]
    moved = []
    for part, stream in zip(parts, mesh.streams):
        if stream is None:
            moved.append(part.to(dev0))
            continue
        with torch.cuda.stream(stream):
            m = part.to(dev0, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        if dev0.type == "cuda":
            cur0 = torch.cuda.current_stream(dev0)
            cur0.wait_event(ev)
            m.record_stream(cur0)
        else:
            ev.synchronize()
        moved.append(m)
    with (torch.cuda.device(dev0) if dev0.type == "cuda"
          else contextlib.nullcontext()):
        return torch.stack(moved) if stack else torch.cat(moved)


class _Sharded:
    """A kernel dispatcher sharded over ``mesh``: ``fn(*batch_args)``
    slices each argument along its axis in ``specs``, runs
    ``kernel(*shard_args, *tables(dev))`` on each shard's stream and
    gathers the verdicts. ``build_count`` is the kernel's, for the flight
    recorder."""

    def __init__(self, mesh: Mesh, kernel, specs, what: str, counter,
                 tables=None):
        self.mesh = mesh
        self.kernel = kernel
        self.specs = specs
        self.what = what
        self.counter = counter
        self.tables = tables

    def build_count(self) -> int:
        return self.counter.build_count()

    def __call__(self, *args):
        if len(args) != len(self.specs):
            raise TypeError(f"{self.what}: expected {len(self.specs)} "
                            f"arguments, got {len(args)}")
        first, axis = args[0], self.specs[0]
        b = int(first.shape[axis])
        _check_batch(b, self.mesh, self.what)
        per = b // self.mesh.size
        _join_callers(self.mesh)
        parts = []
        for k, (dev, stream) in enumerate(zip(self.mesh.devices,
                                              self.mesh.streams)):
            with _on_shard(stream):
                shard_args = _split_args(args, self.specs, k * per, per, dev,
                                         stream)
                tabs = self.tables(dev) if self.tables is not None else ()
                parts.append(self.kernel(*shard_args, *tabs))
        return _gather(self.mesh, parts)


def sharded_ed25519_verify(mesh: Mesh):
    """Batch-sharded Ed25519 verify over the Shamir kernel (B7): returns
    fn(s_bits (256, B), k_bits (256, B), neg_a 4 × (B, 16),
    r_affine 2 × (B, 16)) → ok (B,) bool on ``mesh.devices[0]`` (the
    layout of ops.ed25519.prepare_batch)."""
    return _Sharded(mesh, ed_ops.verify_core, (1, 1, (0,) * 4, (0,) * 2),
                    "ed25519", ed_ops.verify_core)


def sharded_ed25519_verify_windowed(mesh: Mesh):
    """Batch-sharded Ed25519 verify over the windowed constant-B kernel
    (B7): returns fn(b_idx (16, B), a_digits (16, 8, B), neg_a 4 × (B, 16),
    r_y (B, 16), r_sign (B,)) → ok (B,) bool (the layout of
    ops.ed25519.prepare_batch_windowed with ``device_tables=False``); the
    Niels table is one cached copy per mesh device."""
    return _Sharded(mesh, ed_ops.verify_core_windowed,
                    (1, 2, (0,) * 4, 0, 0), "ed25519 windowed",
                    ed_ops.verify_core_windowed, ed_ops.windowed_table)


def sharded_ed25519_verify_split(mesh: Mesh):
    """Batch-sharded Ed25519 verify over the split-k kernel (B2): returns
    fn(bb_idx (16, B), a_packed (8, 8, B), rows (B, 6, 16),
    r_packed (B, 16)) → ok (B,) bool (the layout of
    ops.ed25519.prepare_batch_split); both Niels tables one cached copy
    per mesh device."""
    return _Sharded(mesh, ed_ops.verify_core_split, (1, 2, 0, 0),
                    "ed25519 split", ed_ops.verify_core_split,
                    ed_ops.split_tables)


def sharded_ecdsa_verify(mesh: Mesh, curve_name: str):
    """Batch-sharded ECDSA verify over the Shamir kernel (B8): returns
    fn(u1_bits (256, B), u2_bits (256, B), q_pts 3 × (B, 16),
    r_cands (2, B, 16)) → ok (B,) bool (the reference's layout: Q as its
    (X, Y, Z) triple, which ops.weierstrass.prepare_batch stacks)."""
    wc_ops._curve_of(curve_name)

    def kernel(u1, u2, q, rc):
        return wc_ops.verify_core(u1, u2, torch.stack(q), rc, curve_name)
    return _Sharded(mesh, kernel, (1, 1, (0,) * 3, 1), curve_name,
                    wc_ops.verify_core)


def sharded_ecdsa_verify_hybrid(mesh: Mesh):
    """Batch-sharded secp256k1 verify over the hybrid GLV kernel (B3):
    returns fn(g_idx (16, B), q_bits (16, 4, B), pts (B, 4, 16),
    r_limbs (B, 16)) → ok (B,) bool (the layout of
    ops.weierstrass.prepare_batch_hybrid_wide); the G table one cached copy
    per mesh device."""
    return _Sharded(mesh, wc_ops.verify_core_hybrid_wide, (1, 2, 0, 0),
                    "secp256k1 hybrid", wc_ops.verify_core_hybrid_wide,
                    wc_ops.hybrid_tables)


def sharded_ecdsa_verify_r1_split(mesh: Mesh):
    """Batch-sharded secp256r1 verify over the half-gcd split kernel (B4):
    returns fn(g_idx (8, 2, B), q_digits (8, 4, B), Q = (q_x, q_y) 2 × (B,
    16), xd_limbs (B, 16)) → ok (B,) bool (the layout of
    ops.weierstrass.prepare_batch_r1_split with Q paired); the G and G′
    tables one cached copy per mesh device."""
    def kernel(g_idx, q_digits, q, xd, *tabs):
        return wc_ops.verify_core_r1_split(g_idx, q_digits, *q, xd, *tabs)
    return _Sharded(mesh, kernel, (2, 2, (0, 0), 0), "secp256r1 split",
                    wc_ops.verify_core_r1_split, wc_ops.r1_split_tables)


def _merkle_shapes(n: int, mesh: Mesh) -> None:
    d = mesh.size
    if n < 1 or n & (n - 1):
        raise ValueError(f"sharded_merkle_root needs a power-of-two leaf "
                         f"count, got {n}")
    _check_batch(n, mesh, "merkle")
    per = n // d
    if per & (per - 1):
        raise ValueError(f"{n} leaves over {d} shards leave {per} a shard, "
                         "not a power of two")


def _sharded_root(mesh: Mesh, leaves) -> torch.Tensor:
    """Local roots per shard (B6 on each shard's stream), gathered onto
    ``mesh.devices[0]``, then the top log2(size) levels there."""
    words = leaves if isinstance(leaves, torch.Tensor) else np.asarray(
        leaves, dtype=np.uint32)
    n = int(words.shape[0])
    _merkle_shapes(n, mesh)
    per = n // mesh.size
    _join_callers(mesh)
    parts = []
    for k, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
        with _on_shard(stream):
            shard = _slice_to(words, 0, k * per, per, dev, stream)
            parts.append(sha_ops.merkle_root(shard))
    roots = _gather(mesh, parts, stack=True)          # (size, 8)
    if mesh.size == 1:
        return roots[0]
    return sha_ops.merkle_root(roots)


def sharded_merkle_root(mesh: Mesh):
    """Returns fn: (N, 8) u32 leaf digests (N a power of two, N/size a power
    of two) → (8,) int32 root words on ``mesh.devices[0]``: the exact
    binary tree of MerkleTree.kt:27-66 re-associated shard-first."""
    def root(leaves):
        return _sharded_root(mesh, leaves)
    return root


def tx_verify_step(mesh: Mesh):
    """One batch of transaction work — Ed25519 checks (Shamir, B7,
    batch-sharded) and a Merkle root over the leaves (B6, leaf-sharded) —
    issued together. Returns fn(s_bits, k_bits, neg_a, r_affine, leaves) →
    (ok (B,), root (8,)), both on ``mesh.devices[0]``."""
    verify = sharded_ed25519_verify(mesh)

    def step(s_bits, k_bits, neg_a, r_affine, leaves):
        ok = verify(s_bits, k_bits, neg_a, r_affine)
        return ok, _sharded_root(mesh, leaves)
    return step


# ---------------------------------------------------------------------------
# Batch-level wrappers (the SignatureBatcher's mesh backend)
# ---------------------------------------------------------------------------

def _profiler():
    from ..observability.profiling import get_profiler
    return get_profiler()


def _forced(ok: torch.Tensor) -> np.ndarray:
    """Wait for a sharded dispatch's verdicts on the host, booking the wait
    in the flight recorder against the kernel prof.call attributed to
    ``ok``."""
    prof = _profiler()
    name = prof.pending_name(ok, "sharded")
    t0 = time.perf_counter()
    try:
        out = ok.cpu().numpy().astype(bool)
    except RuntimeError as exc:
        # a kernel (or a copy behind it) faulted on a card of the mesh
        raise _build.LaunchError(f"{name} failed on the card: {exc}") from exc
    prof.device_wait(name, time.perf_counter() - t0)
    return out


def sharded_verify_batch_ed25519(mesh: Mesh, items) -> np.ndarray:
    """[(pub32, sig64, msg)] → bool verdicts (B,), the batch sharded over
    ``mesh`` on the split-k kernel (ops.ed25519.verify_batch semantics,
    ``mesh.size`` shards instead of one device)."""
    n = len(items)
    if n == 0:
        return np.zeros(0, dtype=bool)
    padded = items + [items[-1]] * (_pad_to_mesh_bucket(n, mesh) - n)
    *args, precheck = ed_ops.prepare_batch_split(padded,
                                                 ed_ops.SPLIT_B_WINDOW)
    fn = sharded_ed25519_verify_split(mesh)
    ok = _forced(_profiler().call("sharded.ed25519", fn, *args, live=n,
                                  capacity=len(padded), scheme="ed25519"))
    return (ok & precheck)[:n]


def sharded_verify_batch_secp256k1(mesh: Mesh, items) -> np.ndarray:
    """[(pub_point, msg, r, s)] → bool verdicts (B,) via the hybrid GLV
    kernel, the batch sharded over ``mesh``."""
    n = len(items)
    if n == 0:
        return np.zeros(0, dtype=bool)
    padded = items + [items[-1]] * (_pad_to_mesh_bucket(n, mesh) - n)
    *args, precheck = wc_ops.prepare_batch_hybrid_wide(padded)
    fn = sharded_ecdsa_verify_hybrid(mesh)
    ok = _forced(_profiler().call("sharded.hybrid_k1", fn, *args, live=n,
                                  capacity=len(padded), scheme="secp256k1"))
    return (ok & precheck)[:n]


def sharded_verify_batch_secp256k1_words(mesh: Mesh, e_words, r_words,
                                         s_words, pub_words) -> np.ndarray:
    """Word-form sibling of :func:`sharded_verify_batch_secp256k1`: inputs
    are the native preps' (B, ·) LE u64 rows (the batcher's cached ECDSA
    prep). Requires wc_ops.words_prep_available."""
    n = len(e_words)
    if n == 0:
        return np.zeros(0, dtype=bool)
    capacity = _pad_to_mesh_bucket(n, mesh)
    # padded rows go through reused staging buffers; the resolve is
    # synchronous, so the lease returns right after it (dropped, never
    # recycled, if the dispatch raises mid-flight)
    lease = get_staging_pool().lease()
    e_words, r_words, s_words, pub_words = wc_ops.pad_word_rows(
        (e_words, r_words, s_words, pub_words), capacity, staging=lease,
        tags=("mesh.k1.e", "mesh.k1.r", "mesh.k1.s", "mesh.k1.pub"))
    *args, precheck = wc_ops._prepare_hybrid_native_words(
        e_words, r_words, s_words, pub_words)
    fn = sharded_ecdsa_verify_hybrid(mesh)
    ok = _forced(_profiler().call("sharded.hybrid_k1", fn, *args, live=n,
                                  capacity=capacity, scheme="secp256k1"))
    lease.release()
    return (ok & precheck)[:n]


def sharded_verify_batch_secp256r1_words(mesh: Mesh, e_words, r_words,
                                         s_words, pub_words) -> np.ndarray:
    """Word-form secp256r1 mesh entry (the batcher's r1 bucket): native
    half-gcd prep on the host, device verdicts sharded, the per-item host
    verdicts of the fallbacks OR-ed back in as finish_batch does. Requires
    wc_ops.words_prep_available."""
    n = len(e_words)
    if n == 0:
        return np.zeros(0, dtype=bool)
    capacity = _pad_to_mesh_bucket(n, mesh)
    lease = get_staging_pool().lease()  # see the secp256k1 words entry
    e_words, r_words, s_words, pub_words = wc_ops.pad_word_rows(
        (e_words, r_words, s_words, pub_words), capacity, staging=lease,
        tags=("mesh.r1.e", "mesh.r1.r", "mesh.r1.s", "mesh.r1.pub"))
    (g_idx, q_digits, q_x, q_y, xd, precheck,
     forced) = wc_ops._prepare_r1_split_native_words(
        e_words, r_words, s_words, pub_words)
    fn = sharded_ecdsa_verify_r1_split(mesh)
    ok = _forced(_profiler().call("sharded.r1_split", fn, g_idx, q_digits,
                                  (q_x, q_y), xd, live=n, capacity=capacity,
                                  scheme="secp256r1"))
    lease.release()
    return ((ok & precheck) | forced)[:n]
