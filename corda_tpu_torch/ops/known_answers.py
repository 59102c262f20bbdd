"""Known answers for freshly loaded signature kernels (B2, B3, B4, B5, both
B7 kernels, both B8 kernels).

The kernels are compiled at first use by the toolkit of the machine that runs
them. Before such a library gives its first verdict in a process, a fixed
batch runs through every kernel behind its launcher (B2 and both B7 kernels
on one lane and on lane pairs, B3, B4 and B8 GLV on lane pairs, B5 and B8
Shamir on lane pairs for each curve) and through the kernel's plain PyTorch
version on the CPU. The
batch holds valid signatures, tampered ones, and items whose host precheck
fails, whose wire rows the prep zeroes or fills with placeholders (and for
B3 and B5 signatures whose x(R) = r + n, for B5 and B8 keys G and -G). The
raw verdicts (before the precheck mask) must agree on every row, or the library
is refused with :class:`BuildError`. The lane-pair kernels run on the Comba
field, which was exact in every build tried; large one-thread kernels on the
same field were miscompiled in some builds for a reason not yet found
(PERF.md §7), so no build gives verdicts unchecked.

The batches are made from fixed seeds with the package's own signing code.
"""
from __future__ import annotations

import functools
import hashlib

import torch

from .. import _build
from ..core.crypto import ecmath
from . import ed25519 as ed
from . import weierstrass as wc


def _seeded(tag: bytes, i: int) -> bytes:
    return hashlib.sha256(tag + i.to_bytes(4, "little")).digest()


#: Kinds of the Ed25519 batch, in order: valid, a flipped s bit, a flipped
#: message bit, the wrong key, s >= L, a flipped R sign bit, R y >= p, an
#: undecodable key, an undecodable R (y = 2), a short signature, valid.
ED_KINDS = 11


@functools.lru_cache(maxsize=1)
def ed25519_items() -> tuple:
    """Two rounds of the ED_KINDS kinds: 22 (pub, sig, msg) items."""
    items = []
    for i in range(2 * ED_KINDS):
        sk = _seeded(b"ed25519 key", i)
        pub = ecmath.ed25519_public_key(sk)
        msg = _seeded(b"ed25519 message", i)[:20 + i % 13]
        sig = ecmath.ed25519_sign(sk, msg, pub)
        kind = i % ED_KINDS
        if kind == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif kind == 2:
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
        elif kind == 3:
            pub = ecmath.ed25519_public_key(_seeded(b"ed25519 other", i))
        elif kind == 4:
            s = int.from_bytes(sig[32:], "little") + ecmath.ED_L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 5:
            sig = sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:]
        elif kind == 6:
            sig = (2**255 - 10).to_bytes(32, "little") + sig[32:]
        elif kind == 7:
            pub = b"\xff" * 32
        elif kind == 8:
            sig = (2).to_bytes(32, "little") + sig[32:]
        elif kind == 9:
            sig = sig[:63]
        items.append((pub, sig, msg))
    return tuple(items)


def _ecdsa_items(curve, tag: bytes) -> list:
    """(pub, msg, r, s) items of ``curve``: four valid signatures; the
    first one tampered (message, s) and with a failing precheck (no key,
    an off-curve key, r = 0, r >= n, s = 0, high s); valid signatures
    under the keys G and -G (G + Q = 2G, and the point at infinity)."""
    items = []
    for i, priv in enumerate([int.from_bytes(_seeded(tag + b" key", i), "big")
                              % (curve.n - 1) + 1 for i in range(4)]
                             + [1, curve.n - 1]):
        msg = _seeded(tag + b" message", i)
        items.append((curve.mul(priv, curve.g), msg,
                      *ecmath.ecdsa_sign(curve, priv, msg)))
    pub, msg, r, s = items[0]
    items += [(pub, msg + b"!", r, s),
              (pub, msg, r, s * 3 % curve.n),
              (None, msg, r, s),
              ((pub[0], (pub[1] + 1) % curve.p), msg, r, s),
              (pub, msg, 0, s),
              (pub, msg, r + curve.n, s),
              (pub, msg, r, 0),
              (pub, msg, r, curve.n - s)]
    return items


def _crafted_rn(curve, tag: bytes, valid: bool) -> tuple:
    """A signature whose R has x(R) = r + n < p, which honest signing
    reaches with negligible odds: R is chosen first (the least x above n
    with a point) and the key solved for, Q = r^-1 (s R - e G); the s of
    an invalid one is off by one."""
    p, n = curve.p, curve.n
    x = n + 1
    while pow((x ** 3 + curve.a * x + curve.b) % p, (p - 1) // 2, p) != 1:
        x += 1
    y = pow((x ** 3 + curve.a * x + curve.b) % p, (p + 1) // 4, p)
    msg = _seeded(tag + b" crafted", 0)
    r = x - n
    s = int.from_bytes(_seeded(tag + b" crafted s", 0), "big") % (n // 2) + 1
    e = ecmath._bits2int(hashlib.sha256(msg).digest(), n) % n
    Q = curve.mul(pow(r, n - 2, n), curve.add(curve.mul(s, (x, y)),
                                              curve.mul(n - e, curve.g)))
    return (Q, msg, r, s if valid else s + 1)


@functools.lru_cache(maxsize=1)
def r1_items() -> tuple:
    """secp256r1 items of :func:`_ecdsa_items`."""
    return tuple(_ecdsa_items(ecmath.SECP256R1, b"p256"))


@functools.lru_cache(maxsize=1)
def k1_items() -> tuple:
    """secp256k1 items of :func:`_ecdsa_items`, then a valid and an
    invalid signature with x(R) = r + n (rn_ok set: B3 and B5 accept the
    valid one through their r + n candidate)."""
    curve = ecmath.SECP256K1
    return tuple(_ecdsa_items(curve, b"k1")
                 + [_crafted_rn(curve, b"k1", True),
                    _crafted_rn(curve, b"k1", False)])


def _held(target: str, what: str, got: torch.Tensor,
          want: torch.Tensor) -> None:
    bad = int((got.cpu() != want).sum())
    if bad:
        raise _build.BuildError(
            f"{target}: the built kernel ({what}) disagrees with its plain "
            f"version on {bad} of {want.numel()} known-answer rows; the "
            "library is not used")


def check_ed25519_split(launch, device) -> None:
    """Hold B2 against its plain version on :func:`ed25519_items`:
    ``launch(args, n, lanes)`` runs the kernel on ``lanes`` lanes a
    signature and returns its raw verdicts; raises BuildError on any
    difference."""
    items = ed25519_items()
    *wire, _ = ed.prepare_batch_split(list(items))
    tabs = ed.split_tables(device)
    want = ed.verify_core_split_plain(
        *ed.wire_to_device(*wire, device="cpu"), *(t.cpu() for t in tabs))
    args = (*ed.wire_to_device(*wire, device=device), *tabs)
    for lanes in (1, 2):
        _held("ed25519_split", f"{lanes} lane(s) a signature",
              launch(args, len(items), lanes), want)


def check_r1_split(launch, device) -> None:
    """Hold B4 against its plain version on :func:`r1_items`:
    ``launch(args, n)`` returns the kernel's raw verdicts; raises
    BuildError on any difference."""
    items = r1_items()
    *wire, _, _ = wc.prepare_batch_r1_split(ecmath.SECP256R1, list(items))
    tabs = wc.r1_split_tables(device)
    want = wc.verify_core_r1_split_plain(
        *wc.wire_to_device(wire, "cpu"), *(t.cpu() for t in tabs))
    args = (*wc.wire_to_device(wire, device), *tabs)
    _held("secp256r1_split", "lane pairs", launch(args, len(items)), want)


def check_hybrid(launch, device) -> None:
    """Hold B3 against its plain version on :func:`k1_items`:
    ``launch(args, n)`` returns the kernel's raw verdicts; raises
    BuildError on any difference."""
    items = k1_items()
    *wire, _ = wc.prepare_batch_hybrid_wide(list(items))
    tabs = wc.hybrid_tables(device)
    want = wc.verify_core_hybrid_wide_plain(
        *wc.wire_to_device(wire, "cpu"), *(t.cpu() for t in tabs))
    args = (*wc.wire_to_device(wire, device), *tabs)
    _held("secp256k1_hybrid", "lane pairs", launch(args, len(items)), want)


def check_shamir(launch, device) -> None:
    """Hold B8 (Shamir) against its plain version on :func:`k1_items` and
    :func:`r1_items`: ``launch(args, n, curve_id)`` runs the kernel of the
    curve and returns its raw verdicts; raises BuildError on any
    difference."""
    for curve_id, (curve, items) in enumerate(
            ((ecmath.SECP256K1, k1_items()), (ecmath.SECP256R1, r1_items()))):
        *wire, _ = wc.prepare_batch(curve, list(items))
        want = wc.verify_core_plain(*wc.wire_to_device(wire, "cpu"),
                                    curve.name)
        args = wc.wire_to_device(wire, device)
        _held("weierstrass_shamir", f"{curve.name}, lane pairs",
              launch(args, len(items), curve_id), want)


def _check_b7(target: str, wire, plain, tabs, launch, device) -> None:
    """Hold both kernels of a B7 library (``launch(args, n, lanes)``, its
    raw verdicts on ``lanes`` lanes a signature) against ``plain`` on a
    prep's ``wire`` arrays of :func:`ed25519_items`, the launcher's
    pointers the wire's tensors with point coordinates spread out, then
    ``tabs``; raises BuildError on any difference."""
    cpu = ed.b7_to_device(wire, "cpu")
    want = plain(*cpu, *(t.cpu() for t in tabs))
    args = (*(t.to(device) for t in ed.b7_flat(cpu)), *tabs)
    for lanes in (1, 2):
        _held(target, f"{lanes} lane(s) a signature",
              launch(args, wire[0].shape[-1], lanes), want)


def check_ed25519_shamir(launch, device) -> None:
    """Hold B7 Shamir's kernels against their plain version on
    :func:`ed25519_items` (:func:`_check_b7`)."""
    *wire, _ = ed.prepare_batch(list(ed25519_items()))
    _check_b7("ed25519_shamir", wire, ed.verify_core_plain, (), launch,
              device)


def check_ed25519_windowed(launch, device) -> None:
    """Hold B7 windowed's kernels against their plain version on
    :func:`ed25519_items` (:func:`_check_b7`)."""
    *wire, _ = ed.prepare_batch_windowed(list(ed25519_items()),
                                         device_tables=False)
    _check_b7("ed25519_windowed", wire, ed.verify_core_windowed_plain,
              ed.windowed_table(device), launch, device)


def check_glv(launch, device) -> None:
    """Hold B8 GLV against its plain version on :func:`k1_items`:
    ``launch(args, n)`` returns the kernel's raw verdicts; raises
    BuildError on any difference."""
    items = k1_items()
    *wire, _ = wc.prepare_batch_glv(list(items))
    want = wc.verify_core_glv_plain(*wc.wire_to_device(wire, "cpu"))
    args = wc.wire_to_device(wire, device)
    _held("secp256k1_glv", "lane pairs", launch(args, len(items)), want)


def check_windowed(launch, device) -> None:
    """Hold B5 against its plain version on :func:`k1_items` and
    :func:`r1_items`: ``launch(args, n, curve_id)`` runs the kernel of the
    curve and returns its raw verdicts; raises BuildError on any
    difference."""
    for curve_id, (curve, items) in enumerate(
            ((ecmath.SECP256K1, k1_items()), (ecmath.SECP256R1, r1_items()))):
        *wire, _ = wc.prepare_batch_windowed_single(curve, list(items))
        tabs = wc.windowed_tables(curve, device)
        want = wc.verify_core_windowed_single_plain(
            *wc.wire_to_device(wire, "cpu"), *(t.cpu() for t in tabs),
            curve.name)
        args = (*wc.wire_to_device(wire, device), *tabs)
        _held("weierstrass_windowed", f"{curve.name}, lane pairs",
              launch(args, len(items), curve_id), want)
