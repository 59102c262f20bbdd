"""Binding, argument checks and launch for the port's CUDA kernel libraries.

Every kernel library in ``csrc/`` exposes a plain C launcher that takes device
pointers, a count and a CUDA stream and returns ``cudaGetLastError()``, and
``<prefix>_error_string`` naming a CUDA error. The verify kernels share one
launcher shape, ``<target>_verify(ptrs..., ok, n, [curve id or lanes,] stream)``;
``bind_verify`` and ``launch_verify`` bind and call it. A refused launch
raises :class:`_build.LaunchError` and a failed build
:class:`_build.BuildError`; neither is ever answered by running the work
elsewhere.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def bind_verify(target: str, n_ptrs: int, with_int: bool = False):
    """Build (at first use) and bind a verify kernel's library: its C
    launcher ``<target>_verify`` takes ``n_ptrs`` device pointers, the
    verdict pointer, n, (with ``with_int``, an int: the curve id of the
    two-curve kernels, the lanes a signature of B2 and the B7 kernels) and
    the stream. Raises :class:`BuildError` when the library cannot be built."""
    lib = _build.load(target)
    fn = getattr(lib, f"{target}_verify")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (n_ptrs + 1) + [ctypes.c_int64]
                   + [ctypes.c_int] * with_int + [ctypes.c_void_p])
    bind_error_string(lib, target)
    return lib


def bind_error_string(lib, prefix: str) -> None:
    err = getattr(lib, f"{prefix}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]


def raise_on_error(lib, prefix: str, rc: int, what: str) -> None:
    """Raise LaunchError with ``<prefix>_error_string``'s message when a
    launcher returned ``rc`` != 0."""
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise _build.LaunchError(f"{what} launch failed: {msg} "
                                 f"(cudaError {rc})")


def check_args(spec, args, device: torch.device) -> None:
    """``spec``: (name, dtype, shape) per argument; every argument must be
    on ``device``, contiguous and 16-byte aligned (the kernels load rows as
    16-byte vectors)."""
    for (name, dtype, shape), t in zip(spec, args):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"all arguments must be on {device}, got "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("arguments must be contiguous and 16-byte "
                             "aligned")


def require_fixed(name: str, value, fixed) -> None:
    """A parameter the JAX package's function takes and the port's kernels
    fix (a window width, a curve, a table placement): accepted at the value
    the kernel was built for, refused with ValueError at any other."""
    if value != fixed:
        raise ValueError(f"{name}={value!r}: the port's kernels take "
                         f"{name}={fixed!r} only")


def launch_verify(lib, fn_name: str, args, n: int, device,
                  int_arg: int | None = None) -> torch.Tensor:
    """Run the C launcher ``<prefix>_verify`` on the current stream of
    ``device`` (passing ``int_arg`` after n: the curve id of the two-curve
    kernels, the lanes a signature of B2 and the B7 kernels); returns ok (n,)
    bool without synchronising, or raises LaunchError."""
    ok = torch.empty(n, dtype=torch.bool, device=device)
    extra = () if int_arg is None else (int_arg,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*(t.data_ptr() for t in args),
                                   ok.data_ptr(), n, *extra, stream)
    raise_on_error(lib, fn_name.removesuffix("_verify"), rc, fn_name)
    return ok


#: The libraries whose kernel takes the lanes a signature by batch size
#: (``<target>_lanes(n)``): lane pairs up to a threshold, one lane above.
LANES_BY_SIZE = ("ed25519_split", "ed25519_shamir", "ed25519_windowed")


def lanes_for(lib, target: str, n: int) -> int:
    """Lanes a signature the launcher of ``target`` (one of LANES_BY_SIZE)
    runs for an ``n``-item batch (``<target>_lanes(n)``)."""
    fn = getattr(lib, f"{target}_lanes")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64]
    return fn(n)


def geometry(target: str, n: int, curve_id: int | None = None) -> dict:
    """Launch geometry of the verify kernel of library ``target`` for an
    ``n``-item batch (of the curve ``curve_id`` for the two-curve kernels):
    threads a block, lanes (threads) a signature, and the blocks of that
    size one multiprocessor holds at once (``<target>_occupancy``, the CUDA
    occupancy calculator, registers and shared memory included)."""
    lib = _build.load(target)
    block = getattr(lib, f"{target}_block")()
    occ = getattr(lib, f"{target}_occupancy")
    if target in LANES_BY_SIZE:
        lanes = lanes_for(lib, target, n)
        occ.argtypes = [ctypes.c_int, ctypes.c_int]
        blocks = occ(block, lanes)
    else:
        lanes = getattr(lib, f"{target}_lanes")()
        if curve_id is None:
            occ.argtypes = [ctypes.c_int]
            blocks = occ(block)
        else:
            occ.argtypes = [ctypes.c_int, ctypes.c_int]
            blocks = occ(block, curve_id)
    if blocks < 0:
        raise _build.LaunchError(f"{target}_occupancy failed")
    return {"block": block, "lanes": lanes, "blocks_per_sm": blocks}
