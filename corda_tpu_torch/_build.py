"""Builds the port's native libraries from the repository's sources.

Twelve shared libraries, all with a plain C interface loaded through ctypes:

- ``scalarmath``       — ``native/scalarmath.cpp`` (host scalar prep) and
- ``kvlog``            — ``native/kvlog.cpp`` (the key-value store's
  append-only log engine, ``storage/kvstore.py``), each by g++;
- ``ed25519_split``    — ``csrc/ed25519_split.cu`` (kernel B2, Ed25519
  split-k verify),
- ``secp256k1_hybrid`` — ``csrc/secp256k1_hybrid.cu`` (kernel B3, secp256k1
  hybrid-GLV verify),
- ``secp256r1_split``  — ``csrc/secp256r1_split.cu`` (kernel B4, secp256r1
  half-gcd split verify),
- ``sha256``           — ``csrc/sha256.cu`` (kernel B6, batched SHA-256 and
  Merkle levels),
- ``weierstrass_shamir`` — ``csrc/weierstrass_shamir.cu`` (kernel B8, the
  Shamir ladder, secp256k1 and secp256r1),
- ``secp256k1_glv``    — ``csrc/secp256k1_glv.cu`` (kernel B8, the GLV
  joint ladder) and
- ``weierstrass_windowed`` — ``csrc/weierstrass_windowed.cu`` (kernel B5,
  the single-scalar windowed ladder, secp256k1 and secp256r1),
- ``ed25519_shamir``   — ``csrc/ed25519_shamir.cu`` (kernel B7, the Ed25519
  Shamir ladder),
- ``ed25519_windowed`` — ``csrc/ed25519_windowed.cu`` (kernel B7, the
  Ed25519 windowed constant-B ladder) and
- ``simm_margin``      — ``csrc/simm_margin.cu`` (kernel B10, the SIMM
  margin), each by nvcc for ``sm_90a``.

Each is built at first use into ``corda_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of its sources, of every
header they reach through quoted ``#include``s (:func:`include_closure`) and
of its flags, so an edited source or header is rebuilt and a stale library
is never loaded. A build
writes to a temporary file and renames it into place, so processes that
build at the same time (test workers) never load a half-written library.
``build_all`` starts every compiler at once and waits for all of them.

A failed build raises :class:`BuildError` with the compiler's output, and a
refused or failed launch raises :class:`LaunchError`; both are
:class:`KernelError`, which the port never answers by running the work
elsewhere.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")

#: Hopper target: ``sm_90a`` (wgmma/setmaxnreg exist only there).
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: nvcc flags of every kernel library (``-Xptxas -v``: the register and
#: spill report lands in ``BUILD_LOG``).
_NVCC_FLAGS = NVCC_ARCH + ["-O3", "-std=c++17", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]


class KernelError(RuntimeError):
    """A kernel of the port could not be built or run on the card."""


class BuildError(KernelError):
    """A compiler is missing or refused a source."""


class LaunchError(KernelError):
    """The card refused a kernel launch, or the kernel failed while it ran."""


def nvcc_path() -> str | None:
    """nvcc from CUDA_HOME, the standard toolkit location, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    return shutil.which("nvcc")


def _cxx() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


#: A quoted include of a source or header.
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def include_closure(sources) -> list[str]:
    """Every file that ``sources`` reach through quoted ``#include``s, each
    resolved beside the file that includes it, sorted: the headers a build
    of those sources reads, so that an edit to any of them renames the
    library."""
    seen, todo = set(), list(sources)
    while todo:
        src = todo.pop()
        with open(src) as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            path = os.path.normpath(os.path.join(os.path.dirname(src), name))
            if path not in seen:
                seen.add(path)
                todo.append(path)
    return sorted(seen)


def _nvcc_target(source: str) -> dict:
    sources = [os.path.join(CSRC, source)]
    return {"sources": sources, "deps": include_closure(sources),
            "flags": _NVCC_FLAGS, "compiler": nvcc_path}


def _host_target(source: str) -> dict:
    sources = [os.path.join(_REPO, "native", source)]
    return {"sources": sources, "deps": include_closure(sources),
            "flags": ["-O2", "-fPIC", "-std=c++17", "-shared"],
            "compiler": _cxx}


_TARGETS = {
    "scalarmath": _host_target("scalarmath.cpp"),
    "kvlog": _host_target("kvlog.cpp"),
    **{name: _nvcc_target(f"{name}.cu") for name in (
        "ed25519_split", "ed25519_shamir", "ed25519_windowed",
        "secp256k1_hybrid", "secp256r1_split", "weierstrass_shamir",
        "secp256k1_glv", "weierstrass_windowed", "sha256", "simm_margin")},
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: Per target: builds run by this process, their wall seconds, and the
#: compiler's output (nvcc's ``-Xptxas -v`` register/spill report).
BUILD_COUNT: dict[str, int] = {name: 0 for name in _TARGETS}
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def _output_path(name: str) -> str:
    t = _TARGETS[name]
    h = hashlib.sha256()
    for path in t["sources"] + t["deps"]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(t["flags"]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start the compiler for ``name`` unless its library exists. Returns
    (out_path, popen | None, tmp_path, t0)."""
    out = _output_path(name)
    if os.path.exists(out):
        return out, None, None, 0.0
    t = _TARGETS[name]
    compiler = t["compiler"]()
    if compiler is None:
        raise BuildError(f"no compiler found to build {name}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [compiler, *t["flags"], "-o", tmp, *t["sources"]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp, time.perf_counter()


def _finish(name: str, out: str, proc, tmp: str, t0: float) -> str:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise BuildError(f"building {name} failed (exit {proc.returncode}):\n"
                         f"{log}")
    os.replace(tmp, out)
    BUILD_COUNT[name] += 1
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = log
    return out


def build_all(names=None) -> dict[str, str]:
    """Build every named target not yet built, all compilers running at
    once. Returns {name: library path}."""
    names = list(_TARGETS) if names is None else list(names)
    with _LOCK:
        started, errors = {}, []
        for n in names:
            try:
                started[n] = _start(n)
            except BuildError as exc:
                errors.append(exc)
        paths = {}
        for n, st in started.items():
            try:
                paths[n] = _finish(n, *st)
            except BuildError as exc:
                errors.append(exc)
        if errors:
            raise BuildError("\n".join(str(e) for e in errors))
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]


def can_build(name: str) -> bool:
    """True when ``name``'s library is loaded or built, or its compiler is
    there to build it. Builds nothing."""
    return (name in _LIBS or os.path.exists(_output_path(name))
            or _TARGETS[name]["compiler"]() is not None)


def build_count(name: str) -> int:
    return BUILD_COUNT[name]
