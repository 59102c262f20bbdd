"""Builds the port's native libraries from the repository's sources.

Two shared libraries, both with a plain C interface loaded through ctypes:

- ``scalarmath``    — ``native/scalarmath.cpp`` (host scalar prep), by g++;
- ``ed25519_split`` — ``corda_tpu_torch/csrc/ed25519_split.cu`` (the
  Hopper split-k verify kernel), by nvcc for ``sm_90a``.

Each is built at first use into ``corda_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of its sources and flags, so
an edited source is rebuilt and a stale library is never loaded. A build
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


_TARGETS = {
    "scalarmath": {
        "sources": [os.path.join(_REPO, "native", "scalarmath.cpp")],
        "deps": [],
        "flags": ["-O2", "-fPIC", "-std=c++17", "-shared"],
        "compiler": _cxx,
    },
    "ed25519_split": {
        "sources": [os.path.join(CSRC, "ed25519_split.cu")],
        "deps": [os.path.join(CSRC, "field25519.cuh")],
        "flags": NVCC_ARCH + ["-O3", "-std=c++17", "-shared",
                              "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        "compiler": nvcc_path,
    },
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


def build_count(name: str) -> int:
    return BUILD_COUNT[name]
