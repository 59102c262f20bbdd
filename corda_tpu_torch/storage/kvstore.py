"""KvStore — a persistent dict over the native append-only log engine.

Reference parity: the typed persistent maps the reference builds on H2
(node/utilities/JDBCHashMap.kt:1-507 `AbstractJDBCHashMap`) and the WAL
durability its storage layer inherits from the database. Here the write path
is the C++ engine of the repository's `native/kvlog.cpp` (crc-framed synced
appends, torn-tail truncation on recovery), built by g++ into the port's
build directory at first use (`_build.load("kvlog")`) and loaded via ctypes;
a pure-Python engine with the same file format serves ``use_native=False``.
This is host storage: nothing here touches the device.

The in-memory index (key -> latest value) is rebuilt by a recovery scan at
open; deletes are tombstones; `compact()` rewrites the live set.
"""
from __future__ import annotations

import ctypes
import functools
import os
import struct
import threading
import zlib

from .. import _build
from ..utils.faults import fault_point

_TOMBSTONE = 0xFFFFFFFF


def _bind(lib) -> None:
    lib.kvlog_open.restype = ctypes.c_void_p
    lib.kvlog_open.argtypes = [ctypes.c_char_p]
    lib.kvlog_close.argtypes = [ctypes.c_void_p]
    lib.kvlog_append.restype = ctypes.c_int64
    lib.kvlog_append.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int]
    lib.kvlog_read_at.restype = ctypes.c_int
    lib.kvlog_read_at.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.kvlog_truncate.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.kvlog_size.restype = ctypes.c_int64
    lib.kvlog_size.argtypes = [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _native_lib():
    """The bound kvlog library, built at first use. Raises
    :class:`_build.BuildError` when it cannot be built."""
    lib = _build.load("kvlog")
    _bind(lib)
    return lib


#: The native engine can be had: its library is built, or a C++ compiler is
#: there to build it at the first native open. Nothing is built at import.
NATIVE_AVAILABLE = _build.can_build("kvlog")

_MAX_REC = 16 * 1024 * 1024


class SyncFailure(OSError):
    """The sync after an append failed: the record's durability is unknown.
    The store fails stop (every later operation raises) — the standard answer
    to the fsync-gate problem."""


class _PyEngine:
    """Pure-Python engine with the identical record format (fallback)."""

    def __init__(self, path: str):
        self._f = open(path, "a+b")
        self._f.seek(0, os.SEEK_END)
        self.size = self._f.tell()

    def append(self, key: bytes, value: bytes, tombstone: bool) -> int:
        vlen = _TOMBSTONE if tombstone else len(value)
        body = struct.pack(">II", len(key), vlen) + key + \
            (b"" if tombstone else value)
        rec = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
        offset = self.size
        self._f.seek(offset)
        self._f.write(rec)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.size += len(rec)
        return offset

    def read_at(self, offset: int):
        if offset + 12 > self.size:
            return None
        self._f.seek(offset)
        header = self._f.read(12)
        crc, klen, vlen = struct.unpack(">III", header)
        tomb = vlen == _TOMBSTONE
        body_vlen = 0 if tomb else vlen
        if klen > _MAX_REC or body_vlen > _MAX_REC:
            return None
        total = 12 + klen + body_vlen
        if offset + total > self.size:
            return None
        body = self._f.read(klen + body_vlen)
        if zlib.crc32(header[4:] + body) & 0xFFFFFFFF != crc:
            return None
        key = body[:klen]
        value = None if tomb else body[klen:]
        return key, value, offset + total

    def truncate(self, offset: int) -> None:
        self._f.truncate(offset)
        self.size = offset

    def close(self) -> None:
        self._f.close()


class _NativeEngine:
    def __init__(self, path: str):
        self._lib = _native_lib()
        self._h = self._lib.kvlog_open(path.encode())
        if not self._h:
            raise OSError(f"kvlog_open failed for {path!r}")
        # scratch buffers reused across read_at calls (recovery reads one
        # record at a time; allocating 2x16MB per record would dominate)
        self._key_buf = ctypes.create_string_buffer(_MAX_REC)
        self._val_buf = ctypes.create_string_buffer(_MAX_REC)

    @property
    def size(self) -> int:
        return self._lib.kvlog_size(self._h)

    def append(self, key: bytes, value: bytes, tombstone: bool) -> int:
        off = self._lib.kvlog_append(self._h, key, len(key),
                                value if not tombstone else b"",
                                0 if tombstone else len(value),
                                1 if tombstone else 0)
        if off == -2:
            raise SyncFailure("kvlog sync failed; durability unknown")
        if off < 0:
            raise OSError("kvlog_append failed")
        return off

    def read_at(self, offset: int):
        key_buf, val_buf = self._key_buf, self._val_buf
        klen = ctypes.c_uint32()
        vlen = ctypes.c_uint32()
        nxt = ctypes.c_int64()
        rc = self._lib.kvlog_read_at(self._h, offset, key_buf, _MAX_REC,
                                ctypes.byref(klen), val_buf, _MAX_REC,
                                ctypes.byref(vlen), ctypes.byref(nxt))
        if rc == -3:
            raise OSError("kvlog record exceeds the engine's record cap")
        if rc <= 0:
            return None
        key = key_buf.raw[:klen.value]
        value = None if rc == 2 else val_buf.raw[:vlen.value]
        return key, value, nxt.value

    def truncate(self, offset: int) -> None:
        self._lib.kvlog_truncate(self._h, offset)

    def close(self) -> None:
        self._lib.kvlog_close(self._h)
        self._h = None


class KvStore:
    """dict-like persistent store: bytes keys/values, crash-safe appends."""

    def __init__(self, path: str, use_native: bool | None = None):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        native = NATIVE_AVAILABLE if use_native is None else use_native
        if native and not NATIVE_AVAILABLE:
            raise RuntimeError("native kvlog engine cannot be built "
                               "(no C++ compiler found)")
        self._engine = _NativeEngine(path) if native else _PyEngine(path)
        self.native = native
        self._lock = threading.Lock()
        self._index: dict[bytes, bytes] = {}
        self._failed = False
        self._live_bytes = 0
        self._recover()
        self._live_bytes = sum(12 + len(k) + len(v)
                               for k, v in self._index.items())

    def _recover(self) -> None:
        offset = 0
        while True:
            rec = self._engine.read_at(offset)
            if rec is None:
                break
            key, value, offset = rec
            if value is None:
                self._index.pop(key, None)
            else:
                self._index[key] = value
        if offset < self._engine.size:
            # torn tail from a crash mid-append: discard it
            self._engine.truncate(offset)

    def _check_usable(self, key: bytes, value: bytes = b"") -> None:
        if self._failed:
            raise SyncFailure("store is failed-stop after an earlier sync error")
        if 12 + len(key) + len(value) > _MAX_REC:
            raise ValueError(
                f"record too large ({len(key)}+{len(value)} bytes; cap is "
                f"{_MAX_REC}) — oversize records would be destroyed on recovery")

    # -- dict surface --------------------------------------------------------
    def __setitem__(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._check_usable(key, value)
            try:
                # durability seam: chaos rules raise SyncFailure here to
                # exercise the fail-stop discipline without breaking a disk
                fault_point("kvstore.flush", detail="set")
                self._engine.append(key, value, False)
            except SyncFailure:
                self._failed = True
                raise
            old = self._index.get(key)
            if old is not None:
                self._live_bytes -= 12 + len(key) + len(old)
            self._index[key] = value
            self._live_bytes += 12 + len(key) + len(value)
            self._maybe_compact()

    def __getitem__(self, key: bytes) -> bytes:
        with self._lock:
            return self._index[key]

    def get(self, key: bytes, default=None):
        with self._lock:
            return self._index.get(key, default)

    def __delitem__(self, key: bytes) -> None:
        with self._lock:
            self._check_usable(key)
            if key not in self._index:
                raise KeyError(key)
            try:
                fault_point("kvstore.flush", detail="del")
                self._engine.append(key, b"", True)
            except SyncFailure:
                self._failed = True
                raise
            self._live_bytes -= 12 + len(key) + len(self._index[key])
            del self._index[key]
            self._maybe_compact()

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def keys(self):
        with self._lock:
            return list(self._index)

    def items(self):
        with self._lock:
            return list(self._index.items())

    def _maybe_compact(self) -> None:
        """Auto-GC: when the log carries >4x the live bytes (and is past a
        floor), rewrite it — otherwise checkpoint churn (append + tombstone
        per flow lifecycle) grows the file without bound. Caller holds the
        lock."""
        if self._engine.size > max(1 << 20, 4 * max(self._live_bytes, 1)):
            self._compact_locked()

    def compact(self) -> None:
        """Rewrite only the live set (log-structured GC)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        tmp_path = self.path + ".compact"
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        new_engine = _NativeEngine(tmp_path) if self.native \
            else _PyEngine(tmp_path)
        for key, value in self._index.items():
            new_engine.append(key, value, False)
        self._engine.close()
        new_engine.close()
        os.replace(tmp_path, self.path)
        self._engine = _NativeEngine(self.path) if self.native \
            else _PyEngine(self.path)

    def close(self) -> None:
        self._engine.close()
