"""Reused host staging buffers for device dispatch, on pinned memory.

Port of corda_tpu/ops/staging.py. A steady-state verification server
re-sees the same batch shapes (the batcher cuts drains at a power-of-two
ladder), so freed per-batch host buffers go to a free list keyed by
(tag, shape, dtype) and are handed back instead of re-allocated. On a CUDA
machine the buffers are page-locked (``torch.empty(..., pin_memory=True)``
viewed as numpy), so the host→device copies of a batch are true
asynchronous DMA (``non_blocking=True``).

Safety: a staging buffer may still be read by an in-flight host→device copy
after the launch returns. A lease is therefore released only after a CUDA
event recorded behind the batch's kernel has completed — ``finish_batch``
waits on that event and then calls ``release_for``. Releasing any earlier
would let the next batch's prep overwrite memory a copy is still reading. A
lease that is never released (a dispatch crashed before finish) is dropped:
its buffers are garbage-collected instead of reused, so a failure can never
corrupt a later batch.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

#: Free-list depth per (tag, shape, dtype) key.
MAX_FREE_PER_KEY = 8

#: Cap on leases parked against un-finished pending handles; evicted leases
#: are dropped, never recycled.
MAX_ATTACHED = 128

#: numpy dtype → torch dtype of the same width, for pinned allocations.
_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
             np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
             np.dtype(np.uint16): torch.uint16,
             np.dtype(np.uint64): torch.uint64}


def _pinned_array(shape, dtype) -> np.ndarray:
    """An ndarray over page-locked memory (the torch tensor stays alive as
    the array's base)."""
    t = torch.empty(tuple(shape), dtype=_TORCH_OF[np.dtype(dtype)],
                    pin_memory=True)
    return t.numpy()


class StagingLease:
    """One batch's set of staging buffers, checked out until released."""

    __slots__ = ("_pool", "_taken", "_released")

    def __init__(self, pool: "StagingPool"):
        self._pool = pool
        self._taken: list[tuple[tuple, np.ndarray]] = []
        self._released = False

    def take(self, tag: str, shape: tuple, dtype) -> np.ndarray:
        """A writable ndarray of (shape, dtype) — reused from the pool when
        a previous batch of the same shape has finished, freshly allocated
        otherwise. The caller must overwrite every row it dispatches."""
        if self._released:
            raise RuntimeError("staging lease already released")
        key = (tag, tuple(shape), np.dtype(dtype).str)
        buf = self._pool._checkout(key)
        if buf is None:
            buf = (_pinned_array(shape, dtype) if self._pool.pinned
                   else np.empty(shape, dtype=dtype))
        self._taken.append((key, buf))
        return buf

    def release(self) -> None:
        """Return every taken buffer to the pool. Idempotent. Only call once
        no device copy reads the memory any more."""
        if self._released:
            return
        self._released = True
        self._pool._reclaim(self._taken)
        self._taken = []


class StagingPool:
    """Free lists of staging buffers plus the pending-handle side table that
    ties a lease's lifetime to its batch's finish. Buffers are pinned
    whenever CUDA is available (pinning needs a CUDA driver)."""

    def __init__(self, max_free_per_key: int = MAX_FREE_PER_KEY,
                 max_attached: int = MAX_ATTACHED):
        self._lock = threading.Lock()
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._attached: OrderedDict = OrderedDict()
        self._max_free = max_free_per_key
        self._max_attached = max_attached
        self.pinned = torch.cuda.is_available()
        self.hits = 0
        self.misses = 0

    def lease(self) -> StagingLease:
        return StagingLease(self)

    def _checkout(self, key: tuple):
        with self._lock:
            bufs = self._free.get(key)
            if bufs:
                self.hits += 1
                return bufs.pop()
            self.misses += 1
            return None

    def _reclaim(self, taken) -> None:
        with self._lock:
            for key, buf in taken:
                bufs = self._free.setdefault(key, [])
                if len(bufs) < self._max_free:
                    bufs.append(buf)

    def attach(self, handle, lease: StagingLease) -> None:
        """Park ``lease`` against an async pending handle; ``release_for``
        (called by finish_batch after the batch's CUDA event completed)
        reclaims it."""
        with self._lock:
            self._attached[id(handle)] = lease
            while len(self._attached) > self._max_attached:
                self._attached.popitem(last=False)

    def release_for(self, handle) -> None:
        with self._lock:
            lease = self._attached.pop(id(handle), None)
        if lease is not None:
            lease.release()

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "free_buffers": sum(len(v) for v in self._free.values()),
                    "attached": len(self._attached), "pinned": self.pinned}


_POOL: StagingPool | None = None
_POOL_LOCK = threading.Lock()


def get_staging_pool() -> StagingPool:
    """The process staging pool (created at first use, so importing this
    module touches no CUDA driver)."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = StagingPool()
    return _POOL

