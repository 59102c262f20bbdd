"""Retry with decorrelated-jitter backoff and a deadline budget.

The stack's transient-failure seams (TCP connect/probe, verifier worker
re-hello, raft client forwarding during an election) all need the same
shape: try, back off by a *jittered* growing delay so a thundering herd
of retriers decorrelates, give up when a deadline budget or attempt cap
is exhausted. The delay recurrence is the AWS "decorrelated jitter"
scheme: ``sleep = min(cap, uniform(base, prev * 3))``. Copy of
corda_tpu.utils.retry: the same policy and seed give the same delays.

Every attempt is metered in a module-wide registry under
``Retry.Attempts`` (aggregate) and ``Retry.Attempts.<site>``; exhausted
retries mark ``Retry.GiveUps.<site>``. ``CordaRPCOps.metrics_snapshot``
merges :func:`snapshot` into the node registry so the counters ride
``/metrics`` and ``/api/metrics``.
"""
from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator

from .metrics import MetricRegistry
from ..observability.slog import jlog

_log = logging.getLogger("corda_tpu_torch.retry")

_REGISTRY = MetricRegistry()
_REGISTRY.meter("Retry.Attempts")    # pre-created: the family is always
_REGISTRY.meter("Retry.GiveUps")     # present in /metrics, even at zero


@dataclass(frozen=True)
class RetryPolicy:
    base_s: float = 0.05          # first / minimum backoff
    cap_s: float = 2.0            # per-sleep ceiling
    max_attempts: int = 5         # total tries (first call included)
    deadline_s: float | None = None  # total budget incl. projected sleep


DEFAULT_POLICY = RetryPolicy()


def registry() -> MetricRegistry:
    return _REGISTRY


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def delays(policy: RetryPolicy = DEFAULT_POLICY,
           seed: int | None = None) -> Iterator[float]:
    """Endless decorrelated-jitter delay sequence — for call sites that
    own their retry loop (the TCP plane's async sender) and only need
    the backoff schedule."""
    rng = random.Random(seed)
    prev = policy.base_s
    while True:
        prev = min(policy.cap_s, rng.uniform(policy.base_s, prev * 3))
        yield prev


def retry_call(fn: Callable, *, site: str,
               policy: RetryPolicy = DEFAULT_POLICY,
               retry_on: tuple = (Exception,),
               seed: int | None = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` until it returns, raising the last error once the
    attempt cap is hit or the next projected sleep would blow the
    deadline budget. ``site`` names the caller in the retry metrics."""
    attempts = _REGISTRY.meter(f"Retry.Attempts.{site}")
    total = _REGISTRY.get_metric("Retry.Attempts")
    start = clock()
    backoff = delays(policy, seed=seed)
    last: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        attempts.mark()
        total.mark()
        try:
            return fn()
        except retry_on as e:
            last = e
            if attempt >= policy.max_attempts:
                break
            delay = next(backoff)
            if policy.deadline_s is not None and \
                    clock() - start + delay > policy.deadline_s:
                break
            jlog(_log, "retry.backoff", site=site, attempt=attempt,
                 delay_s=round(delay, 4), error=f"{type(e).__name__}: {e}")
            sleep(delay)
    _REGISTRY.meter(f"Retry.GiveUps.{site}").mark()
    _REGISTRY.get_metric("Retry.GiveUps").mark()
    jlog(_log, "retry.giveup", site=site, attempts=attempt,
         error=f"{type(last).__name__}: {last}")
    assert last is not None
    raise last
