"""Seeded, deterministic fault injection — the chaos harness.

Jepsen-style testing needs faults that are (a) injectable at precise
points in the stack and (b) exactly reproducible from a seed. This module
provides both: production code calls ``fault_point("tcp.send", detail=...)``
at its failure-prone seams, and tests arm a :class:`FaultInjector` with
:class:`FaultRule` schedules describing *which* hits fire and *what*
happens (drop / delay / raise / duplicate).

Design constraints:

* **Zero cost disarmed.** ``fault_point`` is a module-level function whose
  first statement checks a module-level bool. With no injector armed the
  call is one global load + one branch — nothing allocates, no lock is
  taken. Production hot paths (the batcher dispatch loop, the TCP sender)
  keep their benchmarked profile.
* **Deterministic.** Every probabilistic rule draws from its own
  ``random.Random`` seeded from ``(injector seed, rule index)``; count
  predicates (``after`` / ``count`` / ``every``) are plain counters. The
  same seed + the same sequence of fault-point hits ⇒ the same faults.
  The seed defaults to ``CORDA_TPU_FAULT_SEED`` from the environment so a
  red chaos run is reproducible verbatim from its log line.
* **Composable actions.** ``raise`` and ``delay`` are handled inside
  ``fault_point`` (every call site gets them for free); ``drop`` and
  ``duplicate`` are *returned* to the call site, because only the call
  site knows what skipping or doubling its operation means. Sites that
  cannot duplicate simply ignore the return value.

Fault points in this package:

====================== ======================================================
point                  seam
====================== ======================================================
``net.send``           in-memory bus, before a message is enqueued
``raft.append``        raft, before posting an AppendEntries (python + native)
``batcher.device_dispatch`` SignatureBatcher, inside the device-dispatch try
``oop.deliver``        verifier queue → worker request send
``oop.reply``          verifier worker → service reply send
``raft.snapshot.persist`` RaftLogStore.save_snapshot, between the snapshot
                       write and the covered-prefix delete (torn-persist seam)
``raft.snapshot.install`` raft leader, before posting an InstallSnapshot
``coordlog.compact``   CoordinatorLog GC, after the side-file fsync and
                       before the atomic rename over the live log
``shard2pc.prepare``   sharded notary, before each shard's reserve round
``shard2pc.decide``    sharded notary, before the durable commit decision
``shard2pc.finalize``  sharded notary, after the decision, before finalize
====================== ======================================================

``detail`` carries the call-site specifics (``"alice->bob"`` on sends,
the scheme name on batcher dispatch) and rules may target it with an
fnmatch pattern — that is how a test partitions one endpoint or storms
one signature scheme.
"""
from __future__ import annotations

import fnmatch
import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..observability.slog import jlog

_log = logging.getLogger("corda_tpu_torch.faults")

#: sentinel return values of :func:`fault_point` — call sites compare with
#: ``==`` (they are plain strings so tests can assert on fire logs too)
DROP = "drop"
DUPLICATE = "duplicate"


class FaultError(ConnectionError):
    """Default exception for ``action="raise"`` rules.

    Subclasses :class:`ConnectionError` (hence :class:`OSError`) on
    purpose: transport retry paths catch ``(OSError, ConnectionError,
    LookupError)``, so an injected fault exercises exactly the handler a
    real socket failure would."""


@dataclass
class FaultRule:
    """One scheduled fault. ``point`` (and optionally ``detail``) are
    fnmatch patterns; the count predicates select which eligible hits
    actually fire: skip the first ``after``, then fire every ``every``-th
    with ``probability``, at most ``count`` times total."""
    point: str
    action: str = "raise"          # drop | delay | raise | duplicate
    detail: str | None = None      # fnmatch over the call-site detail
    after: int = 0                 # skip the first N eligible hits
    count: int | None = None       # fire at most N times (None = unlimited)
    every: int = 1                 # of the eligible hits, fire each k-th
    probability: float = 1.0       # seeded coin flip per eligible hit
    delay_s: float = 0.0           # for action="delay"
    exc: Exception | type | None = None   # for action="raise"
    matches: int = field(default=0, repr=False)   # eligible hits seen
    fires: int = field(default=0, repr=False)     # times actually fired

    def _make_exc(self, name: str, detail: str | None) -> Exception:
        if self.exc is None:
            return FaultError(f"injected fault at {name}"
                              + (f" ({detail})" if detail else ""))
        if isinstance(self.exc, type):
            return self.exc(f"injected fault at {name}")
        return self.exc


class FaultInjector:
    """Process-wide fault schedule. Arm with :func:`arm` / :func:`inject`;
    every armed hit is recorded in ``self.log`` as ``(point, detail,
    action)`` so tests can assert on exactly what fired."""

    def __init__(self, seed: int | None = None):
        if seed is None:
            seed = int(os.environ.get("CORDA_TPU_FAULT_SEED", "0") or 0)
        self.seed = seed
        self.rules: list[FaultRule] = []
        self.log: list[tuple[str, str | None, str]] = []
        self._rngs: list[random.Random] = []
        self._lock = threading.Lock()

    def add(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self.rules.append(rule)
            # one rng per rule: rules fire deterministically regardless of
            # what other (possibly probabilistic) rules are armed alongside
            self._rngs.append(random.Random(self.seed * 1_000_003
                                            + len(self.rules)))
        return rule

    def fired(self, point: str) -> int:
        """How many times any rule fired at fault points matching *point*."""
        return sum(1 for p, _, _ in self.log if fnmatch.fnmatch(p, point))

    # -- the hit path (only reached while armed) ----------------------------
    def _hit(self, name: str, detail: str | None) -> str | None:
        outcome = None
        with self._lock:
            for rule, rng in zip(self.rules, self._rngs):
                if not fnmatch.fnmatch(name, rule.point):
                    continue
                if rule.detail is not None and (
                        detail is None
                        or not fnmatch.fnmatch(detail, rule.detail)):
                    continue
                rule.matches += 1
                if rule.matches <= rule.after:
                    continue
                if rule.count is not None and rule.fires >= rule.count:
                    continue
                if (rule.matches - rule.after - 1) % rule.every:
                    continue
                if rule.probability < 1.0 and \
                        rng.random() >= rule.probability:
                    continue
                rule.fires += 1
                self.log.append((name, detail, rule.action))
                jlog(_log, "fault.fire", point=name, detail=detail,
                     action=rule.action, seed=self.seed, fire=rule.fires)
                if rule.action == "delay":
                    # sleep outside the lock; keep scanning afterwards so a
                    # delay rule can compose with a drop/raise rule
                    delay = rule.delay_s
                    self._lock.release()
                    try:
                        time.sleep(delay)
                    finally:
                        self._lock.acquire()
                    continue
                if rule.action == "raise":
                    raise rule._make_exc(name, detail)
                outcome = rule.action          # drop | duplicate
                break
        return outcome


# -- process-wide arming ----------------------------------------------------
_ARMED = False            # the fast-path gate: read unlocked, set rarely
_INJECTOR: FaultInjector | None = None


def fault_point(name: str, detail: str | None = None) -> str | None:
    """Call-site hook. Returns ``None`` (armed or not) unless a drop or
    duplicate rule fires, in which case the sentinel string is returned
    for the call site to act on. Raise/delay rules act in here."""
    if not _ARMED:                 # the zero-cost disarmed path
        return None
    inj = _INJECTOR
    if inj is None:
        return None
    return inj._hit(name, detail)


def arm(injector: FaultInjector) -> FaultInjector:
    global _ARMED, _INJECTOR
    _INJECTOR = injector
    _ARMED = True
    jlog(_log, "fault.arm", seed=injector.seed,
         rules=[r.point for r in injector.rules])
    return injector


def disarm() -> None:
    global _ARMED, _INJECTOR
    _ARMED = False
    _INJECTOR = None


def active() -> FaultInjector | None:
    """The armed injector, if any — the conftest failure hook reads its
    seed so every red chaos run prints its reproduction recipe."""
    return _INJECTOR if _ARMED else None


@contextmanager
def inject(*rules: FaultRule, seed: int | None = None):
    """``with inject(FaultRule("tcp.send", "drop", count=3), seed=7) as inj:``
    — arm for the block, always disarm after (even on assertion failure),
    yield the injector for fire-log assertions."""
    inj = FaultInjector(seed=seed)
    for rule in rules:
        inj.add(rule)
    arm(inj)
    try:
        yield inj
    finally:
        disarm()
