"""SLO-fed fleet controller: autoscaling + a stepped degradation ladder.

Port of corda_tpu.verifier.controller, line for line: the
controller holds no device state; its ladder rungs act on the port's
SignatureBatchers (whose kernels run on the card).

Closes the fleet's robustness loop: every signal this module
consumes already exists — SLOTracker burn-rate alerts (observability/
slo.py), the router's capacity-normalized queue-depth estimates and
per-worker service-rate EWMAs (verifier/out_of_process.py), breaker
states (verifier/batcher.py) and load-report staleness (fleet_status) —
but until now nothing ACTED on them. The FleetController is a small
deterministic control loop (injectable clock, pure callables for every
actuator) that:

- **scales** the fleet through the existing join/leave seams: a spawn
  callable rides WorkerHello, retirement rides the graceful Goodbye, and
  dead workers are crash-detached via the stale-reaper so their charged
  work requeues (zero lost futures — the same exactly-once machinery the
  chaos suite pins);
- **degrades in steps, not off a cliff**: a *ladder* of reversible
  rungs applied one per tick under sustained stress and reverted in
  reverse order on recovery — shed bulk admission-class load first
  (backpressure lands on throughput traffic), then shrink the bulk
  batch ladder (smaller, lower-latency device batches), then route
  interactive traffic to host verify (bounded latency even with the
  device path saturated);
- **hysteresis**: scale/step cooldowns plus a consecutive-healthy-tick
  requirement before any reversal, so an oscillating signal cannot flap
  the fleet.

Every action is triple-logged: a ``controller.*`` jlog event, a
``Controller.*`` meter mark, and a span under the live
``controller.episode`` span — one annotated timeline per
stress-to-recovery episode on /traces. ``status()`` is the
``controller`` block on ``/readyz``, ``fleet_status()`` and
``fleetstat``.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from ..observability import get_tracer
from ..observability.slog import jlog
from ..utils.metrics import MetricRegistry

log = logging.getLogger(__name__)

#: Controller states (gauge codes in Controller.State).
STEADY = "steady"          # no stress, no ladder rung applied, no episode
STRESSED = "stressed"      # SLO burning / queue trending up; scaling out
DEGRADED = "degraded"      # at least one ladder rung is applied
RECOVERING = "recovering"  # stress gone, episode not yet closed

_STATE_CODES = {STEADY: 0, STRESSED: 1, DEGRADED: 2, RECOVERING: 3}


@dataclass
class LadderStep:
    """One reversible degradation rung: ``apply`` sheds load, ``revert``
    restores it. Steps are applied front-to-back and reverted back-to-
    front, so the cheapest concession is always the first taken and the
    last returned."""

    name: str
    apply: Callable[[], None]
    revert: Callable[[], None]
    applied: bool = False


@dataclass
class ControllerConfig:
    """Thresholds + hysteresis. Defaults suit the in-process fleet's
    millisecond report cadence; production TCP fleets scale them up with
    their report interval."""

    min_workers: int = 1
    max_workers: int = 8
    #: Seconds between scale actions (up or down) — one worker per
    #: cooldown keeps a burst from over-spawning before new capacity
    #: even reports in.
    scale_cooldown_s: float = 1.0
    #: Seconds between ladder transitions (either direction).
    step_cooldown_s: float = 0.5
    #: Consecutive healthy ticks required before ANY reversal (ladder
    #: revert or scale-down) — the anti-flap guard.
    healthy_ticks: int = 3
    #: Per-worker estimated queue depth (signatures) above which the
    #: fleet counts as stressed even without an SLO alert yet.
    queue_high: float = 256.0
    #: Per-worker depth below which the fleet counts as drained.
    queue_low: float = 32.0
    #: Scale-down additionally requires this much error budget left on
    #: every objective — never give capacity back while the budget is
    #: still scorched.
    budget_scale_down_pct: float = 50.0
    #: EWMA smoothing for the queue-depth trend signal.
    trend_alpha: float = 0.3
    #: Open device breakers count toward stress (a scheme falling back
    #: to host verify is a capacity loss the queue numbers lag on).
    breakers_stress: bool = True


class FleetController:
    """The control loop. Everything it observes and actuates is injected
    as a callable, so unit tests drive it with a fake clock and stub
    seams while production wires the real fleet (InProcessFleet.
    attach_controller / a node's fleet runner).

    ``tick()`` is one evaluation: gather signals, take at most one
    scale/ladder action (stale reaping is exempt — dead workers hold
    charged work hostage, so every tick sweeps them), update state.
    Thread-safe; callers run it from any timer loop.
    """

    def __init__(self, *, slo, worker_count: Callable[[], int],
                 queue_depth: Callable[[], float],
                 spawn: Callable[[], object] | None = None,
                 retire: Callable[[], object] | None = None,
                 reap_stale: Callable[[], list] | None = None,
                 breaker_open_count: Callable[[], int] | None = None,
                 ladder: tuple = (),
                 config: ControllerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: MetricRegistry | None = None):
        self.slo = slo
        self.config = config if config is not None else ControllerConfig()
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.clock = clock
        self._worker_count = worker_count
        self._queue_depth = queue_depth
        self._spawn = spawn
        self._retire = retire
        self._reap_stale = reap_stale
        self._breaker_open_count = breaker_open_count
        self.ladder: list[LadderStep] = list(ladder)
        self._lock = threading.RLock()
        self._state = STEADY
        self._healthy_streak = 0
        self._depth_trend: float | None = None
        self._last_scale = -float("inf")
        self._last_step = -float("inf")
        #: workers added by THIS controller and not yet given back — the
        #: controller only ever retires capacity it spawned, so a healthy
        #: fleet at its operator-provisioned size sees zero actions
        self._net_spawned = 0
        self._actions_total = 0
        self._recent: deque = deque(maxlen=64)
        self._episodes = 0
        self._episode_started: float | None = None
        self._episode_span = None
        self._recovery_s_last: float | None = None
        m = self.metrics
        m.gauge("Controller.State",
                lambda: _STATE_CODES.get(self._state, 0))
        m.gauge("Controller.LadderStep", lambda: self.ladder_step)
        m.gauge("Controller.Workers", lambda: int(self._worker_count()))
        m.meter("Controller.Actions")

    # -- signal views --------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def actions_total(self) -> int:
        return self._actions_total

    @property
    def ladder_step(self) -> int:
        return sum(1 for s in self.ladder if s.applied)

    def _alerts(self) -> list:
        if self.slo is None:
            return []
        try:
            return list(self.slo.alerts())
        except Exception:
            log.exception("SLO alert read failed")
            return []

    def _budget_ok(self) -> bool:
        """Every objective's remaining error budget clears the scale-down
        bar (vacuously true without an SLO tracker)."""
        if self.slo is None:
            return True
        try:
            return all(
                self.slo.error_budget_pct(obj)
                >= self.config.budget_scale_down_pct
                for obj in self.slo.objectives)
        except Exception:
            log.exception("SLO budget read failed")
            return False

    # -- the loop ------------------------------------------------------------
    def tick(self, now: float | None = None) -> list[dict]:
        """One control-loop evaluation; returns the actions it took (also
        recorded on the jlog/metrics/span planes)."""
        with self._lock:
            now = self.clock() if now is None else now
            cfg = self.config
            actions: list[dict] = []
            # dead workers first, in ANY state: their charged work is
            # unreachable until the crash-detach requeues it
            if self._reap_stale is not None:
                try:
                    reaped = list(self._reap_stale() or ())
                except Exception:
                    log.exception("stale reap failed")
                    reaped = []
                for w in reaped:
                    actions.append(self._act("stale_detach", now, worker=w))
            workers = max(1, int(self._worker_count()))
            depth = float(self._queue_depth())
            per_worker = depth / workers
            if self._depth_trend is None:
                self._depth_trend = per_worker
            else:
                self._depth_trend = (cfg.trend_alpha * per_worker
                                     + (1.0 - cfg.trend_alpha)
                                     * self._depth_trend)
            alerts = self._alerts()
            breakers_open = 0
            if cfg.breakers_stress and self._breaker_open_count is not None:
                try:
                    breakers_open = int(self._breaker_open_count())
                except Exception:
                    breakers_open = 0
            stressed = (bool(alerts)
                        or self._depth_trend > cfg.queue_high
                        or breakers_open > 0)
            healthy = (not alerts and breakers_open == 0
                       and self._depth_trend < cfg.queue_low)
            if stressed:
                self._healthy_streak = 0
                actions.extend(self._escalate_locked(now, workers, alerts,
                                                     per_worker))
            elif healthy:
                self._healthy_streak += 1
                if self._healthy_streak >= cfg.healthy_ticks:
                    actions.extend(self._relax_locked(now, workers))
            else:
                # in the hysteresis band: hold position, reset the streak
                # so a reversal needs SUSTAINED health, not a blip
                self._healthy_streak = 0
            self._update_state_locked(now, stressed, healthy)
            return actions

    def _escalate_locked(self, now: float, workers: int, alerts: list,
                         per_worker: float) -> list[dict]:
        cfg = self.config
        severity = alerts[0]["severity"] if alerts else "none"
        if (self._spawn is not None and workers < cfg.max_workers
                and now - self._last_scale >= cfg.scale_cooldown_s):
            self._last_scale = now
            try:
                spawned = self._spawn()
            except Exception:
                log.exception("controller spawn failed")
                return []
            self._net_spawned += 1
            return [self._act("scale_up", now, workers=workers + 1,
                              worker=str(spawned) if spawned else None,
                              severity=severity,
                              queue_per_worker=round(per_worker, 1))]
        step = next((s for s in self.ladder if not s.applied), None)
        if step is not None and now - self._last_step >= cfg.step_cooldown_s:
            self._last_step = now
            try:
                step.apply()
            except Exception:
                log.exception("ladder step %s apply failed", step.name)
                return []
            step.applied = True
            return [self._act("degrade", now, step=step.name,
                              rung=self.ladder_step, severity=severity,
                              queue_per_worker=round(per_worker, 1))]
        return []

    def _relax_locked(self, now: float, workers: int) -> list[dict]:
        cfg = self.config
        applied = [s for s in self.ladder if s.applied]
        if applied:
            if now - self._last_step < cfg.step_cooldown_s:
                return []
            step = applied[-1]
            self._last_step = now
            try:
                step.revert()
            except Exception:
                log.exception("ladder step %s revert failed", step.name)
                return []
            step.applied = False
            return [self._act("restore", now, step=step.name,
                              rung=self.ladder_step, opens_episode=False)]
        if (self._retire is not None and workers > cfg.min_workers
                and self._net_spawned > 0
                and self._budget_ok()
                and now - self._last_scale >= cfg.scale_cooldown_s):
            self._last_scale = now
            try:
                retired = self._retire()
            except Exception:
                log.exception("controller retire failed")
                return []
            self._net_spawned -= 1
            return [self._act("scale_down", now, workers=workers - 1,
                              worker=str(retired) if retired else None,
                              opens_episode=False)]
        return []

    def _update_state_locked(self, now: float, stressed: bool,
                             healthy: bool) -> None:
        if self.ladder_step > 0:
            new = DEGRADED
        elif stressed:
            new = STRESSED
        elif self._episode_started is not None:
            # past stress cooling off — stay out of "steady" until the
            # healthy streak clears the hysteresis bar
            new = (STEADY if self._healthy_streak >= self.config.healthy_ticks
                   else RECOVERING)
        else:
            new = STEADY
        if new == STEADY and self._episode_started is not None:
            self._recovery_s_last = now - self._episode_started
            jlog(log, "controller.recovered", level=logging.INFO,
                 recovery_s=round(self._recovery_s_last, 3),
                 actions=self._actions_total)
            if self._episode_span is not None:
                self._episode_span.set_tag(
                    "recovery_s", round(self._recovery_s_last, 3))
                self._episode_span.set_tag("actions", self._actions_total)
                self._episode_span.finish()
                self._episode_span = None
            self._episode_started = None
        self._state = new

    def _act(self, kind: str, now: float, opens_episode: bool = True,
             **fields) -> dict:
        """Record one action on every observability plane and open the
        episode if this is the first action since steady state. Relax
        actions (ladder restore, scale-down) pass ``opens_episode=False``
        — giving healthy capacity back is housekeeping, not an incident,
        so it must not start a new /traces timeline of its own."""
        fields = {k: v for k, v in fields.items() if v is not None}
        if self._episode_started is None and opens_episode:
            self._episode_started = now
            self._episodes += 1
            # an incident re-arms the hysteresis: health must be re-proven
            # from scratch before this episode may close
            self._healthy_streak = 0
            tracer = get_tracer()
            if tracer.enabled:
                self._episode_span = tracer.span("controller.episode",
                                                 episode=self._episodes)
        self._actions_total += 1
        self.metrics.meter("Controller.Actions").mark()
        self.metrics.meter(f"Controller.Actions.{kind}").mark()
        record = {"action": kind, "t": round(now, 3), **fields}
        self._recent.append(record)
        jlog(log, f"controller.{kind}", level=logging.INFO, **fields)
        if self._episode_span is not None:
            parent = self._episode_span.context()
            get_tracer().record(f"controller.{kind}", parent=parent,
                                **fields)
        return record

    # -- the /readyz + fleetstat block ---------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "workers": int(self._worker_count()),
                "queue_depth_trend": (round(self._depth_trend, 1)
                                      if self._depth_trend is not None
                                      else None),
                "ladder": [{"name": s.name, "applied": s.applied}
                           for s in self.ladder],
                "ladder_step": self.ladder_step,
                "actions_total": self._actions_total,
                "recent_actions": list(self._recent)[-8:],
                "episodes": self._episodes,
                "recovery_s_last": (round(self._recovery_s_last, 3)
                                    if self._recovery_s_last is not None
                                    else None),
                "healthy_streak": self._healthy_streak,
            }


def batcher_ladder(batchers) -> tuple:
    """The standard three-rung degradation ladder over a set of
    SignatureBatchers (one per fleet worker, or a node's single batcher):
    shed bulk admission first, shrink the bulk batch ladder second, route
    interactive to host verify last. Each rung fans out to every batcher
    in the (live) sequence — pass a mutable list and newly spawned
    workers' batchers inherit the currently applied rungs via
    ``apply_degradations``."""

    def _fan(method: str, on: bool) -> None:
        for b in list(batchers):
            try:
                getattr(b, method)(on)
            except Exception:
                log.exception("%s(%s) failed on %r", method, on, b)

    return (
        LadderStep("shed_bulk",
                   apply=lambda: _fan("shed_bulk", True),
                   revert=lambda: _fan("shed_bulk", False)),
        LadderStep("shrink_ladder",
                   apply=lambda: _fan("shrink_ladder", True),
                   revert=lambda: _fan("shrink_ladder", False)),
        LadderStep("host_route_interactive",
                   apply=lambda: _fan("route_interactive_host", True),
                   revert=lambda: _fan("route_interactive_host", False)),
    )


def apply_degradations(ladder, batcher) -> None:
    """Bring a newly spawned worker's batcher up to the fleet's currently
    applied degradation rungs (a worker joining mid-episode must not
    undercut the shed)."""
    for step in ladder:
        if not step.applied:
            continue
        method = {"shed_bulk": "shed_bulk",
                  "shrink_ladder": "shrink_ladder",
                  "host_route_interactive": "route_interactive_host"
                  }.get(step.name)
        if method is None:
            continue
        try:
            getattr(batcher, method)(True)
        except Exception:
            log.exception("applying %s to spawned batcher failed", step.name)
