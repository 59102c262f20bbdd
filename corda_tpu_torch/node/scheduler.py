"""NodeSchedulerService — time-triggered flows from schedulable states.

Reference parity: node/services/events/NodeSchedulerService.kt:44,97,176-212
+ ScheduledActivityObserver: states implementing
`next_scheduled_activity(ref, factory)` get their flow started when the
scheduled instant arrives; consuming the state unschedules it. The clock is
injectable (TestClock semantics) and `wake(now)` is the explicit trigger in
deterministic tests; production wraps it in a timer thread.
"""
from __future__ import annotations

import datetime
import threading

from ..core.contracts.structures import SchedulableState, ScheduledActivity
from ..core.serialization.codec import exact_epoch_micros


class FlowLogicRefFactory:
    """Checkpointable references to flow constructions
    (statemachine/FlowLogicRefFactoryImpl.kt): a (class name, args) pair that
    can be stored inside a state and instantiated later."""

    @staticmethod
    def create(flow_class, *args):
        from ..flows.api import flow_name
        return [flow_name(flow_class), list(args)]

    @staticmethod
    def to_flow_logic(ref):
        from ..node.statemachine import _import_flow_class
        cls = _import_flow_class(ref[0])
        return cls(*ref[1])


class NodeSchedulerService:
    def __init__(self, hub, clock=None):
        self.hub = hub
        self.clock = clock or (lambda: datetime.datetime.now(datetime.timezone.utc))
        self._lock = threading.Lock()
        self._scheduled: dict = {}   # StateRef -> ScheduledActivity

    def start(self) -> None:
        """Observe the vault: produced schedulable states schedule, consumed
        ones unschedule (ScheduledActivityObserver)."""
        self.hub.vault.add_update_observer(self._on_vault_update)

    def _on_vault_update(self, update) -> None:
        with self._lock:
            for sar in update.consumed:
                self._scheduled.pop(sar.ref, None)
            for sar in update.produced:
                state = sar.state.data
                if isinstance(state, SchedulableState):
                    activity = state.next_scheduled_activity(
                        sar.ref, FlowLogicRefFactory)
                    if activity is not None:
                        self._scheduled[sar.ref] = activity

    # -- triggering ----------------------------------------------------------
    def next_deadline_micros(self) -> int | None:
        with self._lock:
            if not self._scheduled:
                return None
            return min(exact_epoch_micros(a.scheduled_at)
                       if hasattr(a.scheduled_at, "tzinfo") else a.scheduled_at
                       for a in self._scheduled.values())

    def wake(self, now: datetime.datetime | None = None) -> list:
        """Fire every activity due at `now` (tests pass a TestClock instant;
        a production timer thread calls this periodically). Returns the
        started state machines."""
        now = now or self.clock()
        now_micros = exact_epoch_micros(now)
        due = []
        with self._lock:
            for ref, activity in list(self._scheduled.items()):
                at = activity.scheduled_at
                at_micros = exact_epoch_micros(at) if hasattr(at, "tzinfo") else at
                if at_micros <= now_micros:
                    due.append((ref, activity))
                    del self._scheduled[ref]
        started = []
        for ref, activity in due:
            flow = FlowLogicRefFactory.to_flow_logic(activity.flow_ref)
            fsm = self.hub.smm.add(flow)
            started.append(fsm)
        return started
