"""Audit service: the typed audit-event taxonomy + recording service.

Reference parity: services/api/AuditService.kt:14-93 — the sealed AuditEvent
hierarchy (FlowAppAuditEvent, FlowPermissionAuditEvent, FlowProgressAuditEvent,
FlowErrorAuditEvent, SystemAuditEvent) and the AuditService SPI the node
records into. The reference ships this as a skeleton (events defined, an
in-memory recorder); here the node actually records flow lifecycle +
permission decisions (see StateMachineManager and CordaRPCOps call sites).
"""
from __future__ import annotations

import datetime
import threading
from dataclasses import dataclass, field
from typing import Any, Callable


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


@dataclass(frozen=True)
class AuditEvent:
    """Base of all audit events (AuditService.kt AuditEvent)."""

    description: str
    principal: str = "node"
    context: dict = field(default_factory=dict)
    timestamp: datetime.datetime = field(default_factory=_now)


@dataclass(frozen=True)
class FlowAuditEvent(AuditEvent):
    """An event tied to one flow instance (FlowAppAuditEvent shape)."""

    flow_type: str = ""
    flow_id: str = ""


@dataclass(frozen=True)
class FlowStartEvent(FlowAuditEvent):
    pass


@dataclass(frozen=True)
class FlowProgressAuditEvent(FlowAuditEvent):
    """Progress-tracker step transition (FlowProgressAuditEvent)."""

    step: str = ""


@dataclass(frozen=True)
class FlowErrorAuditEvent(FlowAuditEvent):
    error: str = ""


@dataclass(frozen=True)
class FlowPermissionAuditEvent(FlowAuditEvent):
    """A permission check on starting/operating a flow
    (FlowPermissionAuditEvent: permissionRequested/permissionGranted)."""

    permission_requested: str = ""
    permission_granted: bool = False


@dataclass(frozen=True)
class SystemAuditEvent(AuditEvent):
    pass


class AuditService:
    """SPI: record one event. The node default keeps an in-memory log with
    observer callbacks (the persistence backend is a storage concern, same
    stance as the reference's skeleton)."""

    def record_audit_event(self, event: AuditEvent) -> None:
        raise NotImplementedError


class InMemoryAuditService(AuditService):
    def __init__(self, capacity: int = 10_000):
        self._lock = threading.Lock()
        self._events: list[AuditEvent] = []
        self._capacity = capacity
        self._observers: list[Callable[[AuditEvent], Any]] = []

    def record_audit_event(self, event: AuditEvent) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self._capacity:
                del self._events[: len(self._events) - self._capacity]
            observers = list(self._observers)
        for cb in observers:
            cb(event)

    def add_observer(self, cb: Callable[[AuditEvent], Any]) -> None:
        with self._lock:
            self._observers.append(cb)

    def events(self, of_type: type | None = None) -> list[AuditEvent]:
        with self._lock:
            evs = list(self._events)
        if of_type is not None:
            evs = [e for e in evs if isinstance(e, of_type)]
        return evs
