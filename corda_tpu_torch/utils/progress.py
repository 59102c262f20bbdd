"""ProgressTracker — hierarchical flow progress with a change stream.

Reference parity: core/utilities/ProgressTracker.kt:37-125 — a flow declares
ordered `Step`s, may attach a child tracker to a step, and observers receive
(tracker, change) events as the current step moves; the RPC layer streams
these to clients (stateMachinesAndUpdates) and the shell renders them
(ANSIProgressRenderer).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Step:
    label: str


UNSTARTED = Step("Unstarted")
DONE = Step("Done")


class ProgressTracker:
    def __init__(self, *steps: Step):
        self.steps = (UNSTARTED, *steps, DONE)
        self._index = 0
        self._children: dict[Step, "ProgressTracker"] = {}
        self._observers: list[Callable] = []
        self.parent: "ProgressTracker | None" = None

    # -- state ---------------------------------------------------------------
    @property
    def current_step(self) -> Step:
        return self.steps[self._index]

    @current_step.setter
    def current_step(self, step: Step) -> None:
        if step not in self.steps:
            raise ValueError(f"{step} is not a step of this tracker")
        self._index = self.steps.index(step)
        self._emit(("position", self, step))

    def next_step(self) -> Step:
        if self._index < len(self.steps) - 1:
            self._index += 1
            self._emit(("position", self, self.current_step))
        return self.current_step

    @property
    def has_ended(self) -> bool:
        return self.current_step == DONE

    # -- hierarchy -----------------------------------------------------------
    def set_child_progress_tracker(self, step: Step,
                                   child: "ProgressTracker") -> None:
        self._children[step] = child
        child.parent = self
        child._observers.append(self._emit)

    def get_child_progress_tracker(self, step: Step):
        return self._children.get(step)

    # -- observation ---------------------------------------------------------
    def subscribe(self, observer: Callable) -> None:
        self._observers.append(observer)

    def _emit(self, change) -> None:
        for obs in list(self._observers):
            obs(change)

    # -- rendering (the shell's ANSIProgressRenderer line format) ------------
    def render(self, indent: int = 0) -> str:
        lines = []
        for i, step in enumerate(self.steps[1:-1], start=1):
            marker = ("✓" if i < self._index
                      else "▶" if i == self._index else " ")
            lines.append("  " * indent + f"{marker} {step.label}")
            child = self._children.get(step)
            if child is not None:
                lines.append(child.render(indent + 1))
        return "\n".join(lines)
