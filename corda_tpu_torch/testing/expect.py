"""Expect — declarative assertions over event streams.

Reference parity: test-utils Expect.kt:1-303 — compose `expect` leaves with
`sequence` (ordered), `parallel` (any interleaving), and `repeat`, then run
the compiled expectation against a recorded event list. Used for asserting
vault updates, state-machine changes and message transfers in tests.

    run_expectations(events, sequence(
        expect(VaultUpdate, lambda u: len(u.produced) == 1),
        parallel(expect(str, lambda s: s == "a"), expect(str, lambda s: s == "b")),
    ))
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


class ExpectationFailed(AssertionError):
    pass


@dataclass
class _Leaf:
    match_type: type
    predicate: Callable[[Any], bool]

    def describe(self) -> str:
        return f"expect({self.match_type.__name__})"


@dataclass
class _Sequence:
    children: tuple


@dataclass
class _Parallel:
    children: tuple


def expect(match_type: type = object,
           predicate: Callable[[Any], bool] = lambda e: True) -> _Leaf:
    return _Leaf(match_type, predicate)


def sequence(*children) -> _Sequence:
    return _Sequence(tuple(children))


def parallel(*children) -> _Parallel:
    return _Parallel(tuple(children))


def repeat(n: int, child) -> _Sequence:
    return _Sequence(tuple(child for _ in range(n)))


def _simplify(node):
    """Collapse vacuously-satisfied nodes (empty sequence/parallel) to None."""
    if node is None or isinstance(node, _Leaf):
        return node
    children = tuple(c for c in (_simplify(c) for c in node.children)
                     if c is not None)
    if not children:
        return None
    return type(node)(children)


def _next_leaves(node) -> list:
    """The set of leaves that may legally match the next event."""
    if isinstance(node, _Leaf):
        return [node]
    if isinstance(node, _Sequence):
        return _next_leaves(node.children[0])
    if isinstance(node, _Parallel):
        out = []
        for c in node.children:
            out.extend(_next_leaves(c))
        return out
    raise TypeError(node)


def _consume(node, leaf):
    """Return the expectation tree with `leaf` satisfied, or None if empty."""
    if isinstance(node, _Leaf):
        return None if node is leaf else node
    if isinstance(node, _Sequence):
        head = _consume(node.children[0], leaf)
        rest = node.children[1:]
        children = ((head,) if head is not None else ()) + rest
        return _Sequence(children) if children else None
    if isinstance(node, _Parallel):
        children = []
        consumed = False
        for c in node.children:
            if not consumed and leaf in _next_leaves(c):
                reduced = _consume(c, leaf)
                consumed = True
                if reduced is not None:
                    children.append(reduced)
            else:
                children.append(c)
        return _Parallel(tuple(children)) if children else None
    raise TypeError(node)


def run_expectations(events, expectation, strict: bool = True) -> None:
    """Match the expectation tree against the event list with full
    backtracking over ambiguous parallel branches.

    ``strict`` (the reference's default, Expect.kt isStrict): every event
    must match some expectation — an unexpected event fails the run.
    Non-strict skips events no leaf wants. Predicate exceptions propagate
    (a broken predicate is a broken test, not a non-match)."""
    events = list(events)

    def attempt(node, idx) -> bool:
        if node is None:
            # all expectations satisfied; strict additionally requires no
            # trailing unexpected events
            return idx == len(events) if strict else True
        if idx == len(events):
            return False
        event = events[idx]
        for leaf in _next_leaves(node):
            if isinstance(event, leaf.match_type) and leaf.predicate(event):
                if attempt(_simplify(_consume(node, leaf)), idx + 1):
                    return True
        if not strict:
            return attempt(node, idx + 1)
        return False

    node = _simplify(expectation)
    if node is None:
        if strict and events:
            raise ExpectationFailed(
                f"Strict mode: {len(events)} unexpected event(s), first: "
                f"{events[0]!r}")
        return
    if not attempt(node, 0):
        raise ExpectationFailed(
            f"No assignment of {len(events)} events satisfies the "
            f"expectations (strict={strict}); remaining shape: {node}")
