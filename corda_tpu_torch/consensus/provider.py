"""Shared commit path for consensus-backed uniqueness providers.

Both the Raft and BFT notary backends expose submit()/abandon() and apply
the same DistributedImmutableMap commands; this is the one place the
blocking commit semantics (timeout, pending-table hygiene, conflict
surfacing) live.
"""
from __future__ import annotations

import concurrent.futures
import time as _time

from ..node.notary import UniquenessException
from ..utils import retry


class _LeaderUnknown(RuntimeError):
    """Transient leaderless window — retried by consensus_round."""


class _RoundStuck(concurrent.futures.TimeoutError):
    """A submit whose pending entry outlived the per-attempt wait —
    typically stranded on a deposed leader whose log entry will never
    reach quorum. Abandoned and re-submitted: every state-machine
    command is idempotent for the same tx, so a re-submit that races a
    late commit of the original entry just reads its own verdict."""


def consensus_round(backend, command, timeout_s: float, trace_ctx=None,
                    on_attempt=None, site: str = "raft.submit",
                    attempt_timeout_s: float | None = None,
                    timing: dict | None = None):
    """One blocking replicated-state-machine round: submit ``command`` to
    `backend` (RaftNode or BFTClient), retrying leaderless windows with
    decorrelated-jitter backoff inside the timeout budget, abandoning the
    pending entry on timeout so the request table cannot leak. Returns the
    apply result verbatim — callers interpret verdicts. ``on_attempt`` (if
    given) is called once per actual submit, the seam the GroupCommitter
    uses to count real raft appends. ``site`` names the retry site on the
    Retry.* meters, so distinct callers — the per-transaction path vs the
    GroupCommitter's batched cut — burn visibly separate retry budgets.

    ``attempt_timeout_s`` bounds ONE submit's wait: a round still pending
    after that long is abandoned and re-submitted (fresh leader lookup)
    instead of burning the whole ``timeout_s`` on an entry stranded on a
    deposed leader. None keeps the single-wait behaviour.

    ``timing`` (optional dict) receives the last attempt's exact clocks
    when the backend stamps them: ``submit_perf`` (just before submit) and
    ``resolved_perf`` (the backend's resolution stamp) — the consensus
    observatory's waiter-wakeup-free round measurement."""

    def _submit(ctx):
        kwargs = {}
        if getattr(backend, "supports_trace_ctx", False):
            kwargs["trace_ctx"] = ctx
        if on_attempt is not None:
            on_attempt()
        if timing is not None:
            timing["submit_perf"] = _time.perf_counter()
            timing.pop("resolved_perf", None)
        fut = backend.submit(command, **kwargs)
        wait_s = timeout_s if attempt_timeout_s is None \
            else min(attempt_timeout_s, timeout_s)
        try:
            result = fut.result(timeout=wait_s)
            if timing is not None:
                resolved = getattr(fut, "raft_resolved_perf", None)
                if isinstance(resolved, float):
                    timing["resolved_perf"] = resolved
            return result
        except concurrent.futures.TimeoutError:
            backend.abandon(fut)
            if attempt_timeout_s is None:
                raise
            raise _RoundStuck(
                f"round still pending after {wait_s:g}s at {site}")
        except RuntimeError as e:
            # only the leadership errors are retryable; anything else
            # (a replica bug, a closed backend) propagates immediately
            if "leader" in str(e):
                raise _LeaderUnknown(str(e)) from e
            raise

    def _sleep_traced(delay: float) -> None:
        # wait-state span over the leaderless backoff: the retry sleep is
        # commit-path dead time, so it rides the transaction's trace with
        # a wait_kind instead of vanishing into retry_call (critpath.py
        # charges it to the raft.leaderless blame component)
        t0 = _time.time()
        _time.sleep(delay)
        if trace_ctx is not None:
            from ..observability import get_tracer
            get_tracer().record(
                "wait.raft_leaderless", parent=trace_ctx, start_s=t0,
                duration_s=_time.time() - t0,
                wait_kind="raft.leaderless", site=site)

    retry_on = (_LeaderUnknown,) if attempt_timeout_s is None \
        else (_LeaderUnknown, _RoundStuck)
    return retry.retry_call(
        lambda: _submit(trace_ctx), site=site,
        policy=retry.RetryPolicy(base_s=0.05, cap_s=0.5, max_attempts=6,
                                 deadline_s=timeout_s),
        retry_on=retry_on, sleep=_sleep_traced)


def consensus_commit(backend, states, tx_id, caller: str,
                     timeout_s: float, trace_ctx=None, metrics=None) -> None:
    """Submit a put_all to `backend` (RaftNode or BFTClient) and block until
    the replicated state machine answers; abandon the pending entry on
    timeout so the request table cannot leak.

    A leaderless window (mid-election, or the leader just died) surfaces
    as ``RuntimeError("no raft leader known")`` from submit() — that is
    transient by construction, so the submission retries with
    decorrelated-jitter backoff inside the caller's timeout budget
    instead of failing the whole notarisation.

    ``trace_ctx`` parents a ``raft.commit`` span over the whole blocking
    round (retries included) and threads into backend.submit's own
    ``raft.submit`` spans when the backend supports it; ``metrics`` (a
    MetricRegistry, optional) receives the ``raft_commit_seconds``
    commit-path stage histogram."""
    from ..observability import get_tracer

    with get_tracer().span("raft.commit", parent=trace_ctx,
                           n_states=len(states), caller=caller) as sp:
        ctx = sp.context() or trace_ctx
        t0 = _time.perf_counter()
        deadline = _time.monotonic() + timeout_s
        try:
            while True:
                result = consensus_round(
                    backend, ("put_all", [tx_id, list(states), caller]),
                    timeout_s, trace_ctx=ctx)
                if result["committed"] or not result.get("provisional"):
                    break
                # every conflict is a revocable cross-shard reservation:
                # the holder may release, so retry inside the timeout
                # budget instead of handing back a terminal double-spend
                # verdict for a state that was never consumed
                if _time.monotonic() + 0.05 >= deadline:
                    break
                _time.sleep(0.05)
        finally:
            if metrics is not None:
                trace_id = getattr(ctx, "trace_id", None)
                metrics.histogram("raft_commit_seconds").update(
                    _time.perf_counter() - t0, trace_id=trace_id)
    if not result["committed"]:
        raise UniquenessException(result["conflicts"])
