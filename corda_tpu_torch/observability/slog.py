"""Structured JSON log lines with trace correlation.

One line per event, machine-parseable, carrying the same ``trace_id`` the
span tracer propagates — so a grep for one trace id walks a transaction
through the state machine, the signature batcher, the notary, and raft in
ORDER, even with tracing's span ring disabled or long since wrapped.

Events are emitted at DEBUG level: a production node runs silent by
default and an operator flips one logger ("corda_tpu_torch") to DEBUG to start
recording. The formatting cost is paid only when the level is enabled
(``isEnabledFor`` gate before any JSON work).

    from corda_tpu_torch.observability.slog import jlog
    jlog(log, "batcher.flush", ctx, bucket="ed25519", batch_size=512)
    # {"event": "batcher.flush", "trace_id": "…", "span_id": "…",
    #  "ts": 1754…, "bucket": "ed25519", "batch_size": 512}
"""
from __future__ import annotations

import json
import logging
import time

from .tracing import Span, SpanContext


def _trace_ids(ctx) -> tuple[str | None, str | None]:
    """SpanContext / Span / (trace_id, span_id) wire tuple / None →
    (trace_id, span_id)."""
    if ctx is None:
        return None, None
    if isinstance(ctx, (SpanContext, Span)):
        return ctx.trace_id, ctx.span_id
    if isinstance(ctx, (tuple, list)) and len(ctx) == 2:
        return ctx[0], ctx[1]
    return None, None


def jlog(logger: logging.Logger, event: str, ctx=None,
         level: int = logging.DEBUG, **fields) -> None:
    """Emit one structured JSON log line (no-op when ``level`` is off)."""
    if not logger.isEnabledFor(level):
        return
    rec: dict = {"event": event, "ts": round(time.time(), 6)}
    trace_id, span_id = _trace_ids(ctx)
    if trace_id is not None:
        rec["trace_id"] = trace_id
        rec["span_id"] = span_id
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    try:
        line = json.dumps(rec, sort_keys=True, default=str)
    except (TypeError, ValueError):
        line = json.dumps({"event": event, "ts": rec["ts"],
                           "error": "unserializable fields"})
    logger.log(level, "%s", line)
