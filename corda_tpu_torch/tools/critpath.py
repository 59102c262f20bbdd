"""critpath — tail forensics report for a node's commit path.

Renders the /debug/critpath payload (observability/critpath.py): the
per-flow-class critical-path blame decomposition and the top-K slowest
transactions with their annotated blocking chains. Two sources::

    python -m corda_tpu_torch.tools.critpath http://127.0.0.1:8080
    python -m corda_tpu_torch.tools.critpath --jsonl spans.jsonl

The first polls a live node webserver; the second replays a span export
(/traces?format=jsonl) offline, recomputing the decomposition locally —
the post-mortem path when the node is gone but the spans survived.

``render()`` is a pure function of the report dict — the unit tests
drive it with canned payloads, no HTTP involved.
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from ..observability.critpath import COMPONENTS, critpath_report


def fetch_report(base_url: str, top_k: int, timeout: float = 5.0) -> dict:
    url = f"{base_url.rstrip('/')}/debug/critpath?top_k={top_k}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def report_from_jsonl(path: str, top_k: int) -> dict:
    """Group a /traces JSONL export by trace_id and decompose locally.
    Malformed lines are skipped (a truncated export must still render)."""
    traces: dict = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                span = json.loads(line)
            except ValueError:
                continue
            if isinstance(span, dict) and span.get("trace_id"):
                traces.setdefault(span["trace_id"], []).append(span)
    return critpath_report(traces, top_k=top_k)


def _fmt_blame(blame: dict) -> str:
    """``component=ms`` pairs, largest share first, known components in
    canonical order on ties."""
    if not isinstance(blame, dict) or not blame:
        return "-"
    order = {c: i for i, c in enumerate(COMPONENTS)}
    items = sorted(blame.items(),
                   key=lambda kv: (-_num(kv[1]), order.get(kv[0], 99)))
    return " ".join(f"{k}={_num(v):.1f}ms" for k, v in items)


def _num(v) -> float:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else 0.0


def render(report: dict) -> str:
    """One screenful: per-class blame vectors + the top-K slowest
    transactions with their blocking chains. Tolerates empty/malformed
    payloads (a node with tracing off answers with zero traces)."""
    if not isinstance(report, dict):
        report = {}
    lines = [f"critical paths over {report.get('traces', 0)} traces"]
    per_class = report.get("per_class")
    if isinstance(per_class, dict) and per_class:
        lines.append(f"{'CLASS':<8}{'N':>5}{'E2E_P50':>10}{'E2E_P99':>10}"
                     f"  {'DOMINANT':<18}BLAME(P50)")
        for kind in sorted(per_class):
            c = per_class[kind]
            if not isinstance(c, dict):
                continue
            lines.append(
                f"{kind:<8}{c.get('n', 0):>5}"
                f"{_num(c.get('e2e_ms_p50')):>10.1f}"
                f"{_num(c.get('e2e_ms_p99')):>10.1f}"
                f"  {str(c.get('dominant', '-')):<18}"
                f"{_fmt_blame(c.get('blame_p50'))}")
    else:
        lines.append("(no per-class decomposition — tracing off or no "
                     "classified flows)")
    top = report.get("top")
    if isinstance(top, list) and top:
        lines.append("")
        lines.append("slowest transactions:")
        for cp in top:
            if not isinstance(cp, dict):
                continue
            tid = str(cp.get("trace_id", "?"))[:16]
            lines.append(f"  {tid:<18}{_num(cp.get('e2e_ms')):>9.1f}ms  "
                         f"{str(cp.get('flow_type') or cp.get('root_name') or '?')}")
            segs = cp.get("segments")
            if isinstance(segs, list):
                for seg in segs:
                    if not isinstance(seg, dict):
                        continue
                    kind = seg.get("wait_kind")
                    lines.append(
                        f"      {_num(seg.get('ms')):>9.1f}ms  "
                        f"{str(seg.get('component', '?')):<18}"
                        f"{str(seg.get('name', '?'))}"
                        + (f" [{kind}]" if kind else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="critpath",
        description="critical-path tail-forensics report")
    ap.add_argument("url", nargs="?", default=None,
                    help="node webserver base URL "
                         "(e.g. http://127.0.0.1:8080)")
    ap.add_argument("--jsonl", default=None, metavar="PATH",
                    help="replay a /traces?format=jsonl span export "
                         "instead of polling a node")
    ap.add_argument("--top", type=int, default=10,
                    help="slow-transaction count (default 10)")
    args = ap.parse_args(argv)
    if (args.url is None) == (args.jsonl is None):
        ap.error("exactly one of URL or --jsonl is required")
    try:
        report = (report_from_jsonl(args.jsonl, args.top)
                  if args.jsonl is not None
                  else fetch_report(args.url, args.top))
    except Exception as e:
        print(f"critpath: cannot load report: {e}", file=sys.stderr)
        return 1
    print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
