"""A device trace of the measured window, and its reduction.

torch.profiler records the card's activity (kernels, copies, memsets)
through CUPTI, for every thread of the process. CPU activity is recorded
on the client thread only, where the window's marker sits: that marker
ties the trace's clock to the host's, so the program's spans (host
wall-clock) can say what the host was doing in each idle gap.
"""
from __future__ import annotations

import os
import tempfile
import time

from .yardsticks import busy_seconds, device_intervals

MARKER = "portbench.window"

#: Program spans that name host work, and those that only wait or enclose
#: others: an idle gap is labelled by the span of the first kind that
#: covers most of it, or failing one, of the second.
WORK_SPANS = ("verifier.resolve", "batcher.dispatch", "batcher.resolve")
WAIT_SPANS = ("batcher.device_wait", "verifier.run", "tx.verify")


class DeviceTrace:
    """The reduction of one traced window: device busy seconds, seconds per
    device operation, and the idle gaps."""

    def __init__(self, merged, ops, lo_us, hi_us):
        self.lo_us, self.hi_us = lo_us, hi_us
        self.busy_s = busy_seconds(merged, lo_us, hi_us)
        self.window_s = (hi_us - lo_us) / 1e6
        self.op_s: dict = {}
        for name, ts, dur in ops:
            a, b = max(ts, lo_us), min(ts + dur, hi_us)
            if b > a:
                self.op_s[name] = self.op_s.get(name, 0.0) + (b - a) / 1e6
        self.gaps = []
        prev = lo_us
        for a, b in merged:
            a, b = max(a, lo_us), min(b, hi_us)
            if b <= a:
                continue
            if a > prev:
                self.gaps.append((prev, a))
            prev = max(prev, b)
        if hi_us > prev:
            self.gaps.append((prev, hi_us))

    def seconds_of(self, substrings) -> float:
        """Summed device seconds of the operations whose name holds one of
        ``substrings``."""
        return sum(s for name, s in self.op_s.items()
                   if any(x in name for x in substrings))

    def top_ops(self) -> list:
        """The ten device operations with the most summed time."""
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        return [[n, s] for n, s in ops]

    def idle_gaps(self, spans, offset_us) -> list:
        """The ten longest idle gaps, each labelled by the program span
        that covers most of it (``offset_us`` maps host wall-clock
        microseconds to the trace's clock; None: no label)."""
        spans_us = [] if offset_us is None else [
            (s["name"], s["start_s"] * 1e6 + offset_us,
             (s["start_s"] + s["duration_s"]) * 1e6 + offset_us)
            for s in spans if s["name"] in WORK_SPANS + WAIT_SPANS]
        gaps = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]:
            cover: dict = {}
            for name, s0, s1 in spans_us:
                o = min(b, s1) - max(a, s0)
                if o > 0:
                    cover[name] = cover.get(name, 0.0) + o
            work = {k: v for k, v in cover.items() if k in WORK_SPANS}
            pick = work or cover
            label = (max(pick, key=pick.get) if pick
                     else "no program span")
            gaps.append([label, (b - a) / 1e6])
        return gaps


def traced(fn):
    """Run ``fn()`` under torch.profiler; ``fn`` returns (window, ...),
    the window with wall-clock bounds ``wall0`` / ``wall_end``. Returns
    (fn's result, DeviceTrace of the window or None where the trace holds
    no device operation, offset from host wall-clock microseconds to trace
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(MARKER):
            mark_wall = time.time()
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        merged, ops, events = device_intervals(path)
    finally:
        os.remove(path)
    offset = None
    for e in events:
        if e.get("name") == MARKER and e.get("ph") == "X":
            offset = float(e["ts"]) - mark_wall * 1e6
            break
    if offset is None or not ops:
        return out, None, offset
    lo = out[0].wall0 * 1e6 + offset
    hi = out[0].wall_end * 1e6 + offset
    return out, DeviceTrace(merged, ops, lo, hi), offset
