"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

A cell (``cells/<name>.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``); the mix names the program's entry that it
drives (``entries/<entry>.py``) and the loop that drives it
(``loops/<loop>.py``). The metrics a run reports are those that
``BENCHMARK.json`` gives the cell, each read by ``metrics/<metric>.py``.
The harness finds all of them by name, so a cell, a mix or a metric is
added as a file, and an entry or a loop as a module.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import multiprocessing
import os
import random
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import entries
import loops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Top-level modules that may not be loaded in the process that prints a
#: result: JAX and the JAX package (compared by whole top-level name, since
#: the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "corda_tpu")

#: Spans the tracer's ring holds in a traced window.
RING_CAPACITY = 1_000_000

#: Processes that make the inputs and run the reference: fixed, so that a
#: run's set-up does not depend on the host's count of cores (the card's
#: machine has 8; one is the run's own).
POOL_WIDTH = 7


class NoCard(RuntimeError):
    pass


def load(kind: str, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout that holds ``root``."""
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell_name: str) -> dict:
    """{"end_to_end": [names], "per_layer": [names]}: the metrics that
    ``BENCHMARK.json`` gives the cell (those that list it under
    ``workloads``, and those that list no cells)."""
    if cell_name not in {w["name"] for w in bench["workloads"]}:
        raise ValueError(f"{cell_name} is no workload of BENCHMARK.json")
    return {kind: [m["name"] for m in bench[kind]
                   if cell_name in m.get("workloads", [cell_name])]
            for kind in ("end_to_end", "per_layer")}


def metric_readers(names, root: str = ROOT) -> dict:
    """{name: module} of the readers ``metrics/<name>.py``."""
    out = {}
    for name in names:
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            os.path.join(root, "metrics", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def input_pool() -> ProcessPoolExecutor:
    """The processes that make the inputs. Forked while the process still
    has one thread, as a run starts them: no resource-tracker process is
    left behind and no named semaphore stays in /dev/shm. A process that
    already has threads (a test) spawns them."""
    method = "fork" if threading.active_count() == 1 else "spawn"
    return ProcessPoolExecutor(POOL_WIDTH,
                               mp_context=multiprocessing.get_context(method))


def reference_pool() -> ProcessPoolExecutor:
    """The processes that run the reference once the window has closed:
    spawned, since the run has threads and CUDA by then."""
    return ProcessPoolExecutor(POOL_WIDTH,
                               mp_context=multiprocessing.get_context("spawn"))


def _hist(batcher, name):
    h = batcher.metrics.histogram(name)
    return h.count, h.total


def _readings(batcher) -> dict:
    return {"verifier_batch_size": _hist(batcher, "verifier_batch_size"),
            "verifier_prep_seconds": _hist(batcher, "verifier_prep_seconds"),
            "device_checked":
                batcher.metrics.meter("SigBatcher.DeviceChecked").count}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, tuple):
            out[k] = tuple(a - b for a, b in zip(v, before[k]))
        else:
            out[k] = v - before[k]
    return out


def make_inputs(pool, seed: int, mix: dict, config: dict):
    """Start the pool's input jobs of the mix's entry; returns a function
    that collects their rows (one a distinct input), in an order drawn
    from the seed."""
    entry = entries.load(mix["entry"])
    futs = [pool.submit(entry.chunk, job)
            for job in entry.jobs(seed, mix, config, POOL_WIDTH)]

    def collect():
        rows = sorted((r for f in futs for r in f.result()),
                      key=lambda r: r[0])
        random.Random(seed).shuffle(rows)
        return rows
    return collect


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, overrides=None,
             t_start: float | None = None) -> dict:
    """Run one cell once; returns the result line's object. Raises NoCard
    where the cell's chips are not there."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load("cells", cell_name, root)
    config = load("configs", cell["config"], root)
    mix = dict(load("traffic", cell["traffic"], root))
    mix.update(overrides or {})
    names = cell_metrics(manifest(root), cell_name)
    readers = metric_readers(names["per_layer" if trace else "end_to_end"],
                             root)
    entry = entries.load(mix["entry"])
    loop_kind = loops.load(mix["loop"])
    with input_pool() as pool:
        t_inputs = time.perf_counter()
        collect = make_inputs(pool, seed, mix, config)
        target, times = _set_up(cell_name, cell, config, mix, entry, device)
        t0 = time.perf_counter()
        rows = collect()
        times["wait"] = time.perf_counter() - t0
    # the pool is closed before the window: no process of the harness but
    # the run's own is alive while it measures
    times["inputs"] = time.perf_counter() - t_inputs
    log(f"inputs: {len(rows)} distinct in {times['inputs']:.3f} s on "
        f"{POOL_WIDTH} processes ({times['wait']:.3f} s waited after the "
        f"program was ready)")
    prepared = entry.prepare(rows, seed, mix, config)
    del rows
    return _run(cell_name, cell, config, mix, entry, loop_kind, target,
                prepared, seconds, trace, device, readers, t_start, times)


def _set_up(cell_name, cell, config, mix, entry, device):
    """Import the program, reach the card and build the system under test;
    (target, seconds of each step)."""
    t0 = time.perf_counter()
    import torch
    import corda_tpu_torch.verifier  # noqa: F401  (the port, timed here)
    times = {"import": time.perf_counter() - t0}
    if device.startswith("cuda") and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.get("chips", 1)):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"{cell_name} needs {cell.get('chips', 1)} CUDA "
                     f"device(s); torch sees {seen}")
    t0 = time.perf_counter()
    if device.startswith("cuda"):
        torch.cuda.init()
        torch.zeros(1, device=device)
    times["cuda"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    target = entry.build_target(config, mix, device)
    times["target"] = time.perf_counter() - t0
    return target, times


def _run(cell_name, cell, config, mix, entry, loop_kind, target, prepared,
         seconds, trace, device, readers, t_start, times) -> dict:
    import torch
    on_card = device.startswith("cuda")
    batcher = entry.batcher_of(target)
    per_submission = prepared.per_submission
    t_loop = time.perf_counter()
    loop = loop_kind.make(
        entry.submitter(target, mix, prepared.program_inputs),
        entry.outcome_reader(mix), prepared.n_distinct, mix)
    gc.collect()

    def run_window():
        """One warm-up and window: (window, the batcher's counters' change
        over the window)."""
        got = {}
        win = loop.run(mix["warmup_submissions"], seconds,
                       lambda: got.setdefault("before", _readings(batcher)),
                       lambda: got.setdefault("after", _readings(batcher)))
        got.setdefault("after", _readings(batcher))
        return win, _delta(got["after"], got["before"])

    windows, spans, dtrace, gaps, offset = [], [], None, None, None
    if trace:
        from corda_tpu_torch.observability import (disable_tracing,
                                                   enable_tracing)
        from .trace import traced
        # the device window: the profiler alone, with no program span
        # recorded (the program's tracer slows the service several times
        # over and shrinks its flushes)
        for attempt in range(3):
            (win, delta), dtrace, _ = traced(run_window)
            windows.append(win)
            if dtrace is not None:
                break
            log(f"traced window {attempt + 1}/3: no device operation in "
                "the trace")
        # the span window: the program's tracer on as well, for the spans
        # of the service and the labels of the idle gaps
        tracer = enable_tracing(RING_CAPACITY)
        try:
            (win_spans, _), gaps, offset = traced(run_window)
        finally:
            disable_tracing()
        windows.append(win_spans)
        spans = [sp for sp in tracer.spans()
                 if win_spans.wall0 <= sp["start_s"] <= win_spans.wall_end]
        if tracer.ring.dropped:
            log(f"tracer ring dropped {tracer.ring.dropped} spans")
    else:
        win, delta = run_window()
        windows.append(win)
    setup_s = windows[0].t0 - t_start
    log(f"setup: {setup_s:.3f} s (import {times['import']:.3f}, cuda "
        f"{times['cuda']:.3f}, program and kernels {times['target']:.3f}, "
        f"inputs {times['inputs']:.3f} in parallel, warm-up "
        f"{windows[0].t0 - t_loop:.3f})")
    per_s = [0] * (int(win.seconds) + 1)
    for t in win.times:
        per_s[int(t - win.t0)] += 1
    snap = batcher.metrics.snapshot()
    flushes, flushed = delta["verifier_batch_size"]
    log(f"window: {win.seconds:.3f} s, {win.answered} answers, per "
        f"second {per_s}; {flushes} flushes of {flushed / max(1, flushes):.1f}"
        f" signatures on average, prep "
        f"{delta['verifier_prep_seconds'][1]:.3f} s; batcher "
        + ", ".join(f"{k} {snap.get(k, {}).get('count', 0)}" for k in (
            "SigBatcher.Checked", "SigBatcher.DeviceChecked",
            "SigBatcher.DeviceBatches", "SigBatcher.HostRouted",
            "SigBatcher.BatchFailure")))
    peak = (torch.cuda.max_memory_allocated(torch.device(device))
            if on_card else 0)
    kind = torch.cuda.get_device_name(torch.device(device)) if on_card \
        else "cpu"
    answers = [a for w in windows for a in w.done]
    unanswered = sum(w.unanswered for w in windows)
    entry.close_target(target)
    del target, batcher, loop, prepared.program_inputs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with reference_pool() as pool:
        expected = entry.reference(pool, prepared.plain, mix)
    wrong, failed = entry.judge(answers, expected)
    construction = sum(entry.mismatches(e, label) for e, label in
                       zip(expected, prepared.labels))
    log(f"reference: {len(prepared.plain)} distinct inputs judged in "
        f"{time.perf_counter() - t0:.3f} s")
    failed += unanswered * per_submission
    attempted = sum(len(w.done) + w.unanswered
                    for w in windows) * per_submission

    bad = forbidden_modules()
    if bad:
        raise RuntimeError("loaded in the measuring process: "
                           + ", ".join(bad))

    run = {"cell": cell_name, "config": config, "mix": mix, "trace": trace,
           "setup_s": setup_s, "window": win, "window_s": win.seconds,
           "items_done": win.answered * per_submission,
           "readings": delta, "spans": spans, "device": dtrace}
    metrics = {}
    for name, mod in readers.items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    result = {"correct": None, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": cell.get("chips", 1),
                         "memory_peak_bytes": peak}}
    if trace and dtrace is not None:
        result["device"]["busy_s"] = dtrace.busy_s
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = {
            "device_ops": dtrace.top_ops(),
            "idle_gaps": (gaps or dtrace).idle_gaps(spans, offset)}
    # the numbers compared, each beside its limit, under a key of their own
    # that comes last in the line
    checks = {"wrong_verdicts": {"value": wrong, "limit": 0},
              "unanswered": {"value": unanswered * per_submission,
                             "limit": 0},
              "reference_vs_construction": {"value": construction,
                                            "limit": 0}}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=t_start)
    except NoCard as exc:
        log(f"no result: {exc}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
