"""In-process verifier fleet: N device-pinned workers behind one queue.

Port of corda_tpu.verifier.fleet. Where the reference pins a worker's
batcher to a JAX device, here each worker's ``SignatureBatcher`` runs on a
``torch.device`` (``devices=``, one per worker; repeats allowed, so several
workers may share one card, each on its own CUDA stream), and the fleet
defaults to the card: ``use_device=True`` and, without ``devices``, every
worker's batcher on ``"cuda"`` (raising where CUDA is absent before any
worker attaches). A host-route fleet (``use_device=False``) launches no
kernel and puts its batchers on the CPU.

The MULTICHIP harness. Everything rides the REAL
out-of-process protocol — ``OutOfProcessTransactionVerifierService``'s
load-aware router, ``VerifierWorker``'s stealable backlog, WorkerLoadReport
/ StealRequest / WorkReturned — but over the deterministic in-memory bus
with a background pump thread, so one process can measure fleet scaling
without spawning N OS processes (the reference's TCP plane and verifier
worker processes are the production spelling of the same topology).

Scaling efficiency is BUSY-TIME based, not count based::

    efficiency = 100 × mean_i(last_completion_i − t0) / makespan

i.e. how long each worker stayed busy relative to the whole run. A
count-based definition (total / (n × max_per_worker)) would punish
successful work stealing — stolen groups inflate the fast worker's count —
while busy-time rewards exactly what the fleet is for: nobody idles while
a straggler holds undone work.

The fleet is also the FleetController's substrate (``attach_controller``):
``add_worker`` / ``retire_worker`` are the scale actuators (riding
WorkerHello / graceful Goodbye), ``kill_worker`` simulates a crash for
the chaos harness (no Goodbye, no more load reports — only the stale
reaper or redelivery can recover its charged work), and the pump thread
doubles as the controller's tick loop. ``kill_storm_recovery`` is the
seeded proof: kill part of the fleet mid-load and measure the time back
to SLO-steady with zero lost futures.
"""
from __future__ import annotations

import random
import time
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError

import torch

from ..core.crypto import generate_keypair
from ..core.crypto.schemes import EDDSA_ED25519_SHA512
from ..core.crypto.signatures import Crypto
from ..device import resolve_device
from ..network.inmemory import InMemoryMessagingNetwork
from ..observability import Tracer, get_tracer, set_tracer
from ..utils.metrics import MetricRegistry
from .batcher import SignatureBatcher
from .out_of_process import (OutOfProcessTransactionVerifierService,
                             VerifierWorker, _weight)


def make_sig_checks(n: int, unique: int = 16, seed: int = 7):
    """Deterministic honestly-signed ed25519 ``(key, sig, content)`` checks,
    ``unique`` distinct tiled to ``n`` (the bench corpus shape — signing is
    pure Python, so uniqueness is bounded like bench.py's UNIQUE)."""
    base = []
    for i in range(min(n, unique)):
        entropy = (seed * 1000003 + i).to_bytes(32, "little")
        kp = generate_keypair(EDDSA_ED25519_SHA512, entropy=entropy)
        content = (seed * 999331 + i).to_bytes(64, "little")
        sig = Crypto.do_sign(kp.private, content, kp.public)
        base.append((kp.public, sig, content))
    return (base * (n // len(base) + 1))[:n]


class InProcessFleet:
    """N ``VerifierWorker``s (each with a private ``SignatureBatcher`` on
    ``devices[i]``, or on ``"cuda"`` when ``devices`` is None) attached to
    one node-side service, all on an in-memory bus pumped by a background
    thread.

    ``report_every_s`` drives ``send_load_report`` from the pump thread —
    the load/steal machinery stays live without per-worker timer threads,
    and the pump delivers the reports in the same loop."""

    def __init__(self, n_workers: int, use_device: bool = True,
                 devices=None, host_crossover: int | None = None,
                 max_latency_s: float = 0.005,
                 max_inflight_groups: int | None = 2,
                 report_every_s: float = 0.01,
                 metrics: MetricRegistry | None = None):
        if n_workers < 1:
            raise ValueError("a fleet needs at least one worker")
        if devices is not None and len(devices) < n_workers:
            raise ValueError(f"{n_workers} workers but only "
                             f"{len(devices)} devices")
        # resolve every device before anything attaches: a fleet meant for
        # the card fails here, not at its first request
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            self._default_device = devices[0]
        else:
            self._default_device = (resolve_device("cuda") if use_device
                                    else torch.device("cpu"))
        self.n_workers = n_workers
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.bus = InMemoryMessagingNetwork()
        self.service = OutOfProcessTransactionVerifierService(
            self.bus.create_node("node"), metrics=self.metrics,
            expected_workers=n_workers,
            load_report_interval_s=report_every_s)
        self._batcher_kwargs: dict = {"use_device": use_device,
                                      "max_latency_s": max_latency_s}
        if host_crossover is not None:
            self._batcher_kwargs["host_crossover"] = host_crossover
        self._use_device = use_device
        self._devices = devices
        self._max_inflight_groups = max_inflight_groups
        self._workers_lock = threading.RLock()
        self.batchers: list[SignatureBatcher] = []
        self.workers: list[VerifierWorker] = []
        self.dead_workers: list[VerifierWorker] = []
        self._next_idx = 0
        for _ in range(n_workers):
            self._spawn_worker_locked()
        # controller plumbing (attach_controller): the SLO tracker fed by
        # verify_signatures outcomes, and the control loop the pump ticks
        self.slo = None
        self.controller = None
        self._controller_tick_s = report_every_s
        self._report_every_s = report_every_s
        # when the node last began draining its inbox right after the live
        # workers reported: the instant the stale reaper judges silence at
        self.heard_at = time.monotonic()
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="fleet-pump")
        self._pump.start()

    # -- worker lifecycle (the controller's scale actuators) -----------------
    def _spawn_worker_locked(self) -> VerifierWorker:
        i = self._next_idx
        self._next_idx += 1
        kwargs = dict(self._batcher_kwargs)
        shard: tuple = ()
        dev = self._default_device
        if self._devices is not None:
            dev = self._devices[i % len(self._devices)]
            shard = (dev.index if dev.index is not None else i,)
        kwargs["device"] = dev
        batcher = SignatureBatcher(**kwargs)
        worker = VerifierWorker(
            self.bus.create_node(f"w{i}"), "node",
            batcher=batcher, use_device=self._use_device, device=dev,
            device_shard=shard, capacity=1,
            load_report_interval_s=None,   # pump thread reports instead
            max_inflight_groups=self._max_inflight_groups)
        worker._report_enabled = True      # idle pings feed the stealer
        self.batchers.append(batcher)
        self.workers.append(worker)
        return worker

    def add_worker(self) -> str:
        """Spawn one more worker (controller scale-up): it attaches through
        the normal WorkerHello path on the next pump cycle. A worker
        spawned mid-degradation inherits the currently applied ladder
        rungs, so a join cannot undercut the shed."""
        with self._workers_lock:
            worker = self._spawn_worker_locked()
            if self.controller is not None:
                from .controller import apply_degradations
                apply_degradations(self.controller.ladder, worker._batcher)
            return worker.network_service.my_address

    def retire_worker(self) -> str | None:
        """Gracefully stop the newest worker (controller scale-down): its
        Goodbye detaches it and requeues anything it still held. Refuses
        to retire the last worker."""
        with self._workers_lock:
            if len(self.workers) <= 1:
                return None
            worker = self.workers.pop()
            self.dead_workers.append(worker)
        worker.stop(announce=True)
        return worker.network_service.my_address

    def kill_worker(self, name: str) -> str:
        """Chaos: crash one worker dead — no Goodbye, no further load
        reports — so its charged work hangs until the stale reaper
        crash-detaches it (the kill-storm recovery path)."""
        with self._workers_lock:
            worker = next(w for w in self.workers
                          if w.network_service.my_address == name)
            self.workers.remove(worker)
            self.dead_workers.append(worker)
        worker.stop(announce=False)
        return name

    def worker_names(self) -> list[str]:
        with self._workers_lock:
            return [w.network_service.my_address for w in self.workers]

    # -- controller wiring ---------------------------------------------------
    def attach_controller(self, slo=None, stale_detach_intervals: int = 5,
                          tick_every_s: float | None = None,
                          config=None):
        """Wire a FleetController onto this fleet: spawn/retire through
        the worker lifecycle above, stale reaping through the service, the
        degradation ladder over every worker batcher, and the pump thread
        as the tick loop. ``slo`` (an SLOTracker or None) is fed by
        ``verify_signatures`` outcomes from here on."""
        from .controller import FleetController, batcher_ladder
        if self.controller is not None:
            return self.controller
        self.slo = slo
        self.service.stale_detach_intervals = stale_detach_intervals
        self.controller = FleetController(
            slo=slo,
            worker_count=lambda: self.service.queue.worker_count,
            queue_depth=self._queue_signal,
            spawn=self.add_worker,
            retire=self.retire_worker,
            reap_stale=lambda: self.service.reap_stale_workers(
                now=self.heard_at),
            breaker_open_count=self._open_breaker_count,
            ladder=batcher_ladder(self.batchers),
            config=config,
            metrics=self.metrics)
        self.service.controller = self.controller
        if tick_every_s is not None:
            self._controller_tick_s = tick_every_s
        return self.controller

    def _queue_signal(self) -> float:
        """Total estimated signature depth across the fleet (node-side
        pending + everything charged to workers) — the controller's
        queue-trend input."""
        q = self.service.queue
        with q._lock:
            pending = sum(_weight(r) for r in q._pending)
            dealt = sum(q._queue_depth_of(w) for w in q._workers)
        return float(pending + dealt)

    def _open_breaker_count(self) -> int:
        with self._workers_lock:
            batchers = [w._batcher for w in self.workers
                        if w._batcher is not None]
        n = 0
        for b in batchers:
            try:
                n += sum(1 for st in b.breaker_status().values()
                         if st.get("state") != "closed")
            except Exception:
                pass
        return n

    def _pump_loop(self) -> None:
        last_report = 0.0
        last_tick = 0.0
        while not self._stop.is_set():
            t_cycle = time.monotonic()
            progressed = self.bus.run_network()
            now = time.monotonic()
            # A cycle longer than the report interval held back every load
            # report (decoding one request on this thread runs the
            # pure-Python codec: about 11 ms for 256 signatures, a second
            # for 32768), and this thread may wait for the interpreter or a
            # core for as long between any two of its steps. So before a
            # tick, and after such a cycle, the live workers report at once
            # and only the node's inbox is drained; the tick below judges
            # silence at the instant that drain began (heard_at), when every
            # live worker's report had reached the inbox, not on the pump's
            # own stall, while a crashed worker, which sends nothing, still
            # goes stale.
            stalled = now - t_cycle > self._report_every_s
            ctl = self.controller
            tick = (ctl is not None
                    and now - last_tick >= self._controller_tick_s)
            if tick or stalled or now - last_report >= self._report_every_s:
                last_report = now
                with self._workers_lock:
                    workers = list(self.workers)
                for w in workers:
                    try:
                        w.send_load_report()
                    except Exception:
                        pass   # a stopped worker mid-close; pump survives
                if tick or stalled:
                    heard = time.monotonic()
                    self.bus.run_network(exclude=[
                        n for n in self.bus.node_names if n != "node"])
                    self.heard_at = heard
                    now = time.monotonic()
            if tick:
                last_tick = now
                try:
                    ctl.tick()
                except Exception:
                    pass   # a control hiccup must not kill the pump
            if not progressed:
                time.sleep(0.0005)

    def verify_signatures(self, checks):
        fut = self.service.verify_signatures(checks)
        if self.slo is not None:
            t0 = time.monotonic()

            def _record(f, t0=t0):
                try:
                    ok = f.exception() is None
                except Exception:
                    ok = False
                try:
                    self.slo.record(ok, time.monotonic() - t0)
                except Exception:
                    pass
            fut.add_done_callback(_record)
        return fut

    def steal_count(self) -> int:
        return self.metrics.meter("Fleet.Steals").count

    def stolen_count(self) -> int:
        return self.metrics.meter("Fleet.Stolen").count

    def close(self) -> None:
        self._stop.set()
        self._pump.join(timeout=5.0)
        with self._workers_lock:
            everyone = list(self.workers) + list(self.dead_workers)
        for w in everyone:
            try:
                w.stop(announce=False)
            except Exception:
                pass
        for b in self.batchers:
            b.close()
        self.service.shutdown()


def stitched_trace_depth(spans) -> int:
    """Deepest parent chain among traces that contain BOTH a node-side
    ``verifier.oop_submit`` span and at least one ``worker.*`` span — i.e.
    traces that actually crossed the process seam. 0 means no stitched
    trace existed (the cross-process plane was dark)."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        if isinstance(s, dict) and s.get("trace_id"):
            by_trace.setdefault(s["trace_id"], []).append(s)
    best = 0
    for group in by_trace.values():
        names = [s.get("name") or "" for s in group]
        if ("verifier.oop_submit" not in names
                or not any(n.startswith("worker.") for n in names)):
            continue
        by_id = {s["span_id"]: s for s in group if s.get("span_id")}
        for s in group:
            depth, cur, hops = 1, s, 0
            while cur.get("parent_id") in by_id and hops < len(by_id):
                cur = by_id[cur["parent_id"]]
                depth += 1
                hops += 1
            best = max(best, depth)
    return best


def fleet_bench(n_workers: int, groups: int = 64, group_size: int = 16,
                use_device: bool = True, devices=None,
                host_crossover: int | None = None,
                max_inflight_groups: int | None = 2,
                unique: int = 16, timeout_s: float = 600.0) -> dict:
    """Run ``groups`` signature groups of ``group_size`` ed25519 checks
    through an N-worker fleet and measure aggregate throughput + busy-time
    scaling efficiency. Returns the MULTICHIP artifact fields.

    Runs under a PRIVATE recording tracer (restored on exit) so the
    artifact can report ``stitched_trace_depth`` — proof the cross-process
    observability plane stitched node- and worker-side spans — without
    clobbering any tracer the host process installed.

    A FleetController rides along in OBSERVE trim (no SLO tracker,
    infinite queue thresholds, scale range pinned to ``n_workers``): an
    unstressed bench must report ``controller_state == "steady"`` with
    zero actions, and that invariant is asserted by the smoke gate — a
    controller that acts on a healthy fleet is a regression."""
    from .controller import ControllerConfig
    prev_tracer = get_tracer()
    tracer = Tracer(capacity=16384)
    set_tracer(tracer)
    fleet = InProcessFleet(
        n_workers, use_device=use_device, devices=devices,
        host_crossover=host_crossover,
        max_inflight_groups=max_inflight_groups)
    ctl = fleet.attach_controller(
        slo=None, stale_detach_intervals=50,
        config=ControllerConfig(
            min_workers=n_workers, max_workers=n_workers,
            queue_high=float("inf"), queue_low=float("inf"),
            breakers_stress=False))
    try:
        checks = make_sig_checks(group_size, unique=unique)
        # warm the path (and, on the card, the kernel builds) before timing
        fleet.verify_signatures(checks).result(timeout=timeout_s)
        t0 = time.monotonic()
        futures = [fleet.verify_signatures(checks) for _ in range(groups)]
        for f in futures:
            f.result(timeout=timeout_s)
        makespan = time.monotonic() - t0
        total = groups * group_size
        busy = [max(0.0, (w.last_completion_t or t0) - t0)
                for w in fleet.workers]
        efficiency = (100.0 * (sum(busy) / len(busy)) / makespan
                      if makespan > 0 else 0.0)
        skew = (100.0 * (max(busy) - min(busy)) / makespan
                if makespan > 0 else 0.0)
        per_worker = {w.network_service.my_address: w.processed_sig_count
                      for w in fleet.workers}
        steals = fleet.steal_count()
        ctl_status = ctl.status()
        return {
            "fleet_verifies_per_sec": round(total / makespan, 1),
            "scaling_efficiency_pct": round(min(100.0, efficiency), 1),
            "worker_busy_skew_pct": round(max(0.0, min(100.0, skew)), 1),
            "n_workers": n_workers,
            "n_devices": len(devices) if devices is not None else 0,
            "fleet_steals": steals,
            "fleet_stolen": fleet.stolen_count(),
            "steals_total": steals,
            "stitched_trace_depth": stitched_trace_depth(
                tracer.ring.snapshot()),
            "groups": groups,
            "group_size": group_size,
            "wall_s": round(makespan, 4),
            "per_worker_sigs": per_worker,
            "controller_state": ctl_status["state"],
            "controller_actions": ctl_status["actions_total"],
            "recovery_s": ctl_status["recovery_s_last"] or 0.0,
        }
    finally:
        fleet.close()
        set_tracer(prev_tracer)


def kill_storm_recovery(n_workers: int = 3, seed: int = 7,
                        groups: int = 60, group_size: int = 6,
                        kill_fraction: float = 0.5,
                        slo_windows_s: tuple = (0.5, 2.0),
                        latency_slo_ms: float = 250.0,
                        timeout_s: float = 60.0,
                        use_device: bool = True, devices=None) -> dict:
    """Seeded kill-storm: crash ~``kill_fraction`` of the fleet mid-load
    and measure the controller-driven recovery. The SLO burns while the
    dead workers' charged futures wait out the stale horizon; the
    controller crash-detaches the corpses (requeue → survivors), spawns
    replacements, and the episode closes when the fleet holds a healthy
    streak again.

    The recovery bound is ERROR-BUDGET based: the long burn window
    (``slo_windows_s[-1]``) is where the budget was burned, and each
    phase of a real recovery is bounded by one such window — the stale
    horizon before the corpses are detached, the requeued-work drain on
    the survivors, the aging-out of the last bad events, and the
    healthy-streak hysteresis — so a controller that actually restored
    service must be back to steady within 4× that window.
    Returns the artifact/assertion fields; ``lost_futures`` must be 0
    and ``recovered_within_bound`` True for the chaos gate to pass.

    ``use_device`` and ``devices`` pass through to ``InProcessFleet``:
    the workers' batchers sit on the card unless the caller asks for the
    host route (``use_device=False``, the reference's default here), which
    measures the control loop without the kernels."""
    from ..observability.slo import SLObjective, SLOTracker
    from .controller import ControllerConfig
    prev_tracer = get_tracer()
    tracer = Tracer(capacity=16384)
    set_tracer(tracer)
    rng = random.Random(seed)
    slo = SLOTracker(
        objectives=(SLObjective("availability", 0.999),
                    SLObjective("latency_p99", 0.95,
                                latency_ms=latency_slo_ms)),
        windows_s=slo_windows_s)
    fleet = InProcessFleet(n_workers, use_device=use_device,
                           devices=devices, report_every_s=0.02)
    ctl = fleet.attach_controller(
        slo=slo, stale_detach_intervals=8,
        config=ControllerConfig(
            min_workers=n_workers, max_workers=n_workers + 2,
            scale_cooldown_s=0.25, step_cooldown_s=0.25,
            # 10 ticks × 0.02 s = 200 ms of sustained health before any
            # reversal: a shorter streak lets a mid-storm lull close the
            # episode early and a second one open, splitting the timeline
            healthy_ticks=10))
    lost = failed = 0
    killed: list[str] = []
    try:
        checks = make_sig_checks(group_size, seed=seed)
        fleet.verify_signatures(checks).result(timeout=timeout_s)  # warm
        futures = []
        kill_at = max(1, groups // 4)
        for i in range(groups):
            futures.append(fleet.verify_signatures(checks))
            if i == kill_at:
                live = fleet.worker_names()
                n_kill = max(1, int(round(len(live) * kill_fraction)))
                for name in rng.sample(live, n_kill):
                    killed.append(fleet.kill_worker(name))
            time.sleep(0.001 + rng.random() * 0.002)
        for f in futures:
            try:
                if f.result(timeout=timeout_s) is not None:
                    failed += 1
            except FutureTimeoutError:
                lost += 1   # a future that never resolved: the real crime
            except Exception:
                failed += 1
        bound_s = 4.0 * slo_windows_s[-1]
        deadline = time.monotonic() + bound_s
        while time.monotonic() < deadline and ctl.state != "steady":
            time.sleep(0.02)
        st = ctl.status()
        spans = tracer.ring.snapshot()
        episodes = [s for s in spans
                    if s.get("name") == "controller.episode"]
        ep_ids = {s["span_id"] for s in episodes}
        annotated = [s for s in spans
                     if (s.get("name") or "").startswith("controller.")
                     and s.get("parent_id") in ep_ids]
        recovery = st["recovery_s_last"]
        return {
            "seed": seed,
            "n_workers": n_workers,
            "killed_workers": killed,
            "groups": groups,
            "group_size": group_size,
            "lost_futures": lost,
            "failed_futures": failed,
            "controller_actions": st["actions_total"],
            "controller_state": st["state"],
            "recovery_s": (round(recovery, 3)
                           if recovery is not None else None),
            "recovery_bound_s": round(bound_s, 3),
            "recovered_within_bound": (st["state"] == "steady"
                                       and recovery is not None
                                       and recovery <= bound_s),
            "episode_spans": len(episodes),
            "episode_action_spans": len(annotated),
        }
    finally:
        fleet.close()
        set_tracer(prev_tracer)
