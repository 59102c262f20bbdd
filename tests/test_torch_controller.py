"""The port's fleet controller and the batcher's degradation hooks against
the JAX package's.

Every scenario of tests/test_controller.py runs on both packages'
controllers with the same injected clock, scripted SLO and stub actuators;
each keeps the reference test's own assertions, and the two packages must
give the same action lists (kind and details), ``status()`` dicts and
``Controller.*`` meter counts and gauges. Then every degradation hook
(``shed_bulk``, ``shrink_ladder``, ``route_interactive_host``,
``degradation_status``, ``ladder_from_occupancy``) runs on both packages'
batchers: the same status after each apply and revert, bulk producers
blocked at the shed cap while interactive is admitted, interactive routed
to the host (the device seam never called), and the same ladders from the
same occupancy records. Batchers run on the host route or with their
device seam stubbed, so no kernel runs."""
import threading
import time
import types

import pytest
import torch

from corda_tpu.core.crypto import generate_keypair
from corda_tpu.core.crypto.schemes import EDDSA_ED25519_SHA512
from corda_tpu.core.crypto.signatures import Crypto
from corda_tpu.observability.profiling import KernelProfiler as JProfiler
from corda_tpu.utils.metrics import MetricRegistry as JRegistry
from corda_tpu.verifier import controller as j_controller
from corda_tpu.verifier.batcher import BULK, INTERACTIVE
from corda_tpu.verifier.batcher import SignatureBatcher as JBatcher
from corda_tpu_torch.core.crypto.keys import PublicKey as TPublicKey
from corda_tpu_torch.core.crypto.schemes import \
    EDDSA_ED25519_SHA512 as T_ED25519
from corda_tpu_torch.observability.profiling import \
    KernelProfiler as TProfiler
from corda_tpu_torch.utils.metrics import MetricRegistry as TRegistry
from corda_tpu_torch.verifier import controller as t_controller
from corda_tpu_torch.verifier.batcher import SignatureBatcher as TBatcher

KP = generate_keypair(EDDSA_ED25519_SHA512, entropy=b"\x42" * 32)
CONTENT = b"degradation ladder content"
SIG = Crypto.sign_with_key(KP, CONTENT).bytes

JAX = types.SimpleNamespace(
    name="jax", ctl=j_controller, Registry=JRegistry, Profiler=JProfiler,
    Batcher=JBatcher,
    batcher=lambda **kw: JBatcher(metrics=JRegistry(), **kw),
    triple=(KP.public, SIG, CONTENT))
PORT = types.SimpleNamespace(
    name="port", ctl=t_controller, Registry=TRegistry, Profiler=TProfiler,
    Batcher=TBatcher,
    batcher=lambda **kw: TBatcher(metrics=TRegistry(), device="cpu", **kw),
    triple=(TPublicKey(T_ED25519, KP.public.encoded), SIG, CONTENT))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- tests/test_controller.py's harness, on either package --------------------

class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class FakeSLO:
    """Scripted burn state: tests flip ``alerting`` / ``budget_pct``."""

    def __init__(self):
        self.alerting = False
        self.budget_pct = 100.0
        self.objectives = ("availability",)

    def alerts(self):
        if not self.alerting:
            return []
        return [{"objective": "availability", "severity": "page",
                 "burn_rate": 20.0, "windows_s": (60, 3600)}]

    def error_budget_pct(self, obj):
        return self.budget_pct


def rung(pkg, name, trail):
    return pkg.ctl.LadderStep(name,
                              apply=lambda: trail.append(f"+{name}"),
                              revert=lambda: trail.append(f"-{name}"))


def build(pkg, slo=None, workers=2, ladder=(), reaped=None, **cfg_kw):
    """A controller over stub seams (tests/test_controller.py's ``build``).
    Returns (controller, clock, state)."""
    clock = FakeClock()
    state = {"workers": workers, "depth": 0.0, "trail": [],
             "reaped": list(reaped or ()), "breakers": 0, "actions": []}

    def spawn():
        state["workers"] += 1
        state["trail"].append("spawn")
        return f"w{state['workers']}"

    def retire():
        state["workers"] -= 1
        state["trail"].append("retire")
        return f"w{state['workers'] + 1}"

    def reap():
        out, state["reaped"] = state["reaped"], []
        return out

    cfg_kw.setdefault("scale_cooldown_s", 1.0)
    cfg_kw.setdefault("step_cooldown_s", 1.0)
    cfg_kw.setdefault("healthy_ticks", 3)
    ctl = pkg.ctl.FleetController(
        slo=slo, worker_count=lambda: state["workers"],
        queue_depth=lambda: state["depth"],
        spawn=spawn, retire=retire, reap_stale=reap,
        breaker_open_count=lambda: state["breakers"],
        ladder=ladder, config=pkg.ctl.ControllerConfig(**cfg_kw),
        clock=clock, metrics=pkg.Registry())
    return ctl, clock, state


def tick_n(ctl, clock, n, state, dt=1.0):
    acts = []
    for _ in range(n):
        clock.advance(dt)
        acts.extend(ctl.tick())
    state["actions"].extend(acts)
    return acts


def record(ctl, state, **extra):
    """What the two packages must agree on: every action, the status, the
    trail of actuator calls and the Controller.* meters and gauges."""
    snap = ctl.metrics.snapshot()
    return {"actions": state["actions"], "status": ctl.status(),
            "trail": state["trail"], "workers": state["workers"],
            "state": ctl.state, "actions_total": ctl.actions_total,
            "ladder_step": ctl.ladder_step,
            "metrics": {k: v.get("count", v.get("value"))
                        for k, v in sorted(snap.items())
                        if k.startswith("Controller.")}, **extra}


# -- the scenarios (each with the reference test's assertions) ----------------

def healthy_slo_means_zero_actions(pkg):
    slo = FakeSLO()
    ctl, clock, state = build(pkg, slo=slo, workers=2, min_workers=1,
                              max_workers=8)
    acts = tick_n(ctl, clock, 20, state)
    assert acts == []
    assert ctl.actions_total == 0
    assert ctl.state == "steady"
    assert state["workers"] == 2
    assert state["trail"] == []
    return record(ctl, state)


def scale_up_before_ladder_and_one_action_per_cooldown(pkg):
    slo = FakeSLO()
    trail = []
    ladder = (rung(pkg, "shed_bulk", trail),)
    ctl, clock, state = build(pkg, slo=slo, workers=1, max_workers=3,
                              ladder=ladder)
    slo.alerting = True
    tick_n(ctl, clock, 2, state)
    assert state["trail"] == ["spawn", "spawn"]
    assert trail == []
    assert ctl.state == "stressed"
    tick_n(ctl, clock, 1, state)
    assert trail == ["+shed_bulk"]
    assert ctl.state == "degraded"
    return record(ctl, state, rungs=trail)


def scale_cooldown_limits_spawn_rate(pkg):
    slo = FakeSLO()
    ctl, clock, state = build(pkg, slo=slo, workers=1, max_workers=8,
                              scale_cooldown_s=10.0)
    slo.alerting = True
    tick_n(ctl, clock, 5, state, dt=1.0)
    assert state["trail"].count("spawn") == 1
    tick_n(ctl, clock, 6, state, dt=1.0)
    assert state["trail"].count("spawn") == 2
    return record(ctl, state)


def ladder_applies_in_order_and_reverts_in_reverse(pkg):
    slo = FakeSLO()
    trail = []
    ladder = tuple(rung(pkg, n, trail) for n in
                   ("shed_bulk", "shrink_ladder", "host_route"))
    ctl, clock, state = build(pkg, slo=slo, workers=2, max_workers=2,
                              ladder=ladder)
    slo.alerting = True
    tick_n(ctl, clock, 3, state)
    assert trail == ["+shed_bulk", "+shrink_ladder", "+host_route"]
    assert ctl.ladder_step == 3
    assert ctl.state == "degraded"
    applied = ctl.status()
    slo.alerting = False
    trail.clear()
    tick_n(ctl, clock, 12, state)
    assert trail == ["-host_route", "-shrink_ladder", "-shed_bulk"]
    assert ctl.ladder_step == 0
    assert ctl.state == "steady"
    return record(ctl, state, rungs=trail, applied=applied)


def no_flap_reversal_requires_sustained_health(pkg):
    slo = FakeSLO()
    trail = []
    ladder = (rung(pkg, "shed_bulk", trail),)
    ctl, clock, state = build(pkg, slo=slo, workers=2, max_workers=2,
                              ladder=ladder, healthy_ticks=3)
    slo.alerting = True
    tick_n(ctl, clock, 1, state)
    assert trail == ["+shed_bulk"]
    for _ in range(6):
        slo.alerting = False
        tick_n(ctl, clock, 2, state)
        slo.alerting = True
        tick_n(ctl, clock, 1, state)
    assert "-shed_bulk" not in trail
    assert ctl.ladder_step == 1
    return record(ctl, state, rungs=trail)


def scale_down_waits_for_budget_and_only_returns_spawned(pkg):
    slo = FakeSLO()
    ctl, clock, state = build(pkg, slo=slo, workers=2, min_workers=1,
                              max_workers=8, budget_scale_down_pct=50.0)
    slo.alerting = True
    tick_n(ctl, clock, 2, state)
    assert state["workers"] == 4
    slo.alerting = False
    slo.budget_pct = 10.0
    tick_n(ctl, clock, 10, state)
    assert state["trail"].count("retire") == 0
    assert state["workers"] == 4
    slo.budget_pct = 90.0
    tick_n(ctl, clock, 30, state)
    assert state["workers"] == 2
    assert state["trail"].count("retire") == 2
    assert ctl.state == "steady"
    tick_n(ctl, clock, 10, state)
    assert state["workers"] == 2
    return record(ctl, state)


def stale_reap_runs_in_any_state_and_counts_as_action(pkg):
    slo = FakeSLO()
    ctl, clock, state = build(pkg, slo=slo, workers=3, reaped=["w1", "w2"])
    acts = tick_n(ctl, clock, 1, state)
    kinds = [a["action"] for a in acts]
    assert kinds == ["stale_detach", "stale_detach"]
    assert {a["worker"] for a in acts} == {"w1", "w2"}
    assert ctl.actions_total == 2
    tick_n(ctl, clock, 10, state)
    assert ctl.state == "steady"
    assert ctl.status()["recovery_s_last"] is not None
    return record(ctl, state)


def queue_trend_alone_triggers_stress_without_slo(pkg):
    ctl, clock, state = build(pkg, slo=None, workers=1, max_workers=4,
                              queue_high=100.0, queue_low=10.0)
    state["depth"] = 100_000.0
    tick_n(ctl, clock, 3, state)
    assert state["trail"].count("spawn") >= 1
    assert ctl.state == "stressed"
    state["depth"] = 0.0
    tick_n(ctl, clock, 40, state)
    assert ctl.state == "steady"
    assert state["workers"] == 1
    return record(ctl, state)


def status_shape(pkg):
    slo = FakeSLO()
    ctl, clock, state = build(pkg, slo=slo, workers=2)
    tick_n(ctl, clock, 1, state)
    st = ctl.status()
    for key in ("state", "workers", "queue_depth_trend", "ladder",
                "ladder_step", "actions_total", "recent_actions",
                "episodes", "recovery_s_last", "healthy_streak"):
        assert key in st, key
    assert st["state"] == "steady"
    assert st["workers"] == 2
    assert st["actions_total"] == 0
    return record(ctl, state)


def batcher_ladder_tracks_live_batcher_list(pkg):
    class FakeBatcher:
        def __init__(self):
            self.calls = []

        def shed_bulk(self, on):
            self.calls.append(("shed_bulk", on))

        def shrink_ladder(self, on):
            self.calls.append(("shrink_ladder", on))

        def route_interactive_host(self, on):
            self.calls.append(("route_interactive_host", on))

    batchers = [FakeBatcher()]
    ladder = pkg.ctl.batcher_ladder(batchers)
    assert [s.name for s in ladder] == \
        ["shed_bulk", "shrink_ladder", "host_route_interactive"]
    ladder[0].apply()
    ladder[0].applied = True
    late = FakeBatcher()
    batchers.append(late)
    pkg.ctl.apply_degradations(ladder, late)
    assert late.calls == [("shed_bulk", True)]
    ladder[0].revert()
    assert ("shed_bulk", False) in late.calls
    assert batchers[0].calls == [("shed_bulk", True), ("shed_bulk", False)]
    return {"first": batchers[0].calls, "late": late.calls,
            "names": [s.name for s in ladder]}


def breaker_open_counts_as_stress(pkg):
    ctl, clock, state = build(pkg, slo=None, workers=1, max_workers=2)
    state["breakers"] = 1
    tick_n(ctl, clock, 2, state)
    assert state["trail"].count("spawn") == 1
    assert ctl.state == "stressed"
    return record(ctl, state)


SCENARIOS = [healthy_slo_means_zero_actions,
             scale_up_before_ladder_and_one_action_per_cooldown,
             scale_cooldown_limits_spawn_rate,
             ladder_applies_in_order_and_reverts_in_reverse,
             no_flap_reversal_requires_sustained_health,
             scale_down_waits_for_budget_and_only_returns_spawned,
             stale_reap_runs_in_any_state_and_counts_as_action,
             queue_trend_alone_triggers_stress_without_slo,
             status_shape,
             batcher_ladder_tracks_live_batcher_list,
             breaker_open_counts_as_stress]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_controller_scenario_matches_reference(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_controller_exports():
    from corda_tpu_torch.verifier import ControllerConfig, FleetController
    assert FleetController is t_controller.FleetController
    assert ControllerConfig is t_controller.ControllerConfig
    assert vars(ControllerConfig()) == vars(j_controller.ControllerConfig())


# -- the batcher's degradation hooks on both packages -------------------------

def _ladders(b):
    return (b._default_ladder, dict(b.bucket_ladder))


def _rungs(pkg):
    """Apply and revert each rung on a fresh host-route batcher, the status
    and ladders after each step."""
    b = pkg.batcher(use_device=False, max_pending=100,
                    bucket_ladder={"ed25519": (512, 1024)})
    try:
        steps = [("start", b.degradation_status(), _ladders(b))]
        for name, fn in (("shed", lambda on: b.shed_bulk(on)),
                         ("shed_cap", lambda on: b.shed_bulk(on, cap=7)),
                         ("shrink", b.shrink_ladder),
                         ("host", b.route_interactive_host)):
            for on in (True, True, False, False):   # idempotent both ways
                fn(on)
                steps.append((name, on, b.degradation_status(),
                              _ladders(b)))
        b.shed_bulk(True)
        b.shrink_ladder(True)
        b.route_interactive_host(True)
        steps.append(("all", b.degradation_status(), _ladders(b)))
        b.route_interactive_host(False)
        b.shrink_ladder(False)
        b.shed_bulk(False)
        steps.append(("none", b.degradation_status(), _ladders(b)))
        return steps
    finally:
        b.close()


def test_degradation_status_after_each_apply_and_revert():
    got, want = _rungs(PORT), _rungs(JAX)
    assert got == want
    assert want[0][1] == {"bulk_shed": False, "ladder_shrunk": False,
                          "interactive_host": False, "max_pending": 100}
    assert want[-2][1] == {"bulk_shed": True, "ladder_shrunk": True,
                           "interactive_host": True, "max_pending": 1024}
    assert want[-1][1:] == want[0][1:]


def _shed_blocks_bulk(pkg):
    """tests/test_continuous_batching.py's admission case, with the cap set
    by shed_bulk instead of max_pending: the host pool wedged, a queued
    bulk group over the shed cap, a bulk producer blocked, interactive
    admitted, and the producer re-admitted when the rung reverts."""
    started = threading.Semaphore(0)
    release = threading.Event()
    b = pkg.batcher(use_device=False, max_latency_s=0.001)
    triple = pkg.triple
    orig_host = type(b)._run_host

    def gated_host(items):
        started.release()
        release.wait(timeout=30)
        return orig_host(items)

    b._run_host = gated_host
    statuses = []
    try:
        wedged = []
        for _ in range(3):
            wedged.append(b.submit_group([triple], latency_class=BULK))
            assert started.acquire(timeout=10)
        wedged.append(b.submit_group([triple], latency_class=BULK))
        deadline = time.time() + 10
        while time.time() < deadline and b._inflight_n["host"] < 4:
            time.sleep(0.01)
        assert b._inflight_n["host"] == 4
        wedged.append(b.submit_group([triple] * 8, latency_class=BULK))
        b.shed_bulk(True, cap=4)
        statuses.append(b.degradation_status())
        blocked_done = threading.Event()
        extra = []

        raised = []

        def producer():
            try:
                extra.append(b.submit_group([triple], latency_class=BULK))
            except Exception as exc:   # the reference's fault, recorded
                raised.append(type(exc).__name__)
            blocked_done.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        blocked = not blocked_done.wait(timeout=0.5)
        t0 = time.perf_counter()
        f_int = b.submit_many([triple], latency_class=INTERACTIVE)[0]
        interactive_fast = time.perf_counter() - t0 < 1.0
        still_blocked = not blocked_done.is_set()
        b.shed_bulk(False)              # reverting the rung re-admits
        statuses.append(b.degradation_status())
        readmitted = blocked_done.wait(timeout=10)
        release.set()
        t.join(timeout=30)
        results = [f_int.result(timeout=30)] + [
            g.result(timeout=30) for g in wedged + extra]
        return {"blocked": blocked, "interactive_fast": interactive_fast,
                "still_blocked": still_blocked, "readmitted": readmitted,
                "raised": raised, "statuses": statuses, "results": results}
    finally:
        release.set()
        b.close()


def test_shed_blocks_bulk_producers_at_the_cap():
    """Equal on both packages but for one fault of the reference: when the
    rung reverts to an uncapped batcher (``max_pending`` None), the
    reference's blocked producer compares its queue depth with None and
    raises TypeError; the port's is admitted (ROADMAP.md §C)."""
    got, want = _shed_blocks_bulk(PORT), _shed_blocks_bulk(JAX)
    assert want["raised"] == ["TypeError"]
    assert got["raised"] == []
    assert len(got["results"]) == len(want["results"]) + 1
    for record_ in (got, want):
        del record_["raised"], record_["results"][len(want["results"]):]
    assert got == want
    assert want["blocked"] and want["still_blocked"]
    assert want["interactive_fast"] and want["readmitted"]
    assert all(want["results"])
    assert want["statuses"][0]["max_pending"] == 4
    assert want["statuses"][1]["max_pending"] is None


def _interactive_to_host(pkg):
    """With the last rung applied, an interactive group takes the host
    route (the device seam is never called) while a bulk group keeps the
    device route; reverted, the interactive group reaches the device."""
    b = pkg.batcher(host_crossover=0, max_latency_s=0.001,
                    interactive_latency_s=0.001)
    calls = []

    def device_seam(items):
        calls.append(len(items))
        return len(items), (lambda n: [True] * n)

    b._start_ed25519 = device_seam
    try:
        b.route_interactive_host(True)
        out = [b.submit_group([pkg.triple] * 3,
                              latency_class=INTERACTIVE).result(timeout=60)]
        snap = b.metrics.snapshot()
        routed = (snap.get("SigBatcher.HostRouted", {}).get("count", 0),
                  list(calls))
        out.append(b.submit_group([pkg.triple] * 5,
                                  latency_class=BULK).result(timeout=60))
        bulk_calls = list(calls)
        b.route_interactive_host(False)
        out.append(b.submit_group([pkg.triple] * 3,
                                  latency_class=INTERACTIVE).result(timeout=60))
        snap = b.metrics.snapshot()
        return {"verdicts": out, "while_applied": routed,
                "bulk_calls": bulk_calls, "after_revert": list(calls),
                "device_checked": snap["SigBatcher.DeviceChecked"]["count"],
                "checked": snap["SigBatcher.Checked"]["count"]}
    finally:
        b.close()


def test_route_interactive_host_skips_the_device():
    got, want = _interactive_to_host(PORT), _interactive_to_host(JAX)
    assert got == want
    assert want["while_applied"][1] == []          # the seam never called
    assert want["bulk_calls"] == [5]
    assert want["after_revert"] == [5, 3]
    assert want["device_checked"] == 8 and want["checked"] == 11


def _ladder_from(pkg):
    prof = pkg.Profiler()
    for _ in range(4):
        prof.record_occupancy("ed25519", 16384, 16384)
        prof.record_occupancy("secp256r1", 300, 512)
    prof.record_occupancy("secp256k1", 1500, 2048)
    return {"mean_live": prof.occupancy_mean_live(),
            "pct": prof.occupancy_pct_per_scheme(),
            "ladders": [
                pkg.Batcher.ladder_from_occupancy(profiler=prof, max_batch=mb,
                                                  min_floor=mf)
                for mb, mf in ((32768, None), (4096, None), (32768, 64))]}


def test_ladder_from_occupancy_matches_reference():
    got, want = _ladder_from(PORT), _ladder_from(JAX)
    assert got == want
    assert want["ladders"][0]["ed25519"] == JBatcher._pow2_ladder(8192, 32768)
    assert want["ladders"][0]["secp256r1"][0] == JBatcher.LADDER_FLOOR


def test_profiler_warm_boundary_publish_and_reset():
    """The profiler methods the controller path and the bench need: the
    warm boundary counts kernel builds after ``mark_warm``, ``publish``
    installs the reference's gauges and histograms, ``reset`` clears."""
    class Wrapper:
        """A kernel wrapper whose calls build its library when asked."""

        def __init__(self):
            self.builds = 0
            self.build_next = False

        def build_count(self):
            return self.builds

        def __call__(self, x):
            if self.build_next:
                self.builds += 1
            return x

    prof = TProfiler()
    fn = Wrapper()
    fn.build_next = True
    prof.call("k", fn, 1)               # a first launch that built
    prof.record_occupancy("ed25519", 3, 4)
    prof.mark_warm()
    assert prof.compiles_since_warm() == 0
    fn.build_next = False
    prof.call("k", fn, 1)               # warm
    assert prof.compiles_since_warm() == 0
    fn.build_next = True
    prof.call("k", fn, 1)               # a rebuild after the boundary
    assert prof.compiles_since_warm() == 1
    treg, jreg = TRegistry(), JRegistry()
    prof.publish(treg)
    JProfiler().publish(jreg)
    assert sorted(treg.snapshot()) == sorted(jreg.snapshot())
    assert treg.snapshot()["Profiler.ed25519.OccupancyPct"]["value"] == 75.0
    assert treg.snapshot()["Profiler.Compiles"]["value"] == 2
    prof.reset()
    assert prof.compile_totals()["compiles"] == 0
    assert prof.occupancy_mean_live() == {}
    assert prof.compiles_since_warm() == 0
