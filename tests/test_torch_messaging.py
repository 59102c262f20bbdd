"""The port's messaging plane and retry helper against the JAX package's:
the same scripted traffic on both packages' in-memory buses, under the same
seeded ``net.send`` faults, gives the same deliveries in the same order and
the same fault counts; the same retry policy and seed give the same delays
and the same attempt counters.

Nothing here touches a kernel: both packages' modules are host code."""
import pytest

from corda_tpu.network import inmemory as j_inmemory
from corda_tpu.network import messaging as j_messaging
from corda_tpu.testing import faults as j_faults
from corda_tpu.utils import retry as j_retry
from corda_tpu_torch.network import inmemory as t_inmemory
from corda_tpu_torch.network import messaging as t_messaging
from corda_tpu_torch.testing import faults as t_faults
from corda_tpu_torch.utils import retry as t_retry

JAX = (j_inmemory, j_messaging, j_faults)
PORT = (t_inmemory, t_messaging, t_faults)
SEEDS = [7, 101, 9001]


def _topic(messaging, name, session=0):
    return messaging.TopicSession(name, session)


def _run_traffic(pkg, seed, rules):
    """A fixed script on one package's bus: three endpoints, handlers on two
    topics (one registered after its first messages arrived, so they park
    and replay), bursts between every pair under the armed ``rules``, then
    pumping in rounds, by endpoint and to quiescence. Returns every
    observable: deliveries in order, send outcomes, the logs, the fire log
    and the rules' counters."""
    inmemory, messaging, faults = pkg
    bus = inmemory.InMemoryMessagingNetwork()
    names = ("alice", "bob", "carol")
    eps = {n: bus.create_node(n) for n in names}
    seen = []

    def handler(me):
        def on(msg):
            seen.append((me, msg.sender, str(msg.topic_session), msg.data,
                         msg.trace))
        return on

    for n in ("alice", "bob"):
        eps[n].add_message_handler(_topic(messaging, "t.a"), handler(n))
    eps["alice"].add_message_handler(_topic(messaging, "t.b", 3),
                                     handler("alice:b3"))
    outcomes = []
    armed = [faults.FaultRule(*r[:2], **r[2]) for r in rules]
    with faults.inject(*armed, seed=seed) as inj:
        for i in range(24):
            src = names[i % 3]
            dst = names[(i + 1 + i // 3) % 3]
            topic = _topic(messaging, "t.b" if i % 4 == 0 else "t.a",
                           3 if i % 4 == 0 else 0)
            try:
                eps[src].send(topic, b"m%d" % i, dst,
                              trace=("tr", str(i)) if i % 5 == 0 else None)
                outcomes.append("sent")
            except ConnectionError as e:
                outcomes.append(f"raised:{e}")
            if i == 11:
                outcomes.append(("rounds", bus.run_network(rounds=3)))
                outcomes.append(("pending", bus.pending_count()))
                outcomes.append(("excluded",
                                 bus.run_network(exclude=("bob",))))
                one = bus.pump_receive("bob")
                outcomes.append(("pump", None if one is None
                                 else one.message.data))
        fired = inj.fired("net.send")
        log = list(inj.log)
        counters = [(r.matches, r.fires) for r in inj.rules]
    # carol's handler arrives last: her parked messages replay in order
    eps["carol"].add_message_handler(_topic(messaging, "t.a"),
                                     handler("carol"))
    outcomes.append(("rest", bus.run_network()))
    eps["carol"].add_message_handler(_topic(messaging, "t.b", 3),
                                     handler("carol:b3"))
    outcomes.append(("pending", bus.pending_count()))

    def transfers(logged):
        return [(t.sender, t.recipient, str(t.message.topic_session),
                 t.message.data) for t in logged]

    return {"seen": seen, "outcomes": outcomes, "fired": fired, "log": log,
            "counters": counters, "sent": transfers(bus.sent_log),
            "delivered": transfers(bus.delivered_log),
            "names": bus.node_names}


RULES = {
    "drop": [("net.send", "drop", {"probability": 0.4})],
    "duplicate": [("net.send", "duplicate", {"detail": "*->bob",
                                             "every": 2})],
    "raise": [("net.send", "raise", {"detail": "carol->*", "after": 1,
                                     "count": 3})],
    "mixed": [("net.send", "drop", {"detail": "alice->*",
                                    "probability": 0.5}),
              ("net.send", "duplicate", {"probability": 0.3}),
              ("net.send", "raise", {"detail": "bob->carol", "count": 1})],
    "none": [],
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rules", sorted(RULES))
def test_bus_traffic_matches_reference(rules, seed):
    want = _run_traffic(JAX, seed, RULES[rules])
    got = _run_traffic(PORT, seed, RULES[rules])
    assert got == want
    if rules != "none":
        assert want["fired"] > 0
    assert len(want["seen"]) > 0


def test_transfer_filter_and_endpoint_surface():
    """``transfer_filter`` drops what it refuses before the fault seam;
    duplicate names and unknown recipients fail as in the reference."""
    got = []
    for inmemory, messaging, _ in (JAX, PORT):
        bus = inmemory.InMemoryMessagingNetwork()
        a, b = bus.create_node("a"), bus.create_node("b")
        seen = []
        reg = b.add_message_handler(_topic(messaging, "x"),
                                    lambda m, s=seen: s.append(m.data))
        bus.transfer_filter = lambda t: t.message.data != b"no"
        for data in (b"yes", b"no", b"again"):
            a.send(_topic(messaging, "x"), data, "b")
        bus.run_network()
        b.remove_message_handler(reg)
        a.send(_topic(messaging, "x"), b"parked", "b")
        bus.run_network()
        errors = []
        for bad in (lambda: bus.create_node("a"),
                    lambda: a.send(_topic(messaging, "x"), b"?", "zed")):
            try:
                bad()
            except (ValueError, KeyError) as e:
                errors.append((type(e).__name__, str(e)))
        got.append((seen, len(bus.sent_log), len(bus.delivered_log),
                    bus.endpoint("a").my_address, a.supports_trace, errors,
                    str(messaging.TopicSession("t", 2))))
    assert got[0] == got[1]
    assert got[1][0] == [b"yes", b"again"] and len(got[1][5]) == 2


def test_topics_and_handler_table_match_reference():
    names = [n for n in dir(j_messaging) if n.startswith("TOPIC_")]
    assert names and all(getattr(t_messaging, n) == getattr(j_messaging, n)
                         for n in names)
    assert t_messaging.DEFAULT_SESSION_ID == j_messaging.DEFAULT_SESSION_ID
    table = t_messaging.HandlerTable()
    r1 = table.add(t_messaging.TopicSession("a", 1), print)
    table.add(t_messaging.TopicSession("a", 2), print)
    msg = t_messaging.Message(t_messaging.TopicSession("a", 1), b"")
    assert table.matching(msg) == [r1]
    table.remove(r1)
    assert table.matching(msg) == []
    with pytest.raises(NotImplementedError):
        t_messaging.MessagingService().send(msg.topic_session, b"", "x")


POLICIES = [
    {},
    {"base_s": 0.01, "cap_s": 0.05, "max_attempts": 9},
    {"base_s": 0.2, "cap_s": 10.0, "max_attempts": 3, "deadline_s": 0.5},
]


@pytest.mark.parametrize("seed", [0, *SEEDS])
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_retry_delays_identical(policy, seed):
    kw = POLICIES[policy]
    gens = [r.delays(r.RetryPolicy(**kw), seed=seed)
            for r in (j_retry, t_retry)]
    want, got = ([next(g) for _ in range(40)] for g in gens)
    assert got == want
    assert t_retry.DEFAULT_POLICY == t_retry.RetryPolicy(
        **vars(j_retry.DEFAULT_POLICY))


def _retry_run(retry, policy, fails, seed):
    """retry_call on a callable failing ``fails`` times, with a fake clock
    whose time advances by each sleep: the result or the last error, the
    sleeps, and the site's attempt and give-up counter deltas."""
    site = f"torch_messaging.{policy}.{fails}.{seed}"
    now = [0.0]
    sleeps = []

    def sleep(d):
        sleeps.append(d)
        now[0] += d

    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise ConnectionError(f"fail {calls[0]}")
        return calls[0]

    def count(name):
        return retry.snapshot().get(name, {}).get("count", 0)

    before = [count(f"Retry.{k}.{site}") for k in ("Attempts", "GiveUps")]
    try:
        out = ("ok", retry.retry_call(
            fn, site=site, policy=retry.RetryPolicy(**POLICIES[policy]),
            retry_on=(ConnectionError,), seed=seed, sleep=sleep,
            clock=lambda: now[0]))
    except ConnectionError as e:
        out = ("raised", str(e))
    after = [count(f"Retry.{k}.{site}") for k in ("Attempts", "GiveUps")]
    return out, sleeps, [a - b for a, b in zip(after, before)]


@pytest.mark.parametrize("fails", [0, 2, 4, 20])
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_retry_call_counters_identical(policy, fails):
    want = _retry_run(j_retry, policy, fails, 7)
    got = _retry_run(t_retry, policy, fails, 7)
    assert got == want
    assert got[2][0] >= 1


def test_retry_registry_families_present():
    """The aggregate families exist before any retry, as in the reference:
    /metrics always shows them."""
    for r in (j_retry, t_retry):
        snap = r.snapshot()
        assert "Retry.Attempts" in snap and "Retry.GiveUps" in snap
    with pytest.raises(ValueError):
        t_retry.retry_call(lambda: (_ for _ in ()).throw(ValueError("x")),
                           site="torch_messaging.noretry",
                           retry_on=(KeyError,))
