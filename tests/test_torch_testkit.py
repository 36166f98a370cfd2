"""The port's testkit (akka_tpu_torch.testkit: the probe, BehaviorTestKit
and TestInbox, manual time, LoggingTestKit, the in-process multi-node kit
and time dilation) on the CPU, held to the JAX package's:
tests/test_testkit.py's 15 cases, each written once over a package
namespace and run on both packages through `side_by_side`
(tests/torch_host_fixture.py); the port's trace (messages, effects,
liveness, barrier order, blackholed deliveries) must equal the
reference's, and each test also asserts the trace's values. The
multi-node cases run each package's role systems on its own in-proc
transport.

`dilation.time_factor` reads the load average, the cached sleep slip and
an environment variable; these tests give each package's module a
stand-in `os` (the same load and core count, no variable) and the same
cached slip (no test touches `os.environ`), and compare the two
packages' factors, `dilated` and `dilated_s`.

Every system starts through the `systems` fixture (the multi-node kit's
too: they are handed to it). Every wait is at most 10 s.
"""

import importlib
import time
from types import SimpleNamespace

import pytest

from torch_host_fixture import Systems, side_by_side


@pytest.fixture()
def systems():
    s = Systems()
    try:
        yield s
    finally:
        s.close()


_ECHO = {}


def echo(P):
    if P.name not in _ECHO:
        class Echo(P.Actor):
            def receive(self, message):
                self.sender.tell(message, self.self_ref)
        _ECHO[P.name] = Echo
    return _ECHO[P.name]


def quiet(P, systems):
    return systems.classic(P, "testkit", {"akka": {
        "stdout-loglevel": "ERROR", "log-dead-letters": 0}})


# ---------------------------------------------------------------- TestProbe
def _expect_msg(P, systems):
    s = quiet(P, systems)
    probe = P.testkit.TestProbe(s)
    e = s.actor_of(P.Props.create(echo(P)))
    probe.send(e, "ping")
    return [probe.expect_msg("ping"), probe.last_sender == e]


def test_probe_expect_msg(systems):
    assert side_by_side(_expect_msg, systems) == ["ping", True]


def _reply(P, systems):
    s = quiet(P, systems)
    probe = P.testkit.TestProbe(s)
    e = s.actor_of(P.Props.create(echo(P)))
    probe.send(e, "hi")
    got = [probe.expect_msg("hi")]
    probe.reply("back")  # echo echoes it back to the probe
    return got + [probe.expect_msg("back")]


def test_probe_reply(systems):
    assert side_by_side(_reply, systems) == ["hi", "back"]


def _no_message(P, systems):
    s = quiet(P, systems)
    probe = P.testkit.TestProbe(s)
    probe.expect_no_message(0.1)
    probe.ref.tell("x")
    with pytest.raises(P.testkit.AssertionFailure):
        probe.expect_no_message(0.3)
    return ["silent", "then x"]


def test_probe_expect_no_message(systems):
    assert side_by_side(_no_message, systems) == ["silent", "then x"]


def _terminated(P, systems):
    s = quiet(P, systems)
    probe = P.testkit.TestProbe(s)
    e = s.actor_of(P.Props.create(echo(P)))
    probe.watch(e)
    e.tell(importlib.import_module(P.name).PoisonPill)
    t = probe.expect_terminated(e)
    return [type(t).__name__, t.actor == e]


def test_probe_expect_terminated(systems):
    assert side_by_side(_terminated, systems) == ["Terminated", True]


def _fish(P, systems):
    s = quiet(P, systems)
    probe = P.testkit.TestProbe(s)
    for i in range(5):
        probe.ref.tell(i)
    return [probe.fish_for_message(lambda m: m == 3), probe.receive_one(1.0)]


def test_probe_fish_for_message(systems):
    assert side_by_side(_fish, systems) == [3, 4]


def _await_assert(P, systems):
    state = {"n": 0}

    def bump():
        state["n"] += 1
        assert state["n"] >= 3
    P.testkit.await_assert(bump, max_time=2.0, interval=0.01)
    return state["n"]


def test_await_assert(systems):
    assert side_by_side(_await_assert, systems) == 3


# ---------------------------------------------------------- BehaviorTestKit
def behaviors(P):
    return importlib.import_module(f"{P.name}.typed.behaviors").Behaviors


def _spawn_effect(P, systems):
    B = behaviors(P)
    child = B.receive_message(lambda m: B.same)

    def on_msg(ctx, msg):
        ctx.spawn(child, "worker")
        return B.same

    kit = P.testkit.BehaviorTestKit(B.receive(on_msg))
    kit.run("go")
    eff = kit.expect_effect_class(P.testkit.Spawned)
    return [type(eff).__name__, eff.child_name, eff.behavior is child,
            kit.has_effects()]


def test_behavior_testkit_spawn_effect(systems):
    assert side_by_side(_spawn_effect, systems) == [
        "Spawned", "worker", True, False]


def _child_inbox(P, systems):
    B = behaviors(P)
    child = B.receive_message(lambda m: B.same)

    def on_msg(ctx, msg):
        ref = ctx.spawn(child, "kid")
        ref.tell(("hello", msg))
        return B.same

    kit = P.testkit.BehaviorTestKit(B.receive(on_msg))
    kit.run(42)
    effects = [type(e).__name__ for e in kit.retrieve_all_effects()]
    return [effects, kit.child_inbox("kid").receive_message(),
            kit.child_inbox("nobody")]


def test_behavior_testkit_child_inbox(systems):
    assert side_by_side(_child_inbox, systems) == [
        ["Spawned"], ("hello", 42), None]


def _timers_effect(P, systems):
    B = behaviors(P)

    def factory(timers):
        def on_msg(ctx, msg):
            timers.start_single_timer("k", "tick", 1.5)
            return B.same
        return B.receive(on_msg)

    kit = P.testkit.BehaviorTestKit(B.with_timers(factory))
    kit.run("arm")
    eff = kit.expect_effect_class(P.testkit.Scheduled)
    return [eff.message, eff.delay]


def test_behavior_testkit_timers_effect(systems):
    assert side_by_side(_timers_effect, systems) == ["tick", 1.5]


def _stop(P, systems):
    B = behaviors(P)

    def on_msg(ctx, msg):
        if msg == "die":
            return B.stopped()
        return B.same

    kit = P.testkit.BehaviorTestKit(B.receive(on_msg))
    alive = [kit.is_alive]
    kit.run("live")
    alive.append(kit.is_alive)
    kit.run("die")
    return alive + [kit.is_alive]


def test_behavior_testkit_stop(systems):
    assert side_by_side(_stop, systems) == [True, True, False]


def _inbox(P, systems):
    inbox = P.testkit.TestInbox("box")
    inbox.ref.tell("a")
    inbox.ref.tell("b")
    out = [inbox.expect_message("a"), inbox.receive_message(),
           inbox.has_messages]
    with pytest.raises(AssertionError):
        inbox.receive_message()
    return out + [repr(inbox.ref)]


def test_test_inbox(systems):
    assert side_by_side(_inbox, systems) == [
        "a", "b", False, "TestInboxRef(box)"]


# --------------------------------------------------------------- ManualTime
def _manual_time(P, systems):
    s = quiet(P, systems)
    manual = P.testkit.install_manual_time(s)
    probe = P.testkit.TestProbe(s)
    s.scheduler.schedule_tell_once(5.0, probe.ref, "later")
    probe.expect_no_message(0.1)
    manual.time_passes(4.0)
    probe.expect_no_message(0.1)
    manual.time_passes(2.0)
    return [type(manual).__name__, probe.expect_msg("later")]


def test_manual_time(systems):
    assert side_by_side(_manual_time, systems) == [
        "ExplicitlyTriggeredScheduler", "later"]


# ----------------------------------------------------------- LoggingTestKit
def _logging(P, systems):
    s = quiet(P, systems)
    with P.testkit.LoggingTestKit.warn("something odd").expect(s) as kit:
        s.log.warning("something odd happened")
    out = [[str(e.message) for e in kit.matched]]
    with pytest.raises(AssertionError, match="expected 1 matching"):
        with P.testkit.LoggingTestKit.error("never said").expect(s):
            s.log.warning("never said")
    return out


def test_logging_testkit(systems):
    assert side_by_side(_logging, systems) == [["something odd happened"]]


# ------------------------------------------------------------- MultiNodeKit
def multi_node(P, systems, roles):
    """A MultiNodeKit of package P whose systems the fixture ends too."""
    kit = P.testkit.MultiNodeKit(roles)
    systems.open.extend(kit.systems.values())
    return kit


def _barrier_and_messaging(P, systems):
    out, order = {}, []
    with multi_node(P, systems, ["first", "second"]) as kit:
        def first(node):
            node.system.actor_of(P.Props.create(echo(P)), "echo")
            order.append("first deployed")
            node.enter_barrier("deployed")
            node.enter_barrier("done")

        def second(node):
            node.enter_barrier("deployed")
            order.append("second past deployed")
            probe = P.testkit.TestProbe(node.system)
            remote = node.system.provider.resolve_actor_ref(
                kit.node("first", "/user/echo"))
            probe.send(remote, "over-the-wire")
            out["reply"] = probe.receive_one(5.0)
            node.enter_barrier("done")

        kit.run({"first": first, "second": second})
    return [order, out["reply"]]


def test_multi_node_barrier_and_messaging(systems):
    assert side_by_side(_barrier_and_messaging, systems) == [
        ["first deployed", "second past deployed"], "over-the-wire"]


def _blackhole(P, systems):
    got = []
    with multi_node(P, systems, ["a", "b"]) as kit:
        kit.system("a").actor_of(P.Props.create(echo(P)), "echo")
        time.sleep(0.1)
        probe = P.testkit.TestProbe(kit.system("b"))
        remote = kit.system("b").provider.resolve_actor_ref(
            kit.node("a", "/user/echo"))
        probe.send(remote, "one")
        got.append(probe.expect_msg("one", timeout=5.0))
        kit.conductor.blackhole("a", "b")
        probe.send(remote, "two")
        probe.expect_no_message(0.4)
        got.append("two lost")
        kit.conductor.pass_through("a", "b")
        probe.send(remote, "three")
        got.append(probe.expect_msg("three", timeout=5.0))
    return got


def test_multi_node_blackhole(systems):
    assert side_by_side(_blackhole, systems) == ["one", "two lost", "three"]


# ----------------------------------------------------------------- dilation
READINGS = [  # (1-minute load, ncpu, sleep slip)
    (0.0, 8, 1.0), (3.9, 8, 1.0), (8.0, 8, 1.0), (20.0, 8, 1.2),
    (200.0, 8, 1.0), (0.0, 8, 3.5), (1.0, 1, 1.0), (0.5, 4, 30.0)]


@pytest.mark.parametrize("load,ncpu,slip", READINGS)
def test_time_factor_and_dilated_match_the_reference(monkeypatch, load,
                                                     ncpu, slip):
    """Both packages' time_factor, dilated and dilated_s at the same
    readings of the load, the core count and the cached slip (no sleep:
    the slip cache is fresh); the factor is 1 + 3 x the load beyond half
    the cores per core, or the slip, between 1 and 8. Each module's `os`
    is a stand-in with no timefactor variable."""
    readings = SimpleNamespace(environ={},
                               getloadavg=lambda: (load, 0.0, 0.0),
                               cpu_count=lambda: ncpu)
    out = {}
    for name in ("akka_tpu", "akka_tpu_torch"):
        d = importlib.import_module(f"{name}.testkit.dilation")
        monkeypatch.setattr(d, "os", readings)
        monkeypatch.setitem(d._slip_cache, "at", time.monotonic() + 60.0)
        monkeypatch.setitem(d._slip_cache, "value", slip)
        out[name] = (d.time_factor(), d.dilated(2.0), d.dilated_s(1.5))
    assert out["akka_tpu_torch"] == out["akka_tpu"]
    excess = max(0.0, load - 0.5 * ncpu) / ncpu
    want = min(max(1.0, 1.0 + 3.0 * excess, slip), 8.0)
    assert out["akka_tpu_torch"] == (want, 2.0 * want, f"{1.5 * want:.2f}s")
