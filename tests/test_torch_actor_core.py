"""The port's host actor core (akka_tpu_torch.actor, dispatch, event,
pattern) on the CPU: a port of the 16 scenarios of tests/test_actor_core.py
(ActorRefSpec / DeathWatchSpec / SupervisorSpec / ActorLifeCycleSpec), the
configurations the port refuses, the unconditional `tpu-batched` type, and
the copied serialization registry held to the reference's bytes.

Every ActorSystem starts through the `systems` fixture (the `system`
fixture is its port system named "test"), which terminates each system,
asserts that termination finished, and asserts that no thread the test
started is still alive (5 s join). The backoff scenarios run on both
packages through `side_by_side` and hold the port's trace to the
reference's."""

import threading
import time

import numpy as np
import pytest
import torch

from akka_tpu_torch import (Actor, ActorSystem, Props, PoisonPill, Kill,
                            Terminated, Identify, ActorIdentity, DeadLetter,
                            OneForOneStrategy, Resume, Stop, ask_sync,
                            AskTimeoutException)

from torch_host_fixture import (WAIT, Systems, assert_no_new_threads,
                                side_by_side)
from torch_host_fixture import threads as _threads

CFG = {"akka": {"loglevel": "WARNING", "stdout-loglevel": "ERROR",
                "log-dead-letters": 0}}


@pytest.fixture()
def systems():
    s = Systems()
    try:
        yield s
    finally:
        s.close()


@pytest.fixture()
def system(systems):
    sys_ = ActorSystem.create("test", CFG)
    systems.open.append(sys_)
    return sys_


class Echo(Actor):
    def receive(self, message):
        self.sender.tell(message, self.self_ref)


class Counter(Actor):
    def __init__(self):
        super().__init__()
        self.count = 0

    def receive(self, message):
        if message == "inc":
            self.count += 1
        elif message == "get":
            self.sender.tell(self.count, self.self_ref)
        else:
            return NotImplemented


def test_tell_and_ask(system):
    echo = system.actor_of(Props.create(Echo), "echo")
    assert ask_sync(echo, "hello", timeout=5.0) == "hello"


def test_ordering_single_sender(system):
    received = []
    done = threading.Event()

    class Collect(Actor):
        def receive(self, message):
            received.append(message)
            if message == 999:
                done.set()

    ref = system.actor_of(Props.create(Collect))
    for i in range(1000):
        ref.tell(i)
    assert done.wait(10.0)
    assert received == list(range(1000))


def test_counter_state(system):
    ref = system.actor_of(Props.create(Counter))
    for _ in range(100):
        ref.tell("inc")
    assert ask_sync(ref, "get") == 100


def test_ask_timeout(system):
    class Silent(Actor):
        def receive(self, message):
            pass

    ref = system.actor_of(Props.create(Silent))
    with pytest.raises(AskTimeoutException):
        ask_sync(ref, "anything", timeout=0.2)


def test_poison_pill_and_deathwatch(system):
    terminated = threading.Event()
    seen = []

    class Watcher(Actor):
        def __init__(self, target):
            super().__init__()
            self.context.watch(target)

        def receive(self, message):
            if isinstance(message, Terminated):
                seen.append(message.actor)
                terminated.set()

    target = system.actor_of(Props.create(Echo), "target")
    system.actor_of(Props.create(Watcher, target))
    target.tell(PoisonPill)
    assert terminated.wait(5.0)
    assert seen[0] == target


def test_identify(system):
    echo = system.actor_of(Props.create(Echo), "identify-me")
    reply = ask_sync(echo, Identify("corr"))
    assert isinstance(reply, ActorIdentity)
    assert reply.correlation_id == "corr"
    assert reply.ref == echo


def test_stop_cascades_to_children(system):
    child_stopped = threading.Event()
    parent_stopped = threading.Event()

    class Child(Actor):
        def post_stop(self):
            child_stopped.set()

        def receive(self, message):
            pass

    class Parent(Actor):
        def __init__(self):
            super().__init__()
            self.context.actor_of(Props.create(Child), "kid")

        def post_stop(self):
            parent_stopped.set()

        def receive(self, message):
            pass

    parent = system.actor_of(Props.create(Parent), "parent")
    system.stop(parent)
    assert child_stopped.wait(5.0)
    assert parent_stopped.wait(5.0)


def test_supervision_restart(system):
    starts = []
    restarted = threading.Event()

    class Failing(Actor):
        def __init__(self):
            super().__init__()
            self.hits = 0

        def pre_start(self):
            starts.append(time.monotonic())
            if len(starts) >= 2:
                restarted.set()

        def receive(self, message):
            if message == "boom":
                raise ValueError("boom")
            self.sender.tell(("ok", len(starts)), self.self_ref)

    class Sup(Actor):
        def __init__(self):
            super().__init__()
            self.child = self.context.actor_of(Props.create(Failing), "failing")

        @property
        def supervisor_strategy(self):
            return OneForOneStrategy(max_nr_of_retries=3, within_time_range=60.0)

        def receive(self, message):
            self.child.forward(message, self.context)

    sup = system.actor_of(Props.create(Sup), "sup")
    assert ask_sync(sup, "ping")[0] == "ok"
    sup.tell("boom")
    assert restarted.wait(5.0), "child was not restarted"
    assert ask_sync(sup, "ping") == ("ok", 2)


def test_supervision_resume_keeps_state(system):
    class Failing(Counter):
        def receive(self, message):
            if message == "boom":
                raise ValueError("boom")
            return super().receive(message)

    class Sup(Actor):
        def __init__(self):
            super().__init__()
            self.child = self.context.actor_of(Props.create(Failing), "failing")

        @property
        def supervisor_strategy(self):
            return OneForOneStrategy(decider=lambda e: Resume)

        def receive(self, message):
            self.child.forward(message, self.context)

    sup = system.actor_of(Props.create(Sup))
    sup.tell("inc")
    sup.tell("boom")
    sup.tell("inc")
    assert ask_sync(sup, "get") == 2


def test_supervision_stop_decider(system):
    stopped = threading.Event()

    class Failing(Actor):
        def post_stop(self):
            stopped.set()

        def receive(self, message):
            raise RuntimeError("die")

    class Sup(Actor):
        def __init__(self):
            super().__init__()
            self.child = self.context.actor_of(Props.create(Failing))

        @property
        def supervisor_strategy(self):
            return OneForOneStrategy(decider=lambda e: Stop)

        def receive(self, message):
            self.child.forward(message, self.context)

    sup = system.actor_of(Props.create(Sup))
    sup.tell("x")
    assert stopped.wait(5.0)


def test_kill_stops_via_default_decider(system):
    # default decider -> Stop on ActorKilledException (reference:
    # SupervisorStrategy.defaultDecider)
    stopped = threading.Event()

    class Victim(Actor):
        def post_stop(self):
            stopped.set()

        def receive(self, message):
            pass

    ref = system.actor_of(Props.create(Victim))
    ref.tell(Kill)
    assert stopped.wait(5.0)


def test_become_unbecome(system):
    class Switcher(Actor):
        def receive(self, message):
            if message == "switch":
                self.context.become(self.other, discard_old=False)
            else:
                self.sender.tell("base", self.self_ref)

        def other(self, message):
            if message == "back":
                self.context.unbecome()
            else:
                self.sender.tell("other", self.self_ref)

    ref = system.actor_of(Props.create(Switcher))
    assert ask_sync(ref, "q") == "base"
    ref.tell("switch")
    assert ask_sync(ref, "q") == "other"
    ref.tell("back")
    assert ask_sync(ref, "q") == "base"


def test_dead_letters_published(system):
    got = threading.Event()
    events = []

    def listener(event):
        events.append(event)
        got.set()

    system.event_stream.subscribe(listener, DeadLetter)
    echo = system.actor_of(Props.create(Echo))
    system.stop(echo)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not echo.is_terminated:
        time.sleep(0.01)
    echo.tell("too late")
    assert got.wait(5.0)
    assert events[0].message == "too late"


def test_actor_selection(system):
    system.actor_of(Props.create(Echo), "sel-target")
    time.sleep(0.1)
    ref = system.actor_selection(f"akka://test/user/sel-target")
    assert ask_sync(ref, "hi") == "hi"


def test_receive_timeout(system):
    from akka_tpu_torch import ReceiveTimeout
    fired = threading.Event()

    class Timed(Actor):
        def pre_start(self):
            self.context.set_receive_timeout(0.2)

        def receive(self, message):
            if message is ReceiveTimeout:
                fired.set()

    system.actor_of(Props.create(Timed))
    assert fired.wait(5.0)


def test_scheduler_tell(system):
    got = threading.Event()

    class L(Actor):
        def receive(self, message):
            if message == "tick":
                got.set()

    ref = system.actor_of(Props.create(L))
    system.scheduler.schedule_tell_once(0.05, ref, "tick")
    assert got.wait(5.0)


# ------------------------------------------------- what the port refuses
@pytest.mark.parametrize("config, item", [
    ({"akka": {"jax-distributed": {"enabled": True, "device": "cpu",
                                   "coordinator-address": "127.0.0.1:1",
                                   "num-processes": 2,
                                   "process-id": 1}}}, None),
    ({"akka": {"actor": {"provider": "remote"}}}, "remote"),
    ({"akka": {"actor": {"provider": "cluster"}}}, "cluster"),
], ids=["jax-distributed", "remote", "cluster"])
def test_unported_configurations_raise_naming_their_item(config, item,
                                                         monkeypatch):
    """The remote and cluster providers are ported: such a system starts,
    binds its default transport (TCP on 127.0.0.1, port 0) and
    terminates, joining the transport's threads. `akka.jax-distributed`
    is ported: the system calls the hook at start, which starts this
    process's rank of a process group (`dist.init_process_group`,
    recorded here instead), and terminate() destroys the group it
    started."""
    import torch.distributed as dist

    from akka_tpu_torch.parallel import mesh as tmesh
    from akka_tpu_torch.remote.provider import RemoteActorRefProvider
    calls = []
    monkeypatch.setattr(tmesh, "_distributed_initialized", False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", a, kw)))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a, **kw: calls.append(("destroy",)))
    monkeypatch.setattr(dist, "is_initialized",
                        lambda: len(calls) == 1)
    before = _threads()
    if item is not None:
        system = ActorSystem.create(f"bound-{item}", config)
        try:
            assert isinstance(system.provider, RemoteActorRefProvider)
            address = system.provider.local_address
            assert (address.host, address.system) == ("127.0.0.1",
                                                      f"bound-{item}")
            assert address.port > 0
            assert system.address == address
        finally:
            system.terminate()
        assert system.await_termination(10.0)
        assert calls == []
        assert_no_new_threads(before)
        return
    system = ActorSystem.create("ranked", config)
    assert calls == [("init", ("gloo",), {
        "init_method": "tcp://127.0.0.1:1", "world_size": 2, "rank": 1})]
    assert tmesh._distributed_initialized
    system.terminate()
    assert system.await_termination(10.0)
    assert calls[1:] == [("destroy",)]
    assert not tmesh._distributed_initialized


def test_tpu_batched_type_is_registered(system):
    from akka_tpu_torch.dispatch.batched import (
        TpuBatchedDispatcher, TpuBatchedDispatcherConfigurator)
    assert system.dispatchers._type_factories["tpu-batched"] is \
        TpuBatchedDispatcherConfigurator
    disp = system.dispatchers.lookup("akka.actor.tpu-dispatcher")
    assert isinstance(disp, TpuBatchedDispatcher)
    assert disp._config.get_string("device") == "cuda"
    assert not disp.has_runtime  # nothing built until a device actor


# --------------------------------- the serialization registry's bytes
def test_tensor_serializer_matches_the_reference():
    """A torch tensor serializes to the bytes and manifest the reference
    gives the same values as a numpy array (bf16 as float32), and both
    registries read each other's output."""
    from akka_tpu.serialization import Serialization as JSer
    from akka_tpu_torch.serialization import Serialization as TSer
    rng = np.random.default_rng(3)
    jser, tser = JSer(), TSer()
    for arr in (rng.standard_normal((3, 5)).astype(np.float32),
                rng.integers(-9, 9, (7,)).astype(np.int32),
                np.zeros((0, 2), np.float32)):
        t = torch.from_numpy(arr.copy())
        got = tser.serialize(t)
        want = jser.serialize(arr)
        assert got == want
        np.testing.assert_array_equal(jser.deserialize(*got), arr)
        np.testing.assert_array_equal(tser.deserialize(*want), arr)
    bf = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    sid, manifest, data = tser.serialize(bf)
    np.testing.assert_array_equal(
        tser.deserialize(sid, manifest, data),
        np.asarray([1.5, -2.0, 3.25], np.float32))


def test_wire_codec_matches_the_reference():
    """The fixed-schema codec (FieldSchemaSerializer) writes the
    reference's bytes for plain values, and each side decodes the
    other's."""
    from akka_tpu.serialization import codec as jcodec
    from akka_tpu_torch.serialization import codec as tcodec
    value = {"a": [1, 2.5, "x", None, True], "b": (b"raw", -7),
             "c": {"nested": [np.arange(4, dtype=np.int32)]}}
    got, want = tcodec.dumps(value), jcodec.dumps(value)
    assert got == want
    back = tcodec.loads(want)
    assert back["a"] == value["a"] and back["b"] == value["b"]
    np.testing.assert_array_equal(back["c"]["nested"][0],
                                  value["c"]["nested"][0])
    with pytest.raises(tcodec.WireCodecError):
        # an unregistered class outside the port is refused, never imported
        tcodec._resolve_class("akka_tpu.actor.messages:PoisonPillType")


# ------------------ pattern/backoff (tests/test_routing_patterns.py:161-213)

def _backoff_restart(P, systems):
    B = P.backoff

    class Crashy(P.Actor):
        def receive(self, message):
            if message == "boom":
                raise RuntimeError("crash")
            self.sender.tell("alive", self.self_ref)

    system = systems.classic(P, "backoff", CFG)
    sup = system.actor_of(B.BackoffSupervisor.props(
        P.Props.create(Crashy), "crashy", min_backoff=0.05, max_backoff=0.5))
    trace = [P.ask_sync(sup, "ping", timeout=WAIT)]
    first = P.ask_sync(sup, B.GetCurrentChild(), timeout=WAIT)
    trace.append((type(first).__name__, first.ref is not None))
    sup.tell("boom")
    deadline = time.monotonic() + WAIT
    while True:
        rc = P.ask_sync(sup, B.GetRestartCount(), timeout=WAIT)
        if rc.count >= 1:
            break
        assert time.monotonic() < deadline, "no restart counted"
        time.sleep(0.02)
    trace.append(type(rc).__name__)
    # asks sent while no child lives are buffered and forwarded to it
    trace.append(P.ask_sync(sup, "ping", timeout=WAIT))
    trace.append(P.ask_sync(sup, B.GetRestartCount(), timeout=WAIT).count)
    second = P.ask_sync(sup, B.GetCurrentChild(), timeout=WAIT).ref
    trace.append((second is not None, second != first.ref))
    systems.close_one(system)
    return trace


def test_backoff_supervisor_restarts_child(systems):
    """A crash stops the child (the supervisor's decider); the supervisor
    respawns it after its minimum backoff, counts the restart, and
    forwards the next messages to the new incarnation, as the reference's
    does."""
    assert side_by_side(_backoff_restart, systems) == [
        "alive", ("CurrentChild", True), "RestartCount", "alive", 1,
        (True, True)]


def _retry(P, systems):
    from concurrent.futures import Future
    system = systems.classic(P, "retry", CFG)
    attempts = [0]

    def attempt():
        attempts[0] += 1
        f = Future()
        if attempts[0] < 3:
            f.set_exception(RuntimeError(f"fail {attempts[0]}"))
        else:
            f.set_result("done")
        return f

    out = P.backoff.retry(attempt, attempts=5, delay=0.02,
                          scheduler=system.scheduler)
    trace = [out.result(WAIT), attempts[0]]
    # out of attempts: the last failure completes the future
    attempts[0] = -10
    failed = P.backoff.retry(attempt, attempts=2, delay=0.02,
                             scheduler=system.scheduler)
    err = failed.exception(WAIT)
    trace.append((type(err).__name__, str(err), attempts[0]))
    systems.close_one(system)
    return trace


def test_retry_succeeds_after_failures(systems):
    assert side_by_side(_retry, systems) == [
        "done", 3, ("RuntimeError", "fail -8", -8)]


def _graceful_stop(P, systems):
    class Echo(P.Actor):
        def receive(self, message):
            self.sender.tell(message, self.self_ref)

    system = systems.classic(P, "stop", CFG)
    echo = system.actor_of(P.Props.create(Echo))
    fut = P.backoff.graceful_stop(echo, 5.0, system)
    trace = [fut.result(WAIT), echo.is_terminated]
    systems.close_one(system)
    return trace


def test_graceful_stop(systems):
    assert side_by_side(_graceful_stop, systems) == [True, True]
