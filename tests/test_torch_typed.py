"""The port's typed actor API (akka_tpu_torch.typed) on the CPU, side by
side with the JAX package's: a port of the 8 scenarios of
tests/test_typed.py (behaviors, setup/stopped, supervision, watch, timers,
stash, message adapters) and the 8 of tests/test_typed_ecosystem.py
(receptionist, reliable delivery, work pulling, topics, the stream-typed
adapters). Each scenario is written once, runs on both packages, and the
port's trace of replies and listings must equal the reference's. The
cluster receptionist runs on two cluster nodes of each package over its
own in-proc transport.

Every system starts through the `systems` fixture
(tests/torch_host_fixture.py), which asserts `await_termination(10.0)` and
that no thread is left; every wait is at most 10 s.
"""

import importlib
import threading
import time

import pytest

from torch_host_fixture import QUIET, WAIT, Systems, package, side_by_side


@pytest.fixture()
def systems():
    s = Systems()
    try:
        yield s
    finally:
        s.close()


def _empty(P):
    return P.typed.Behaviors.empty


# ------------------------------------------------ tests/test_typed.py

def _counter(P, systems):
    B = P.typed.Behaviors
    ts = systems.typed(P, _empty(P))
    replies, got = [], threading.Event()

    def counter(count=0):
        def on_msg(ctx, msg):
            if msg == "inc":
                return counter(count + 1)
            if isinstance(msg, tuple) and msg[0] == "get":
                msg[1].tell(count)
                return B.same
            return B.unhandled
        return B.receive(on_msg)

    ref = ts.spawn(counter(), "counter")
    for _ in range(5):
        ref.tell("inc")
    probe = ts.classic.provider.create_function_ref(
        lambda msg, sender: (replies.append(msg), got.set()))
    ref.tell(("get", probe))
    assert got.wait(WAIT)
    return replies


def test_counter_behavior(systems):
    assert side_by_side(_counter, systems) == [5]


def _setup_and_stopped(P, systems):
    B = P.typed.Behaviors
    ts = systems.typed(P, _empty(P))
    stopped, started = threading.Event(), threading.Event()

    def root():
        def _setup(ctx):
            started.set()

            def on_msg(ctx, msg):
                if msg == "stop":
                    return B.stopped(lambda: stopped.set())
                return B.same
            return B.receive(on_msg)
        return B.setup(_setup)

    ref = ts.spawn(root())
    ref.tell("noop")
    assert started.wait(WAIT)
    ref.tell("stop")
    assert stopped.wait(WAIT)
    return ["started", "stopped"]


def test_setup_and_stopped(systems):
    side_by_side(_setup_and_stopped, systems)


def _await(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _supervision_restart(P, systems):
    B, S = P.typed.Behaviors, P.typed.SupervisorStrategy
    ts = systems.typed(P, _empty(P))
    starts, seen = [], []

    def flaky():
        def _setup(ctx):
            starts.append(1)

            def on_msg(ctx, msg):
                if msg == "boom":
                    raise ValueError("boom")
                seen.append(msg)
                return B.same
            return B.receive(on_msg)
        return B.setup(_setup)

    ref = ts.spawn(B.supervise(flaky()).on_failure(S.restart()), "flaky")
    ref.tell("ok")
    _await(lambda: seen == ["ok"], "the first message")
    assert len(starts) == 1
    ref.tell("boom")
    ref.tell("ok-again")  # handled by the restarted behavior
    _await(lambda: seen == ["ok", "ok-again"], "alive after the restart")
    return [len(starts), seen]


def test_supervision_restart(systems):
    # setup re-ran on restart
    assert side_by_side(_supervision_restart, systems) == \
        [2, ["ok", "ok-again"]]


def _supervision_stop(P, systems):
    B, S = P.typed.Behaviors, P.typed.SupervisorStrategy
    ts = systems.typed(P, _empty(P))
    stopped = threading.Event()

    def flaky():
        def on_msg(ctx, msg):
            raise ValueError("die")
        return B.receive(on_msg, lambda ctx, sig: (stopped.set(), B.same)[1]
                         if sig is P.typed.PostStop else B.unhandled)

    ref = ts.spawn(B.supervise(flaky()).on_failure(S.stop()))
    ref.tell("x")
    assert stopped.wait(WAIT)
    return ["post-stop"]


def test_supervision_stop(systems):
    side_by_side(_supervision_stop, systems)


def _watch_terminated(P, systems):
    B = P.typed.Behaviors
    ts = systems.typed(P, _empty(P))
    saw, names = threading.Event(), []

    def watcher():
        def _setup(ctx):
            child = ctx.spawn(B.receive_message(
                lambda m: B.stopped() if m == "die" else B.same), "child")
            ctx.watch(child)
            child.tell("die")

            def on_sig(ctx, sig):
                if isinstance(sig, P.typed.Terminated):
                    names.append(sig.ref.path.name)
                    saw.set()
                    return B.same
                return B.unhandled
            return B.receive(lambda ctx, m: B.same, on_sig)
        return B.setup(_setup)

    ts.spawn(watcher())
    assert saw.wait(WAIT)
    return names


def test_watch_terminated_signal(systems):
    assert side_by_side(_watch_terminated, systems) == ["child"]


def _timers(P, systems):
    B = P.typed.Behaviors
    ts = systems.typed(P, _empty(P))
    ticks, done = [], threading.Event()

    def ticker():
        def _factory(timers):
            timers.start_timer_with_fixed_delay("tick", "tick", 0.05)

            def on_msg(ctx, msg):
                ticks.append(msg)
                if len(ticks) >= 3:
                    timers.cancel("tick")
                    done.set()
                return B.same
            return B.receive(on_msg)
        return B.with_timers(_factory)

    ts.spawn(ticker())
    assert done.wait(WAIT)
    return ticks[:3]


def test_timers(systems):
    assert side_by_side(_timers, systems) == ["tick"] * 3


def _stash_buffer(P, systems):
    B = P.typed.Behaviors
    ts = systems.typed(P, _empty(P))
    processed, done = [], threading.Event()

    def initializing():
        def _factory(stash):
            def waiting(ctx, msg):
                if msg == "go":
                    return stash.unstash_all(active())
                stash.stash(msg)
                return B.same

            def active():
                def on_msg(ctx, msg):
                    processed.append(msg)
                    if msg == "c":
                        done.set()
                    return B.same
                return B.receive(on_msg)

            return B.receive(waiting)
        return B.with_stash(100, _factory)

    ref = ts.spawn(initializing())
    for m in ["a", "b", "c"]:
        ref.tell(m)
    ref.tell("go")
    assert done.wait(WAIT)
    return processed


def test_stash_buffer(systems):
    assert side_by_side(_stash_buffer, systems) == ["a", "b", "c"]


def _message_adapter(P, systems):
    B = P.typed.Behaviors
    ts = systems.typed(P, _empty(P))
    got, seen = threading.Event(), []

    def backend():
        return B.receive(lambda ctx, msg: (msg[1].tell(("raw", msg[0])),
                                           B.same)[1])

    def frontend():
        def _setup(ctx):
            be = ctx.spawn(backend(), "backend")
            adapter = ctx.message_adapter(lambda raw: ("wrapped", raw))
            be.tell((42, adapter))

            def on_msg(ctx, msg):
                seen.append(msg)
                got.set()
                return B.same
            return B.receive(on_msg)
        return B.setup(_setup)

    ts.spawn(frontend())
    assert got.wait(WAIT)
    return seen


def test_message_adapter(systems):
    assert side_by_side(_message_adapter, systems) == \
        [("wrapped", ("raw", 42))]


# --------------------------------------- tests/test_typed_ecosystem.py

_actor_classes = {}


def actors(P):
    """The ecosystem scenarios' classic actors, one set per package."""
    if P.name in _actor_classes:
        return _actor_classes[P.name]
    d = P.delivery

    class Echo(P.Actor):
        def receive(self, message):
            self.sender.tell(("echo", message), self.self_ref)

    class Producer(P.Actor):
        """Sends words on demand (reference ReliableDeliverySpec
        TestProducer)."""

        def __init__(self, words, probe):
            super().__init__()
            self.words = list(words)
            self.probe = probe

        def receive(self, message):
            if isinstance(message, d.RequestNext):
                if self.words:
                    message.send_next_to.tell(self.words.pop(0),
                                              self.self_ref)
                else:
                    self.probe.tell("producer-drained", self.self_ref)

    class Consumer(P.Actor):
        """Confirms every delivery (reference TestConsumer)."""

        def __init__(self, probe):
            super().__init__()
            self.probe = probe

        def receive(self, message):
            if isinstance(message, d.Delivery):
                self.probe.tell(("delivered", message.seq_nr,
                                 message.message), self.self_ref)
                message.confirm_to.tell(d.Confirmed(), self.self_ref)

    class DroppingConsumer(P.Actor):
        def receive(self, message):
            pass

    class Worker(P.Actor):
        def __init__(self, name, probe):
            super().__init__()
            self.name_ = name
            self.probe = probe

        def receive(self, message):
            if isinstance(message, d.Delivery):
                self.probe.tell((self.name_, message.message), self.self_ref)
                message.confirm_to.tell(d.Confirmed(), self.self_ref)

    class JobProducer(P.Actor):
        def __init__(self, jobs):
            super().__init__()
            self.jobs = list(jobs)

        def receive(self, message):
            if isinstance(message, d.WorkPullingRequestNext):
                if self.jobs:
                    message.send_next_to.tell(self.jobs.pop(0),
                                              self.self_ref)

    out = _actor_classes[P.name] = dict(
        Echo=Echo, Producer=Producer, Consumer=Consumer,
        DroppingConsumer=DroppingConsumer, Worker=Worker,
        JobProducer=JobProducer)
    return out


def _paths(refs):
    return sorted(r.path.name for r in refs)


def _receptionist(P, systems, config=None):
    T, A = P.typed, actors(P)
    system = systems.classic(P, "typed-eco", config)
    probe_of = P.testkit.TestProbe
    rec = T.Receptionist.get(system)
    key = T.ServiceKey("echo-service")
    probe = probe_of(system)
    svc1 = system.actor_of(P.Props.create(A["Echo"]), "svc1")
    trace = []

    rec.register(key, svc1, reply_to=probe.ref)
    registered = probe.receive_one(WAIT)
    assert registered.service == svc1
    trace.append(("registered", registered.service.path.name))

    rec.find(key, probe.ref)
    listing = probe.receive_one(WAIT)
    assert listing.service_instances == frozenset({svc1})
    trace.append(("found", _paths(listing.service_instances)))

    sub = probe_of(system)
    rec.subscribe(key, sub.ref)
    first = sub.receive_one(WAIT).service_instances
    assert first == frozenset({svc1})
    svc2 = system.actor_of(P.Props.create(A["Echo"]), "svc2")
    rec.register(key, svc2)
    second = sub.receive_one(WAIT).service_instances
    assert second == frozenset({svc1, svc2})
    trace += [("listed", _paths(first)), ("listed", _paths(second))]

    # terminated services drop out
    system.stop(svc1)

    def find_now():
        p = probe_of(system)
        rec.find(key, p.ref)
        return p.receive_one(WAIT).service_instances

    P.testkit.await_condition(lambda: find_now() == frozenset({svc2}),
                              max_time=WAIT)
    trace.append(("found", _paths(find_now())))
    return trace


def test_receptionist_register_find_subscribe(systems):
    assert side_by_side(_receptionist, systems)[-1] == ("found", ["svc2"])


def test_receptionist_of_a_remote_system_keeps_a_local_registry(systems):
    """A `provider = remote` system (no cluster) keeps its receptionist's
    registry local on both packages: the reference's receptionist tries
    Cluster.get, which a remote provider refuses, and stays local. Group
    routers, topics and work pulling find their services through it."""
    remote = {"akka": {"actor": {"provider": "remote"},
                       "remote": {"transport": "inproc",
                                  "canonical": {"hostname": "local",
                                                "port": 0}},
                       **QUIET["akka"]}}
    trace = side_by_side(_receptionist, systems, remote)
    assert trace[-1] == ("found", ["svc2"])


def _cluster_visibility(P, systems):
    """tests/test_typed_ecosystem.py::test_receptionist_cluster_visibility:
    two cluster nodes; a service registered on node 0 is found on node 1
    through the registry the replicator spreads, and the found ref
    answers across the nodes."""
    cfg = {"akka": {
        "actor": {"provider": "cluster"}, **QUIET["akka"],
        "remote": {"transport": "inproc",
                   "canonical": {"hostname": "local", "port": 0}},
        "cluster": {"gossip-interval": "0.05s",
                    "leader-actions-interval": "0.05s",
                    "distributed-data": {
                        "gossip-interval": "0.1s",
                        "notify-subscribers-interval": "0.05s",
                        "delta-crdt": {
                            "delta-propagation-interval": "0.05s"}}}}}
    Cluster = importlib.import_module(f"{P.name}.cluster").Cluster
    nodes = [systems.classic(P, "rc", cfg) for _ in range(2)]
    for s in nodes:
        Cluster.get(s).join(str(nodes[0].provider.local_address))
    P.testkit.await_condition(
        lambda: all(sum(1 for m in Cluster.get(s).state.members
                        if m.status.value == "Up") == 2 for s in nodes),
        max_time=WAIT)
    key = P.typed.ServiceKey("cluster-svc")
    svc = nodes[0].actor_of(P.Props.create(actors(P)["Echo"]),
                            "clustered-echo")
    P.typed.Receptionist.get(nodes[0]).register(key, svc)

    def found_on_node1():
        p = P.testkit.TestProbe(nodes[1])
        P.typed.Receptionist.get(nodes[1]).find(key, p.ref)
        return p.receive_one(3.0).service_instances

    P.testkit.await_condition(lambda: len(found_on_node1()) == 1,
                              max_time=WAIT)
    remote_ref = next(iter(found_on_node1()))
    p = P.testkit.TestProbe(nodes[1])
    remote_ref.tell("hi", p.ref)
    reply = p.receive_one(5.0)
    return [remote_ref.path.name,
            remote_ref.path.address == nodes[0].provider.local_address,
            reply]


def test_receptionist_cluster_visibility(systems):
    """The cluster receptionist replicates its registry through ddata's
    replicator, on both packages: node 1 finds node 0's service and its
    ref reaches node 0."""
    assert side_by_side(_cluster_visibility, systems) == [
        "clustered-echo", True, ("echo", "hi")]


def _delivery_trace(probe, n):
    got = []
    while len(got) < n:
        m = probe.receive_one(WAIT)
        if isinstance(m, tuple) and m[0] == "delivered":
            got.append(m)
    return got


def _point_to_point(P, systems):
    d, A = P.delivery, actors(P)
    system = systems.classic(P, "typed-eco")
    probe = P.testkit.TestProbe(system)
    pc = system.actor_of(d.producer_controller_props("p1"), "pc")
    cc = system.actor_of(d.consumer_controller_props(flow_control_window=5),
                         "cc")
    consumer = system.actor_of(P.Props.create(A["Consumer"], probe.ref))
    producer = system.actor_of(P.Props.create(
        A["Producer"], ["a", "b", "c", "d", "e", "f"], probe.ref))
    cc.tell(d.Start(consumer), None)
    cc.tell(d.RegisterToProducerController(pc), None)
    pc.tell(d.Start(producer), None)
    return _delivery_trace(probe, 6)


def test_reliable_delivery_point_to_point(systems):
    got = side_by_side(_point_to_point, systems)
    assert [g[2] for g in got] == ["a", "b", "c", "d", "e", "f"]
    assert [g[1] for g in got] == [1, 2, 3, 4, 5, 6]  # sequenced, in order


def _confirmation_ask(P, systems):
    d, A = P.delivery, actors(P)
    system = systems.classic(P, "typed-eco")
    probe, reply_probe = (P.testkit.TestProbe(system),
                          P.testkit.TestProbe(system))
    pc = system.actor_of(d.producer_controller_props("p2"))
    cc = system.actor_of(d.consumer_controller_props())
    consumer = system.actor_of(P.Props.create(A["Consumer"], probe.ref))
    cc.tell(d.Start(consumer), None)
    cc.tell(d.RegisterToProducerController(pc), None)
    # MessageWithConfirmation: reply arrives once the consumer confirmed
    pc.tell(d.MessageWithConfirmation("important", reply_probe.ref), None)
    return [probe.receive_one(WAIT)[2], reply_probe.receive_one(WAIT)]


def test_reliable_delivery_with_confirmation_ask(systems):
    # the message, then its confirmed seq nr
    assert side_by_side(_confirmation_ask, systems) == ["important", 1]


def _durable_queue(P, systems):
    """Unconfirmed messages survive a producer-controller restart
    (reference: EventSourcedProducerQueue)."""
    d, A = P.delivery, actors(P)
    system = systems.classic(P, "typed-eco")
    probe = P.testkit.TestProbe(system)
    pc1 = system.actor_of(d.producer_controller_props(
        "p3", durable_queue_name="dq-test"), "pc-durable-1")
    producer = system.actor_of(P.Props.create(A["Producer"], ["x", "y"],
                                              probe.ref))
    pc1.tell(d.Start(producer), None)
    # demand opens when a consumer registers: one that drops deliveries
    # (never confirms) puts messages in flight
    cc1 = system.actor_of(d.consumer_controller_props(), "cc-durable-1")
    cc1.tell(d.Start(system.actor_of(P.Props.create(
        A["DroppingConsumer"]))), None)
    cc1.tell(d.RegisterToProducerController(pc1), None)
    time.sleep(0.5)  # x persisted to the durable queue, never confirmed
    system.stop(pc1)
    system.stop(cc1)

    # a new incarnation with the same durable queue name redelivers x
    pc2 = system.actor_of(d.producer_controller_props(
        "p3", durable_queue_name="dq-test"), "pc-durable-2")
    cc2 = system.actor_of(d.consumer_controller_props(), "cc-durable-2")
    consumer = system.actor_of(P.Props.create(A["Consumer"], probe.ref))
    cc2.tell(d.Start(consumer), None)
    cc2.tell(d.RegisterToProducerController(pc2), None)
    return _delivery_trace(probe, 1)[0][2]


def test_reliable_delivery_durable_queue_resends_after_restart(systems):
    assert side_by_side(_durable_queue, systems) == "x"


def _work_pulling(P, systems):
    T, d, A = P.typed, P.delivery, actors(P)
    system = systems.classic(P, "typed-eco")
    probe = P.testkit.TestProbe(system)
    key = T.ServiceKey("workers")
    rec = T.Receptionist.get(system)
    # two workers, each with its own consumer controller
    for i in range(2):
        cc = system.actor_of(d.consumer_controller_props(), f"wp-cc{i}")
        worker = system.actor_of(P.Props.create(A["Worker"], f"w{i}",
                                                probe.ref))
        cc.tell(d.Start(worker), None)
        rec.register(key, cc)
    wp = system.actor_of(d.work_pulling_producer_props("wp1", key), "wp")
    producer = system.actor_of(P.Props.create(
        A["JobProducer"], [f"job{i}" for i in range(6)]))
    wp.tell(d.Start(producer), None)
    got = [probe.receive_one(WAIT) for _ in range(6)]
    workers_used = {w for w, _ in got}
    assert workers_used <= {"w0", "w1"} and workers_used
    return sorted(j for _, j in got)


def test_work_pulling(systems):
    assert side_by_side(_work_pulling, systems) == \
        [f"job{i}" for i in range(6)]


def _topic(P, systems):
    T = P.typed
    system = systems.classic(P, "typed-eco")
    topic = T.Topic.create(system, "news")
    p1, p2 = P.testkit.TestProbe(system), P.testkit.TestProbe(system)
    topic.tell(T.TopicSubscribe(p1.ref), None)
    topic.tell(T.TopicSubscribe(p2.ref), None)
    time.sleep(0.2)  # receptionist listing settles
    topic.tell(T.Publish("hello"), None)
    return [p1.receive_one(WAIT), p2.receive_one(WAIT)]


def test_topic_pubsub(systems):
    assert side_by_side(_topic, systems) == ["hello", "hello"]


def _actor_source_and_sink(P, systems):
    st = importlib.import_module(f"{P.name}.stream")
    typed = importlib.import_module(f"{P.name}.stream.typed")
    system = systems.classic(P, "typed-eco")
    ref, fut = typed.ActorSource.actor_ref(
        complete_matcher=lambda m: m == "DONE",
        failure_matcher=lambda m: None, buffer_size=64) \
        .to_mat(st.Sink.seq(), st.Keep.both).run(system)
    time.sleep(0.1)
    for m in ("a", "b", "DONE"):
        ref.tell(m)
    sourced = fut.result(WAIT)

    # the ack-based sink: the target acks each element before the next
    class AckingTarget(P.Actor):
        def __init__(self, probe):
            super().__init__()
            self.probe = probe

        def receive(self, message):
            if message in ("init", "done"):
                self.probe.tell(message, self.self_ref)
                if message == "init":
                    self.sender.tell("ACK", self.self_ref)
            else:
                self.probe.tell(("elem", message), self.self_ref)
                self.sender.tell("ACK", self.self_ref)

    probe = P.testkit.TestProbe(system)
    target = system.actor_of(P.Props.create(AckingTarget, probe.ref))
    st.Source.from_iterable([1, 2, 3]).to(
        typed.ActorSink.actor_ref_with_backpressure(
            target, message_adapter=None, on_init_message="init",
            ack_message="ACK", on_complete_message="done"),
        st.Keep.right).run(system)
    return sourced, [probe.receive_one(WAIT) for _ in range(5)]


def test_actor_source_and_acked_sink(systems):
    """tests/test_typed_ecosystem.py's stream-typed case: an ActorSource
    fed by tells until its completion message, and an ActorSink that
    waits for the target's ack before each next element."""
    assert side_by_side(_actor_source_and_sink, systems) == (
        ["a", "b"], ["init", ("elem", 1), ("elem", 2), ("elem", 3), "done"])
