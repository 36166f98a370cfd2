"""The port's RetryFlow, PartitionHub, JsonFraming and context flows
(akka_tpu_torch.stream.retry, .hub, .framing, .context) on the CPU, side
by side with the JAX package's: the 30 cases of tests/test_stream_tail.py
and the 7 of tests/test_stream_context.py. Each scenario is written once
over a package's names, runs on both packages, and the port's trace must
equal the reference's (tests/torch_stream_fixture.py).

Where the reference holds a retry's wall-clock delays against a budget,
both packages are held to the order and number of the attempts and to the
backoff schedule the stage computes (`delay_for`), not to the clock. The
port's own addition, a seeded jitter, is held to `random.Random(seed)`.
"""

import random
import time

import pytest

from torch_stream_fixture import WAIT, err, side_by_side


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# ================================ RetryFlow =================================

@side_by_side
def test_retry_flow_no_retries_passes_through(S):
    wrapped = S.RetryFlow.with_backoff(0.01, 0.1, 0.0, 3,
                                       S.Flow().map(lambda x: x * 10),
                                       lambda i, o: None)
    out = S.seq(S.Source.from_iterable([1, 2, 3]).via(wrapped))
    assert out == [10, 20, 30]
    return out


@side_by_side
def test_retry_flow_retries_until_success(S):
    """A flaky service that answers with an error marker the first two
    times per element; decide_retry re-injects until success."""
    attempts, calls = {}, []

    def service(x):
        attempts[x] = attempts.get(x, 0) + 1
        calls.append(x)
        return ("ok", x) if attempts[x] >= 3 else ("err", x)

    wrapped = S.RetryFlow.with_backoff(
        0.005, 0.02, 0.0, 5, S.Flow().map(service),
        lambda i, o: i if o[0] == "err" else None)
    out = S.seq(S.Source.from_iterable([7, 8]).via(wrapped))
    assert out == [("ok", 7), ("ok", 8)]
    assert attempts == {7: 3, 8: 3}
    return out, calls


@side_by_side
def test_retry_flow_gives_up_after_max_retries(S):
    """After max_retries re-injections the last response is emitted even
    though decide_retry still asks for a retry."""
    calls = []

    def service(x):
        calls.append(x)
        return "err"

    wrapped = S.RetryFlow.with_backoff(0.001, 0.01, 0.0, 2,
                                       S.Flow().map(service),
                                       lambda i, o: i)
    out = S.seq(S.Source.single(1).via(wrapped))
    assert out == ["err"] and len(calls) == 3  # original + 2 retries
    return out, calls


@side_by_side
def test_retry_flow_can_modify_retried_element(S):
    """decide_retry may re-inject a different element (a retry budget
    carried in the element)."""
    seen = []

    def decide(inp, out):
        seen.append(inp)
        return (inp[0], inp[1] - 1) if inp[1] > 0 else None

    wrapped = S.RetryFlow.with_backoff(0.001, 0.01, 0.0, 10,
                                       S.Flow().map(lambda p: p), decide)
    out = S.seq(S.Source.from_iterable([("a", 2)]).via(wrapped))
    assert out == [("a", 0)]
    return out, seen


@side_by_side
def test_retry_flow_backoff_delays_grow(S):
    """Two forced retries with min_backoff 60 ms: three attempts in order,
    and the stage's schedule doubles (60 ms, then 120 ms; no jitter)."""
    seen = []

    def service(x):
        seen.append(time.monotonic())
        return "err"

    flow = S.Flow().map(service)
    wrapped = S.RetryFlow.with_backoff(0.06, 1.0, 0.0, 2, flow,
                                       lambda i, o: i)
    out = S.seq(S.Source.single(1).via(wrapped))
    stage = S.stream.retry._RetryFlowStage(0.06, 1.0, 0.0, 2, flow,
                                           lambda i, o: i)
    delays = [stage.delay_for(k) for k in (1, 2, 3)]
    assert len(seen) == 3 and seen == sorted(seen)
    assert delays == [0.06, 0.12, 0.24]
    return out, len(seen), delays


@side_by_side
def test_retry_flow_inner_failure_fails_stage(S):
    def boom(x):
        raise RuntimeError("service down")

    wrapped = S.RetryFlow.with_backoff(0.001, 0.01, 0.0, 2,
                                       S.Flow().map(boom), lambda i, o: None)
    fut = S.Source.single(1).via(wrapped).run_with(S.Sink.seq(), S.system)
    with pytest.raises(RuntimeError, match="service down"):
        fut.result(WAIT)
    return err(fut), str(fut.exception())


@side_by_side
def test_retry_flow_inner_early_completion_is_contract_violation(S):
    wrapped = S.RetryFlow.with_backoff(0.001, 0.01, 0.0, 2,
                                       S.Flow().take(1), lambda i, o: None)
    fut = S.Source.from_iterable([1, 2, 3]).via(wrapped) \
        .run_with(S.Sink.seq(), S.system)
    with pytest.raises(RuntimeError, match="contract"):
        fut.result(WAIT)
    return err(fut), str(fut.exception())


@side_by_side
def test_retry_flow_none_is_a_legal_element(S):
    """None flows through without wedging the send stash (its sentinel is
    a private object, not None)."""
    wrapped = S.RetryFlow.with_backoff(
        0.001, 0.01, 0.0, 3, S.Flow().map(lambda x: x), lambda i, o: None)
    out = S.seq(S.Source.from_iterable([None, None, "x"]).via(wrapped))
    assert out == [None, None, "x"]
    return out


@side_by_side
def test_retry_flow_with_backoff_and_context(S):
    attempts = {}

    def service(pair):
        x, ctx = pair
        attempts[x] = attempts.get(x, 0) + 1
        return (("ok", x) if attempts[x] >= 2 else ("err", x)), ctx

    wrapped = S.RetryFlow.with_backoff_and_context(
        0.001, 0.01, 0.0, 3, S.Flow().map(service),
        lambda i, o: i if o[0][0] == "err" else None)
    out = S.SourceWithContext.from_tuples(
        S.Source.from_iterable([(5, "c5")])).via(wrapped) \
        .run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out == [(("ok", 5), "c5")]
    return out, attempts


def test_retry_flow_jitter_is_seeded():
    """The port's stage draws its jitter from its own `random.Random`:
    two stages of one seed give one schedule, `random.Random(seed)`'s,
    and the module-level generator is left alone."""
    from akka_tpu_torch.stream import Flow
    from akka_tpu_torch.stream.retry import _RetryFlowStage

    def schedule(seed):
        st = _RetryFlowStage(0.01, 1.0, 0.5, 4, Flow(), lambda i, o: None,
                             seed=seed)
        return [st.delay_for(k) for k in (1, 2, 3, 4)]

    random.seed(123)
    want_module = random.random()
    random.seed(123)
    a, b = schedule(7), schedule(7)
    assert random.random() == want_module
    rng = random.Random(7)
    want = [min(1.0, 0.01 * 2.0 ** (k - 1)) * (1.0 + rng.random() * 0.5)
            for k in (1, 2, 3, 4)]
    assert a == b == want
    assert schedule(8) != a


# =============================== PartitionHub ===============================

@side_by_side
def test_partition_hub_routes_by_index(S):
    """partitioner(size, elem) -> index; two consumers split odd/even."""
    src = S.Source.from_iterable(range(10)).run_with(
        S.PartitionHub.sink(lambda size, elem: elem % size,
                            start_after_nr_of_consumers=2), S.system)
    f0 = src.run_with(S.Sink.seq(), S.system)
    f1 = src.run_with(S.Sink.seq(), S.system)
    a, b = f0.result(WAIT), f1.result(WAIT)
    # attach order decides which consumer is index 0
    halves = sorted([sorted(a), sorted(b)])
    assert halves == [[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]
    return halves


@side_by_side
def test_partition_hub_waits_for_start_after(S):
    """No element is consumed (or dropped) before start_after consumers
    attach: the first consumer alone sees nothing."""
    got = []
    src = S.Source.from_iterable(range(6)).run_with(
        S.PartitionHub.sink(lambda size, elem: elem % size,
                            start_after_nr_of_consumers=2), S.system)
    src.to(S.Sink.foreach(got.append)).run(S.system)
    time.sleep(0.3)
    gated = list(got)
    assert gated == []  # gated until the second consumer arrives
    rest = src.run_with(S.Sink.seq(), S.system).result(WAIT)
    _wait_until(lambda: len(got) + len(rest) == 6, "elements lost")
    assert sorted(got + rest) == list(range(6))
    return gated, sorted(got + rest)


@side_by_side
def test_partition_hub_stateful_round_robin(S):
    """stateful_sink: a fresh partitioner per materialization, round-robin
    over whoever is attached."""
    def factory():
        counter = {"n": 0}

        def route(info, elem):
            cid = info.consumer_id_by_idx(counter["n"] % info.size)
            counter["n"] += 1
            return cid
        return route

    src = S.Source.from_iterable(range(8)).run_with(
        S.PartitionHub.stateful_sink(factory, start_after_nr_of_consumers=2),
        S.system)
    f0 = src.run_with(S.Sink.seq(), S.system)
    f1 = src.run_with(S.Sink.seq(), S.system)
    a, b = f0.result(WAIT), f1.result(WAIT)
    assert sorted(a + b) == list(range(8)) and len(a) == len(b) == 4
    return sorted(a + b), len(a)


@side_by_side
def test_partition_hub_consumer_leaves_rebalances_to_survivor(S):
    """`sink`'s partitioner indexes into the current consumers: when one
    cancels mid-stream, later elements go to the survivor, and nothing
    routed to a live consumer is lost."""
    sq, src = S.Source.queue(64).to_mat(
        S.PartitionHub.sink(lambda size, elem: elem % size,
                            start_after_nr_of_consumers=1, buffer_size=4),
        S.Keep.both).run(S.system)
    survivor = src.run_with(S.Sink.seq(), S.system)
    time.sleep(0.5)                                  # attaches as index 0
    leaver = src.via(S.Flow().take(1)).run_with(S.Sink.seq(), S.system)
    time.sleep(0.5)                                  # attaches as index 1
    for i in range(3):
        sq.offer(i)
    left = leaver.result(WAIT)
    assert left == [1]
    time.sleep(0.5)                                  # the leaver detaches
    for i in range(4, 8):
        sq.offer(i)                                  # size is 1 again
    sq.complete()
    out = survivor.result(WAIT)
    assert out == [0, 2, 4, 5, 6, 7]
    return left, out


@side_by_side
def test_partition_hub_stateful_unknown_id_drops(S):
    """An id with no live consumer drops the element without stalling the
    stream."""
    def factory():
        return lambda info, elem: \
            info.consumer_id_by_idx(0) if elem >= 0 else 99

    sq, src = S.Source.queue(16).to_mat(
        S.PartitionHub.stateful_sink(factory, start_after_nr_of_consumers=1,
                                     buffer_size=4),
        S.Keep.both).run(S.system)
    consumer = src.run_with(S.Sink.seq(), S.system)
    for x in (-1, 1, -2, 2, -3, 3):
        sq.offer(x)
    sq.complete()
    out = consumer.result(WAIT)
    assert out == [1, 2, 3]
    return out


@side_by_side
def test_partition_hub_backpressures_on_full_consumer(S):
    """A full targeted consumer stalls upstream, and draining it resumes
    the flow without loss."""
    produced = []
    sq, src = S.Source.queue(64) \
        .map(lambda x: produced.append(x) or x) \
        .to_mat(S.PartitionHub.sink(lambda size, elem: 0,
                                    start_after_nr_of_consumers=1,
                                    buffer_size=4),
                S.Keep.both).run(S.system)
    consumer = src.run_with(S.Sink.queue(1), S.system)  # prefetch of 1
    for i in range(20):
        sq.offer(i)
    sq.complete()
    time.sleep(0.5)
    # hub buffer (4) + stash (1) + a couple in flight pass the map
    held = len(produced) <= 8
    assert held, produced
    got = [consumer.pull().result(WAIT) for _ in range(20)]
    assert got == list(range(20))
    return held, got


@side_by_side
def test_partition_hub_out_of_range_index_fails_stream(S):
    """A partitioner index outside [0, size) fails the stream instead of
    misrouting through Python's negative indexing."""
    sq, src = S.Source.queue(8).to_mat(
        S.PartitionHub.sink(lambda size, elem: -1,
                            start_after_nr_of_consumers=1),
        S.Keep.both).run(S.system)
    consumer = src.run_with(S.Sink.seq(), S.system)
    sq.offer(1)
    with pytest.raises(IndexError, match="outside"):
        consumer.result(WAIT)
    return err(consumer), str(consumer.exception())


@side_by_side
def test_partition_hub_partitioner_failure_reaches_consumers(S):
    """A throwing partitioner fails the hub, and attached consumers see
    the failure instead of hanging."""
    def factory():
        def route(info, elem):
            if elem == 2:
                raise ValueError("bad route")
            return info.consumer_id_by_idx(0)
        return route

    sq, src = S.Source.queue(16).to_mat(
        S.PartitionHub.stateful_sink(factory, start_after_nr_of_consumers=1),
        S.Keep.both).run(S.system)
    consumer = src.run_with(S.Sink.seq(), S.system)
    for x in (1, 2, 3):
        sq.offer(x)
    with pytest.raises(ValueError, match="bad route"):
        consumer.result(WAIT)
    return err(consumer)


@side_by_side
def test_partition_hub_gate_does_not_reengage(S):
    """start_after is an initial gate: consumers dropping back below it
    mid-stream do not stall the hub, even when the leaver holds a stashed
    element as it cancels (buffer_size 1, everything routed to it)."""
    sq, src = S.Source.queue(16).to_mat(
        S.PartitionHub.stateful_sink(
            lambda: (lambda info, elem:
                     info.consumer_ids[-1] if info.size else -1),
            start_after_nr_of_consumers=2, buffer_size=1),
        S.Keep.both).run(S.system)
    stayer = src.run_with(S.Sink.seq(), S.system)
    time.sleep(0.4)
    leaver = src.via(S.Flow().take(1)).run_with(S.Sink.seq(), S.system)
    time.sleep(0.4)
    for i in range(5):
        sq.offer(i)
    left = leaver.result(WAIT)
    assert left == [0]
    sq.complete()
    got = stayer.result(WAIT)
    assert got and got == sorted(got)  # progressed past the departure
    return left, bool(got), got == sorted(got)


@side_by_side
def test_partition_hub_sink_waits_for_first_consumer_by_default(S):
    """The stateless sink defaults start_after to 1, so an index
    partitioner never runs against zero consumers."""
    src = S.Source.from_iterable([1, 2, 3]).run_with(
        S.PartitionHub.sink(lambda size, elem: elem % size), S.system)
    time.sleep(0.3)  # elements wait for the gate rather than exploding
    out = src.run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out == [1, 2, 3]
    return out


# =========================== sinks of the same tail ==========================

@side_by_side
def test_sink_actor_ref_with_backpressure(S):
    """init -> ack -> element -> ack -> ... -> on_complete: the consumer
    actor paces the stream."""
    got = []

    class Consumer(S.Actor):
        def receive(self, message):
            got.append(message)
            if message != "done":
                self.sender.tell("ack", self.self_ref)

    ref = S.system.actor_of(S.Props.create(Consumer), "bp-consumer")
    S.Source.from_iterable([1, 2, 3]).run_with(
        S.Sink.actor_ref_with_backpressure(ref, "init", "ack", "done"),
        S.system)
    _wait_until(lambda: got == ["init", 1, 2, 3, "done"], got)
    return got


@side_by_side
def test_sink_combine_broadcasts_to_all(S):
    fut_seq, fut_sum = S.Source.from_iterable([1, 2, 3, 4]).run_with(
        S.Sink.combine(S.Sink.seq(), S.Sink.fold(0, lambda a, x: a + x)),
        S.system)
    t = [fut_seq.result(WAIT), fut_sum.result(WAIT)]
    assert t == [[1, 2, 3, 4], 10]
    return t


# =============================== JsonFraming ================================

def _frames(S, chunks, max_len=1 << 20):
    return S.seq(S.Source.from_iterable(chunks)
                 .via(S.JsonFraming.object_scanner(max_len)))


def _framing_failure(S, chunks, max_len=1 << 20, match=""):
    fut = S.Source.from_iterable(chunks) \
        .via(S.JsonFraming.object_scanner(max_len)) \
        .run_with(S.Sink.seq(), S.system)
    with pytest.raises(S.FramingException, match=match):
        fut.result(WAIT)
    return err(fut), str(fut.exception())


@side_by_side
def test_json_framing_single_chunk_multiple_objects(S):
    out = _frames(S, [b'{"a":1}{"b":2}\n{"c":3}'])
    assert out == [b'{"a":1}', b'{"b":2}', b'{"c":3}']
    return out


@side_by_side
def test_json_framing_object_split_across_chunks(S):
    out = _frames(S, [b'{"a":', b'{"nested"', b':[1,2,{"x":3}]}}'])
    assert out == [b'{"a":{"nested":[1,2,{"x":3}]}}']
    return out


@side_by_side
def test_json_framing_outer_array_and_commas(S):
    out = _frames(S, [b'[{"a":1},', b'{"b":2},{"c":3}]'])
    assert out == [b'{"a":1}', b'{"b":2}', b'{"c":3}']
    return out


@side_by_side
def test_json_framing_braces_in_strings_ignored(S):
    out = _frames(S, [br'{"s":"}{\"}","t":"{{"}'])
    assert out == [br'{"s":"}{\"}","t":"{{"}']
    return out


@side_by_side
def test_json_framing_truncated_object_fails(S):
    return _framing_failure(S, [b'{"a":1}{"b":'], match="truncated")


@side_by_side
def test_json_framing_oversize_object_fails(S):
    return _framing_failure(S, [b'{"a":"' + b"x" * 64 + b'"}'], 16,
                            match="exceeds")


@side_by_side
def test_json_framing_separator_flood_stays_bounded(S):
    """Separator floods between objects are trimmed as they are scanned:
    a tiny max_len with huge separator runs still frames."""
    out = _frames(S, [b" " * 4096, b'{"a":1},', b"\n" * 4096, b'{"b":2}'],
                  max_len=16)
    assert out == [b'{"a":1}', b'{"b":2}']
    return out


@side_by_side
def test_json_framing_exact_max_length_boundary(S):
    """An object of exactly max_len bytes passes; max_len + 1 fails."""
    obj = b'{"a":"xx"}'  # 10 bytes
    out = _frames(S, [obj], max_len=10)
    assert out == [obj]
    return out, _framing_failure(S, [obj], 9, match="exceeds")


@side_by_side
def test_json_framing_garbage_between_objects_fails(S):
    return _framing_failure(S, [b'{"a":1} nope {"b":2}'],
                            match="invalid JSON")


# ============================ context flows ==================================

def _offsets(S, records):
    """A Kafka-like feed: (value, offset) with the offset as context."""
    return S.Source.from_iterable(list(enumerate(records))) \
        .as_source_with_context(lambda p: p[0]).map(lambda p: p[1])


def _pairs(S, swc):
    return swc.run_with(S.Sink.seq(), S.system).result(WAIT)


@side_by_side
def test_context_follows_map_and_filter(S):
    out = _pairs(S, _offsets(S, ["a", "b", "skip", "d"])
                 .map(str.upper).filter(lambda v: v != "SKIP"))
    assert out == [("A", 0), ("B", 1), ("D", 3)]  # offset 2 dropped
    return out


@side_by_side
def test_map_concat_duplicates_context(S):
    out = _pairs(S, _offsets(S, ["xy", "z"]).map_concat(list))
    assert out == [("x", 0), ("y", 0), ("z", 1)]
    return out


@side_by_side
def test_grouped_collects_contexts(S):
    out = _pairs(S, _offsets(S, ["a", "b", "c"]).grouped(2))
    assert out == [(["a", "b"], [0, 1]), (["c"], [2])]
    return out


@side_by_side
def test_map_async_preserves_context_order(S):
    def slow_upper(v):
        return S.later(v.upper(), 0.01 if v == "a" else 0.001)

    out = _pairs(S, _offsets(S, ["a", "b", "c"]).map_async(3, slow_upper))
    assert out == [("A", 0), ("B", 1), ("C", 2)]
    return out


@side_by_side
def test_map_context_and_collect(S):
    out = _pairs(S, _offsets(S, ["a", "b"])
                 .map_context(lambda off: ("part0", off))
                 .collect(lambda v: v * 2 if v == "b" else None))
    assert out == [("bb", ("part0", 1))]
    return out


@side_by_side
def test_via_flow_with_context_and_as_flow(S):
    fwc = S.FlowWithContext.create().map(lambda x: x + 1) \
        .filter(lambda x: x % 2 == 0)
    out = _pairs(S, S.SourceWithContext.from_tuples(
        S.Source.from_iterable([(1, "c1"), (2, "c2"), (3, "c3")])).via(fwc))
    assert out == [(2, "c1"), (4, "c3")]
    # as_flow unwraps to a plain Flow of pairs
    plain = S.seq(S.Source.from_iterable([(5, "k")]).via(fwc.as_flow()))
    assert plain == [(6, "k")]
    return out, plain


@side_by_side
def test_flow_as_flow_with_context(S):
    # adapt a plain Flow: collapse (data, ctx) -> input, re-extract ctx
    fwc = S.Flow().map(lambda s: s + "!").as_flow_with_context(
        lambda data, ctx: f"{ctx}:{data}",
        lambda out: out.split(":", 1)[0])
    out = _pairs(S, S.SourceWithContext.from_tuples(
        S.Source.from_iterable([("hi", "k1"), ("yo", "k2")])).via(fwc))
    assert out == [("k1:hi!", "k1"), ("k2:yo!", "k2")]
    return out
