"""The port's stream DSL (akka_tpu_torch.stream) on the CPU, side by side
with the JAX package's: the 38 cases of tests/test_stream.py (operators,
fan-in and fan-out, buffering and rate, queues, actor sources and sinks,
kill switches, device pipelines, the stream probes). Each scenario is
written once over a package's names, runs on both packages, and the
port's trace must equal the reference's (tests/torch_stream_fixture.py).

Where the reference holds a duration against a budget (throttle, delay),
both packages are held to the order of events and the elements instead.
The three hub cases run through each package's `MergeHub` and
`BroadcastHub` (stream/hub.py). `DevicePipeline.as_flow` runs the
reference's jnp pipeline and the port's torch pipeline on the CPU:
integers bit-equal, float32 within rtol 1e-6.
"""

import time
from concurrent.futures import Future

import numpy as np
import pytest

from torch_stream_fixture import WAIT, both, err, side_by_side


# -- basics -------------------------------------------------------------------

@side_by_side
def test_source_map_filter_to_seq(S):
    out = S.seq(
        S.Source.from_iterable(range(10)).via(
            S.Flow().map(lambda x: x * 2).filter(lambda x: x % 4 == 0)))
    assert out == [0, 4, 8, 12, 16]
    return out


@side_by_side
def test_source_single_empty_failed(S):
    t = [S.seq(S.Source.single(42)), S.seq(S.Source.empty())]
    assert t == [[42], []]
    fut = S.Source.failed(ValueError("boom")).run_with(S.Sink.seq(),
                                                       S.system)
    with pytest.raises(ValueError):
        fut.result(WAIT)
    return t + [err(fut)]


@side_by_side
def test_blueprint_reusable(S):
    src = S.Source.from_iterable([1, 2, 3]).via(S.Flow().map(lambda x: x + 1))
    t = [S.seq(src), S.seq(src)]  # the second is a second materialization
    assert t == [[2, 3, 4]] * 2
    return t


@side_by_side
def test_take_drop_takewhile_dropwhile(S):
    f = S.Flow()
    t = [S.seq(S.Source.from_iterable(range(100)).via(f.take(3))),
         S.seq(S.Source.from_iterable(range(5)).via(f.drop(3))),
         S.seq(S.Source.from_iterable([1, 2, 9, 1]).via(
             f.take_while(lambda x: x < 5))),
         S.seq(S.Source.from_iterable([1, 2, 9, 1]).via(
             f.drop_while(lambda x: x < 5)))]
    assert t == [[0, 1, 2], [3, 4], [1, 2], [9, 1]]
    return t


@side_by_side
def test_take_from_infinite_source(S):
    t = [S.seq(S.Source.repeat(7).via(S.Flow().take(4))),
         S.seq(S.Source.unfold(0, lambda s: (s + 1, s)).via(
             S.Flow().take(5)))]
    assert t == [[7] * 4, [0, 1, 2, 3, 4]]
    return t


@side_by_side
def test_scan_fold_reduce(S):
    src = S.Source.from_iterable([1, 2, 3, 4])
    t = [S.seq(src.via(S.Flow().scan(0, lambda a, b: a + b))),
         src.run_fold(0, lambda a, b: a + b, S.system).result(WAIT),
         src.run_reduce(lambda a, b: a * b, S.system).result(WAIT)]
    assert t == [[0, 1, 3, 6, 10], 10, 24]
    fut = S.Source.empty().run_reduce(lambda a, b: a, S.system)
    with pytest.raises(S.NoSuchElementException):
        fut.result(WAIT)
    return t + [err(fut)]


@side_by_side
def test_grouped_sliding_mapconcat_intersperse(S):
    t = [S.seq(S.Source.from_iterable(range(7)).via(S.Flow().grouped(3))),
         S.seq(S.Source.from_iterable(range(4)).via(S.Flow().sliding(2))),
         S.seq(S.Source.from_iterable([1, 2]).via(
             S.Flow().map_concat(lambda x: [x] * x))),
         S.seq(S.Source.from_iterable("abc").via(
             S.Flow().intersperse(",", start="[", end="]")))]
    assert t == [[[0, 1, 2], [3, 4, 5], [6]], [[0, 1], [1, 2], [2, 3]],
                 [1, 2, 2], ["[", "a", ",", "b", ",", "c", "]"]]
    return t


@side_by_side
def test_zip_with_index_and_statefulmapconcat(S):
    out = S.seq(S.Source.from_iterable("xyz").via(S.Flow().zip_with_index()))
    assert out == [("x", 0), ("y", 1), ("z", 2)]
    return out


@side_by_side
def test_sink_head_last_foreach(S):
    src = S.Source.from_iterable([5, 6, 7])
    t = [src.run_with(S.Sink.head(), S.system).result(WAIT),
         src.run_with(S.Sink.last(), S.system).result(WAIT),
         S.Source.empty().run_with(S.Sink.head_option(), S.system)
         .result(WAIT)]
    assert t == [5, 7, None]
    fut = S.Source.empty().run_with(S.Sink.head(), S.system)
    with pytest.raises(S.NoSuchElementException):
        fut.result(WAIT)
    seen = []
    S.Source.from_iterable([1, 2]).run_foreach(seen.append, S.system) \
        .result(WAIT)
    assert seen == [1, 2]
    return t + [err(fut), seen]


@side_by_side
def test_recover(S):
    def gen():
        yield 1
        yield 2
        raise ValueError("bang")
    out = S.seq(S.Source.from_iterable(gen()).via(
        S.Flow().recover(lambda ex: -1)))
    assert out == [1, 2, -1]
    return out


@side_by_side
def test_mat_value_combination(S):
    # Keep.both across to_mat
    queue, seq_fut = S.Source.queue(8).to_mat(S.Sink.seq(), S.Keep.both) \
        .run(S.system)
    t = [queue.offer(1).result(WAIT), queue.offer(2).result(WAIT)]
    queue.complete()
    t.append(seq_fut.result(WAIT))
    assert t == [True, True, [1, 2]]
    return t


# -- fan-in / fan-out ---------------------------------------------------------

@side_by_side
def test_merge_and_concat(S):
    merged = S.seq(S.Source.from_iterable([1, 2]).merge(
        S.Source.from_iterable([10, 20])))
    assert sorted(merged) == [1, 2, 10, 20]
    t = [sorted(merged),
         S.seq(S.Source.from_iterable([1, 2]).concat(
             S.Source.from_iterable([10, 20]))),
         S.seq(S.Source.from_iterable([5]).prepend(
             S.Source.from_iterable([1, 2])))]
    assert t[1:] == [[1, 2, 10, 20], [1, 2, 5]]
    return t


@side_by_side
def test_zip_and_zipwith(S):
    t = [S.seq(S.Source.from_iterable([1, 2, 3]).zip(
             S.Source.from_iterable("ab"))),
         S.seq(S.Source.from_iterable([1, 2]).zip_with(
             S.Source.from_iterable([10, 20]), lambda a, b: a + b))]
    assert t == [[(1, "a"), (2, "b")], [11, 22]]
    return t


@side_by_side
def test_or_else(S):
    t = [S.seq(S.Source.empty().or_else(S.Source.from_iterable([9]))),
         S.seq(S.Source.from_iterable([1]).or_else(
             S.Source.from_iterable([9])))]
    assert t == [[9], [1]]
    return t


@side_by_side
def test_interleave(S):
    out = S.seq(S.Source.from_iterable([1, 2, 3, 4]).interleave(
        S.Source.from_iterable([10, 20]), 2))
    assert out == [1, 2, 10, 20, 3, 4]
    return out


@side_by_side
def test_also_to_and_wiretap(S):
    side = []
    out = S.seq(S.Source.from_iterable([1, 2, 3]).also_to(
        S.Sink.foreach(side.append)))
    assert out == [1, 2, 3]
    assert side == [1, 2, 3]
    tapped = []
    out2 = S.seq(S.Source.from_iterable([4, 5]).via(
        S.Flow().wire_tap(tapped.append)))
    assert out2 == [4, 5] and tapped == [4, 5]
    return [out, side, out2, tapped]


@side_by_side
def test_flat_map_concat(S):
    out = S.seq(S.Source.from_iterable([1, 3]).via(
        S.Flow().flat_map_concat(
            lambda n: S.Source.from_iterable(range(n)))))
    assert out == [0, 0, 1, 2]
    return out


# -- buffering / rate ops -----------------------------------------------------

@side_by_side
def test_buffer_backpressure_and_drop(S):
    out = S.seq(S.Source.from_iterable(range(100)).via(
        S.Flow().buffer(4, "backpressure")))
    assert out == list(range(100))
    return out


@side_by_side
def test_conflate_and_batch_pass_all_when_slow_enough(S):
    out = S.seq(S.Source.from_iterable(range(5)).via(
        S.Flow().conflate(lambda a, b: a + b)))
    assert sum(out) == sum(range(5))  # conflation preserves the sum
    batches = S.seq(S.Source.from_iterable(range(5)).via(
        S.Flow().batch(10, lambda x: [x], lambda acc, x: acc + [x])))
    flat = [x for grp in batches for x in grp]
    assert flat == list(range(5))
    return [sum(out), flat]


@side_by_side
def test_map_async_preserves_order(S):
    def slow_double(x):
        return S.later(x * 2, 0.01 * (5 - x))
    out = S.seq(S.Source.from_iterable(range(5)).via(
        S.Flow().map_async(4, slow_double)))
    assert out == [0, 2, 4, 6, 8]
    return out


@side_by_side
def test_map_async_unordered_delivers_all(S):
    def slow(x):
        return S.later(x, 0.005 * (x % 3))
    out = S.seq(S.Source.from_iterable(range(10)).via(
        S.Flow().map_async_unordered(4, slow)))
    assert sorted(out) == list(range(10))
    return sorted(out)


@side_by_side
def test_map_async_failure_fails_stream(S):
    def boom(x):
        f = Future()
        f.set_exception(ValueError("async boom"))
        return f
    fut = S.Source.from_iterable([1]).via(S.Flow().map_async(2, boom)) \
        .run_with(S.Sink.seq(), S.system)
    with pytest.raises(ValueError):
        fut.result(WAIT)
    return err(fut)


@side_by_side
def test_throttle_rate(S):
    """The elements in order, each past the throttle after it entered
    (no wall-clock budget)."""
    events = []
    out = S.seq(S.Source.from_iterable(range(6))
                .wire_tap(lambda x: events.append(("in", x)))
                .via(S.Flow().throttle(elements=100, per=0.1,
                                       maximum_burst=1))
                .wire_tap(lambda x: events.append(("out", x))))
    assert out == list(range(6))
    assert all(events.index(("in", x)) < events.index(("out", x))
               for x in out)
    return [out, [e for e in events if e[0] == "out"]]


@side_by_side
def test_delay(S):
    """The elements in order, each leaving the delay after it entered
    (no wall-clock budget)."""
    events = []
    out = S.seq(S.Source.from_iterable([1, 2])
                .wire_tap(lambda x: events.append(("in", x)))
                .via(S.Flow().delay(0.1))
                .wire_tap(lambda x: events.append(("out", x))))
    assert out == [1, 2]
    assert events.index(("in", 1)) < events.index(("out", 1))
    assert events.index(("in", 2)) < events.index(("out", 2))
    return [out, [e for e in events if e[0] == "out"]]


@side_by_side
def test_tick_source(S):
    mat = S.Materializer(S.system)
    cancellable, fut = S.Source.tick(0.01, 0.02, "tick") \
        .via(S.Flow().take(3)).to_mat(S.Sink.seq(), S.Keep.both).run(mat)
    out = fut.result(WAIT)
    assert out == ["tick"] * 3
    return [out, type(cancellable).__name__]


# -- queues -------------------------------------------------------------------

@side_by_side
def test_source_queue_and_sink_queue(S):
    src_q, sink_q = S.Source.queue(16).to_mat(S.Sink.queue(16),
                                              S.Keep.both).run(S.system)
    t = [src_q.offer("a").result(WAIT), sink_q.pull().result(WAIT),
         src_q.offer("b").result(WAIT)]
    src_q.complete()
    t.append(sink_q.pull().result(WAIT))
    assert t == [True, "a", True, "b"]
    assert sink_q.pull().result(WAIT) is S.QUEUE_END
    return t + ["end"]


@side_by_side
def test_actor_ref_source_and_sink(S):
    ref, fut = S.Source.actor_ref(64).to_mat(S.Sink.seq(), S.Keep.both) \
        .run(S.system)
    time.sleep(0.1)  # let materialization spawn the ref
    ref.tell("x")
    ref.tell("y")
    ref.tell(S.Status.Success())
    t = [fut.result(WAIT)]
    assert t == [["x", "y"]]

    probe = S.TestProbe(S.system)
    S.Source.from_iterable([1, 2]).run_with(
        S.Sink.actor_ref(probe.ref, on_complete_message="done"), S.system)
    t += [probe.receive_one(WAIT) for _ in range(3)]
    assert t[1:] == [1, 2, "done"]
    return t


# -- kill switches ------------------------------------------------------------

@side_by_side
def test_unique_kill_switch(S):
    switch, fut = S.Source.repeat(1) \
        .via_mat(S.KillSwitches.single(), S.Keep.right) \
        .to_mat(S.Sink.fold(0, lambda a, b: a + b), S.Keep.both) \
        .run(S.system)
    time.sleep(0.05)
    switch.shutdown()
    total = fut.result(WAIT)
    assert total > 0  # completed (not hung), partial sum
    return type(switch).__name__


@side_by_side
def test_shared_kill_switch_abort(S):
    shared = S.KillSwitches.shared("grp")
    fut1 = S.Source.repeat(1).via(shared.flow).run_with(S.Sink.ignore(),
                                                        S.system)
    fut2 = S.Source.repeat(2).via(shared.flow).run_with(S.Sink.ignore(),
                                                        S.system)
    time.sleep(0.05)
    shared.abort(RuntimeError("stop all"))
    with pytest.raises(RuntimeError):
        fut1.result(WAIT)
    with pytest.raises(RuntimeError):
        fut2.result(WAIT)
    return [err(fut1), str(fut1.exception()), err(fut2)]


# -- hubs ---------------------------------------------------------------------

@side_by_side
def test_merge_hub_many_producers(S):
    """Two producer streams attach to one MergeHub's sink: every element
    arrives, each producer's in its order."""
    attach_sink, fut = S.MergeHub.source(16).via(S.Flow().take(6)) \
        .to_mat(S.Sink.seq(), S.Keep.both).run(S.system)
    S.Source.from_iterable([1, 2, 3]).to(attach_sink, S.Keep.right) \
        .run(S.system)
    S.Source.from_iterable([10, 20, 30]).to(attach_sink, S.Keep.right) \
        .run(S.system)
    out = fut.result(WAIT)
    assert sorted(out) == [1, 2, 3, 10, 20, 30]
    assert [x for x in out if x < 10] == [1, 2, 3]
    assert [x for x in out if x >= 10] == [10, 20, 30]
    return sorted(out)


@side_by_side
def test_broadcast_hub_many_consumers(S):
    """A finished source's elements wait in the BroadcastHub's buffer for
    the first consumer."""
    attach_source = S.Source.from_iterable(range(5)) \
        .to_mat(S.BroadcastHub.sink(64), S.Keep.right).run(S.system)
    time.sleep(0.05)  # the hub sink runs; elements buffered pre-consumer
    out1 = attach_source.run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out1 == list(range(5))
    return out1


@side_by_side
def test_broadcast_hub_live_fanout(S):
    """A queue's elements through a BroadcastHub to two consumers, each
    seeing all of them in order."""
    src_q, attach_source = S.Source.queue(64) \
        .to_mat(S.BroadcastHub.sink(64), S.Keep.both).run(S.system)
    f1 = attach_source.run_with(S.Sink.seq(), S.system)
    f2 = attach_source.run_with(S.Sink.seq(), S.system)
    time.sleep(0.5)  # both consumers registered
    for i in range(4):
        assert src_q.offer(i).result(WAIT)
    src_q.complete()
    t = [f1.result(WAIT), f2.result(WAIT)]
    assert t == [[0, 1, 2, 3]] * 2
    return t


# -- device pipelines ---------------------------------------------------------

def _pipeline(S, **kw):
    """The package's DevicePipeline; the port's on the CPU."""
    if S.name == "akka_tpu_torch":
        kw.setdefault("device", "cpu")
    return S.DevicePipeline(**kw)


@side_by_side
def test_device_pipeline_fused_ops(S):
    pipe = (_pipeline(S).map(lambda x: x * 2)
            .filter(lambda x: x % 3 == 0)
            .map(lambda x: x + 1))
    outs, masks, _ = pipe.run(np.arange(32).reshape(4, 8))  # 4 chunks of 8
    got = S.DevicePipeline.compact(outs, masks)
    expect = np.array([x * 2 + 1 for x in range(32) if (x * 2) % 3 == 0])
    assert (got == expect).all()
    return got.tolist()


@side_by_side
def test_device_pipeline_scan_carry(S):
    # running sum across chunks: carry = total so far
    def add_chunk(carry, chunk):
        return carry + chunk.sum(), chunk + carry
    pipe = _pipeline(S).scan(add_chunk, np.int32(0))
    outs, masks, carry = pipe.run(np.ones((3, 4), np.int32))
    outs = np.asarray(outs)
    assert int(carry) == 12
    assert (outs[0] == 1).all() and (outs[1] == 5).all() \
        and (outs[2] == 9).all()
    return [int(carry), outs.tolist(), np.asarray(masks).tolist()]


def _as_flow(S, dtype):
    """The reference case (x * x over two chunks of `dtype`) and a float32
    chain with a filter and a scan, each through `as_flow` into Sink.seq,
    beside the scanned chain's own `run` on the same chunks."""
    pipe = _pipeline(S).map(lambda x: x * x)
    chunks = [np.arange(4, dtype=dtype), np.arange(4, 8, dtype=dtype)]
    out = S.seq(S.Source.from_iterable(chunks).via(pipe.as_flow()))
    got = np.concatenate([np.asarray(o) for o, m in out])
    assert (got == np.arange(8) ** 2).all()

    scan = (_pipeline(S).map(lambda x: x * 1.5 + 0.25)
            .filter(lambda x: x > 1.0)
            .scan(lambda c, x: (c + x.sum(), x * 0.5 + c),
                  np.asarray(0, np.float32)))
    xs = list(np.random.default_rng(23).standard_normal((5, 16))
              .astype(np.float32))
    pairs = S.seq(S.Source.from_iterable(xs).via(scan.as_flow()))
    ran, run_masks, _ = scan.run(xs)
    return {"got": got, "masks": [np.asarray(m) for _, m in out],
            "outs": np.stack([np.asarray(o) for o, _ in pairs]),
            "scan_masks": np.stack([np.asarray(m) for _, m in pairs]),
            "run": np.asarray(ran), "run_masks": np.asarray(run_masks)}


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
def test_device_pipeline_as_flow(dtype):
    """`as_flow` on both packages (the reference's jnp pipeline, the
    port's on the CPU), and each against its own `run`: the masks and
    the int32 chunks bit-equal, float32 within rtol 1e-6."""
    traces = both(_as_flow, dtype)
    ref, port = traces["akka_tpu"], traces["akka_tpu_torch"]
    if dtype is np.int32:
        np.testing.assert_array_equal(port["got"], ref["got"])
    else:
        np.testing.assert_allclose(port["got"], ref["got"], rtol=1e-6)
    for p, r in zip(port["masks"], ref["masks"]):
        np.testing.assert_array_equal(p, r)
    for t in (ref, port):
        np.testing.assert_array_equal(t["scan_masks"], t["run_masks"])
        np.testing.assert_allclose(t["outs"], t["run"], rtol=1e-6)
    np.testing.assert_array_equal(port["scan_masks"], ref["scan_masks"])
    np.testing.assert_allclose(port["outs"], ref["outs"], rtol=1e-6)


# -- testkit probes -----------------------------------------------------------

@side_by_side
def test_test_source_and_sink_probes(S):
    pub, sub = S.TestSource.probe().via(S.Flow().map(lambda x: x * 10)) \
        .to_mat(S.TestSink.probe(), S.Keep.both).run(S.system)
    sub.request(2)
    pub.expect_request()
    pub.send_next(1).send_next(2)
    t = [sub.expect_next(10), sub.expect_next(20)]
    pub.send_complete()
    sub.expect_complete()
    return t


@side_by_side
def test_sink_probe_error(S):
    pub, sub = S.TestSource.probe().to_mat(S.TestSink.probe(), S.Keep.both) \
        .run(S.system)
    sub.request(1)
    pub.send_error(ValueError("probe boom"))
    ex = sub.expect_error()
    assert isinstance(ex, ValueError)
    return [type(ex).__name__, str(ex)]


@side_by_side
def test_backpressure_visible_through_probes(S):
    pub, sub = S.TestSource.probe().to_mat(S.TestSink.probe(), S.Keep.both) \
        .run(S.system)
    # no demand -> no pull reaches the source
    with pytest.raises(AssertionError):
        pub.expect_request(timeout=0.2)
    sub.request(1)
    pub.expect_request()
    pub.send_next("ok")
    return sub.expect_next("ok")
