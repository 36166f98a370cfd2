"""The port's operator tranches three and four (akka_tpu_torch.stream
ops3, ops4) on the CPU, side by side with the JAX package's: the 22
cases of tests/test_stream_ops3.py (divertTo, mergeSorted,
mergePrioritized, zipLatest/zipAll, foldAsync/scanAsync,
onErrorComplete, lazy and never sources, unfoldResource, the count and
predicate sinks, async islands, the composition batch, the exploring
resizer) and the 46 of tests/test_stream_ops4.py (statefulMap,
mapWithResource, mapAsyncPartitioned, weighted grouping, timer ops,
monitor, watch, async sources, lazy and future sinks, switchMap). Each
scenario runs on both packages; the port's trace must equal the
reference's (tests/torch_stream_fixture.py).

Where the reference holds a duration against a budget (initialDelay,
delayWith, groupedWeightedWithin's window), both packages are held to
the order of events and the elements instead.
"""

import threading
import time
from concurrent.futures import Future

from torch_stream_fixture import WAIT, err, side_by_side


def _capture(S, futs, name):
    """A Sink.seq whose materialized future lands in futs[name]."""
    inner = S.Sink.seq()

    def build(b, upstream):
        futs[name] = inner._build(b, upstream)
        return futs[name]
    return S.Sink(build)


def _wait_for(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


# ---------------------------------------- tests/test_stream_ops3.py

@side_by_side
def test_divert_to(S):
    futs = {}
    out = S.seq(S.Source.from_iterable(range(10)).divert_to(
        _capture(S, futs, "div"), lambda x: x % 2 == 0))
    t = [out, futs["div"].result(WAIT)]
    assert t == [[1, 3, 5, 7, 9], [0, 2, 4, 6, 8]]
    return t


@side_by_side
def test_merge_sorted(S):
    out = S.seq(S.Source.from_iterable([1, 4, 5, 9]).merge_sorted(
        S.Source.from_iterable([2, 3, 6, 7, 8, 10])))
    assert out == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    return out


@side_by_side
def test_merge_sorted_with_key(S):
    out = S.seq(S.Source.from_iterable([("a", 1), ("c", 4)]).merge_sorted(
        S.Source.from_iterable([("b", 2), ("d", 3)]), key=lambda t: t[1]))
    assert [t[1] for t in out] == [1, 2, 3, 4]
    return out


@side_by_side
def test_merge_prioritized_all_elements_arrive(S):
    out = S.seq(S.Source.from_iterable(range(5)).merge_prioritized(
        S.Source.from_iterable(range(100, 105)), 10, 1))
    assert sorted(out) == [0, 1, 2, 3, 4, 100, 101, 102, 103, 104]
    return sorted(out)


@side_by_side
def test_zip_all(S):
    t = [S.seq(S.Source.from_iterable([1, 2, 3]).zip_all(
             S.Source.from_iterable("ab"), this_default=0,
             that_default="?")),
         S.seq(S.Source.from_iterable([1]).zip_all(
             S.Source.from_iterable("abc"), this_default=0,
             that_default="?"))]
    assert t == [[(1, "a"), (2, "b"), (3, "?")],
                 [(1, "a"), (0, "b"), (0, "c")]]
    return t


@side_by_side
def test_zip_latest_emits_pending_pair_on_completion(S):
    """Both sides complete while downstream is slow: the pending combined
    element must still be emitted, not dropped."""
    out = S.Source.from_iterable([1]).zip_latest(
        S.Source.from_iterable(["a"])).delay(0.1) \
        .run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out == [(1, "a")]
    return out


@side_by_side
def test_zip_latest(S):
    out = S.seq(S.Source.from_iterable([1]).zip_latest(
        S.Source.from_iterable("a")))
    assert out == [(1, "a")]
    return out


@side_by_side
def test_fold_async(S):
    def add(acc, x):
        return S.pool.submit(lambda: acc + x)
    total = S.Source.from_iterable(range(10)).fold_async(0, add) \
        .run_with(S.Sink.head(), S.system).result(WAIT)
    assert total == 45
    return total


@side_by_side
def test_fold_async_plain_values(S):
    total = S.Source.from_iterable(range(5)) \
        .fold_async(0, lambda a, x: a + x) \
        .run_with(S.Sink.head(), S.system).result(WAIT)
    assert total == 10
    return total


@side_by_side
def test_scan_async(S):
    out = S.seq(S.Source.from_iterable([1, 2, 3])
                .scan_async(0, lambda a, x: a + x))
    assert out == [0, 1, 3, 6]
    return out


@side_by_side
def test_on_error_complete(S):
    def boom(x):
        if x == 3:
            raise ValueError("x")
        return x
    out = S.seq(S.Source.from_iterable(range(10)).map(boom)
                .on_error_complete())
    assert out == [0, 1, 2]
    return out


@side_by_side
def test_on_error_complete_predicate_no_match(S):
    def boom(x):
        if x == 1:
            raise ValueError("x")
        return x
    fut = S.Source.from_iterable(range(3)).map(boom) \
        .on_error_complete(lambda e: isinstance(e, KeyError)) \
        .run_with(S.Sink.seq(), S.system)
    assert err(fut) == "ValueError"
    return err(fut)


@side_by_side
def test_lazy_sources(S):
    calls = []

    def factory():
        calls.append(1)
        return S.Source.from_iterable([1, 2, 3])
    src = S.Source.lazy_source(factory)
    assert calls == []  # nothing built until materialized and pulled
    t = [S.seq(src), list(calls), S.seq(S.Source.lazy_single(lambda: 42))]
    f = Future()
    f.set_result("x")
    t.append(S.seq(S.Source.lazy_future(lambda: f)))
    assert t == [[1, 2, 3], [1], [42], ["x"]]
    return t


@side_by_side
def test_unfold_resource(S):
    log = []

    def create():
        log.append("open")
        return iter(range(3))

    def read(it):
        return next(it, None)

    def close(it):
        log.append("close")

    src = S.Source.unfold_resource(create, read, close)
    t = [S.seq(src), S.seq(src)]  # the blueprint is reusable
    assert t == [[0, 1, 2]] * 2
    assert log == ["open", "close", "open", "close"]
    return t + [log]


@side_by_side
def test_source_never_with_timeout(S):
    fut = S.Source.never().initial_timeout(0.2).run_with(S.Sink.seq(),
                                                         S.system)
    assert err(fut) == "TimeoutError"
    return err(fut)


@side_by_side
def test_sink_count_take_last_exists_forall(S):
    src = S.Source.from_iterable(range(10))
    t = [S.Source.from_iterable(range(7)).run_with(S.Sink.count(), S.system)
         .result(WAIT)]
    for sink in (S.Sink.take_last(3), S.Sink.exists(lambda x: x == 4),
                 S.Sink.exists(lambda x: x == 40),
                 S.Sink.forall(lambda x: x < 10),
                 S.Sink.forall(lambda x: x < 5)):
        t.append(src.run_with(sink, S.system).result(WAIT))
    assert t == [7, [7, 8, 9], True, False, True, False]
    return t


@side_by_side
def test_async_boundary_three_islands(S):
    """A 3-island graph runs on 3 interpreter actors with backpressure
    across the boundaries."""
    queue, seq_fut = S.Source.queue(256).async_().map(lambda x: x * 2) \
        .async_().filter(lambda x: x % 4 == 0) \
        .to_mat(S.Sink.seq(), S.Keep.both).run(S.system)
    time.sleep(0.2)
    names = [str(c.path) for c in S.system.provider.guardian.cell.children]
    islands = {n for n in names if "-island-" in n}
    assert len(islands) >= 3, names
    for i in range(100):
        queue.offer(i)
    queue.complete()
    out = seq_fut.result(WAIT)
    assert out == [i * 2 for i in range(100) if (i * 2) % 4 == 0]
    return [len(islands), out]


@side_by_side
def test_async_boundary_backpressure(S):
    """A slow downstream island backpressures the fast upstream island
    (bounded in-flight elements across the channel)."""
    produced = []
    out = S.Source.from_iterable(range(200)) \
        .wire_tap(produced.append).async_() \
        .throttle(50, 0.1) \
        .take(40).run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out == list(range(40))
    # upstream runs ahead by the channel batch and a stage buffer or two,
    # never the whole 200-element source
    assert len(produced) <= 40 + 3 * 16, len(produced)
    return out


@side_by_side
def test_async_boundary_error_crosses_islands(S):
    def boom(x):
        if x == 5:
            raise ValueError("boom")
        return x
    fut = S.Source.from_iterable(range(10)).map(boom).async_() \
        .map(lambda x: x).run_with(S.Sink.seq(), S.system)
    assert err(fut) == "ValueError"
    return err(fut)


@side_by_side
def test_composition_operator_batch(S):
    """alsoToAll / mergeAll / interleaveAll / concatAllLazy / collectType /
    flatMapPrefix / extrapolate."""
    futs = {}
    t = [S.Source.from_iterable(range(4))
         .also_to_all(_capture(S, futs, "a"), _capture(S, futs, "b"))
         .run_with(S.Sink.seq(), S.system).result(WAIT)]
    t += [futs["a"].result(WAIT), futs["b"].result(WAIT)]
    assert t == [[0, 1, 2, 3]] * 3
    t.append(sorted(S.seq(S.Source.from_iterable([1]).merge_all(
        [S.Source.from_iterable([2]), S.Source.from_iterable([3])]))))
    t.append(S.seq(S.Source.from_iterable([1]).concat_all_lazy(
        S.Source.from_iterable([2]), S.Source.from_iterable([3]))))
    # interleave_all: exact round-robin order across all sources
    t.append(S.seq(S.Source.from_iterable([1, 4]).interleave_all(
        [S.Source.from_iterable([2, 5]), S.Source.from_iterable([3, 6])], 1)))
    t.append(S.seq(S.Source.from_iterable([1, "a", 2.5, "b", 3])
                   .collect_type(str)))
    # flat_map_prefix: the prefix configures the rest of the stream
    t.append(S.seq(S.Source.from_iterable([10, 1, 2, 3]).flat_map_prefix(
        1, lambda prefix: S.Flow().map(lambda x: x * prefix[0]))))
    # extrapolate: an open but idle upstream and an eager downstream get
    # the element, then its extrapolations
    queue, fut = S.Source.queue(8).extrapolate(
        lambda e: iter([e + 1, e + 2])).take(3) \
        .to_mat(S.Sink.seq(), lambda l, r: (l, r)).run(S.system)
    queue.offer(5)
    t.append(fut.result(WAIT))
    queue.complete()
    assert t[3:] == [[1, 2, 3], [1, 2, 3], [1, 2, 3, 4, 5, 6], ["a", "b"],
                     [10, 20, 30], [5, 6, 7]]
    return t


@side_by_side
def test_optimal_size_exploring_resizer(S):
    """Explore/exploit pool sizing: stays within bounds, explores off the
    current size, and exploits the best recorded size."""
    class FakeRoutee:
        class ref:
            class cell:
                class mailbox:
                    number_of_messages = 0

    r = S.OptimalSizeExploringResizer(lower_bound=2, upper_bound=8,
                                      chance_of_exploration=1.0)
    routees = [FakeRoutee()] * 4
    for _ in range(50):
        delta = r.resize(routees)
        assert 2 <= 4 + delta <= 8  # always within bounds
    r2 = S.OptimalSizeExploringResizer(lower_bound=1, upper_bound=10,
                                       chance_of_exploration=0.0)
    r2._perf = {3: 10.0, 5: 50.0, 7: 20.0}
    t = [4 + r2.resize(routees), r2.is_time_for_resize(10),
         r2.is_time_for_resize(11)]
    assert t == [5, True, False]
    return t


@side_by_side
def test_flow_level_fan_ins(S):
    t = [S.seq(S.Source.from_iterable([1, 2]).via(
             S.Flow().concat(S.Source.from_iterable([3, 4])))),
         S.seq(S.Source.from_iterable([3, 4]).via(
             S.Flow().prepend(S.Source.from_iterable([1, 2])))),
         S.seq(S.Source.empty().via(
             S.Flow().or_else(S.Source.from_iterable([9])))),
         S.seq(S.Source.from_iterable([1, 3]).via(
             S.Flow().interleave(S.Source.from_iterable([2, 4]), 1))),
         S.seq(S.Source.from_iterable([1, 2]).via(
             S.Flow().zip_with(S.Source.from_iterable([10, 20]),
                               lambda a, b: a + b)))]
    assert t == [[1, 2, 3, 4], [1, 2, 3, 4], [9], [1, 2, 3, 4], [11, 22]]
    return t


# ---------------------------------------- tests/test_stream_ops4.py

@side_by_side
def test_stateful_map(S):
    out = S.seq(S.Source.from_iterable([1, 2, 3, 4]).stateful_map(
        lambda: 0, lambda s, x: (s + x, s + x),          # running sum
        on_complete=lambda s: ("total", s)))
    assert out == [1, 3, 6, 10, ("total", 10)]
    return out


@side_by_side
def test_stateful_map_fresh_state_per_materialization(S):
    src = S.Source.from_iterable([1, 1]).stateful_map(
        lambda: 0, lambda s, x: (s + x, s + x))
    t = [S.seq(src), S.seq(src)]
    assert t == [[1, 2]] * 2
    return t


@side_by_side
def test_map_with_resource(S):
    closed = []

    def close(r):
        closed.append(r["n"])
        return ("closed", r["n"])

    out = S.seq(S.Source.from_iterable([1, 2, 3]).map_with_resource(
        lambda: {"n": 0},
        lambda r, x: (r.__setitem__("n", r["n"] + 1), x * 10)[1],
        close))
    assert out == [10, 20, 30, ("closed", 3)]
    assert closed == [3]
    return [out, closed]


@side_by_side
def test_map_with_resource_closes_on_cancel(S):
    closed = []
    out = S.seq(S.Source.from_iterable(range(100)).map_with_resource(
        lambda: "res", lambda r, x: x, lambda r: closed.append(r)).take(2))
    assert out == [0, 1]
    assert closed == ["res"]
    return [out, closed]


@side_by_side
def test_map_async_partitioned_orders_and_serializes_partitions(S):
    in_flight, most = {}, {}
    lock = threading.Lock()

    def fn(elem, part):
        def work():
            with lock:
                in_flight[part] = in_flight.get(part, 0) + 1
                most[part] = max(most.get(part, 0), in_flight[part])
            time.sleep(0.01)
            with lock:
                in_flight[part] -= 1
            return elem * 10
        return S.pool.submit(work)

    out = S.seq(S.Source.from_iterable(range(12)).map_async_partitioned(
        4, lambda x: x % 3, fn))
    assert out == [x * 10 for x in range(12)]  # input order preserved
    assert all(v == 1 for v in most.values())
    return [out, sorted(most.items())]


@side_by_side
def test_grouped_weighted(S):
    out = S.seq(S.Source.from_iterable([1, 2, 3, 4, 5]).grouped_weighted(
        3, lambda x: x))
    assert out == [[1, 2], [3], [4], [5]]
    return out


@side_by_side
def test_grouped_weighted_within_flushes_on_window(S):
    """The window flushes a group while upstream is still open: the first
    element comes out as a group of its own before the second is offered
    (the weight limit, 100, is never reached). No wall-clock budget."""
    queue, pulls = S.Source.queue(8) \
        .grouped_weighted_within(100, 0.05, lambda x: 1) \
        .to_mat(S.Sink.queue(8), S.Keep.both).run(S.system)
    assert queue.offer("t1").result(WAIT)
    first = pulls.pull().result(WAIT)
    assert first == ["t1"]
    for x in ("t2", "t3"):
        assert queue.offer(x).result(WAIT)
    queue.complete()
    rest = []
    while True:
        g = pulls.pull().result(WAIT)
        if g is S.QUEUE_END:
            break
        rest.extend(g)
    assert rest == ["t2", "t3"]
    return [first, rest]


@side_by_side
def test_batch_weighted(S):
    # fast producer, slow consumer: batches aggregate by weight
    out = S.seq(S.Source.from_iterable(range(10)).batch_weighted(
        100, lambda x: 1, lambda x: [x], lambda acc, x: acc + [x])
        .delay(0.02))
    flat = [x for g in out for x in g]
    assert flat == list(range(10))
    return flat


@side_by_side
def test_initial_delay(S):
    """The elements in order, none before the stream materialized and
    each after it left the source (no wall-clock budget)."""
    events = []
    out = S.seq(S.Source.from_iterable([1, 2, 3])
                .wire_tap(lambda x: events.append(("in", x)))
                .initial_delay(0.1)
                .wire_tap(lambda x: events.append(("out", x))))
    assert out == [1, 2, 3]
    assert all(events.index(("in", x)) < events.index(("out", x))
               for x in out)
    return [out, [e for e in events if e[0] == "out"]]


@side_by_side
def test_backpressure_timeout_passes_fast_consumer(S):
    out = S.seq(S.Source.from_iterable(range(5)).backpressure_timeout(5.0))
    assert out == list(range(5))
    return out


@side_by_side
def test_backpressure_timeout_fails_stuck_consumer(S):
    gate = threading.Event()

    def stuck(x):
        # the reference waits 10 s in a pool thread; here the pool thread
        # waits on a gate that the scenario opens once the stream failed
        return S.pool.submit(lambda: (gate.wait(WAIT), x)[1]) if x else x
    fut = S.Source.from_iterable(range(5)) \
        .backpressure_timeout(0.05) \
        .map_async(1, stuck) \
        .run_with(S.Sink.seq(), S.system)
    name = err(fut)
    gate.set()
    assert name == "BackpressureTimeoutException"
    return name


@side_by_side
def test_delay_with(S):
    """The elements in order, each delayed after it entered (no
    wall-clock budget)."""
    events = []
    out = S.seq(S.Source.from_iterable([1, 2])
                .wire_tap(lambda x: events.append(("in", x)))
                .delay_with(lambda: (lambda elem: 0.05 * elem))
                .wire_tap(lambda x: events.append(("out", x))))
    assert out == [1, 2]
    assert all(events.index(("in", x)) < events.index(("out", x))
               for x in out)
    return [out, [e for e in events if e[0] == "out"]]


@side_by_side
def test_monitor(S):
    holder = {}
    out = (S.Source.from_iterable([1, 2, 3])
           .via_mat(S.Flow().monitor().map_materialized_value(
               lambda m: holder.setdefault("m", m)), S.Keep.right)
           .run_with(S.Sink.seq(), S.system))
    t = [out.result(WAIT)]
    _wait_for(lambda: holder["m"].state[0] == "finished")
    t.append(holder["m"].state)
    assert t == [[1, 2, 3], ("finished",)]
    return t


@side_by_side
def test_fold_while(S):
    # sum until the aggregate reaches 10; upstream is infinite
    out = S.seq(S.Source.repeat(3).fold_while(
        0, lambda acc: acc < 10, lambda acc, x: acc + x))
    assert out == [12]
    return out


@side_by_side
def test_watch_fails_stream_when_actor_dies(S):
    ref = S.system.actor_of(S.Props.from_receive(lambda ctx, msg: None))
    fut = S.Source.tick(0.01, 0.05, "x").watch(ref) \
        .run_with(S.Sink.seq(), S.system)
    time.sleep(0.1)
    S.system.stop(ref)
    assert err(fut) == "WatchedActorTerminatedException"
    return err(fut)


@side_by_side
def test_detach_passes_elements(S):
    out = S.seq(S.Source.from_iterable(range(6)).detach())
    assert out == list(range(6))
    return out


@side_by_side
def test_recover_with(S):
    out = S.seq(S.Source.from_iterable([1, 2])
                .concat(S.Source.failed(ValueError("x")))
                .recover_with(lambda ex: S.Source.from_iterable([8, 9])))
    assert out == [1, 2, 8, 9]
    return out


@side_by_side
def test_collect_first_and_collect_while(S):
    t = [S.seq(S.Source.from_iterable([1, 3, 4, 5, 6]).collect_first(
             lambda x: x * 10 if x % 2 == 0 else None)),
         S.seq(S.Source.from_iterable([2, 4, 5, 6]).collect_while(
             lambda x: x * 10 if x % 2 == 0 else None))]
    assert t == [[40], [20, 40]]
    return t


@side_by_side
def test_flatten_merge(S):
    out = S.seq(S.Source.from_iterable([S.Source.from_iterable([1, 2]),
                                        S.Source.from_iterable([3, 4])])
                .flatten_merge(2))
    assert sorted(out) == [1, 2, 3, 4]
    return sorted(out)


@side_by_side
def test_switch_map_cancels_previous_inner(S):
    # a new outer element switches away from the (infinite) previous inner
    out = S.seq(S.Source.from_iterable(["a", "b"]).switch_map(
        lambda k: S.Source.tick(0.0, 0.01, k).take(50) if k == "a"
        else S.Source.from_iterable([k] * 3)))
    assert out[-3:] == ["b", "b", "b"]
    assert len(out) < 53  # "a" was cut short by the switch
    assert set(out[:-3]) <= {"a"}
    return out[-3:]


@side_by_side
def test_concat_lazy_and_prepend_lazy(S):
    built = []

    def make_second():
        built.append(True)
        return S.Source.from_iterable([3, 4])

    src = S.Source.from_iterable([1, 2]).concat_lazy(
        S.Source.lazy_source(make_second))
    assert built == []  # not built before materialization and pull
    t = [S.seq(src), S.seq(S.Source.from_iterable([3, 4]).prepend_lazy(
        S.Source.from_iterable([1])))]
    assert t == [[1, 2, 3, 4], [1, 3, 4]]
    return t


@side_by_side
def test_map_materialized_value(S):
    out = S.Source.from_iterable([1, 2]) \
        .map_materialized_value(lambda m: ("wrapped", m)) \
        .run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out == [1, 2]
    return out


@side_by_side
def test_source_maybe_success(S):
    promise, fut = S.Source.maybe().to_mat(S.Sink.seq(), S.Keep.both) \
        .run(S.Materializer(S.system))
    promise.success(42)
    out = fut.result(WAIT)
    assert out == [42]
    return out


@side_by_side
def test_source_maybe_empty_and_failure(S):
    mat = S.Materializer(S.system)
    promise, fut = S.Source.maybe().to_mat(S.Sink.seq(), S.Keep.both) \
        .run(mat)
    promise.success(None)
    t = [fut.result(WAIT)]
    promise2, fut2 = S.Source.maybe().to_mat(S.Sink.seq(), S.Keep.both) \
        .run(mat)
    promise2.failure(RuntimeError("nope"))
    t.append(err(fut2))
    assert t == [[], "RuntimeError"]
    return t


@side_by_side
def test_unfold_async(S):
    def fn(s):
        return S.later(None) if s >= 4 else S.later((s + 1, s))
    out = S.seq(S.Source.unfold_async(0, fn))
    assert out == [0, 1, 2, 3]
    return out


@side_by_side
def test_unfold_resource_async(S):
    closed = []

    def close(it):
        closed.append(True)
        return S.later(True)

    out = S.seq(S.Source.unfold_resource_async(
        lambda: S.later(iter([1, 2, 3])),
        lambda it: S.later(next(it, None)), close))
    assert out == [1, 2, 3]
    assert closed == [True]
    return [out, closed]


@side_by_side
def test_zip_n_and_zip_with_n(S):
    t = [S.seq(S.Source.zip_n([S.Source.from_iterable([1, 2, 3]),
                               S.Source.from_iterable("ab")])),
         S.seq(S.Source.zip_with_n(
             lambda xs: sum(xs), [S.Source.from_iterable([1, 2]),
                                  S.Source.from_iterable([10, 20]),
                                  S.Source.from_iterable([100, 200])]))]
    assert t == [[[1, "a"], [2, "b"]], [111, 222]]
    return t


@side_by_side
def test_merge_latest(S):
    out = S.seq(S.Source.from_iterable([1]).merge_latest(
        S.Source.from_iterable(["a", "b"])))
    # after both sides emitted, each update emits the latest pair
    assert [1, "a"] in out or [1, "b"] in out
    assert out[-1] == [1, "b"]
    return out[-1]


@side_by_side
def test_merge_prioritized_n(S):
    out = S.seq(S.Source.merge_prioritized_n(
        [(S.Source.from_iterable([1, 1]), 1),
         (S.Source.from_iterable([9, 9]), 10)]))
    assert sorted(out) == [1, 1, 9, 9]
    return sorted(out)


@side_by_side
def test_source_range_and_from_iterator(S):
    calls = []

    def factory():
        calls.append(True)
        return iter([1, 2])
    src = S.Source.from_iterator(factory)
    t = [S.seq(S.Source.range(1, 5)), S.seq(S.Source.range(5, 1, -2)),
         S.seq(src), S.seq(src)]  # a fresh iterator per run
    assert t == [[1, 2, 3, 4, 5], [5, 3, 1], [1, 2], [1, 2]]
    assert len(calls) == 2
    return t


@side_by_side
def test_actor_ref_with_backpressure(S):
    ref_fut, seq_fut = S.Source.actor_ref_with_backpressure("ACK") \
        .to_mat(S.Sink.seq(), S.Keep.both).run(S.Materializer(S.system))
    ref = ref_fut.result(WAIT)
    acks = []
    Status = S.Status

    class Producer(S.Actor):
        def pre_start(self):
            ref.tell("one", self.self_ref)

        def receive(self, message):
            if message == "ACK":
                acks.append(True)
                if len(acks) == 1:
                    ref.tell("two", self.self_ref)
                else:
                    ref.tell(Status.Success(None), self.self_ref)

    S.system.actor_of(S.Props.create(Producer))
    out = seq_fut.result(WAIT)
    assert out == ["one", "two"]
    assert len(acks) == 2
    return [out, len(acks)]


@side_by_side
def test_foreach_async(S):
    seen = []
    S.Source.from_iterable([1, 2, 3]).run_with(
        S.Sink.foreach_async(2, lambda x: S.later(seen.append(x))),
        S.system).result(WAIT)
    assert sorted(seen) == [1, 2, 3]
    return sorted(seen)


@side_by_side
def test_sink_cancelled(S):
    # nothing to hold beyond termination: the stream cancels cleanly
    mat = S.Source.from_iterable(range(1000)).to(S.Sink.cancelled()) \
        .run(S.Materializer(S.system))
    return mat is None


@side_by_side
def test_lazy_sink_builds_on_first_element(S):
    built, seen = [], []

    def factory():
        built.append(True)
        return S.Sink.foreach(seen.append)

    S.Source.from_iterable([1, 2, 3]).to(S.Sink.lazy_sink(factory)) \
        .run(S.system)
    _wait_for(lambda: len(seen) >= 3)
    assert built == [True]
    assert seen == [1, 2, 3]
    return [built, seen]


@side_by_side
def test_lazy_sink_never_builds_without_elements(S):
    built = []

    def factory():
        built.append(True)
        return S.Sink.ignore()

    S.Source.empty().to(S.Sink.lazy_sink(factory)).run(S.system)
    time.sleep(0.2)
    assert built == []
    return built


@side_by_side
def test_future_sink(S):
    seen = []
    fut = Future()
    S.Source.from_iterable([1, 2]).to(S.Sink.future_sink(fut)).run(S.system)
    time.sleep(0.05)
    fut.set_result(S.Sink.foreach(seen.append))
    _wait_for(lambda: len(seen) >= 2)
    assert seen == [1, 2]
    return seen


@side_by_side
def test_lazy_flow(S):
    built = []

    def factory():
        built.append(True)
        return S.Flow().map(lambda x: x * 2)

    out = S.seq(S.Source.from_iterable([1, 2, 3]).via(
        S.Flow.lazy_flow(factory)))
    assert out == [2, 4, 6]  # the first element went through the inner flow
    assert built == [True]
    return [out, built]


@side_by_side
def test_from_sink_and_source(S):
    seen = []
    flow = S.Flow.from_sink_and_source(
        S.Sink.foreach(seen.append), S.Source.from_iterable(["x", "y"]))
    out = S.seq(S.Source.from_iterable([1, 2]).via(flow))
    assert out == ["x", "y"]
    _wait_for(lambda: len(seen) >= 2)
    assert seen == [1, 2]
    return [out, seen]


@side_by_side
def test_from_sink_and_source_coupled_cancels_input_side(S):
    # the output side completes -> the input side is torn down too
    flow = S.Flow.from_sink_and_source_coupled(
        S.Sink.ignore(), S.Source.from_iterable(["x"]))
    out = S.seq(S.Source.tick(0.01, 0.01, 1).via(flow))
    assert out == ["x"]
    return out


@side_by_side
def test_pre_materialize(S):
    mat, src = S.Source.from_iterable([1, 2, 3]).pre_materialize(
        S.Materializer(S.system))
    out = S.seq(src)
    assert out == [1, 2, 3]
    return out


@side_by_side
def test_map_async_partitioned_sync_fn(S):
    # fn returning plain values (allowed) must not corrupt the entry queue
    out = S.seq(S.Source.from_iterable(range(6)).map_async_partitioned(
        2, lambda e: e % 2, lambda e, p: e * 10))
    assert out == [0, 10, 20, 30, 40, 50]
    return out


@side_by_side
def test_source_maybe_downstream_cancel_completes(S):
    out = S.seq(S.Source.maybe().take(0))
    assert out == []
    return out


@side_by_side
def test_merge_latest_backpressure_bounded(S):
    # fast inputs and a slow consumer: the stream completes, bounded
    out = S.seq(S.Source.from_iterable(range(50)).merge_latest(
        S.Source.from_iterable(range(50))).take(5).delay(0.01))
    assert len(out) == 5
    return len(out)


@side_by_side
def test_lazy_sink_materializes_inner_mat(S):
    fut = S.Source.from_iterable([1, 2, 3]).to_mat(
        S.Sink.lazy_sink(lambda: S.Sink.seq()), S.Keep.right) \
        .run(S.Materializer(S.system))
    inner_mat = fut.result(WAIT)          # Future[inner Sink.seq future]
    out = inner_mat.result(WAIT)
    assert out == [1, 2, 3]
    return out


@side_by_side
def test_lazy_sink_mat_fails_when_never_materialized(S):
    fut = S.Source.empty().to_mat(
        S.Sink.lazy_sink(lambda: S.Sink.seq()), S.Keep.right) \
        .run(S.Materializer(S.system))
    assert err(fut) == "NeverMaterializedException"
    assert isinstance(fut.exception(), S.NeverMaterializedException)
    return err(fut)


@side_by_side
def test_actor_ref_with_backpressure_two_senders_no_loss(S):
    ref_fut, seq_fut = S.Source.actor_ref_with_backpressure("ACK") \
        .to_mat(S.Sink.seq(), S.Keep.both).run(S.Materializer(S.system))
    ref = ref_fut.result(WAIT)
    acked = []

    class P(S.Actor):
        def __init__(self, tag):
            super().__init__()
            self.tag = tag

        def pre_start(self):
            ref.tell(self.tag, self.self_ref)

        def receive(self, message):
            if message == "ACK":
                acked.append(self.tag)

    S.system.actor_of(S.Props.create(P, "a"))
    S.system.actor_of(S.Props.create(P, "b"))
    _wait_for(lambda: len(acked) >= 2)
    assert sorted(acked) == ["a", "b"]   # neither sender lost its ack
    ref.tell(S.Status.Success(None), None)
    out = sorted(seq_fut.result(WAIT))
    assert out == ["a", "b"]
    return [sorted(acked), out]


def test_the_files_cover_both_reference_files():
    """Every case of tests/test_stream_ops3.py and test_stream_ops4.py
    has a scenario of the same name here."""
    import ast
    from pathlib import Path

    here = Path(__file__).resolve().parent
    ours = {n.name for n in ast.parse(Path(__file__).read_text()).body
            if isinstance(n, ast.FunctionDef)}
    for ref in ("test_stream_ops3.py", "test_stream_ops4.py"):
        theirs = {n.name for n in ast.parse((here / ref).read_text()).body
                  if isinstance(n, ast.FunctionDef)
                  and n.name.startswith("test_")}
        assert theirs <= ours, sorted(theirs - ours)
