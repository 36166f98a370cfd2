"""The port's sub-streams, timed and limit operators, graph shapes,
supervision and restart sections (akka_tpu_torch.stream) on the CPU, side
by side with the JAX package's: the core cases of
tests/test_stream_breadth.py (all but framing, file IO, gzip and TCP,
which tests/test_torch_stream_io.py runs; the operator inventory is held
to the reference's), the four BidiFlow and GraphDSL cases of
tests/test_parity_breadth.py, the cases of tests/test_stream_supervision.py
but its two `stream.tck` cases (tests/test_torch_stream_tck.py and
test_torch_stream_tck_sources.py run those), and lazy and future sinks over
the restart bridge that they materialize through.
Each scenario runs on both packages; the port's trace must equal the
reference's (tests/torch_stream_fixture.py).

Where the reference holds a duration against a budget (takeWithin, the
restart backoff's growth), both packages are held to the order of
events and the elements instead.
"""

import time
from concurrent.futures import Future

import pytest

from torch_stream_fixture import WAIT, both, err, side_by_side


def _wait_for(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


def _fast(S, **kw):
    """The restart settings of tests/test_stream_supervision.py."""
    args = dict(min_backoff=0.02, max_backoff=0.1, random_factor=0.0)
    args.update(kw)
    return S.RestartSettings(**args)


def _boom_on(bad):
    def fn(x):
        if x == bad:
            raise ValueError(f"boom on {x}")
        return x
    return fn


def _resuming(S):
    return S.Attributes.supervision_strategy(S.Supervision.resuming_decider)


# ----------------------------------- tests/test_stream_breadth.py: sub-streams

@side_by_side
def test_group_by_and_merge_substreams(S):
    out = S.seq(S.Source.from_iterable(range(12))
                .group_by(4, lambda x: x % 3)
                .flat_map_merge(4, lambda pair: pair[1].map(
                    lambda v, k=pair[0]: (k, v))))
    by_key = {}
    for k, v in out:
        by_key.setdefault(k, []).append(v)
    assert by_key == {0: [0, 3, 6, 9], 1: [1, 4, 7, 10], 2: [2, 5, 8, 11]}
    return sorted(by_key.items())


@side_by_side
def test_split_when_sub_streams(S):
    # split on multiples of 4: [0..3], [4..7], [8..11]
    subs = S.seq(S.Source.from_iterable(range(12))
                 .split_when(lambda x: x % 4 == 0 and x > 0)
                 .flat_map_concat(
                     lambda s: s.fold([], lambda acc, x: acc + [x])))
    assert subs == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    return subs


@side_by_side
def test_split_after(S):
    subs = S.seq(S.Source.from_iterable([1, 2, 0, 3, 4, 0, 5])
                 .split_after(lambda x: x == 0)
                 .flat_map_concat(
                     lambda s: s.fold([], lambda acc, x: acc + [x])))
    assert subs == [[1, 2, 0], [3, 4, 0], [5]]
    return subs


@side_by_side
def test_flat_map_merge_concurrent(S):
    out = S.seq(S.Source.from_iterable([0, 10, 20]).flat_map_merge(
        3, lambda base: S.Source.from_iterable([base + i for i in range(3)])))
    assert sorted(out) == [0, 1, 2, 10, 11, 12, 20, 21, 22]
    return sorted(out)


@side_by_side
def test_prefix_and_tail(S):
    prefix, tail = S.Source.from_iterable(range(6)).prefix_and_tail(2) \
        .run_with(S.Sink.head(), S.system).result(WAIT)
    t = [prefix, S.seq(tail)]
    assert t == [[0, 1], [2, 3, 4, 5]]
    return t


# ------------------------ tests/test_stream_breadth.py: timed / limit / error

@side_by_side
def test_grouped_within_by_size(S):
    out = S.seq(S.Source.from_iterable(range(10)).grouped_within(4, 5.0))
    assert out == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    return out


@side_by_side
def test_take_within_cuts_a_tick_stream(S):
    """The window ends a tick stream and a stream that never emits, and
    passes a finite one whole (no count of ticks against a budget)."""
    ticks = S.Source.tick(0.0, 0.05, "t").take_within(0.4) \
        .run_with(S.Sink.seq(), S.system).result(WAIT)
    assert set(ticks) <= {"t"}
    t = [S.seq(S.Source.never().take_within(0.2)),
         S.seq(S.Source.from_iterable(range(5)).take_within(5.0))]
    assert t == [[], [0, 1, 2, 3, 4]]
    return t


@side_by_side
def test_limit_fails_beyond_max(S):
    fut = S.Source.from_iterable(range(100)).limit(10) \
        .run_with(S.Sink.seq(), S.system)
    assert isinstance(fut.exception(WAIT), S.StreamLimitReachedException)
    out = S.seq(S.Source.from_iterable(range(5)).limit(10))
    assert out == list(range(5))
    return [err(fut), out]


@side_by_side
def test_deduplicate(S):
    out = S.seq(S.Source.from_iterable([1, 1, 2, 2, 2, 3, 1]).deduplicate())
    assert out == [1, 2, 3, 1]
    return out


@side_by_side
def test_map_error(S):
    class Custom(RuntimeError):
        pass

    fut = S.Source.failed(ValueError("boom")).map_error(
        lambda e: Custom(str(e))).run_with(S.Sink.seq(), S.system)
    ex = fut.exception(WAIT)
    assert isinstance(ex, Custom)
    return [type(ex).__name__, str(ex)]


@side_by_side
def test_recover_with_retries(S):
    out = S.seq(S.Source.from_iterable(range(10)).map(_boom_on(3))
                .recover_with_retries(
                    1, lambda e: S.Source.from_iterable([99, 100])))
    assert out == [0, 1, 2, 99, 100]
    return out


@side_by_side
def test_watch_termination(S):
    fut = S.Source.from_iterable(range(3)).watch_termination() \
        .to_mat(S.Sink.ignore(), S.Keep.left).run(S.system)
    t = [fut.result(WAIT)]
    fut = S.Source.failed(ValueError("x")).watch_termination() \
        .to_mat(S.Sink.ignore(), S.Keep.left).run(S.system)
    t.append(err(fut))
    assert t == [None, "ValueError"]
    return t


@side_by_side
def test_timeouts(S):
    fut = S.Source.tick(5.0, 5.0, "never").initial_timeout(0.2) \
        .run_with(S.Sink.seq(), S.system)
    t = [err(fut), S.seq(S.Source.from_iterable(range(3)).idle_timeout(5.0))]
    assert t == ["TimeoutError", [0, 1, 2]]
    return t


def _operators(S):
    names = set()
    for cls in (S.Source, S.Flow, S.Sink):
        names.update(m for m in dir(cls)
                     if not m.startswith("_") and callable(getattr(cls, m)))
    return sorted(names)


def test_operator_breadth_at_least_160_distinct():
    """The distinct operator names across Source/Flow/Sink: at least 160
    on each package, and the port's are the reference's, the two that
    `stream/context.py` attaches to Source and Flow included."""
    traces = both(_operators)
    ref, port = set(traces["akka_tpu"]), set(traces["akka_tpu_torch"])
    assert len(ref) >= 160 and len(port) >= 160
    assert {"as_flow_with_context", "as_source_with_context"} <= port
    assert port == ref


# ------------------------ tests/test_parity_breadth.py: BidiFlow, GraphDSL

@side_by_side
def test_bidiflow_join_protocol_stack(S):
    # codec (int <-> str) atop framing (str <-> bytes) joined over an
    # echo transport: the classic protocol-stack shape
    codec = S.BidiFlow.from_functions(lambda i: str(i),
                                      lambda s: int(s) * 10)
    framing = S.BidiFlow.from_functions(lambda s: s.encode(),
                                        lambda b: b.decode())
    stack = codec.atop(framing).join(S.Flow())  # loopback transport
    out = S.seq(S.Source.from_iterable([1, 2, 3]).via(stack))
    assert out == [10, 20, 30]
    return out


@side_by_side
def test_bidiflow_reversed(S):
    bidi = S.BidiFlow.from_functions(lambda x: x + 1, lambda x: x * 2)
    out = S.seq(S.Source.from_iterable([1, 2]).via(
        bidi.reversed().join(S.Flow())))
    assert out == [3, 5]  # *2 then +1
    return out


@side_by_side
def test_graphdsl_diamond(S):
    def build(g):
        bcast = g.broadcast(2)
        merge = g.merge(2)
        g.edge(g.source(S.Source.from_iterable(range(10))), bcast.shape.in_)
        g.edge(g.flow(bcast.shape.outs[0], S.Flow().map(lambda x: x * 10)),
               merge.shape.ins[0])
        g.edge(g.flow(bcast.shape.outs[1],
                      S.Flow().map(lambda x: x + 1000)),
               merge.shape.ins[1])
        return g.sink(S.Sink.seq(), merge.shape.out)

    out = sorted(S.GraphDSL.create(build).run(S.system).result(WAIT))
    assert out == sorted([x * 10 for x in range(10)] +
                         [x + 1000 for x in range(10)])
    return out


@side_by_side
def test_graphdsl_zip_two_sources(S):
    def build(g):
        z = g.zip()
        g.edge(g.source(S.Source.from_iterable("abc")), z.shape.ins[0])
        g.edge(g.source(S.Source.from_iterable(range(3))), z.shape.ins[1])
        return g.sink(S.Sink.seq(), z.shape.out)

    out = S.GraphDSL.create(build).run(S.system).result(WAIT)
    assert out == [("a", 0), ("b", 1), ("c", 2)]
    return out


# -------------------------- tests/test_stream_supervision.py: deciders

@side_by_side
def test_default_decider_stops_the_stream(S):
    fut = S.Source.from_iterable(range(5)).map(_boom_on(2)) \
        .run_with(S.Sink.seq(), S.system)
    with pytest.raises(ValueError):
        fut.result(WAIT)
    return err(fut)


@side_by_side
def test_resume_skips_the_failing_element(S):
    out = S.seq(S.Source.from_iterable(range(6))
                .via(S.Flow().map(_boom_on(2)).with_attributes(_resuming(S))))
    assert out == [0, 1, 3, 4, 5]
    return out


@side_by_side
def test_resume_on_filter_predicate_failure(S):
    out = S.seq(S.Source.from_iterable(range(6)).via(
        S.Flow().filter(lambda x: (x % 2 == 0) if x != 3 else 1 // 0)
        .with_attributes(_resuming(S))))
    assert out == [0, 2, 4]
    return out


@side_by_side
def test_restart_resets_scan_state_resume_keeps_it(S):
    def run(decider):
        return S.seq(S.Source.from_iterable([1, 2, 100, 3]).via(
            S.Flow().scan(0, lambda acc, x: acc + x if x != 100 else 1 // 0)
            .with_attributes(S.Attributes.supervision_strategy(decider))))
    # resume: the sum survives the dropped element; restart resets it
    t = [run(S.Supervision.resuming_decider),
         run(S.Supervision.restarting_decider)]
    assert t == [[0, 1, 3, 6], [0, 1, 3, 3]]
    return t


@side_by_side
def test_attributes_scope_is_the_wrapped_section_only(S):
    # the throwing map sits after with_attributes, outside the resumed
    # section: the default stop decider applies and the stream fails
    fut = (S.Source.from_iterable(range(5))
           .via(S.Flow().map(lambda x: x).with_attributes(_resuming(S))
                .map(_boom_on(2)))
           .run_with(S.Sink.seq(), S.system))
    assert err(fut) == "ValueError"
    return err(fut)


@side_by_side
def test_innermost_attributes_win(S):
    # the outer section resumes, the inner one pins stop for its stage
    fut = (S.Source.from_iterable(range(5))
           .via(S.Flow()
                .via(S.Flow().map(_boom_on(2)).with_attributes(
                    S.Attributes.supervision_strategy(
                        S.Supervision.stopping_decider)))
                .with_attributes(_resuming(S)))
           .run_with(S.Sink.seq(), S.system))
    assert err(fut) == "ValueError"
    return err(fut)


@side_by_side
def test_source_side_resume_retries_production(S):
    # an unfold whose fn fails once mid-stream: resume retries the pull
    state = {"failed": False}

    def fn(s):
        if s == 3 and not state["failed"]:
            state["failed"] = True
            raise RuntimeError("transient")
        return (s + 1, s) if s < 6 else None

    out = S.seq(S.Source.unfold(0, fn).with_attributes(_resuming(S)))
    assert out == [0, 1, 2, 3, 4, 5]
    return out


@side_by_side
def test_source_side_resume_survives_long_failure_runs(S):
    """200 consecutive pull failures with an advancing cursor are all
    skipped (resume semantics)."""
    state = {"cursor": 0}

    def fn(_):
        state["cursor"] += 1
        c = state["cursor"]
        if c <= 200:
            raise RuntimeError(f"bad record {c}")
        return (None, c) if c <= 203 else None

    out = S.seq(S.Source.unfold(None, fn).with_attributes(_resuming(S)))
    assert out == [201, 202, 203]
    return out


@side_by_side
def test_named_and_name_attribute(S):
    t = [S.seq(S.Source.from_iterable([1]).named("my-source")),
         S.Attributes.name("a").and_then(S.Attributes.name("b")).get("name")]
    assert t == [[1], "b"]
    return t


@side_by_side
def test_input_buffer_attribute_sizes_async_boundary(S):
    out = S.seq(S.Source.from_iterable(range(20))
                .via(S.Flow().map(lambda x: x).async_())
                .via(S.Flow().map(lambda x: x + 1).with_attributes(
                    S.Attributes.input_buffer(1, 2))))
    assert out == list(range(1, 21))
    return out


@side_by_side
def test_restart_decider_reopens_unfold_resource(S):
    opened, closed = [], []

    def create():
        opened.append(len(opened))
        return {"reads": 0, "id": len(opened) - 1}

    def read(r):
        r["reads"] += 1
        if r["id"] == 0 and r["reads"] == 3:
            raise RuntimeError("wedged handle")
        if r["reads"] > 4:
            return None
        return (r["id"], r["reads"])

    out = S.seq(S.Source.unfold_resource(
        create, read, lambda r: closed.append(r["id"]))
        .with_attributes(S.Attributes.supervision_strategy(
            S.Supervision.restarting_decider)))
    # resource 0 read twice, wedged on the 3rd: reopened as resource 1
    assert opened == [0, 1] and closed == [0, 1]
    assert out == [(0, 1), (0, 2), (1, 1), (1, 2), (1, 3), (1, 4)]
    return [out, opened, closed]


@side_by_side
def test_resume_on_last_element_still_completes(S):
    # the dropped element was the last, with upstream completion already
    # pending behind it: the stream still completes
    t = [S.seq(S.Source.from_iterable([1, 2, 3]).via(
             S.Flow().map(_boom_on(3)).with_attributes(_resuming(S)))),
         S.seq(S.Source.single(1).via(
             S.Flow().map(_boom_on(1)).with_attributes(_resuming(S))))]
    assert t == [[1, 2], []]
    return t


# ------------------- tests/test_stream_supervision.py: restart sections

@side_by_side
def test_restart_source_rematerializes_after_failure(S):
    attempts = {"n": 0}

    def factory():
        attempts["n"] += 1
        if attempts["n"] == 1:
            return S.Source.from_iterable([1, 2]).concat(
                S.Source.failed(RuntimeError("die")))
        return S.Source.from_iterable([3, 4])

    out = S.seq(S.RestartSource.on_failures_with_backoff(_fast(S), factory))
    assert out == [1, 2, 3, 4]
    assert attempts["n"] == 2
    return [out, attempts["n"]]


@side_by_side
def test_restart_source_with_backoff_restarts_on_completion(S):
    attempts = {"n": 0}

    def factory():
        attempts["n"] += 1
        return S.Source.single(attempts["n"])

    out = S.seq(S.RestartSource.with_backoff(_fast(S), factory).take(3))
    assert out == [1, 2, 3]
    assert attempts["n"] >= 3
    return out


@side_by_side
def test_restart_source_max_restarts_propagates_failure(S):
    settings = _fast(S, min_backoff=0.01, max_backoff=0.02, max_restarts=2,
                     max_restarts_within=60.0)
    fut = S.RestartSource.on_failures_with_backoff(
        settings, lambda: S.Source.failed(RuntimeError("always"))) \
        .run_with(S.Sink.seq(), S.system)
    assert err(fut) == "RuntimeError"
    return err(fut)


@side_by_side
def test_restart_source_backoff_grows(S):
    """Three restarts, then the failure; the attempts in order (no
    wall-clock budget on the gaps)."""
    stamps = []

    def factory():
        stamps.append(time.monotonic())
        return S.Source.failed(RuntimeError("die"))

    settings = _fast(S, min_backoff=0.05, max_backoff=1.0, max_restarts=3,
                     max_restarts_within=60.0)
    fut = S.RestartSource.on_failures_with_backoff(settings, factory) \
        .run_with(S.Sink.seq(), S.system)
    name = err(fut)
    assert name == "RuntimeError"
    assert len(stamps) == 4 and stamps == sorted(stamps)
    return [name, len(stamps)]


@side_by_side
def test_restart_flow_survives_inner_failure(S):
    out = S.seq(S.Source.from_iterable([1, 2, 3, 4, 5]).via(
        S.RestartFlow.with_backoff(_fast(S),
                                   lambda: S.Flow().map(_boom_on(3)))))
    # the failing element is lost across the restart (at-most-once wrap)
    assert out == [1, 2, 4, 5]
    return out


@side_by_side
def test_restart_flow_completes_when_upstream_completes(S):
    out = S.seq(S.Source.from_iterable(range(4)).via(
        S.RestartFlow.with_backoff(_fast(S),
                                   lambda: S.Flow().map(lambda x: x * 10))))
    assert out == [0, 10, 20, 30]
    return out


def _failing_once_sink(S, bad, seen):
    armed = {"on": True}

    def factory():
        def consume(x):
            if x == bad and armed["on"]:
                armed["on"] = False
                raise RuntimeError(f"die on {x}")
            seen.append(x)
        return S.Sink.foreach(consume)
    return factory


@side_by_side
def test_restart_sink_rematerializes_and_keeps_consuming(S):
    seen = []
    S.Source.from_iterable([1, 2, 3, 4, 5]).to(S.RestartSink.with_backoff(
        _fast(S), _failing_once_sink(S, 3, seen))).run(S.system)
    _wait_for(lambda: 5 in seen)
    # 3 was in flight at the failure (lost, at-most-once wrap);
    # consumption continues after the rematerialization
    assert seen == [1, 2, 4, 5]
    return seen


@side_by_side
def test_restart_sink_public_api(S):
    seen = []
    S.Source.from_iterable([1, 2, 3]).to(S.RestartSink.with_backoff(
        _fast(S), _failing_once_sink(S, 2, seen))).run(S.system)
    _wait_for(lambda: 3 in seen)
    # 2 was in flight at the failure (lost); 3 arrives after the restart
    assert seen == [1, 3]
    return seen


# ------------------------------------ lazy and future sinks over the bridge

@side_by_side
def test_lazy_and_future_sinks_over_the_restart_bridge(S):
    """Sink.future_sink and Sink.lazy_sink materialize their inner sink
    through restart's bridge (`_BridgeHandle`, `_BridgeSource`): the
    elements offered before the future completes wait in the bridge, the
    inner mat value comes out of the outer one, a failed future fails it,
    and a lazy sink over a RestartSink goes on after the inner failure."""
    fut = Future()
    mat = S.Source.from_iterable(range(5)).to_mat(
        S.Sink.future_sink(fut), S.Keep.right).run(S.system)
    time.sleep(0.05)
    fut.set_result(S.Sink.fold(0, lambda a, b: a + b))
    t = [mat.result(WAIT).result(WAIT)]

    bad = Future()
    mat2 = S.Source.from_iterable(range(5)).to_mat(
        S.Sink.future_sink(bad), S.Keep.right).run(S.system)
    bad.set_exception(LookupError("no sink"))
    t.append(err(mat2))

    seen = []
    S.Source.from_iterable([1, 2, 3, 4]).to(S.Sink.lazy_sink(
        lambda: S.RestartSink.with_backoff(
            _fast(S), _failing_once_sink(S, 3, seen)))).run(S.system)
    _wait_for(lambda: 4 in seen)
    t.append(seen)
    assert t[0] == 10 and t[1] and seen == [1, 2, 4]
    assert S.restart._BridgeHandle.__module__ == f"{S.name}.stream.restart"
    return t
