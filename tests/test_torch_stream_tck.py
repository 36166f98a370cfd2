"""The port's compliance harness (akka_tpu_torch.stream.tck) on the CPU,
side by side with the JAX package's: the cases of tests/test_stream_tck.py
(11 publishers and 10 identity processors through the rule battery, and
the battery failing a publisher that breaks ordering) and the two `tck`
cases of tests/test_stream_supervision.py (a supervised flow and a
restarting source). Each scenario is written once over a package's names,
runs the package's own harness on the package's own stages, and the
port's trace (the rules that ran, or the rule a violation names) must
equal the reference's (tests/torch_stream_fixture.py).

The publisher battery waits out its silence windows (about 1 s a
package), so the publishers built from a source alone and the restarting
source run in tests/test_torch_stream_tck_sources.py, which shares this
file's tables; this file runs the operator publishers, the processors and
the rest.
"""

import importlib

import pytest

from torch_stream_fixture import both, side_by_side


def _tck(S):
    """The package's own harness module."""
    return importlib.import_module(f"{S.name}.stream.tck")


def _json_frames(S, n):
    payload = b"".join(b'{"i":%d}' % i for i in range(n))
    # frames arrive as bytes; map to ints so the ordering rules compare
    return S.Source.from_iterable(
        [payload[i:i + 7] for i in range(0, len(payload), 7)]) \
        .via(S.JsonFraming.object_scanner()) \
        .map(lambda b: int(b[5:-1]))


# publishers built from a source alone (run in test_torch_stream_tck_sources)
SOURCE_PUBLISHERS = {
    "from_iterable": lambda S, n: S.Source.from_iterable(range(n)),
    "unfold": lambda S, n: S.Source.unfold(
        0, lambda i: (i + 1, i) if i < n else None),
    "concat": lambda S, n: S.Source.from_iterable(range(n // 2)).concat(
        S.Source.from_iterable(range(n // 2, n))),
    "async_island": lambda S, n: S.Source.from_iterable(range(n)).async_()
        .map(lambda x: x),
    "json_framing": _json_frames,
}

# publishers through operators
OPERATOR_PUBLISHERS = {
    "via_map": lambda S, n: S.Source.from_iterable(range(n))
        .map(lambda x: x),
    "via_filter": lambda S, n: S.Source.from_iterable(range(2 * n))
        .filter(lambda x: x < n),
    "via_take": lambda S, n: S.Source.from_iterable(range(10 * n)).take(n),
    "via_buffer": lambda S, n: S.Source.from_iterable(range(n)).buffer(4),
    "stateful_map_concat": lambda S, n: S.Source.from_iterable(range(n))
        .stateful_map_concat(lambda: lambda x: [x]),
    "grouped_flat": lambda S, n: S.Source.from_iterable(range(n))
        .grouped(4).map_concat(lambda g: g),
}
PUBLISHERS = {**SOURCE_PUBLISHERS, **OPERATOR_PUBLISHERS}


def _retry_identity(S):
    # a never-retry decider around an identity flow is itself an identity
    return S.RetryFlow.with_backoff(0.001, 0.01, 0.0, 2,
                                    S.Flow().map(lambda x: x),
                                    lambda i, o: None)


PROCESSORS = {
    "map_identity": lambda S: S.Flow().map(lambda x: x),
    "filter_true": lambda S: S.Flow().filter(lambda x: True),
    "map_concat_single": lambda S: S.Flow().map_concat(lambda x: [x]),
    "take_while_true": lambda S: S.Flow().take_while(lambda x: True),
    "via_chain": lambda S: S.Flow().map(lambda x: x)
        .filter(lambda x: True).map(lambda x: x),
    "buffer": lambda S: S.Flow().buffer(8),
    "log": lambda S: S.Flow().log("tck", lambda x: x),
    "wire_tap": lambda S: S.Flow().wire_tap(lambda x: None),
    "scan_async_passthrough": lambda S: S.Flow().map(lambda x: x)
        .stateful_map_concat(lambda: lambda x: [x]),
    "retry_flow_identity": _retry_identity,
}


def _publisher(S, name):
    return _tck(S).verify_publisher(
        lambda n: PUBLISHERS[name](S, n), S.system)


def check_publisher(name):
    traces = both(_publisher, name)
    ran = traces["akka_tpu_torch"]
    assert ran == traces["akka_tpu"]
    assert {"1.01", "1.02", "1.03", "1.05", "1.08", "1.09",
            "1.10"} <= set(ran)


@pytest.mark.parametrize("name", sorted(OPERATOR_PUBLISHERS))
def test_publisher_compliance(name):
    check_publisher(name)


def _processor(S, name):
    return _tck(S).verify_identity_processor(
        lambda: PROCESSORS[name](S), S.system)


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_identity_processor_compliance(name):
    traces = both(_processor, name)
    ran = traces["akka_tpu_torch"]
    assert ran == traces["akka_tpu"]
    assert {"2.01", "2.02", "2.03", "2.04", "2.05"} <= set(ran)


@side_by_side
def test_harness_catches_violations(S):
    """The battery fails a non-compliant publisher (one that breaks rule
    1.03, ordering)."""
    tck = _tck(S)
    with pytest.raises(tck.TckViolation) as info:
        tck.verify_publisher(
            lambda n: S.Source.from_iterable(reversed(range(n))), S.system)
    return info.value.rule, str(info.value)


# -------------------- tests/test_stream_supervision.py: the tck cases

@side_by_side
def test_supervised_flow_passes_identity_tck(S):
    return _tck(S).verify_identity_processor(
        lambda: S.Flow().map(lambda x: x).with_attributes(
            S.Attributes.supervision_strategy(
                S.Supervision.resuming_decider)),
        S.system)
