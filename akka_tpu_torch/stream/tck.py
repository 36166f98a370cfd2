"""Reactive-streams-style compliance verification harness.

A copy of `akka_tpu/stream/tck.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream-tests-tck/src/test/scala/akka/stream/tck/
AkkaPublisherVerification.scala:18 and AkkaIdentityProcessorVerification.scala
— a REUSABLE rule-by-rule battery any Source (publisher) or Flow (processor)
implementation runs against, instead of per-operator ad-hoc assertions. The
rules checked are the spirit of the reactive-streams spec mapped onto the
port-state interpreter's contract:

publisher rules (spec §1.x):
  1.01 no elements without demand
  1.02 no more elements than requested
  1.03 elements arrive in order
  1.05 completion after the final element
  1.08 cancel stops the stream (no further elements)
  1.09 error is terminal (no elements after onError)
  1.10 a blueprint supports multiple independent materializations

processor rules (identity processing, spec §2.x):
  2.01 demand propagates upstream
  2.02 elements pass through in order
  2.03 upstream completion propagates after in-flight elements
  2.04 upstream error propagates
  2.05 downstream cancel propagates upstream

Usage:
    verify_publisher(lambda n: Source.from_iterable(range(n)), system)
    verify_identity_processor(lambda: Flow().map(lambda x: x), system)
Each raises AssertionError naming the violated rule.
"""

from __future__ import annotations

from typing import Callable, List

from .dsl import Flow, Keep, Sink, Source
from .testkit import TestSink, TestSource


class TckViolation(AssertionError):
    def __init__(self, rule: str, detail: str):
        super().__init__(f"[{rule}] {detail}")
        self.rule = rule


def _probe(source: Source, system):
    return source.to_mat(TestSink.probe(), Keep.right).run(system)


def verify_publisher(source_factory: Callable[[int], Source], system,
                     n: int = 16) -> List[str]:
    """Run the publisher battery against `source_factory(k)` — which must
    build a Source emitting exactly k known elements 0..k-1 (or any fixed
    sequence; order/count is what is checked). Returns the rule ids that
    ran (all passed; violations raise TckViolation)."""
    ran: List[str] = []

    def rule(rid: str, cond: bool, detail: str = ""):
        ran.append(rid)
        if not cond:
            raise TckViolation(rid, detail)

    # 1.01: nothing before demand
    p = _probe(source_factory(n), system)
    try:
        p.expect_no_message(0.25)
        rule("1.01", True)
    except AssertionError as e:
        raise TckViolation("1.01", f"emitted without demand: {e}") from e

    # 1.02 + 1.03: at most the requested count, in order
    p.request(3)
    got = [p.expect_next() for _ in range(3)]
    p.expect_no_message(0.25)
    rule("1.02", True, "")
    expected_all = None
    try:
        expected_all = list(range(n))
        rule("1.03", got == expected_all[:3],
             f"out of order: {got} vs {expected_all[:3]}")
    except TckViolation:
        raise
    # drain + 1.05: completion after the final element
    p.request(n)  # over-request past the end
    rest = [p.expect_next() for _ in range(n - 3)]
    rule("1.03b", got + rest == expected_all,
         f"full sequence mismatch: {got + rest}")
    p.expect_complete()
    rule("1.05", True)

    # 1.08: cancel stops the stream
    p2 = _probe(source_factory(n), system)
    p2.request(1)
    p2.expect_next()
    p2.cancel()
    try:
        p2.expect_no_message(0.3)
        rule("1.08", True)
    except AssertionError as e:
        raise TckViolation("1.08", f"emitted after cancel: {e}") from e

    # 1.09: error is terminal
    boom = RuntimeError("tck-error")
    perr = _probe(
        source_factory(n).map(
            lambda x: (_ for _ in ()).throw(boom) if x == 1 else x),
        system)
    perr.request(n + 1)
    perr.expect_next()  # element 0
    err = perr.expect_error()
    rule("1.09", isinstance(err, RuntimeError), f"wrong error: {err!r}")
    perr.expect_no_message(0.2)

    # 1.10: blueprint reuse — two independent materializations.
    # Demand is n+1: the spec does not force completion-without-demand on
    # every operator (unfold-style stages discover the end on the next
    # pull), so the battery supplies the extra pull like the reference
    # TCK's requestNextElementOrEndOfStream
    src = source_factory(4)
    a = _probe(src, system)
    b = _probe(src, system)
    a.request(5)
    b.request(5)
    got_a = [a.expect_next() for _ in range(4)]
    got_b = [b.expect_next() for _ in range(4)]
    rule("1.10", got_a == got_b == list(range(4)),
         f"materializations diverge: {got_a} vs {got_b}")
    a.expect_complete()
    b.expect_complete()
    return ran


def verify_identity_processor(flow_factory: Callable[[], Flow], system,
                              n: int = 16) -> List[str]:
    """Run the processor battery against `flow_factory()` — a Flow that
    must pass elements through unchanged (identity) so ordering/count
    checks are exact (AkkaIdentityProcessorVerification analogue)."""
    ran: List[str] = []

    def rule(rid: str, cond: bool, detail: str = ""):
        ran.append(rid)
        if not cond:
            raise TckViolation(rid, detail)

    def harness():
        """TestSource -> flow -> TestSink with both probes."""
        return TestSource.probe().via_mat(flow_factory(), Keep.left) \
            .to_mat(TestSink.probe(), Keep.both).run(system)

    # 2.01: demand propagates upstream
    up, down = harness()
    down.request(2)
    req = up.expect_request()
    rule("2.01", req >= 1, f"no upstream demand, got {req}")

    # 2.02: elements pass through in order
    for i in range(3):
        up.send_next(i)
    down.request(8)
    first = [down.expect_next() for _ in range(3)]
    rule("2.02", first == [0, 1, 2], f"reordered: {first}")

    # 2.03: upstream completion propagates (after in-flight elements)
    up.send_next(99)
    up.send_complete()
    rule("2.03", down.expect_next() == 99, "in-flight element lost")
    down.expect_complete()

    # 2.04: upstream error propagates
    up2, down2 = harness()
    down2.request(4)
    up2.expect_request()
    up2.send_next(1)
    down2.expect_next()
    up2.send_error(ValueError("tck"))
    err = down2.expect_error()
    rule("2.04", isinstance(err, ValueError), f"wrong error: {err!r}")

    # 2.05: downstream cancel propagates upstream
    up3, down3 = harness()
    down3.request(1)
    up3.expect_request()
    down3.cancel()
    try:
        up3.expect_cancellation()
        rule("2.05", True)
    except AssertionError as e:
        raise TckViolation("2.05", f"cancel never reached upstream: {e}") \
            from e
    return ran
