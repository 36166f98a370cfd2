"""Stream Attributes + per-element supervision (reference parity:
akka-stream/src/main/scala/akka/stream/Attributes.scala — an immutable
heterogeneous list of attribute values attached to a graph section, with
`and` composition where the most specific (innermost/latest) wins; and
Supervision.scala — Decider: Throwable => Directive with resume/restart/
stop, honored per element by the interpreter rather than per-operator
try/catch as in Ops.scala, which is the same contract centralized).

A copy of `akka_tpu/stream/attributes.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Usage (scaladsl `withAttributes(supervisionStrategy(resumingDecider))`):

    flow.map(f).with_attributes(
        Attributes.supervision_strategy(Supervision.resuming_decider))

Attributes apply to every stage built by the wrapped section only —
operators appended AFTER with_attributes are outside it, exactly like the
reference's section scoping (Attributes.scala:662 supervisionStrategy).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple


class Supervision:
    """Directives + canned deciders (reference: stream/Supervision.scala).

    stop    — tear the stream down (default; fail downstream/cancel upstream)
    resume  — drop the failing element and keep the stream running
    restart — drop the element AND reset the failing stage's accumulated
              state (stages expose reset via GraphStageLogic.restart_state;
              stages without one resume — mirroring the reference where
              restart is meaningful only for stages that declare state)
    """

    stop = "stop"
    resume = "resume"
    restart = "restart"

    Decider = Callable[[BaseException], str]

    @staticmethod
    def stopping_decider(ex: BaseException) -> str:  # noqa: ARG004
        return Supervision.stop

    @staticmethod
    def resuming_decider(ex: BaseException) -> str:  # noqa: ARG004
        return Supervision.resume

    @staticmethod
    def restarting_decider(ex: BaseException) -> str:  # noqa: ARG004
        return Supervision.restart


class Attributes:
    """Immutable attribute bag. Keys are strings; `and_then` (the
    reference's `and`) layers another bag on top with the NEW values
    winning — the interpreter reads the effective (topmost) value."""

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = dict(values or {})

    # -- composition ---------------------------------------------------------
    def and_then(self, other: "Attributes") -> "Attributes":
        merged = dict(self._values)
        merged.update(other._values)
        return Attributes(merged)

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def __repr__(self) -> str:
        return f"Attributes({self._values!r})"

    # -- well-known attributes (reference: Attributes object) ---------------
    @staticmethod
    def name(n: str) -> "Attributes":
        return Attributes({"name": n})

    @staticmethod
    def supervision_strategy(decider: "Supervision.Decider") -> "Attributes":
        """(reference: ActorAttributes.supervisionStrategy /
        Attributes.scala:662)"""
        return Attributes({"supervision_decider": decider})

    @staticmethod
    def input_buffer(initial: int, max_: int) -> "Attributes":
        return Attributes({"input_buffer": (initial, max_)})

    @staticmethod
    def dispatcher(name: str) -> "Attributes":
        """(reference: ActorAttributes.dispatcher — which dispatcher the
        island's interpreter actor runs on)"""
        return Attributes({"dispatcher": name})

    @staticmethod
    def log_levels(on_element: str = "debug", on_finish: str = "debug",
                   on_failure: str = "error") -> "Attributes":
        return Attributes({"log_levels": (on_element, on_finish, on_failure)})

    # -- effective lookups ---------------------------------------------------
    def effective_decider(self) -> "Supervision.Decider":
        return self._values.get("supervision_decider",
                                Supervision.stopping_decider)

    def effective_input_buffer(self,
                               default: Tuple[int, int] = (16, 16)
                               ) -> Tuple[int, int]:
        return self._values.get("input_buffer", default)


def effective_decider_of(logic) -> "Supervision.Decider":
    """The decider the interpreter consults for a failing stage: the
    stage's stamped attributes, else stop (reference default)."""
    attrs = getattr(logic, "attributes", None)
    if attrs is None:
        return Supervision.stopping_decider
    return attrs.effective_decider()
