"""GraphStage API: user-definable stream operators.

A copy of `akka_tpu/stream/stage.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/stage/
GraphStage.scala — GraphStageLogic with per-port InHandler/OutHandler,
pull/push/grab/complete/fail/cancel, completeStage/failStage, emit,
AsyncCallback (getAsyncCallback), timers (TimerGraphStageLogic); Shape/
Inlet/Outlet from akka-stream/src/main/scala/akka/stream/Shape.scala.

The port-state machine semantics these helpers enforce are the interpreter's
(see interpreter.py, mirroring impl/fusing/GraphInterpreter.scala:154-198).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_port_ids = itertools.count()


class Inlet:
    __slots__ = ("name", "id")

    def __init__(self, name: str = "in"):
        self.name = name
        self.id = next(_port_ids)

    def __repr__(self):
        return f"Inlet({self.name})"


class Outlet:
    __slots__ = ("name", "id")

    def __init__(self, name: str = "out"):
        self.name = name
        self.id = next(_port_ids)

    def __repr__(self):
        return f"Outlet({self.name})"


class Shape:
    """(reference: stream/Shape.scala)"""

    def __init__(self, inlets: Sequence[Inlet], outlets: Sequence[Outlet]):
        self.inlets = list(inlets)
        self.outlets = list(outlets)


class SourceShape(Shape):
    def __init__(self, out: Outlet):
        super().__init__([], [out])
        self.out = out


class SinkShape(Shape):
    def __init__(self, in_: Inlet):
        super().__init__([in_], [])
        self.in_ = in_


class FlowShape(Shape):
    def __init__(self, in_: Inlet, out: Outlet):
        super().__init__([in_], [out])
        self.in_ = in_
        self.out = out


class FanInShape(Shape):
    def __init__(self, ins: Sequence[Inlet], out: Outlet):
        super().__init__(list(ins), [out])
        self.ins = list(ins)
        self.out = out


class FanOutShape(Shape):
    def __init__(self, in_: Inlet, outs: Sequence[Outlet]):
        super().__init__([in_], list(outs))
        self.in_ = in_
        self.outs = list(outs)


class InHandler:
    """(reference: stage/GraphStage.scala InHandler)"""

    def on_push(self) -> None:
        raise NotImplementedError

    def on_upstream_finish(self) -> None:
        self._logic.complete_stage()  # type: ignore[attr-defined]

    def on_upstream_failure(self, ex: BaseException) -> None:
        self._logic.fail_stage(ex)  # type: ignore[attr-defined]


class OutHandler:
    """(reference: stage/GraphStage.scala OutHandler)"""

    def on_pull(self) -> None:
        raise NotImplementedError

    def on_downstream_finish(self, cause: Optional[BaseException] = None) -> None:
        self._logic.cancel_stage(cause)  # type: ignore[attr-defined]


def make_in_handler(on_push: Callable[[], None],
                    on_upstream_finish: Optional[Callable[[], None]] = None,
                    on_upstream_failure: Optional[
                        Callable[[BaseException], None]] = None) -> InHandler:
    h = InHandler()
    h.on_push = on_push  # type: ignore[method-assign]
    if on_upstream_finish is not None:
        h.on_upstream_finish = on_upstream_finish  # type: ignore[method-assign]
    if on_upstream_failure is not None:
        h.on_upstream_failure = on_upstream_failure  # type: ignore[method-assign]
    return h


def make_out_handler(on_pull: Callable[[], None],
                     on_downstream_finish: Optional[
                         Callable[[Optional[BaseException]], None]] = None
                     ) -> OutHandler:
    h = OutHandler()
    h.on_pull = on_pull  # type: ignore[method-assign]
    if on_downstream_finish is not None:
        h.on_downstream_finish = on_downstream_finish  # type: ignore[method-assign]
    return h


class AsyncCallback:
    """Thread-safe entry back into the stream (reference:
    GraphStageLogic.getAsyncCallback). invoke() may be called from any
    thread; the handler runs inside the interpreter."""

    def __init__(self, interpreter, logic, handler: Callable[[Any], None]):
        self._interpreter = interpreter
        self._logic = logic
        self._handler = handler

    def invoke(self, event: Any = None) -> None:
        # resolve lazily: a callback created inside create_logic (before the
        # logic is wired into an interpreter) must still work at runtime
        interp = self._interpreter if self._interpreter is not None \
            else self._logic.interpreter
        interp.enqueue_async(self._logic, self._handler, event)


class GraphStageLogic:
    """Per-materialization mutable operator state + port operations."""

    def __init__(self, shape: Shape):
        self.shape = shape
        self.handlers: Dict[int, Any] = {}
        self.interpreter = None  # set at materialization
        self._emit_queues: Dict[int, List[Any]] = {}
        self._closed = False
        self._keep_going = False
        # stamped by the graph's _Builder from the enclosing
        # with_attributes section (Attributes.scala analogue); consulted
        # by the interpreter for the supervision decider
        self.attributes = None
        # stages with accumulated state set this to a zero-state reset
        # callback; the Supervision.restart directive invokes it (the
        # reference's restart recreating operator state, Ops.scala Scan etc.)
        self.restart_state: Optional[Callable[[], None]] = None

    # -- wiring ---------------------------------------------------------------
    def set_handler(self, port, handler) -> None:
        handler._logic = self
        self.handlers[port.id] = handler

    def in_handler(self, inlet: Inlet) -> InHandler:
        return self.handlers[inlet.id]

    def out_handler(self, outlet: Outlet) -> OutHandler:
        return self.handlers[outlet.id]

    # -- lifecycle hooks ------------------------------------------------------
    def pre_start(self) -> None:
        pass

    def post_stop(self) -> None:
        pass

    # -- port ops (delegate to the interpreter's port-state machine) ---------
    def pull(self, inlet: Inlet) -> None:
        self.interpreter.pull(self, inlet)

    def push(self, outlet: Outlet, elem: Any) -> None:
        q = self._emit_queues.get(outlet.id)
        if q:
            q.append(elem)  # keep emit order
            return
        self.interpreter.push(self, outlet, elem)

    def grab(self, inlet: Inlet) -> Any:
        return self.interpreter.grab(self, inlet)

    def is_available(self, port) -> bool:
        return self.interpreter.is_available(self, port)

    def has_been_pulled(self, inlet: Inlet) -> bool:
        return self.interpreter.has_been_pulled(self, inlet)

    def is_closed(self, port) -> bool:
        return self.interpreter.is_port_closed(self, port)

    def complete(self, outlet: Outlet) -> None:
        q = self._emit_queues.get(outlet.id)
        if q:
            q.append("__COMPLETE__")  # in place: _drain_emit may be iterating
            return
        self.interpreter.complete(self, outlet)

    def fail(self, outlet: Outlet, ex: BaseException) -> None:
        self.interpreter.fail(self, outlet, ex)

    def cancel(self, inlet: Inlet, cause: Optional[BaseException] = None) -> None:
        self.interpreter.cancel(self, inlet, cause)

    def complete_stage(self) -> None:
        for inlet in self.shape.inlets:
            if not self.is_closed(inlet):
                self.cancel(inlet)
        for outlet in self.shape.outlets:
            if not self.is_closed(outlet):
                self.complete(outlet)

    def fail_stage(self, ex: BaseException) -> None:
        for inlet in self.shape.inlets:
            if not self.is_closed(inlet):
                self.cancel(inlet, ex)
        for outlet in self.shape.outlets:
            if not self.is_closed(outlet):
                self.fail(outlet, ex)

    def cancel_stage(self, cause: Optional[BaseException] = None) -> None:
        if cause is None:
            self.complete_stage()
        else:
            self.fail_stage(cause)

    # -- emit: push now or as soon as pulled (reference: emit/emitMultiple) --
    def emit(self, outlet: Outlet, elem: Any,
             and_then: Optional[Callable[[], None]] = None) -> None:
        if self.is_available(outlet) and not self._emit_queues.get(outlet.id):
            self.interpreter.push(self, outlet, elem)
            if and_then is not None:
                and_then()
        else:
            self._emit_queues.setdefault(outlet.id, []).append(elem)
            if and_then is not None:
                self._emit_queues[outlet.id].append(("__THEN__", and_then))

    def emit_multiple(self, outlet: Outlet, elems,
                      and_then: Optional[Callable[[], None]] = None) -> None:
        elems = list(elems)
        if not elems:
            if and_then is not None:
                and_then()
            return
        for e in elems:
            self.emit(outlet, e)
        if and_then is not None:
            self._emit_queues.setdefault(outlet.id, []).append(
                ("__THEN__", and_then))

    def _drain_emit(self, outlet: Outlet) -> bool:
        """Called by the interpreter on pull; returns True if it pushed."""
        q = self._emit_queues.get(outlet.id)
        while q:
            head = q.pop(0)
            if head == "__COMPLETE__":
                self.interpreter.complete(self, outlet)
                return True
            if isinstance(head, tuple) and len(head) == 2 and \
                    head[0] == "__THEN__":
                head[1]()
                continue
            self.interpreter.push(self, outlet, head)
            return True
        return False

    def has_pending_emits(self, outlet: Outlet) -> bool:
        return bool(self._emit_queues.get(outlet.id))

    # -- async + timers -------------------------------------------------------
    def get_async_callback(self, handler: Callable[[Any], None]
                           ) -> AsyncCallback:
        return AsyncCallback(self.interpreter, self, handler)

    def schedule_once(self, key: Any, delay: float) -> None:
        self.interpreter.schedule_timer(self, key, delay, repeat=None)

    def schedule_periodically(self, key: Any, initial: float,
                              interval: float) -> None:
        self.interpreter.schedule_timer(self, key, initial, repeat=interval)

    def cancel_timer(self, key: Any) -> None:
        self.interpreter.cancel_timer(self, key)

    def on_timer(self, key: Any) -> None:
        """Override for timer callbacks (reference: TimerGraphStageLogic)."""

    # -- keep-going (stage alive with all ports closed) ----------------------
    def set_keep_going(self, enabled: bool) -> None:
        self._keep_going = enabled

    @property
    def materializer(self):
        return self.interpreter.materializer


class GraphStage:
    """A reusable blueprint: shape + create_logic (reference:
    stage/GraphStage.scala GraphStageWithMaterializedValue)."""

    name = "stage"

    @property
    def shape(self) -> Shape:
        raise NotImplementedError

    def create_logic_and_mat(self) -> Tuple[GraphStageLogic, Any]:
        return self.create_logic(), None

    def create_logic(self) -> GraphStageLogic:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"
