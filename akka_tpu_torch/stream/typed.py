"""Stream ↔ typed-actor interop.

A copy of `akka_tpu/stream/typed.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream-typed/src/main/scala/akka/stream/typed/
scaladsl/ActorSource.scala & ActorSink.scala — ActorSource.actorRef (mat an
ActorRef fed into the stream, complete/fail match functions),
ActorSink.actorRef (elements as messages + onComplete message),
ActorSink.actorRefWithBackpressure (ack-based: the actor replies with an
ack message before the next element is sent).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..actor.ref import ActorRef
from .dsl import Sink, Source
from .stage import (GraphStage, GraphStageLogic, Inlet, SinkShape,
                    make_in_handler)


class ActorSource:
    @staticmethod
    def actor_ref(complete_matcher: Callable[[Any], bool],
                  failure_matcher: Callable[[Any], Optional[BaseException]],
                  buffer_size: int = 256) -> Source:
        """Messages to the mat ActorRef stream out; a message matching
        `complete_matcher` completes, `failure_matcher` returning an
        exception fails."""
        from ..actor.messages import Status

        base = Source.actor_ref(buffer_size)

        def adapt(b):
            outlet, lazy_ref = base._build(b)

            class _AdaptedRef:
                def tell(self, msg, sender=None):
                    ex = failure_matcher(msg)
                    if ex is not None:
                        lazy_ref.tell(Status.Failure(ex), sender)
                    elif complete_matcher(msg):
                        lazy_ref.tell(Status.Success(), sender)
                    else:
                        lazy_ref.tell(msg, sender)

                @property
                def ref(self):
                    return lazy_ref.ref
            return outlet, _AdaptedRef()
        return Source(adapt)


@dataclass(frozen=True)
class _AckReceived:
    pass


class _AckedActorSink(GraphStage):
    """Ack-based backpressure: wait for `ack_message` from the target before
    pulling the next element (reference: ActorSink.actorRefWithBackpressure)."""

    def __init__(self, ref: ActorRef, message_adapter, on_init_message,
                 ack_message, on_complete_message, on_failure_message):
        self.name = "AckedActorSink"
        self.ref = ref
        self.message_adapter = message_adapter
        self.on_init_message = on_init_message
        self.ack_message = ack_message
        self.on_complete_message = on_complete_message
        self.on_failure_message = on_failure_message
        self.in_ = Inlet("AckedActorSink.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        stage = self
        in_ = self.in_

        class _L(GraphStageLogic):
            def pre_start(self):
                from ..actor.props import Props
                system = self.materializer.system
                cb = self.get_async_callback(lambda _: self._on_ack())

                def receive(_ctx, msg):
                    if msg == stage.ack_message or stage.ack_message is None:
                        cb.invoke(None)
                self._ack_ref = system.actor_of(Props.from_receive(receive))
                if stage.on_init_message is not None:
                    stage.ref.tell(stage.on_init_message(self._ack_ref)
                                   if callable(stage.on_init_message)
                                   else stage.on_init_message, self._ack_ref)
                else:
                    self.pull(in_)

            def _on_ack(self):
                if not self.has_been_pulled(in_) and not self.is_closed(in_):
                    self.pull(in_)

            def post_stop(self):
                self.materializer.system.stop(self._ack_ref)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            msg = stage.message_adapter(logic._ack_ref, elem) \
                if stage.message_adapter else elem
            stage.ref.tell(msg, logic._ack_ref)
            # next pull happens on ack

        def on_finish():
            if stage.on_complete_message is not None:
                stage.ref.tell(stage.on_complete_message, None)
            logic.complete_stage()

        def on_failure(ex):
            if stage.on_failure_message is not None:
                stage.ref.tell(stage.on_failure_message(ex), None)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, None


class ActorSink:
    @staticmethod
    def actor_ref(ref: ActorRef, on_complete_message: Any,
                  on_failure_message: Optional[Callable] = None) -> Sink:
        return Sink.actor_ref(ref, on_complete_message, on_failure_message)

    @staticmethod
    def actor_ref_with_backpressure(
            ref: ActorRef, message_adapter: Callable[[ActorRef, Any], Any],
            on_init_message: Any, ack_message: Any,
            on_complete_message: Any,
            on_failure_message: Optional[Callable] = None) -> Sink:
        return Sink.from_graph(lambda: _AckedActorSink(
            ref, message_adapter, on_init_message, ack_message,
            on_complete_message, on_failure_message))
