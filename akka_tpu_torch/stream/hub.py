"""Hubs: dynamic fan-in/fan-out across independent materializations.

A copy of `akka_tpu/stream/hub.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/scaladsl/Hub.scala —
MergeHub.source materializes a Sink that MANY producer streams can attach to
at runtime; BroadcastHub.sink materializes a Source that MANY consumer
streams can attach to (slowest-consumer backpressure over a bounded buffer).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional

from .stage import (GraphStage, GraphStageLogic, Inlet, Outlet, SinkShape,
                    SourceShape, make_in_handler, make_out_handler)


# ============================== MergeHub ====================================

class _MergeHubState:
    """Shared between the hub source stage and attached producer sinks."""

    def __init__(self, per_producer_buffer: int):
        self.lock = threading.Lock()
        self.buffer_size = per_producer_buffer
        self.buf: collections.deque = collections.deque()
        self.waiting_producers: collections.deque = collections.deque()
        self.consumer_cb = None      # async callback into the hub source
        self.closed = False


class _MergeHubSource(GraphStage):
    def __init__(self, state: _MergeHubState):
        self.name = "MergeHubSource"
        self.state = state
        self.out = Outlet("MergeHub.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        st, out = self.state, self.out

        class _L(GraphStageLogic):
            def pre_start(self):
                with st.lock:
                    st.consumer_cb = self.get_async_callback(self._wakeup)

            def _wakeup(self, _):
                self._try_emit()

            def _try_emit(self):
                while self.is_available(out):
                    with st.lock:
                        if not st.buf:
                            return
                        elem = st.buf.popleft()
                        resume = None
                        if st.waiting_producers:
                            resume = st.waiting_producers.popleft()
                    self.push(out, elem)
                    if resume is not None:
                        resume.invoke(None)

            def post_stop(self):
                with st.lock:
                    st.closed = True
                    waiting = list(st.waiting_producers)
                    st.waiting_producers.clear()
                for w in waiting:
                    w.invoke(None)
        logic = _L(self._shape)
        logic.set_handler(out, make_out_handler(
            lambda: logic._try_emit(),
            lambda cause=None: logic.post_stop() or logic.cancel_stage(cause)))
        return logic


class _MergeHubSink(GraphStage):
    def __init__(self, state: _MergeHubState):
        self.name = "MergeHubSink"
        self.state = state
        self.in_ = Inlet("MergeHub.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        st, in_ = self.state, self.in_

        class _L(GraphStageLogic):
            def pre_start(self):
                self._resume_cb = self.get_async_callback(
                    lambda _: self._resume())
                self.pull(in_)

            def _resume(self):
                with st.lock:
                    closed = st.closed
                if closed:
                    self.complete_stage()
                elif not self.has_been_pulled(in_) and \
                        not self.is_closed(in_):
                    self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            wake = None
            with st.lock:
                if st.closed:
                    pass  # consumer gone: drop + complete below
                else:
                    st.buf.append(elem)
                    wake = st.consumer_cb
                    if len(st.buf) >= st.buffer_size:
                        st.waiting_producers.append(logic._resume_cb)
                        if wake is not None:
                            wake.invoke(None)
                        return  # backpressure this producer
            if st.closed:
                logic.complete_stage()
                return
            if wake is not None:
                wake.invoke(None)
            logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        return logic


class MergeHub:
    @staticmethod
    def source(per_producer_buffer_size: int = 16):
        """Source whose mat value is a reusable Sink producers attach to."""
        from .dsl import Sink, Source

        def build(b):
            state = _MergeHubState(per_producer_buffer_size)
            logic, _ = b.add(_MergeHubSource(state))
            attach_sink = Sink.from_graph(lambda: _MergeHubSink(state))
            return logic.shape.outlets[0], attach_sink
        return Source(build)


# ============================= BroadcastHub =================================

class _BroadcastHubState:
    def __init__(self, buffer_size: int):
        self.lock = threading.Lock()
        self.buffer_size = buffer_size
        self.consumers: List["_ConsumerSlot"] = []
        self.pending: collections.deque = collections.deque()  # pre-consumer
        self.upstream_cb = None
        self.done = None  # ("complete",) | ("fail", ex)


class _ConsumerSlot:
    def __init__(self, cb):
        self.cb = cb  # async callback into the consumer source stage
        self.buf: collections.deque = collections.deque()


class _BroadcastHubSink(GraphStage):
    def __init__(self, state: _BroadcastHubState):
        self.name = "BroadcastHubSink"
        self.state = state
        self.in_ = Inlet("BcastHub.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        st, in_ = self.state, self.in_

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)
                with st.lock:
                    st.upstream_cb = self.get_async_callback(
                        lambda _: self._maybe_pull())
                self.pull(in_)

            def _maybe_pull(self):
                with st.lock:
                    room = all(len(c.buf) < st.buffer_size
                               for c in st.consumers) \
                        and len(st.pending) < st.buffer_size
                if room and not self.has_been_pulled(in_) and \
                        not self.is_closed(in_):
                    self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            wakes = []
            with st.lock:
                if st.consumers:
                    for c in st.consumers:
                        c.buf.append(elem)
                        wakes.append(c.cb)
                    room = all(len(c.buf) < st.buffer_size
                               for c in st.consumers)
                else:
                    st.pending.append(elem)
                    room = len(st.pending) < st.buffer_size
            for w in wakes:
                w.invoke(None)
            if room:
                logic.pull(in_)
            # else: slowest consumer backpressures; resumed via upstream_cb

        def on_finish():
            wakes = []
            with st.lock:
                st.done = ("complete",)
                wakes = [c.cb for c in st.consumers]
            for w in wakes:
                w.invoke(None)
            logic.set_keep_going(False)
            logic.complete_stage()

        def on_failure(ex):
            wakes = []
            with st.lock:
                st.done = ("fail", ex)
                wakes = [c.cb for c in st.consumers]
            for w in wakes:
                w.invoke(None)
            logic.set_keep_going(False)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic


class _BroadcastHubSource(GraphStage):
    def __init__(self, state: _BroadcastHubState):
        self.name = "BroadcastHubSource"
        self.state = state
        self.out = Outlet("BcastHub.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        st, out = self.state, self.out
        slot_holder: Dict[str, _ConsumerSlot] = {}

        class _L(GraphStageLogic):
            def pre_start(self):
                slot = _ConsumerSlot(self.get_async_callback(
                    lambda _: self._deliver()))
                slot_holder["slot"] = slot
                with st.lock:
                    # late joiner takes over any pre-consumer backlog once
                    if not st.consumers and st.pending:
                        slot.buf.extend(st.pending)
                        st.pending.clear()
                    st.consumers.append(slot)

            def _deliver(self):
                slot = slot_holder["slot"]
                pulled_upstream = None
                while self.is_available(out):
                    with st.lock:
                        if not slot.buf:
                            break
                        elem = slot.buf.popleft()
                        pulled_upstream = st.upstream_cb
                    self.push(out, elem)
                with st.lock:
                    done = st.done if not slot.buf else None
                if done is not None:
                    if done[0] == "complete":
                        self.complete(out)
                    else:
                        self.fail(out, done[1])
                    return
                if pulled_upstream is not None:
                    pulled_upstream.invoke(None)

            def post_stop(self):
                with st.lock:
                    slot = slot_holder.get("slot")
                    if slot in st.consumers:
                        st.consumers.remove(slot)
                    cb = st.upstream_cb
                if cb is not None:
                    cb.invoke(None)  # fewer consumers: maybe unblock
        logic = _L(self._shape)
        logic.set_handler(out, make_out_handler(lambda: logic._deliver()))
        return logic


class BroadcastHub:
    @staticmethod
    def sink(buffer_size: int = 256):
        """Sink whose mat value is a reusable Source consumers attach to."""
        from .dsl import Sink, Source

        def build(b, upstream):
            state = _BroadcastHubState(buffer_size)
            logic, _ = b.add(_BroadcastHubSink(state))
            b.connect(upstream, logic.shape.inlets[0])
            attach_source = Source.from_graph(
                lambda: _BroadcastHubSource(state))
            return attach_source
        return Sink(build)


# ============================= PartitionHub =================================

class ConsumerInfo:
    """View handed to a stateful partitioner (reference: Hub.scala
    PartitionHub.ConsumerInfo): registered consumer ids in attach order,
    plus per-consumer queue sizes for load-aware routing. Valid only for
    the duration of the partitioner call (it reads the live registry,
    which the hub lock protects during routing — no per-element copies)."""

    __slots__ = ("_order", "_consumers")

    def __init__(self, order, consumers):
        self._order = order
        self._consumers = consumers

    @property
    def consumer_ids(self):
        return tuple(self._order)

    @property
    def size(self) -> int:
        return len(self._order)

    def queue_size(self, consumer_id: int) -> int:
        slot = self._consumers.get(consumer_id)
        return len(slot.buf) if slot is not None else 0

    def consumer_id_by_idx(self, idx: int) -> int:
        return self._order[idx]


class _PartitionHubState:
    def __init__(self, buffer_size: int, start_after: int):
        self.lock = threading.Lock()
        self.buffer_size = buffer_size
        self.start_after = start_after
        self.consumers: Dict[int, _ConsumerSlot] = {}
        self.order: List[int] = []          # attach order (consumerIdByIdx)
        self.next_id = 0
        self.upstream_cb = None
        self.done = None                    # ("complete",) | ("fail", ex)
        self.stash = None                   # (target_id, elem) awaiting room
        self.done_pending = None            # completion awaiting stash flush
        self.started = False                # start_after gate passed once

    def info(self) -> ConsumerInfo:
        # called under lock; the view reads the live registry lazily
        return ConsumerInfo(self.order, self.consumers)


class _PartitionHubSink(GraphStage):
    def __init__(self, state: _PartitionHubState, partitioner):
        self.name = "PartitionHubSink"
        self.state = state
        self.partitioner = partitioner      # (ConsumerInfo, elem) -> id
        self.in_ = Inlet("PartitionHub.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):  # noqa: C901
        st, in_, partitioner = self.state, self.in_, self.partitioner

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)
                with st.lock:
                    st.upstream_cb = self.get_async_callback(
                        lambda _: self._maybe_pull())
                    st.started = st.started or \
                        len(st.order) >= st.start_after
                    ready = st.started
                if ready:
                    self.pull(in_)
                # else: the start_after'th consumer's registration wakes us

            def _maybe_pull(self):
                """Woken on consumer attach/detach/drain: flush a stashed
                element whose target now has room (or vanished), start
                pulling once start_after consumers registered, and finish a
                deferred completion once the stash is flushed."""
                wake = None
                with st.lock:
                    # the gate is an INITIAL gate only: once passed it never
                    # re-engages when consumers later drop below the
                    # threshold (the reference's RegistrationPending model)
                    if not st.started:
                        if len(st.order) < st.start_after:
                            return
                        st.started = True
                    if st.stash is not None:
                        target, elem = st.stash
                        slot = st.consumers.get(target)
                        if slot is None:
                            st.stash = None      # target left: element drops
                        elif len(slot.buf) < st.buffer_size:
                            st.stash = None
                            slot.buf.append(elem)
                            wake = slot.cb
                        else:
                            return               # still blocked
                if wake is not None:
                    wake.invoke(None)
                if st.done_pending is not None:
                    self._finalize()             # stash flushed: finish now
                    return
                if not self.has_been_pulled(in_) and not self.is_closed(in_):
                    self.pull(in_)

            def _finalize(self):
                with st.lock:
                    st.done = st.done_pending or ("complete",)
                    wakes = [c.cb for c in st.consumers.values()]
                for w in wakes:
                    w.invoke(None)
                self.set_keep_going(False)
                self.complete_stage()
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            wake = None
            blocked = False
            try:
                with st.lock:
                    target = partitioner(st.info(), elem)
            except Exception as ex:  # noqa: BLE001 — user partitioner threw:
                on_failure(ex)       # consumers must see the failure too
                return
            with st.lock:
                slot = st.consumers.get(target)
                if slot is not None:
                    if len(slot.buf) < st.buffer_size:
                        slot.buf.append(elem)
                        wake = slot.cb
                    else:
                        # chosen consumer is full: backpressure upstream
                        # until ITS queue drains (reference PartitionHub
                        # blocks only on the targeted queue)
                        st.stash = (target, elem)
                        wake = slot.cb
                        blocked = True
                # unknown id: element dropped (reference contract)
            if wake is not None:
                wake.invoke(None)
            if not blocked:
                logic.pull(in_)

        def on_finish():
            with st.lock:
                st.done_pending = ("complete",)
                stash = st.stash
                wakes = [c.cb for c in st.consumers.values()]
            if stash is None:
                logic._finalize()
                return
            # a stashed element is still owed to a full consumer: stay
            # alive (keep_going) until its drain wakes _maybe_pull, which
            # flushes the stash and finalizes
            for w in wakes:
                w.invoke(None)

        def on_failure(ex):
            with st.lock:
                st.done = ("fail", ex)
                st.stash = None
                wakes = [c.cb for c in st.consumers.values()]
            for w in wakes:
                w.invoke(None)
            logic.set_keep_going(False)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic


class _PartitionHubSource(GraphStage):
    def __init__(self, state: _PartitionHubState):
        self.name = "PartitionHubSource"
        self.state = state
        self.out = Outlet("PartitionHub.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        st, out = self.state, self.out
        holder: Dict[str, Any] = {}

        class _L(GraphStageLogic):
            def pre_start(self):
                slot = _ConsumerSlot(self.get_async_callback(
                    lambda _: self._deliver()))
                with st.lock:
                    cid = st.next_id
                    st.next_id += 1
                    st.consumers[cid] = slot
                    st.order.append(cid)
                    cb = st.upstream_cb
                holder["slot"], holder["id"] = slot, cid
                if cb is not None:
                    cb.invoke(None)  # may be the start_after'th consumer

            def _deliver(self):
                slot = holder["slot"]
                drained = False
                while self.is_available(out):
                    with st.lock:
                        if not slot.buf:
                            break
                        elem = slot.buf.popleft()
                        drained = True
                    self.push(out, elem)
                with st.lock:
                    done = st.done if not slot.buf else None
                    cb = st.upstream_cb
                if done is not None:
                    if done[0] == "complete":
                        self.complete(out)
                    else:
                        self.fail(out, done[1])
                    return
                if drained and cb is not None:
                    cb.invoke(None)  # room again: unblock a stashed element

            def post_stop(self):
                with st.lock:
                    cid = holder.get("id")
                    st.consumers.pop(cid, None)
                    if cid in st.order:
                        st.order.remove(cid)
                    cb = st.upstream_cb
                if cb is not None:
                    cb.invoke(None)  # a stash targeting us must not wedge
        logic = _L(self._shape)
        logic.set_handler(out, make_out_handler(lambda: logic._deliver()))
        return logic


class PartitionHub:
    """(reference: Hub.scala:737 PartitionHub)"""

    @staticmethod
    def stateful_sink(partitioner_factory, start_after_nr_of_consumers: int = 0,
                      buffer_size: int = 256):
        """Sink whose mat is a reusable Source; `partitioner_factory()`
        yields a fresh `(ConsumerInfo, elem) -> consumer_id` per
        materialization of the sink. Elements routed to an unknown id are
        dropped; upstream is not pulled until start_after consumers
        attached; the targeted consumer's full queue backpressures."""
        from .dsl import Sink, Source

        def build(b, upstream):
            state = _PartitionHubState(buffer_size,
                                       start_after_nr_of_consumers)
            logic, _ = b.add(_PartitionHubSink(state, partitioner_factory()))
            b.connect(upstream, logic.shape.inlets[0])
            return Source.from_graph(lambda: _PartitionHubSource(state))
        return Sink(build)

    @staticmethod
    def sink(partitioner, start_after_nr_of_consumers: int = 1,
             buffer_size: int = 256):
        """Stateless variant: `partitioner(size, elem) -> index` into the
        consumers in attach order (reference PartitionHub.sink). Defaults
        to waiting for one consumer (an index partitioner is meaningless
        against zero consumers); if every consumer later detaches,
        elements are dropped until one re-attaches."""
        def factory():
            def route(info: ConsumerInfo, elem):
                if info.size == 0:
                    return -1  # no consumers: unknown id -> drop
                idx = partitioner(info.size, elem)
                if not 0 <= idx < info.size:
                    # out of range is a user bug either way: fail loudly
                    # rather than letting Python's negative indexing
                    # silently misroute to the last-attached consumer
                    raise IndexError(
                        f"PartitionHub partitioner returned index {idx} "
                        f"outside [0, {info.size})")
                return info.consumer_id_by_idx(idx)
            return route
        return PartitionHub.stateful_sink(
            factory, start_after_nr_of_consumers, buffer_size)
