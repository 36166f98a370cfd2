"""Kill switches: external stream termination.

A copy of `akka_tpu/stream/killswitch.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/KillSwitch.scala —
UniqueKillSwitch (one materialization, via KillSwitches.single) and
SharedKillSwitch (many materializations share one switch).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from .stage import (FlowShape, GraphStage, GraphStageLogic, Inlet, Outlet,
                    make_in_handler, make_out_handler)


class UniqueKillSwitch:
    def __init__(self):
        self._cb = None
        self._lock = threading.Lock()
        self._pending = None  # buffered shutdown/abort before bind

    def _bind(self, cb) -> None:
        with self._lock:
            self._cb = cb
            pending = self._pending
        if pending is not None:
            cb.invoke(pending)

    def shutdown(self) -> None:
        with self._lock:
            if self._cb is None:
                self._pending = ("shutdown", None)
                return
        self._cb.invoke(("shutdown", None))

    def abort(self, ex: BaseException) -> None:
        with self._lock:
            if self._cb is None:
                self._pending = ("abort", ex)
                return
        self._cb.invoke(("abort", ex))


class SharedKillSwitch:
    def __init__(self, name: str = "shared"):
        self.name = name
        self._lock = threading.Lock()
        self._switches: List[UniqueKillSwitch] = []
        self._terminated = None  # ("shutdown", None) | ("abort", ex)

    def _register(self, switch: UniqueKillSwitch) -> None:
        with self._lock:
            if self._terminated is not None:
                kind, ex = self._terminated
            else:
                self._switches.append(switch)
                return
        if kind == "shutdown":
            switch.shutdown()
        else:
            switch.abort(ex)

    def shutdown(self) -> None:
        with self._lock:
            self._terminated = ("shutdown", None)
            switches = list(self._switches)
        for s in switches:
            s.shutdown()

    def abort(self, ex: BaseException) -> None:
        with self._lock:
            self._terminated = ("abort", ex)
            switches = list(self._switches)
        for s in switches:
            s.abort(ex)

    @property
    def flow(self) -> "object":
        """A Flow stage joining this shared switch (reference:
        SharedKillSwitch.flow)."""
        from .dsl import Flow
        shared = self

        def factory():
            stage = KillSwitchStage()
            shared._register(stage.switch)
            return stage
        return Flow.from_graph(factory)


class KillSwitchStage(GraphStage):
    """Pass-through until the switch fires (reference: KillSwitches.single)."""

    def __init__(self):
        self.name = "KillSwitch"
        self.in_ = Inlet("KillSwitch.in")
        self.out = Outlet("KillSwitch.out")
        self._shape = FlowShape(self.in_, self.out)
        self.switch = UniqueKillSwitch()

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        in_, out, switch = self.in_, self.out, self.switch

        class _L(GraphStageLogic):
            def pre_start(self):
                switch._bind(self.get_async_callback(self._on_kill))

            def _on_kill(self, cmd):
                kind, ex = cmd
                if kind == "shutdown":
                    self.complete_stage()
                else:
                    self.fail_stage(ex)
        logic = _L(self._shape)
        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_))))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic, switch


class KillSwitches:
    @staticmethod
    def single():
        """Flow materializing a UniqueKillSwitch (use with Keep.right)."""
        from .dsl import Flow
        return Flow.from_graph(KillSwitchStage)

    @staticmethod
    def shared(name: str = "shared") -> SharedKillSwitch:
        return SharedKillSwitch(name)
