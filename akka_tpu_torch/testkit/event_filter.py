"""LoggingTestKit: assert on log events published to the event stream.

A copy of `akka_tpu/testkit/event_filter.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor-testkit-typed LoggingTestKit / classic
EventFilter (akka-testkit/.../TestEventListener.scala) — intercept LogEvents,
count matches, optionally mute them from stdout while the block runs.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Type

from ..event.logging import Debug, Error, Info, LogEvent, Warning


class LoggingTestKit:
    """Context manager that records matching LogEvents.

    with LoggingTestKit.error("boom", occurrences=1).expect(system):
        ref.tell("explode")
    """

    def __init__(self, level: Optional[Type[LogEvent]] = None,
                 message_contains: str = "", occurrences: int = 1,
                 custom: Optional[Callable[[LogEvent], bool]] = None):
        self._level = level
        self._contains = message_contains
        self._occurrences = occurrences
        self._custom = custom
        self._matched: List[LogEvent] = []
        self._event = threading.Event()
        self._system = None

    # -- factories (reference: LoggingTestKit.error/warn/info/debug) ---------
    @staticmethod
    def error(message_contains: str = "", occurrences: int = 1) -> "LoggingTestKit":
        return LoggingTestKit(Error, message_contains, occurrences)

    @staticmethod
    def warn(message_contains: str = "", occurrences: int = 1) -> "LoggingTestKit":
        return LoggingTestKit(Warning, message_contains, occurrences)

    @staticmethod
    def info(message_contains: str = "", occurrences: int = 1) -> "LoggingTestKit":
        return LoggingTestKit(Info, message_contains, occurrences)

    @staticmethod
    def debug(message_contains: str = "", occurrences: int = 1) -> "LoggingTestKit":
        return LoggingTestKit(Debug, message_contains, occurrences)

    @staticmethod
    def custom(fn: Callable[[LogEvent], bool], occurrences: int = 1) -> "LoggingTestKit":
        return LoggingTestKit(custom=fn, occurrences=occurrences)

    # -- matching -------------------------------------------------------------
    def _matches(self, event: LogEvent) -> bool:
        if self._custom is not None:
            return self._custom(event)
        if self._level is not None and not isinstance(event, self._level):
            return False
        return self._contains in str(event.message)

    def _on_event(self, event: Any) -> None:
        if isinstance(event, LogEvent) and self._matches(event):
            self._matched.append(event)
            if len(self._matched) >= self._occurrences:
                self._event.set()

    # -- use ------------------------------------------------------------------
    def expect(self, system) -> "LoggingTestKit":
        self._system = system
        return self

    def __enter__(self) -> "LoggingTestKit":
        if self._system is None:
            raise RuntimeError("call .expect(system) before entering")
        self._system.event_stream.subscribe(self._on_event, LogEvent)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None and not self._event.wait(3.0):
                raise AssertionError(
                    f"expected {self._occurrences} matching log event(s), "
                    f"saw {len(self._matched)}")
        finally:
            self._system.event_stream.unsubscribe(self._on_event)

    @property
    def matched(self) -> List[LogEvent]:
        return list(self._matched)
