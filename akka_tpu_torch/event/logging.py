"""Logging events + logger actors.

A copy of `akka_tpu/event/logging.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/event/Logging.scala —
LogEvent levels (Error/Warning/Info/Debug), logger actors subscribed on the
EventStream with a dedicated mailbox (event/LoggerMailbox.scala), and the
LoggingAdapter (BusLogging) front-end.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional

ERROR_LEVEL = 1
WARNING_LEVEL = 2
INFO_LEVEL = 3
DEBUG_LEVEL = 4

_LEVEL_NAMES = {ERROR_LEVEL: "ERROR", WARNING_LEVEL: "WARNING",
                INFO_LEVEL: "INFO", DEBUG_LEVEL: "DEBUG"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}
_NAME_LEVELS["OFF"] = 0


def level_for(name: str) -> int:
    return _NAME_LEVELS.get(name.upper(), INFO_LEVEL)


@dataclass
class LogEvent:
    log_source: str
    log_class: str
    message: Any
    level: int = INFO_LEVEL
    timestamp: float = field(default_factory=time.time)
    mdc: dict = field(default_factory=dict)
    marker: Optional[str] = None


@dataclass
class Error(LogEvent):
    cause: Optional[BaseException] = None

    def __post_init__(self):
        self.level = ERROR_LEVEL


@dataclass
class Warning(LogEvent):
    def __post_init__(self):
        self.level = WARNING_LEVEL


@dataclass
class Info(LogEvent):
    def __post_init__(self):
        self.level = INFO_LEVEL


@dataclass
class Debug(LogEvent):
    def __post_init__(self):
        self.level = DEBUG_LEVEL


_CLASS_FOR = {ERROR_LEVEL: Error, WARNING_LEVEL: Warning, INFO_LEVEL: Info, DEBUG_LEVEL: Debug}


class StdOutLogger:
    """Synchronous fallback logger used during system startup/shutdown
    (reference: Logging.StandardOutLogger)."""

    _lock = threading.Lock()

    def __init__(self, level: int = WARNING_LEVEL):
        self.level = level

    def __call__(self, event: LogEvent) -> None:
        if event.level > self.level:
            return
        ts = time.strftime("%H:%M:%S", time.localtime(event.timestamp))
        line = f"[{_LEVEL_NAMES.get(event.level, '?')}] [{ts}] [{event.log_source}] {event.message}"
        with self._lock:
            print(line, file=sys.stderr)
            cause = getattr(event, "cause", None)
            if cause is not None:
                traceback.print_exception(type(cause), cause, cause.__traceback__, file=sys.stderr)


class LoggingAdapter:
    """Per-source front-end publishing onto the event stream
    (reference: event/Logging.scala BusLogging)."""

    __slots__ = ("bus", "log_source", "log_class", "level")

    def __init__(self, bus, log_source: str, log_class: str = "", level: int = DEBUG_LEVEL):
        self.bus = bus
        self.log_source = log_source
        self.log_class = log_class
        self.level = level

    def _log(self, level: int, message: str, cause: Optional[BaseException] = None) -> None:
        if level > self.level:
            return
        cls = _CLASS_FOR[level]
        if cls is Error:
            self.bus.publish(Error(self.log_source, self.log_class, message, cause=cause))
        else:
            self.bus.publish(cls(self.log_source, self.log_class, message))

    def error(self, message: str, cause: Optional[BaseException] = None) -> None:
        self._log(ERROR_LEVEL, message, cause)

    def warning(self, message: str) -> None:
        self._log(WARNING_LEVEL, message)

    def info(self, message: str) -> None:
        self._log(INFO_LEVEL, message)

    def debug(self, message: str) -> None:
        self._log(DEBUG_LEVEL, message)

    def is_enabled(self, level: int) -> bool:
        return level <= self.level
