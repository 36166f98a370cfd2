"""EventStream: the system-wide pub-sub bus with subchannel classification.

A copy of `akka_tpu/event/event_stream.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/event/EventStream.scala:26-50 —
subscribe by channel *class*; publishing an event delivers it to subscribers of
the event's class and every superclass (subchannel classification via
util/Subclassification). Carries LogEvents, DeadLetters, lifecycle events.
Also EventBus variants (LookupClassification / ScanningClassification) from
akka-actor/src/main/scala/akka/event/EventBus.scala.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Set


class EventBus:
    """Classifier-based bus: subclasses define classify(event) -> classifier
    and compare classifiers (reference: event/EventBus.scala)."""

    def subscribe(self, subscriber, to: Any) -> bool:
        raise NotImplementedError

    def unsubscribe(self, subscriber, from_: Any = None) -> bool:
        raise NotImplementedError

    def publish(self, event: Any) -> None:
        raise NotImplementedError


class LookupEventBus(EventBus):
    """Exact-classifier lookup (reference: LookupClassification)."""

    def __init__(self):
        self._subscribers: Dict[Any, Set] = defaultdict(set)
        self._lock = threading.RLock()

    def classify(self, event: Any) -> Any:
        raise NotImplementedError

    def publish_to(self, event: Any, subscriber: Any) -> None:
        subscriber.tell(event, None)

    def subscribe(self, subscriber, to: Any) -> bool:
        with self._lock:
            self._subscribers[to].add(subscriber)
        return True

    def unsubscribe(self, subscriber, from_: Any = None) -> bool:
        with self._lock:
            if from_ is None:
                for subs in self._subscribers.values():
                    subs.discard(subscriber)
            else:
                self._subscribers[from_].discard(subscriber)
        return True

    def publish(self, event: Any) -> None:
        for sub in list(self._subscribers.get(self.classify(event), ())):
            self.publish_to(event, sub)


class EventStream(EventBus):
    """Class-hierarchy (subchannel) classification: subscribing to a class
    receives events of that class and all its subclasses."""

    def __init__(self, debug: bool = False):
        self._subscribers: Dict[type, Set] = defaultdict(set)
        self._lock = threading.RLock()
        self.debug = debug
        self._direct: list[Callable[[Any], None]] = []  # synchronous taps (stdout logger)

    def attach_tap(self, fn: Callable[[Any], None]) -> None:
        self._direct.append(fn)

    def detach_tap(self, fn: Callable[[Any], None]) -> None:
        try:
            self._direct.remove(fn)
        except ValueError:
            pass

    def subscribe(self, subscriber, to: type) -> bool:
        if subscriber is None:
            raise ValueError("subscriber is None")
        with self._lock:
            self._subscribers[to].add(subscriber)
        return True

    def unsubscribe(self, subscriber, from_: Optional[type] = None) -> bool:
        with self._lock:
            if from_ is None:
                for subs in self._subscribers.values():
                    subs.discard(subscriber)
            else:
                self._subscribers.get(from_, set()).discard(subscriber)
        return True

    def publish(self, event: Any) -> None:
        for tap in self._direct:
            try:
                tap(event)
            except Exception:  # noqa: BLE001 — bus must not die
                pass
        event_cls = type(event)
        targets: Set = set()
        with self._lock:
            for cls, subs in self._subscribers.items():
                if isinstance(cls, type) and isinstance(event, cls):
                    targets |= subs
        for sub in targets:
            try:
                if hasattr(sub, "tell"):
                    sub.tell(event, None)
                else:
                    sub(event)
            except Exception:  # noqa: BLE001
                pass
