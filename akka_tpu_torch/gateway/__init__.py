"""Serving gateway (port of `akka_tpu/gateway`): so far only the serving
entity, `counter_behavior`. The host layers (ingress transport, admission,
aggregator, dedup, SLO tracking) are not ported yet (ROADMAP A7)."""

from .ingress import counter_behavior

__all__ = ["counter_behavior"]
