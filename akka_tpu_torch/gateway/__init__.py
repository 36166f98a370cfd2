"""Serving gateway (port of `akka_tpu/gateway`): external traffic in,
sharded entities on the card, SLOs out.

The planes, each its own module:
- ingress:    framed-TCP front door + in-proc transport + RegionBackend
- evloop:     selector event-loop transport (all sockets on one thread,
              optional SO_REUSEPORT accept shards)
- aggregator: cross-connection ingest windows (shared decode/admission/
              ask waves across sockets)
- admission:  per-tenant token buckets + runtime-pressure load shedding
- dedup:      reply-cache dedup (exactly-once retry effects)
- replica:    hot-entity read replica (local, or fed by ddata's replicator)
- slo:        p50/p99 latency vs targets, error budget, per-tenant counters

Not ported: the "stream" transport (ROADMAP A12.5).
"""

from .admission import (AdmissionController, AskPoolExhausted, Reject,
                        TokenBucket, VectorTenantTable,
                        handle_pressure_signals, region_pressure_signals)
from .aggregator import IngestAggregator
from .dedup import ReplyCacheTable
from .evloop import EvLoopIngress
from .ingress import (DEFAULT_MAX_FRAME, GatewayClient, GatewayServer,
                      RegionBackend, counter_behavior, encode_body,
                      encode_frame, FrameReader)
from .slo import SloTracker
from ..serialization import frames

__all__ = ["AdmissionController", "AskPoolExhausted", "Reject",
           "TokenBucket", "VectorTenantTable", "ReplyCacheTable",
           "EvLoopIngress",
           "handle_pressure_signals",
           "region_pressure_signals", "GatewayClient", "GatewayServer",
           "IngestAggregator", "RegionBackend", "counter_behavior",
           "encode_body", "encode_frame", "FrameReader", "SloTracker",
           "frames", "DEFAULT_MAX_FRAME"]
