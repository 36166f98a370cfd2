"""Test infrastructure of the port (reference: akka-testkit,
akka-actor-testkit-typed, akka-multi-node-testkit): the host-actor probe
(`probe`), the synchronous behavior kit (`behavior_testkit`), manual
time, the logging kit, the sharding helper, the in-process multi-node
kit and the multi-process harness, time dilation, the deterministic
chaos twins (`chaos`) and the loopback cluster settings (`cluster`)."""

from .probe import (AssertionFailure, TestProbe, await_assert,
                    await_condition)
from .behavior_testkit import (BehaviorTestKit, Effect, MessageAdapter,
                               ReceiveTimeoutCancelled, ReceiveTimeoutSet,
                               Scheduled, Spawned, SpawnedAnonymous, Stopped,
                               TestInbox, Unwatched, Watched, WatchedWith)
from .manual_time import ManualTimeScheduler, install_manual_time
from .event_filter import LoggingTestKit
from .sharding import region_entity_ids
from .multi_node import (BarrierTimeout, MultiNodeKit, NodeHandle,
                         TestConductor)
from .chaos import (CRASH_SALT, DROP_SALT, DUP_SALT, LOSS_SALT,
                    NAN_SALT, STALL_SALT, DeviceLossInjector, chaos_hash,
                    chaos_hit, chaos_hit_np, chaos_uniform_np, inject,
                    loss_schedule, loss_schedule_np)

__all__ = ["AssertionFailure", "BarrierTimeout", "BehaviorTestKit",
           "CRASH_SALT", "DROP_SALT", "DUP_SALT", "DeviceLossInjector",
           "Effect", "LOSS_SALT", "LoggingTestKit", "ManualTimeScheduler",
           "MessageAdapter", "MultiNodeKit", "NAN_SALT", "NodeHandle",
           "ReceiveTimeoutCancelled", "ReceiveTimeoutSet", "STALL_SALT",
           "Scheduled", "Spawned", "SpawnedAnonymous", "Stopped",
           "TestConductor", "TestInbox", "TestProbe", "Unwatched",
           "Watched", "WatchedWith", "await_assert", "await_condition",
           "chaos_hash", "chaos_hit", "chaos_hit_np", "chaos_uniform_np",
           "inject", "install_manual_time", "loss_schedule",
           "loss_schedule_np", "region_entity_ids"]
