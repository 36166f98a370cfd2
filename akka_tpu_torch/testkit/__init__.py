"""Test infrastructure of the port: the host-actor probe (`probe`:
TestProbe and the await helpers) and the deterministic chaos twins
(`chaos`). Port of the part of `akka_tpu/testkit` that the runtime and
the bridge need."""

from .chaos import (CRASH_SALT, DROP_SALT, DUP_SALT, LOSS_SALT,
                    NAN_SALT, STALL_SALT, DeviceLossInjector, chaos_hash,
                    chaos_hit, chaos_hit_np, chaos_uniform_np, inject,
                    loss_schedule, loss_schedule_np)
from .probe import (AssertionFailure, TestProbe, await_assert,
                    await_condition)

__all__ = ["AssertionFailure", "CRASH_SALT", "DROP_SALT", "DUP_SALT",
           "DeviceLossInjector", "LOSS_SALT", "NAN_SALT", "STALL_SALT",
           "TestProbe", "await_assert", "await_condition", "chaos_hash",
           "chaos_hit", "chaos_hit_np", "chaos_uniform_np", "inject",
           "loss_schedule", "loss_schedule_np"]
