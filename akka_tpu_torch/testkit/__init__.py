"""Test infrastructure of the port: the deterministic chaos twins
(`chaos`). Port of the part of `akka_tpu/testkit` that the batched runtime
needs; the host-actor testkit is not ported."""

from .chaos import (CRASH_SALT, DROP_SALT, DUP_SALT, LOSS_SALT,
                    NAN_SALT, STALL_SALT, DeviceLossInjector, chaos_hash,
                    chaos_hit, chaos_hit_np, chaos_uniform_np, inject,
                    loss_schedule, loss_schedule_np)

__all__ = ["CRASH_SALT", "DROP_SALT", "DUP_SALT", "DeviceLossInjector",
           "LOSS_SALT", "NAN_SALT", "STALL_SALT", "chaos_hash", "chaos_hit",
           "chaos_hit_np", "chaos_uniform_np", "inject", "loss_schedule",
           "loss_schedule_np"]
