"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, and each cell's whole run goes on
with the program's step (`StepCore.run_local`, which both the ring's and
the region's systems step through) broken in one way at a time:

- `unchanged`: the step returns its state unchanged;
- `half`: half of the inbox's rows are left out of delivery;
- `altered`: every message a step produces carries its first payload
  column nudged by a part in a million (a ring token, a counter's reply).

The fourth fault the contract lists, the exchange between cards left out,
has nothing to break here: every cell runs on one card."""

import pytest
import torch

from akka_tpu_torch.batched import step as step_mod
from cells import CELLS, run_small

REAL = step_mod.StepCore.run_local


def unchanged(self, state, behavior_id, alive, *args, **kw):
    out = REAL(self, state, behavior_id, alive, *args, **kw)
    return (dict(state),) + out[1:]


def half(self, state, behavior_id, alive, inbox_dst, inbox_type,
         inbox_payload, inbox_valid, *args, **kw):
    keep = torch.arange(inbox_valid.shape[0],
                        device=inbox_valid.device) % 2 == 0
    return REAL(self, state, behavior_id, alive, inbox_dst, inbox_type,
                inbox_payload, inbox_valid & keep, *args, **kw)


def altered(self, *args, **kw):
    out = REAL(self, *args, **kw)
    emits = out[3]
    payload = emits.payload.clone()
    payload[..., 0] = payload[..., 0] * (1 + 2 ** -20)
    return out[:3] + (emits._replace(payload=payload),) + out[4:]


@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(monkeypatch, workload, fault):
    monkeypatch.setattr(step_mod.StepCore, "run_local", fault)
    out = run_small(workload)
    assert not out.correct, out.checks
