"""The port against the plain references at small sizes on the CPU: each
cell's whole run (set-up, window, drain, outputs, comparison) comes out
correct, and each control, the reference put in the program's place in
bfloat16 or with a guarantee broken, does not."""

import numpy as np
import pytest

from cells import CELLS, run_small


# the controls that fail each cell: bfloat16 where totals pass 256 (the
# hot keys) or a payload's low bits show; the skipped per-entity order
# wherever a wave repeats an entity. Uniform keys keep every total small,
# so there bfloat16 is exact.
FAILS = {"counter-zipf": {"bfloat16", "one_round"},
         "counter-uniform": {"one_round"},
         "ring-one": {"bfloat16"}}


@pytest.mark.parametrize("workload", CELLS)
def test_port_matches_reference(workload):
    # two seconds: the hot key's total passes 256 in counter-zipf, while
    # uniform keys leave every total far below it
    out = run_small(workload, seconds=2.0, control=True)
    assert out.correct, out.checks
    assert all(v == 0 for v, _ in out.checks.values())
    assert out.attempted > 0 and out.failed == 0
    failing = {name for name, checks in out.control.items()
               if any(v > lim for v, lim in checks.values())}
    assert failing == FAILS[workload], out.control


@pytest.mark.parametrize("workload", ["counter-zipf", "ring-one"])
def test_end_to_end_metrics_from_the_window(workload):
    out = run_small(workload)
    assert all(v > 0 for v in out.end_to_end.values()), out.end_to_end
    assert out.setup_s > 0


def test_counter_reference_running_totals():
    from portbench import harness
    ref = harness.load_module("reference", "sharded-counter-4m")
    keys = np.asarray([3, 1, 3, 3, 1], np.int64)
    adds = np.asarray([1.5, 2.25, 0.1, 7.0, 1.0], np.float32)
    import torch
    totals, last_keys, last = ref.running_totals(keys, adds, torch.float32)
    want = np.asarray([1.5, 2.25, np.float32(1.5) + np.float32(0.1),
                       np.float32(np.float32(1.5) + np.float32(0.1))
                       + np.float32(7.0), 3.25], np.float32)
    assert np.array_equal(totals, want)
    assert last_keys.tolist() == [1, 3] and last.tolist() == [3.25, want[3]]
    out = {"n_entities": 4, "keys": keys, "adds": adds,
           "caller": np.zeros(5, np.int32), "replies": totals.copy(),
           "final": np.asarray([0, 3.25, 0, want[3]], np.float32)}
    assert all(v == 0 for v, _ in ref.compare(out).values())
    swapped = dict(out, replies=totals[[0, 4, 3, 2, 1]])
    assert ref.compare(swapped)["replies_off"][0] > 0
    unanswered = dict(out, replies=np.where(keys == 1, np.nan, totals)
                      .astype(np.float32))
    assert ref.compare(unanswered)["replies_off"][0] == 2
    # one caller's asks 2 and 3 to entity 3 applied against sending order
    applied = [0, 1, 3, 2, 4]
    late, _, _ = ref.running_totals(keys[applied], adds[applied],
                                    torch.float32)
    replies = np.empty_like(late)
    replies[applied] = late
    reordered = dict(out, replies=replies)
    # every total is right in the order applied; the caller's order broke
    assert ref.compare(reordered)["replies_off"][0] == 1


def test_ring_reference_wraps_and_counts():
    from portbench import harness
    ref = harness.load_module("reference", "savina-thread-ring")
    p0 = np.asarray([[0.25, 0.5], [0.75, 1.0]], np.float32)
    received, count, sums = ref.expected(5, 7, np.asarray([3, 4]), p0)
    # 7 steps over 5 actors: one lap each, then two more from each seed
    assert received.tolist() == [2 + 1, 2, 2, 2 + 1, 2 + 2]
    assert count.tolist() == [1, 1, 0, 0, 0]
    assert sums[0].tolist() == [0.25, 0.5] and sums[1].tolist() == [0.75, 1.0]


def test_counter_one_round_control():
    """Asks of one wave to one entity all answered with the wave's total
    break the per-entity order; distinct entities in a wave do not."""
    from portbench import harness
    ref = harness.load_module("reference", "sharded-counter-4m")
    keys = np.asarray([5, 5, 6, 5, 7, 7], np.int64)
    out = {"n_entities": 8, "keys": keys, "adds": np.ones(6, np.float32),
           "caller": np.arange(6, dtype=np.int32), "max_batch": 3,
           "replies": np.zeros(6, np.float32),
           "final": np.zeros(8, np.float32)}
    sim = ref.simulate(out, "one_round")
    assert sim["replies"].tolist() == [2, 2, 1, 3, 2, 2]
    assert sim["final"].tolist() == [0, 0, 0, 0, 0, 3, 1, 2]
    assert ref.compare(sim)["replies_off"][0] == 2
    exact = ref.simulate(out, "bfloat16")
    assert all(v == 0 for v, _ in ref.compare(exact).values())
