"""The port's DeviceShardRegion over a mesh of ranks against the
reference's region on 2 of the conftest's virtual CPU devices, on the
CPU.

Two gloo ranks run as threads of this process (tests/torch_rank_fixture.py),
each with a region of one slot on device="cpu" over one mesh of their
group. Every rank sends the same ask waves, rebalances one shard, takes a
checkpoint with both journals attached, sends more waves, restores a
fresh ranked region from the directory (rank 0 wrote every file) and
sends the last waves. Every rank's replies, entity rows and totals are
held bit for bit (the counter adds integer-valued floats, so every sum is
exact) to the reference's region driven alike (2 ranks x 1 slot, reduce
mode) or, where the reference run would add nothing that
tests/test_torch_region.py does not hold already, to the port's one-card
region driven alike (2-slot mailboxes; 2 ranks x 2 slots). The region
holds 64 rows (2 shards x 16 entities, two spare blocks).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import akka_tpu.persistence.slab_snapshot as j_snapshot
from akka_tpu.gateway import counter_behavior as j_counter
from akka_tpu.sharding.device import DeviceEntity as JEntity
from akka_tpu.sharding.device import DeviceShardRegion as JRegion

from akka_tpu_torch.gateway import counter_behavior as t_counter
from akka_tpu_torch.parallel import make_mesh
from akka_tpu_torch.sharding.device import DeviceEntity as TEntity
from akka_tpu_torch.sharding.device import DeviceShardRegion as TRegion
from torch_rank_fixture import run_ranks

P = 4
NAMES = [f"e-{i}" for i in range(12)]


def make_trace(seed: int):
    """Six waves of nine adds over twelve entities (repeats within a wave
    serialize), integer values 1..9."""
    rng = np.random.default_rng(seed)
    return [[(NAMES[i], float(v)) for i, v in
             zip(rng.integers(0, len(NAMES), 9), rng.integers(1, 10, 9))]
            for _ in range(6)]


def spec(pkg, slots, n_devices=2):
    kw = dict(n_shards=2, entities_per_shard=16, n_devices=n_devices,
              payload_width=P, mailbox_slots=slots, spare_blocks=2)
    if pkg == "j":
        return JEntity(f"rr-s{slots}", j_counter(P), **kw)
    return TEntity(f"rr-s{slots}", t_counter(P), **kw)


def drive(make, directory: str, trace):
    """The region's life: waves, a rebalance, a checkpoint, a wave, then
    a fresh region restored from `directory` and the last wave. Returns
    the replies (as float32 arrays), the entity rows, the restored step
    and the totals."""
    region = make()
    region.attach_journal(directory)
    region.attach_entity_journal()
    refs = {n: region.entity_ref(n) for n in NAMES}
    assert region.system.capacity <= 64

    def wave(r, refs, asks):
        out = r.ask_many([(refs[n].shard, refs[n].index, [v])
                          for n, v in asks])
        return [np.asarray(o, np.float32) for o in out]

    replies = [wave(region, refs, w) for w in trace[:3]]
    moved = region.rebalance(refs[NAMES[0]].shard)
    replies.append(wave(region, refs, trace[3]))
    region.checkpoint()
    replies.append(wave(region, refs, trace[4]))
    rows = [refs[n].row for n in NAMES]

    fresh = make()
    fresh.attach_journal(directory)
    fresh.attach_entity_journal()
    step = fresh.restore()
    refs = {n: fresh.entity_ref(n) for n in NAMES}
    replies.append(wave(fresh, refs, trace[5]))
    totals = fresh.system.read_state(
        "total", np.asarray([refs[n].row for n in NAMES], np.int32))
    return {"replies": replies, "rows": rows, "moved": moved,
            "step": step, "totals": np.asarray(totals, np.float32),
            "pool": fresh.ask_pool_stats()["in_flight"],
            "journal": fresh._entity_journal.totals()}


# (mailbox slots, slots per rank, the twin: "jax" the reference on 2 ranks'
# worth of devices, "port" the port's one-card region)
CASES = [(0, 1, "jax"), (2, 1, "port"), (0, 2, "port")]


@pytest.mark.parametrize("slots,per_rank,twin", CASES,
                         ids=["slots0-reference", "slots2-one-card",
                              "2x2-one-card"])
def test_region_on_two_ranks_matches_reference(slots, per_rank, twin,
                                               tmp_path, monkeypatch):
    """Replies, rows, the restored step and totals: equal on both ranks
    and to the twin's; the totals equal the host oracle's."""
    monkeypatch.setattr(j_snapshot, "_try_orbax", lambda: None)
    trace = make_trace(slots + per_rank)
    width = 2 * per_rank
    if twin == "jax":
        make = lambda: JRegion(spec("j", slots, width))  # noqa: E731
    else:
        make = lambda: TRegion(spec("t", slots, width),  # noqa: E731
                               device="cpu")
    want = drive(make, str(tmp_path / "twin"), trace)
    oracle = {n: 0.0 for n in NAMES}
    for w in trace:
        for n, v in w:
            oracle[n] += v
    np.testing.assert_array_equal(
        want["totals"], np.asarray([oracle[n] for n in NAMES], np.float32))
    directory = str(tmp_path / "t")

    def rank(r, group):
        mesh = make_mesh(width, device="cpu", group=group)
        return drive(lambda: TRegion(spec("t", slots, width), mesh=mesh,
                                     device="cpu"), directory, trace)

    for r, got in enumerate(run_ranks(2, rank, f"region-{slots}-{width}")):
        ctx = f"slots={slots} {width} slots, rank {r}"
        assert len(got["replies"]) == len(want["replies"])
        for k, (a, b) in enumerate(zip(want["replies"], got["replies"])):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x, err_msg=f"{ctx} wave {k}")
        for key in ("rows", "moved", "step", "pool", "journal"):
            assert got[key] == want[key], (ctx, key)
        np.testing.assert_array_equal(got["totals"], want["totals"],
                                      err_msg=ctx)
