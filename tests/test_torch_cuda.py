"""Card-only tests of the PyTorch port: the ring-mailbox CUDA kernels
against their plain versions, the delivery seam on CUDA tensors, the
sharded system and the region's ask path through the kernels, and the
compiled step: CUDA graph replays against the eager step, the captures a
rebalance and a re-sharded restore cause, and a behavior that cannot be
captured.

Launch counts are read after `warmup()`: the eager warm-up steps before a
system's first capture launch the kernels too.

They skip without a CUDA device. On a machine with a card (and no JAX),
run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os
import time

import numpy as np
import pytest
import torch

from akka_tpu_torch.gateway import counter_behavior
from akka_tpu_torch.models import baseline_benches as tbb
from akka_tpu_torch.ops import cuda_mailbox as cm
from akka_tpu_torch.ops import segment as tsg
from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion
from akka_tpu_torch.tools import bench_mailbox as bm
from akka_tpu_torch.utils.carry import numpy_carry

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-3  # float atomics add in a run-dependent order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cm.build()
    cm.reset_launches()
    return torch.device("cuda")


def _inputs(m, n, p, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    dst = torch.randint(-1, n + 1, (m,), generator=g, dtype=torch.int32)
    mtype = torch.randint(1, 5, (m,), generator=g, dtype=torch.int32)
    payload = torch.randn((m, p), generator=g)
    valid = torch.rand((m,), generator=g) > 0.1
    return [t.to(device) for t in (dst, mtype, payload, valid)]


@pytest.mark.parametrize("m,n,p,slots", [(300, 13, 3, 2), (4099, 64, 4, 3),
                                         (1, 1, 1, 1)])
def test_kernels_match_plain_versions(card, m, n, p, slots):
    _assert_kernels_match(*_inputs(m, n, p, card, seed=m), n, slots)
    assert cm.LAUNCHES == {"ring_reduce": 1, "ring_slots": 1}


def _assert_kernels_match(dst, mtype, payload, valid, n, slots):
    got = cm.ring_reduce(dst, payload, valid, n)
    want = cm.ring_reduce_plain(dst, payload, valid, n)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
    got = cm.ring_slots(dst, mtype, payload, valid, n, slots)
    want = cm.ring_slots_plain(dst, mtype, payload, valid, n, slots)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[4], want[4], rtol=RTOL, atol=ATOL)


# P = 4 and 8 take the float4 path (one vector atomic per 4 columns), P = 1
# and 3 the scalar one. The fan-in's ~4 rows per collector overflow S <= 3
# and cascade through every level of S = 5.
@pytest.mark.parametrize("slots", [1, 2, 3, 5])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("pattern", bm.PATTERNS)
def test_kernels_match_plain_versions_by_pattern(card, pattern, p, slots):
    n = 4096
    inputs = bm.make_pattern(pattern, n + bm.HOST_ROWS, n, p, seed=p,
                             device=card)
    _assert_kernels_match(*inputs, n, slots)
    assert cm.LAUNCHES == {"ring_reduce": 1, "ring_slots": 1}


# int32 puts one lane on each payload element in both kernels (every P;
# K2 keeps one row a lane for its claim and shuffles each element's
# recipient across the warp); bf16 adds rows of P % 4 == 0 as float4
# vector atomics into a float32 accumulator in both kernels, other widths
# column by column, and rounds once (K2 in ring_fill, 16 bytes in and 8
# out at a time where P % 4 == 0). K2's ring_fill copies cells of P % 4 ==
# 0 as 16-byte (int32) or 8-byte (bf16) words, other widths column by
# column. m = n + 11 is no multiple of 32 or of any block's rows or
# elements; the fan-in's ~4 rows per collector cascade through every level
# of S = 5. int32 outputs, sums included, are bit-equal to the plain
# versions; bf16 sums lie within one bf16 ulp plus the float32 reordering
# allowance (bench_mailbox.compare).
@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16])
@pytest.mark.parametrize("slots", [1, 2, 3, 5])
@pytest.mark.parametrize("p", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("pattern", bm.PATTERNS)
def test_typed_kernels_match_plain_versions(card, pattern, p, slots, dtype):
    n = 4096
    dst, mtype, payload, valid = bm.make_pattern(
        pattern, n + bm.HOST_ROWS + 3, n, p, seed=p, device=card,
        dtype=dtype)
    slack = bm.sum_slack(dst, payload, valid, n) \
        if dtype == torch.bfloat16 else None
    got = cm.ring_reduce(dst, payload, valid, n)
    assert got[1].dtype == dtype
    bm.compare("K1", got, cm.ring_reduce_plain(dst, payload, valid, n),
               slack)
    got = cm.ring_slots(dst, mtype, payload, valid, n, slots)
    assert got[1].dtype == got[4].dtype == dtype
    bm.compare("K2", got, cm.ring_slots_plain(dst, mtype, payload, valid, n,
                                              slots), slack)
    assert cm.LAUNCHES == {"ring_reduce": 1, "ring_slots": 1}


# K2 at P = 4 with one operand off the alignment its vector branch needs:
# the int32 payload 4 bytes past 16, the bf16 payload 2 bytes past 8
# (both kernels take the column branch for it), the ring payload `buf_p`
# one element past (ring_fill copies column by column; the float32 and
# bf16 sweeps keep their float4 rows), bf16 `sums` 2 bytes past 8
# (ring_fill rounds column by column) and the bf16 float32 accumulator 4
# bytes past 16 (the sweep adds column by column). Each must still match
# the plain version.
@pytest.mark.parametrize("dtype,shift", [
    (torch.float32, "buf_p"),
    (torch.int32, "payload"), (torch.int32, "buf_p"),
    (torch.bfloat16, "payload"), (torch.bfloat16, "buf_p"),
    (torch.bfloat16, "sums"), (torch.bfloat16, "acc")])
@pytest.mark.parametrize("pattern", bm.PATTERNS)
def test_misaligned_k2_takes_the_column_branch(card, pattern, dtype, shift):
    n, p, slots = 4096, 4, 3
    inputs = bm.make_pattern(pattern, n + bm.HOST_ROWS + 3, n, p, seed=13,
                             device=card, dtype=dtype)
    slack = bm.sum_slack(inputs[0], inputs[2], inputs[3], n) \
        if dtype == torch.bfloat16 else None
    bm.compare("K2", bm.shifted_slots(cm.build(), inputs, n, slots, shift),
               cm.ring_slots_plain(*inputs, n, slots), slack)


def test_int32_sums_wrap_as_int32(card):
    """Sums past 2^31 wrap as int32 arithmetic does, in both kernels and
    the plain versions: 3000 rows of values near 2^30 onto each of 7
    recipients."""
    m, n, p = 21_000, 7, 5
    g = torch.Generator().manual_seed(2)
    payload = torch.randint(2 ** 29, 2 ** 30, (m, p), generator=g,
                            dtype=torch.int32)
    dst = torch.arange(m, dtype=torch.int32) % n
    valid = torch.ones((m,), dtype=torch.bool)
    wide = torch.zeros((n, p), dtype=torch.int64).index_add_(
        0, dst.long(), payload.long())
    want = ((wide + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    assert (wide > 2 ** 31).all()
    dst, payload, valid = dst.to(card), payload.to(card), valid.to(card)
    for got in (cm.ring_reduce(dst, payload, valid, n)[1],
                cm.ring_slots(dst, dst, payload, valid, n, 2)[4],
                cm.ring_reduce_plain(dst, payload, valid, n)[1]):
        assert torch.equal(got.cpu(), want)


def test_bf16_sums_keep_growing_past_256(card):
    """30000 rows of 1.0 into each of 10 recipients: a bf16 accumulator
    would stop at 256 (256 + 1 rounds to 256); the float32 one reaches
    30000 and rounds once, as the plain version does."""
    m, n = 300_000, 10
    dst = (torch.arange(m, device=card) % n).to(torch.int32)
    payload = torch.ones((m, 4), dtype=torch.bfloat16, device=card)
    valid = torch.ones((m,), dtype=torch.bool, device=card)
    want = torch.full((n, 4), 30000.0, device=card).to(torch.bfloat16)
    assert torch.equal(cm.ring_reduce(dst, payload, valid, n)[1], want)
    assert torch.equal(cm.ring_slots(dst, dst, payload, valid, n, 2)[4],
                       want)
    assert torch.equal(cm.ring_reduce_plain(dst, payload, valid, n)[1], want)


def test_misaligned_payload_takes_the_scalar_path(card):
    m, n, p = 3001, 500, 4
    dst, mtype, payload, valid = _inputs(m, n, p, card, seed=11)
    # a contiguous [m, 4] view 4 bytes past a 16-byte boundary
    shifted = torch.empty(m * p + 1, device=card)[1:].view(m, p)
    shifted.copy_(payload)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _assert_kernels_match(dst, mtype, shifted, valid, n, 3)


def test_misaligned_bf16_payload_takes_the_column_branch(card):
    """A bf16 [m, 4] payload 2 bytes past an 8-byte boundary cannot take
    K1's 8-byte loads: it adds column by column, and both kernels still
    match their plain versions."""
    m, n, p = 3001, 500, 4
    dst, mtype, payload, valid = bm.make_pattern(
        "random", m, n, p, seed=12, device=card, dtype=torch.bfloat16)
    shifted = torch.empty(m * p + 1, dtype=torch.bfloat16,
                          device=card)[1:].view(m, p)
    shifted.copy_(payload)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 != 0
    slack = bm.sum_slack(dst, shifted, valid, n)
    bm.compare("K1", cm.ring_reduce(dst, shifted, valid, n),
               cm.ring_reduce_plain(dst, shifted, valid, n), slack)
    bm.compare("K2", cm.ring_slots(dst, mtype, shifted, valid, n, 3),
               cm.ring_slots_plain(dst, mtype, shifted, valid, n, 3), slack)


def test_repeated_launches_give_identical_integers(card):
    n = 1 << 14
    for pattern in bm.PATTERNS:
        inputs = bm.make_pattern(pattern, n + bm.HOST_ROWS, n, 4, seed=5,
                                 device=card)
        first = cm.ring_slots(*inputs, n, 2)
        counts = cm.ring_reduce(inputs[0], inputs[2], inputs[3], n)[0]
        for _ in range(5):
            again = cm.ring_slots(*inputs, n, 2)
            for i in (0, 2, 3, 5):
                assert torch.equal(again[i], first[i]), (pattern, i)
            assert torch.equal(again[1], first[1]), pattern  # copied rows
            assert torch.equal(cm.ring_reduce(inputs[0], inputs[2],
                                              inputs[3], n)[0], counts)
    assert cm.LAUNCHES == {"ring_reduce": 18, "ring_slots": 18}


def test_auto_backend_launches_the_ring_kernel(card):
    dst, mtype, payload, valid = _inputs(2048, 100, 4, card)
    tsg.deliver(dst, payload, valid, 100)
    tsg.deliver_slots(dst, mtype, payload, valid, 100, 2)
    assert cm.LAUNCHES == {"ring_reduce": 1, "ring_slots": 1}
    # spill generations stay on the ranked kernels under "auto" ...
    tsg.deliver_slots(dst, mtype, payload, valid, 100, 2, spill_cap=8)
    assert cm.LAUNCHES["ring_slots"] == 1
    # ... and an explicit "cuda" request for them raises
    with pytest.raises(ValueError, match="spill_cap"):
        tsg.deliver_slots(dst, mtype, payload, valid, 100, 2, spill_cap=8,
                          backend="cuda")


def test_wrapper_raises_on_wrong_dtype(card):
    dst, _, payload, valid = _inputs(64, 8, 2, card)
    with pytest.raises(ValueError, match="float32"):
        cm.ring_reduce(dst, payload.double(), valid, 8)


def test_cuda_backend_outside_the_dtypes_raises(card):
    """float16 lies outside the kernels' dtypes: backend="cuda" raises,
    "auto" ranks it (no launch), and int32 and bf16 launch the kernels."""
    dst, mtype, payload, valid = _inputs(2048, 100, 4, card)
    half = payload.half()
    with pytest.raises(ValueError, match="dtype"):
        tsg.deliver(dst, half, valid, 100, mode="merge", backend="cuda")
    with pytest.raises(ValueError, match="dtype"):
        tsg.deliver_slots(dst, mtype, half, valid, 100, 2, backend="cuda")
    tsg.deliver(dst, half, valid, 100)
    tsg.deliver_slots(dst, mtype, half, valid, 100, 2)
    assert cm.LAUNCHES == {"ring_reduce": 0, "ring_slots": 0}
    for dtype in (torch.int32, torch.bfloat16):
        typed = payload.to(dtype)
        tsg.deliver(dst, typed, valid, 100, backend="cuda")
        tsg.deliver_slots(dst, mtype, typed, valid, 100, 2)
    assert cm.LAUNCHES == {"ring_reduce": 2, "ring_slots": 2}


@pytest.mark.parametrize("slots", [0, 2])
def test_sharded_step_launches_one_kernel_per_step(card, slots):
    """The 8-shard cross-shard ring delivers through ONE kernel launch per
    step for all shards, and its carry equals its twin's on the CPU (the
    kernel's plain version): integers bit for bit, payloads within the
    tolerance."""
    build = tbb.build_cross_shard_slots if slots else tbb.build_cross_shard
    kernel = "ring_slots" if slots else "ring_reduce"
    a, b = (build(8, 256, n_devices=8, device=dev) for dev in (card, "cpu"))
    for s in (a, b):
        tbb.seed_ring_full(s)
    a.warmup()
    cm.reset_launches()
    a.run(5)
    b.run(5)
    assert cm.LAUNCHES[kernel] == 5 and sum(cm.LAUNCHES.values()) == 5
    assert (a.read_state("received") == 5).all()
    ca, cb = numpy_carry(a), numpy_carry(b)
    for k in ca:
        if ca[k].dtype.kind == "f":
            np.testing.assert_allclose(ca[k], cb[k], rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


@pytest.mark.parametrize("slots", [0, 2])
def test_region_answers_asks_through_the_ring_kernels(card, slots):
    """A counter region with delivery_backend="cuda" (bounded mailboxes
    when slots > 0) answers a batch with repeated entities and a solo
    ask, before and after a rebalance, as its twin on the CPU does; every
    step launched K1 (reduce) or K2 (slots) once."""
    spec = dict(n_shards=4, entities_per_shard=256, n_devices=2,
                mailbox_slots=slots, spill_capacity=0 if slots else None,
                spare_blocks=2)
    on_card = DeviceShardRegion(DeviceEntity(
        "c", counter_behavior(4), delivery_backend="cuda", **spec),
        device=card)
    twin = DeviceShardRegion(DeviceEntity("c", counter_behavior(4), **spec),
                             device="cpu")
    names = [f"e{i}" for i in range(12)]
    picks = [0, 1, 2, 0, 3, 4, 5, 1, 6, 7, 8, 9, 10, 11, 0]
    on_card.system.warmup()
    cm.reset_launches()
    outs = []
    for r in (on_card, twin):
        refs = [r.entity_ref(n) for n in names]
        reqs = [(refs[i].shard, refs[i].index, [float(i + 1)])
                for i in picks]
        got = r.ask_many(reqs)
        got.append(r.ask(refs[3].shard, refs[3].index, [2.0]))
        r.rebalance(refs[0].shard)
        got += r.ask_many(reqs[:5])
        outs.append(got)
        assert r.ask_pool_stats()["in_flight"] == 0
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    kernel = "ring_slots" if slots else "ring_reduce"
    steps = on_card.system._host_step
    assert cm.LAUNCHES[kernel] == steps and sum(cm.LAUNCHES.values()) == steps



def test_continuous_gateway_serves_through_k1(card):
    """A continuous RegionBackend on the card behind the evloop gateway:
    4 clients, each on its own entities, send pipelined binary adds; every
    reply is its client's running total, the totals are conserved, and
    the region's every step launched K1 once."""
    from akka_tpu_torch.tools import gateway_load as gl
    region = DeviceShardRegion(DeviceEntity(
        "gw", counter_behavior(4), n_shards=4, entities_per_shard=256,
        n_devices=1, spare_blocks=2), device=card)
    region.system.warmup()  # capture before the front end's threads start
    cm.reset_launches()
    backend, srv = gl.serve_stack(region, continuous=True)
    try:
        res = gl.drive(srv.host, srv.port, gl.client_traces(3, 4, 8, 96))
        assert not res.errors, res.errors[:3]
        assert res.requests == 4 * 96
        assert gl.running_totals_hold(res)
        assert backend.batcher.quiesce(60.0)
        assert backend.sum_all() == res.acked
        assert region.ask_pool_stats()["in_flight"] == 0
    finally:
        srv.stop()
        backend.close()
    steps = region.system._host_step
    assert steps > 0
    assert cm.LAUNCHES["ring_reduce"] == steps
    assert sum(cm.LAUNCHES.values()) == steps


@pytest.mark.parametrize("slots", [0, 2])
def test_restore_on_the_card_equals_restore_on_the_cpu(card, tmp_path, slots):
    """The same journaled trace (asks, a checkpoint, more asks, a
    rebalance, tells staged but not stepped) crashes on the card and on
    the CPU; fresh regions restore from each directory. The restored
    carries are equal (integers bit for bit, the integer-valued totals
    exactly), and the card's replay launched K1 (K2 with slots)."""
    spec = dict(n_shards=4, entities_per_shard=64, n_devices=2,
                mailbox_slots=slots, spill_capacity=0 if slots else None,
                spare_blocks=2)
    names = [f"e{i}" for i in range(24)]

    def crash(device, d):
        r = DeviceShardRegion(DeviceEntity("c", counter_behavior(4),
                                           **spec), device=device)
        r.attach_journal(d)
        r.attach_entity_journal(d)
        refs = [r.entity_ref(n) for n in names]
        for k in range(4):
            r.ask_many([(refs[i].shard, refs[i].index, [float(i + k)])
                        for i in range(k, 24, 3)])
            if k == 1:
                r.checkpoint()
        r.rebalance(refs[0].shard)
        for ref in refs[::5]:
            ref.tell([2.0, 0.0, 0.0, -1.0])

    def restore(device, d):
        r = DeviceShardRegion(DeviceEntity("c", counter_behavior(4),
                                           **spec), device=device)
        r.attach_journal(d)
        r.attach_entity_journal(d)
        cm.reset_launches()
        r.restore()
        launches = dict(cm.LAUNCHES)
        return r, launches

    crash(card, str(tmp_path / "card"))
    crash("cpu", str(tmp_path / "cpu"))
    on_card, launches = restore(card, str(tmp_path / "card"))
    on_cpu, _ = restore("cpu", str(tmp_path / "cpu"))
    kernel = "ring_slots" if slots else "ring_reduce"
    assert launches[kernel] >= 2  # the replay's steps and the flush
    ca, cb = numpy_carry(on_card.system), numpy_carry(on_cpu.system)
    for k in ca:
        if k == "state/__promise_reply":
            np.testing.assert_allclose(ca[k], cb[k], rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert on_card._durable_replayed_totals == \
        on_cpu._durable_replayed_totals


# ------------------------------------------------------ the compiled step

def _assert_twins(a, b, ctx):
    """Integer carry fields bit-equal, float fields within the kernel
    tolerance."""
    ca, cb = numpy_carry(a), numpy_carry(b)
    assert sorted(ca) == sorted(cb), ctx
    for k in ca:
        if ca[k].dtype.kind == "f":
            np.testing.assert_allclose(ca[k], cb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(ca[k], cb[k], err_msg=f"{ctx} {k}")


def _eager_twin(system):
    """The same system stepping eagerly (the private `_step_impl` loop)."""
    system._eager = True
    return system


@pytest.mark.parametrize("cell", ["ring", "ring_slots", "cross_shard_d8"])
def test_graph_replays_match_the_eager_twin(card, cell):
    """run(n), step() and staged tells through the step's CUDA graph give
    the eager step's carry; the graph was captured once, the live carry
    kept its storage, and K1 (K2 for slots) launched once per step by
    replay count."""
    build = {"ring": lambda: tbb.build_ring(2048, static=False,
                                            device=card),
             "ring_slots": lambda: tbb.build_ring_slots(2048, 2,
                                                        device=card),
             "cross_shard_d8": lambda: tbb.build_cross_shard(
                 16, 64, n_devices=8, device=card)}[cell]
    kernel = "ring_slots" if cell == "ring_slots" else "ring_reduce"
    g, e = build(), _eager_twin(build())
    for s in (g, e):
        tbb.seed_ring_full(s)
    ptr = g.inbox_dst.data_ptr()
    g.warmup()
    _assert_twins(g, e, "warmup leaves the carry")
    assert g._graphs.stats()["captures"] == 1
    cm.reset_launches()
    for s in (g, e):
        s.run(5)
        s.tell(3, [1.0, 0.0, 0.0, 0.0])
        s.step()
        s.run(2)
    assert cm.LAUNCHES[kernel] == 16  # 8 graph steps + 8 eager ones
    assert g._graphs.stats()["captures"] == 1
    assert g.inbox_dst.data_ptr() == ptr
    _assert_twins(g, e, cell)
    want = np.full(g.capacity, 8, np.int32)
    want[3] += 1  # the told row
    np.testing.assert_array_equal(g.read_state("received"), want)


def test_static_ring_graph_matches_the_eager_twin(card):
    """The static ring (kind shift) through the step's CUDA graph gives
    the eager step's carry and the dynamic ring's, with staged tells, and
    launches no ring kernel; its topology lives on the card."""
    g, e = tbb.build_ring(2048, device=card), \
        _eager_twin(tbb.build_ring(2048, device=card))
    dynamic = tbb.build_ring(2048, static=False, device=card)
    assert g._core.topology.kind == "shift"
    for s in (g, e, dynamic):
        tbb.seed_ring_full(s)
    g.warmup()
    dynamic.warmup()
    cm.reset_launches()
    for s in (g, e):
        s.run(5)
        s.tell(3, [1.0, 0.0, 0.0, 0.0])
        s.step()
        s.run(2)
    assert cm.LAUNCHES == {"ring_reduce": 0, "ring_slots": 0}
    dynamic.run(5)
    dynamic.tell(3, [1.0, 0.0, 0.0, 0.0])
    dynamic.step()
    dynamic.run(2)
    assert g._graphs.stats()["captures"] == 1
    _assert_twins(g, e, "static ring")
    _assert_twins(g, dynamic, "static ring vs dynamic")
    want = np.full(g.capacity, 8, np.int32)
    want[3] += 1
    np.testing.assert_array_equal(g.read_state("received"), want)


def test_spill_region_at_width_answers_every_ask(card):
    """A full-width slots region (256 x 4096 entities, 2 slots) with its
    default spill region runs the ranked kernels on the card; its summed
    reply-row ids pass 2^24 over the inbox, so every reply must still
    equal the host oracle's running total (ROADMAP A14)."""
    region = DeviceShardRegion(DeviceEntity(
        "c", counter_behavior(4), n_shards=256, entities_per_shard=4096,
        n_devices=1, spare_blocks=2, mailbox_slots=2), device=card)
    assert region.system.spill_cap > 0
    region.system.warmup()
    rng = np.random.default_rng(8)
    oracle = {}
    for _ in range(4):
        names = [f"e{i}" for i in rng.choice(1 << 20, 224, replace=False)]
        names += list(rng.choice(names, 32))
        vals = rng.integers(1, 10, len(names)).astype(float)
        refs = [region.entity_ref(n) for n in names]
        out = region.ask_many([(r.shard, r.index, [v])
                               for r, v in zip(refs, vals)])
        for n, v, o in zip(names, vals, out):
            assert not isinstance(o, BaseException), o
            oracle[n] = oracle.get(n, 0.0) + v
            assert float(o[0]) == oracle[n], n
    assert region.ask_pool_stats()["in_flight"] == 0
    assert cm.LAUNCHES == {"ring_reduce": 0, "ring_slots": 0}


@pytest.mark.parametrize("slots", [0, 2])
def test_region_graph_matches_eager_twin_across_rebalances(card, slots):
    """A region stepping on graphs and its eager twin answer the same ask
    waves across two rebalances with the same replies and carries. The
    captures: the steady graph at warmup, the stray graph at the first
    run of the first hand-off window, none at leaving stray mode (the
    region's run drains the window), at the second rebalance or after
    it."""
    spec = dict(n_shards=4, entities_per_shard=256, n_devices=2,
                mailbox_slots=slots, spill_capacity=0 if slots else None,
                spare_blocks=3)
    regions = [DeviceShardRegion(DeviceEntity("c", counter_behavior(4),
                                              **spec), device=card)
               for _ in range(2)]
    g, e = regions
    _eager_twin(e.system)
    g.system.warmup()
    names = [f"e{i}" for i in range(40)]
    picks = [i % 40 for i in range(0, 120, 7)]

    def captures(r, want):
        return r.system._graphs.stats()["captures"] == (want if r is g
                                                          else 0)

    outs = []
    for r in regions:
        refs = [r.entity_ref(n) for n in names]
        reqs = [(refs[i].shard, refs[i].index, [float(i + 1)])
                for i in picks]
        got = r.ask_many(reqs)
        assert captures(r, 1)
        for k in (0, 1):
            r.rebalance(refs[k].shard)
            got += r.ask_many(reqs[::1 - 2 * k])
            assert r.system.stray_mode
            r.run(8)
            assert not r.system.stray_mode
            assert captures(r, 2)
        got.append(r.ask(refs[5].shard, refs[5].index, [2.0]))
        outs.append(got)
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    _assert_twins(g.system, e.system, f"region slots={slots}")


def test_captures_after_a_resharded_restore(card, tmp_path):
    """A snapshot taken in the hand-off window (its wider inbox) restores
    into a steady system through the re-sharding path: both graphs are
    dropped and the next run captures again, where a same-shape restore
    captures nothing."""
    def build():
        return tbb.build_cross_shard(16, 64, n_devices=4, device=card,
                                     reroute_strays=True)

    a = build()
    tbb.seed_ring_full(a)
    a.run(3)
    a.enter_stray_mode()
    a.run(1)
    wide = a.checkpoint(str(tmp_path / "wide"))
    assert a.exit_stray_mode()
    a.run(1)
    steady = a.checkpoint(str(tmp_path / "steady"))
    assert a._graphs.stats()["captures"] == 2

    b = build()
    b.warmup()
    assert b._graphs.stats()["captures"] == 1
    b.restore(steady)
    b.run(1)
    assert b._graphs.stats()["captures"] == 1  # same shape: in place
    b.restore(wide)
    assert b._graphs.stats()["graphs"] == 0
    b.run(2)
    assert b._graphs.stats()["captures"] == 2
    assert (b.read_state("received") > 0).all()


def test_a_behavior_that_syncs_cannot_be_captured(card):
    """A behavior reading a value with .item() makes warmup() raise an
    error naming it; the live carry is untouched and run() raises too:
    nothing falls back to eager."""
    from akka_tpu_torch.batched import BatchedSystem, Emit, behavior
    from akka_tpu_torch.batched.graphs import GraphCaptureError

    @behavior("reads_item", {"n": ((), torch.int32)})
    def reads_item(state, inbox, ctx):
        k = int(inbox.count.sum().item())
        return ({"n": state["n"] + k},
                Emit.none(ctx.actor_id.shape[0], 1, 4, device=card))

    s = BatchedSystem(64, [reads_item], device=card)
    s.spawn_block(0, 64)
    s.tell([1, 2], [1.0, 0.0, 0.0, 0.0])
    before = numpy_carry(s)
    with pytest.raises(GraphCaptureError, match="reads_item"):
        s.warmup()
    after = numpy_carry(s)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    with pytest.raises(GraphCaptureError, match="reads_item"):
        s.run(1)
    assert int(s.step_count.item()) == 0


def test_stray_capture_survives_a_concurrent_pressure_poll(card):
    """The stray graph is captured at the first rebalance, under the ask
    lock, while another thread polls the admission pressure sources (a
    device read each poll) in a loop: the capture holds and the poller
    sees no error."""
    import threading
    from akka_tpu_torch.event.pressure import system_pressure_sources
    region = DeviceShardRegion(DeviceEntity(
        "c", counter_behavior(4), n_shards=4, entities_per_shard=256,
        n_devices=1, spare_blocks=2), device=card)
    region.system.warmup()
    sources = system_pressure_sources(region,
                                      ask_pool_stats=region.ask_pool_stats)
    stop, errors, polls = threading.Event(), [], [0]

    def poll():
        while not stop.is_set():
            try:
                for fn in sources.values():
                    fn()
                polls[0] += 1
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

    refs = [region.entity_ref(f"e{i}") for i in range(32)]
    region.ask_many([(r.shard, r.index, [1.0]) for r in refs])
    t = threading.Thread(target=poll)
    t.start()
    try:
        for k in range(3):
            region.rebalance(refs[k].shard)
            out = region.ask_many([(r.shard, r.index, [1.0]) for r in refs])
            assert [float(o[0]) for o in out] == [k + 2.0] * len(refs)
    finally:
        stop.set()
        t.join()
    assert not errors, errors[:3]
    assert polls[0] > 0
    assert region.system._graphs.stats()["captures"] == 2


# --------------------------------- the region width on the card (A14)

def _region_width_inputs(device):
    """The region's stray-mode inbox at full width (the pattern of
    test_ranked_sums_do_not_cancel_at_region_width in
    tests/test_torch_segment.py): integer payloads, the last column a
    reply-row id, every recipient's total below 2^24 while the running
    total over the inbox passes it."""
    m, n, p = 2_113_792, 1_056_768, 4
    rng = np.random.default_rng(14)
    dst = rng.integers(-1, n + 1, size=m).astype(np.int32)
    valid = rng.random(m) > 0.1
    mtype = rng.integers(1, 5, size=m).astype(np.int32)
    payload = np.empty((m, p), np.float32)
    payload[:, :3] = rng.integers(1, 10, size=(m, 3))
    payload[:, 3] = rng.integers(0, n, size=m)
    ok = valid & (dst >= 0) & (dst < n)
    key = np.where(ok, dst, n)
    order = np.argsort(key, kind="stable")
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m) - np.searchsorted(key[order],
                                                 np.arange(n + 1))[key[order]]

    def oracle(rows):
        out = np.zeros((n + 1, p), np.float64)
        np.add.at(out, key[rows], payload[rows].astype(np.float64))
        return out[:n]

    t = [torch.from_numpy(a).to(device) for a in (dst, mtype, payload, valid)]
    return t, n, ok, rank, oracle


def test_ranked_family_at_region_width_is_exact(card):
    """At the region's width every per-recipient sum of the ranked
    kernels on the card (reduce in both modes, the bounded slots path and
    the spill path) equals the float64 oracle exactly, and their integers
    equal K1/K2's: sums are scatter-adds per segment, never differences
    of the running total (ROADMAP A14). The reference's wide family,
    which the port leaves to these kernels, loses those low bits."""
    (dst, mtype, payload, valid), n, ok, rank, oracle = \
        _region_width_inputs(card)
    everything = oracle(ok)
    assert everything[:, 3].max() < 2 ** 24 < everything[:, 3].sum()
    counts, _ = cm.ring_reduce(dst, payload, valid, n)
    for mode in ("merge", "sort"):
        got = tsg.deliver(dst, payload, valid, n, mode=mode,
                          backend="ranked")
        np.testing.assert_array_equal(got.sum.cpu().numpy(), everything,
                                      err_msg=mode)
        assert torch.equal(got.count, counts), mode
    bounded = tsg.deliver_slots(dst, mtype, payload, valid, n, 2,
                                backend="ranked")
    ring = cm.ring_slots(dst, mtype, payload, valid, n, 2)
    for f, want in zip(("types", "payload", "valid", "count", "sum",
                        "dropped"), ring):
        if f != "sum":
            assert torch.equal(getattr(bounded, f), want), f
    np.testing.assert_array_equal(bounded.sum.cpu().numpy(), everything)
    spill = tsg.deliver_slots(dst, mtype, payload, valid, n, 2,
                              spill_cap=4096, backend="ranked")
    np.testing.assert_array_equal(spill.sum.cpu().numpy(),
                                  oracle(ok & (rank < 2)))
    for f in ("types", "payload", "valid"):
        assert torch.equal(getattr(spill, f), getattr(bounded, f)), f
    # with a spill region a mailbox consumes its first two, the rest spill
    assert torch.equal(spill.count, bounded.count.clamp(max=2))


# ------------------------------------------ the observed step (telemetry)

@pytest.mark.parametrize("cell", ["ring", "cross_shard_d8"])
def test_graph_epoch_and_drain_match_the_eager_twin(card, cell):
    """With the metric slab on, the epoch the captured step writes in
    place and the lanes drain_metrics() hands over equal the eager step's,
    run after run; a quiet system keeps its epoch at 0."""
    build = {"ring": lambda: tbb.build_ring(2048, static=False, device=card,
                                            metrics_enabled=True),
             "cross_shard_d8": lambda: tbb.build_cross_shard(
                 16, 64, n_devices=8, device=card,
                 metrics_enabled=True)}[cell]
    g, e, quiet = build(), _eager_twin(build()), build()
    for s in (g, e):
        tbb.seed_ring_full(s)
    word = g.metrics_epoch.data_ptr()
    g.warmup()
    quiet.warmup()
    assert g.metrics_epoch_value() == 0  # the warm-up ran on clones
    for k in (5, 3):
        for s in (g, e, quiet):
            s.run(k)
        assert g.metrics_epoch_value() == e.metrics_epoch_value() > 0
        got, want = g.drain_metrics(), e.drain_metrics()
        assert got is not None and got[0] == want[0] == g._host_step
        for lane, buckets in want[1].items():
            np.testing.assert_array_equal(got[1][lane], buckets)
        assert g.drain_metrics() is None and e.drain_metrics() is None
        assert quiet.metrics_epoch_value() == 0
        assert quiet.drain_metrics() is None
    assert g.metrics_epoch.data_ptr() == word
    assert g._graphs.stats()["captures"] == 1


def test_registry_sinks_start_and_close_joins_them(card, tmp_path):
    """The registry's HTTP endpoint answers a scrape with the drained
    device lanes, its JSONL emitter writes rows, and close() joins both
    threads."""
    import json
    import time
    import urllib.request

    from akka_tpu_torch.event.metrics import MetricsRegistry

    s = tbb.build_ring(2048, static=False, device=card,
                       metrics_enabled=True)
    tbb.seed_ring_full(s)
    s.run(4)
    step, lanes = s.drain_metrics()
    reg = MetricsRegistry()
    reg.ingest_device_slab(lanes, step)
    try:
        port = reg.serve_http(0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        assert f"akka_device_mailbox_occupancy_count {4 * 2048}" in body
        path = tmp_path / "m" / "metrics.jsonl"
        reg.start_jsonl(str(path), interval_s=0.05)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and (
                not path.exists() or len(path.read_text().splitlines()) < 2):
            time.sleep(0.05)
        threads = (reg._http_thread, reg._jsonl_thread)
    finally:
        reg.close()
    assert all(t is not None and not t.is_alive() for t in threads)
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(rows) >= 3
    assert rows[-1]["device"]["device_mailbox_occupancy"]["step"] == step


def test_profiler_trace_holds_the_step(card, tmp_path):
    """start_trace/stop_trace return True, the Chrome trace holds the
    akka.device.step range and the K1 launch of the replayed step, and a
    second stop returns False."""
    import json

    from akka_tpu_torch.event.flight_recorder import start_trace, stop_trace

    s = tbb.build_ring(2048, static=False, device=card)
    tbb.seed_ring_full(s)
    s.warmup()
    s.step()
    assert start_trace(str(tmp_path))
    assert not start_trace(str(tmp_path))  # one trace at a time
    s.step()
    assert stop_trace()
    assert not stop_trace()
    (path,) = tmp_path.glob("*.json")
    evs = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "akka.device.step" for e in evs)
    assert any(e.get("cat") == "kernel" and "ring_sweep" in e.get("name", "")
               for e in evs)


# ------------------------------------------- device actors (the bridge)
def _actor_config(**dispatcher):
    return {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                     "actor": {"tpu-dispatcher": dispatcher}}}


def test_actor_ring_matches_a_bare_ring_at_full_width(card):
    """system.actor_of(device_props(ring)) at 2^20 rows (256 promise rows
    after the block), seeded by one DeviceBlockRef.tell and stepped by
    the handle, against a bare BatchedSystem ring of the same behavior:
    the received counts bit-equal, one K1 launch a step."""
    from akka_tpu_torch import ActorSystem
    from akka_tpu_torch.batched import BatchedSystem, device_props, get_handle
    n = 1 << 20
    block_n = n - 256
    ring_n = tbb.make_block_ring_behavior(block_n)
    system = ActorSystem.create("cuda-actor-ring", _actor_config(
        capacity=n, **{"payload-width": tbb.PAYLOAD_W, "promise-rows": 256,
                       "host-inbox": block_n}))
    try:
        block = system.actor_of(device_props(ring_n, n=block_n), "ring")
        h = get_handle(system)
        h.runtime  # built and captured
        cm.reset_launches()
        block.tell((0, [1.0, 0.0, 0.0, 0.0]))
        h.step(8)
        steps = h.runtime._host_step
        assert cm.LAUNCHES["ring_reduce"] == steps >= 8
        got = block.read_state("received")
    finally:
        system.terminate()
        assert system.await_termination(30.0)
    bare = BatchedSystem(capacity=block_n, behaviors=[ring_n],
                         payload_width=tbb.PAYLOAD_W, host_inbox=8,
                         device="cuda")
    bare.spawn_block(ring_n, block_n)
    tbb.seed_ring_full(bare)
    bare.run(steps)
    np.testing.assert_array_equal(got, bare.read_state("received"))
    assert (got == steps).all()


def test_pump_attention_words_are_each_their_own_step(card):
    """The graph writes each step's attention word into one carried
    tensor: the depth-4 pipeline retires, in order, the word each step
    wrote (its step lane 1, 2, ...), never the newest one four times."""
    from akka_tpu_torch.batched.bridge import BatchedRuntimeHandle
    from akka_tpu_torch.batched.supervision import ATT_STEP
    h = BatchedRuntimeHandle(capacity=1024, payload_width=tbb.PAYLOAD_W,
                             host_inbox=16, promise_rows=8, pipeline_depth=4)
    try:
        h.spawn(tbb.ring_behavior, 16)
        h.runtime
        retired = []
        drain = h._drain_one

        def record(inflight):
            host, copied = inflight[0]
            if copied is not None:  # the word's copy has landed
                copied.synchronize()
            retired.append(int(host[ATT_STEP]))
            return drain(inflight)

        h._drain_one = record
        h.step(32)
        assert retired == list(range(1, 33))
    finally:
        h.shutdown()


def test_rebuild_under_a_live_pump(card):
    """A new behavior type spawned while the pump serves asks: the system
    is rebuilt (a new capture over the same tensors), every ask resolves
    with its own reply, the always-on rows count every step through the
    rebuild, and a tell to the new behavior lands once."""
    from akka_tpu_torch.batched import Emit, behavior
    from akka_tpu_torch.batched.bridge import BatchedRuntimeHandle, reply_dst
    P = tbb.PAYLOAD_W

    @behavior("cuda-acc", {"acc": ((), torch.int32)}, always_on=True)
    def acc(state, inbox, ctx):
        return ({"acc": state["acc"] + 1},
                Emit.none(ctx.actor_id.shape[0], 1, P,
                          device=ctx.actor_id.device))

    @behavior("cuda-echo", {})
    def echo(state, inbox, ctx):
        return state, Emit.single(reply_dst(inbox.sum), inbox.sum * 2, 1, P,
                                  when=inbox.count > 0)

    @behavior("cuda-late", {"seen": ((), torch.float32)})
    def late(state, inbox, ctx):
        return ({"seen": state["seen"] + inbox.sum[:, 0]},
                Emit.none(ctx.actor_id.shape[0], 1, P,
                          device=ctx.actor_id.device))

    h = BatchedRuntimeHandle(capacity=4096, payload_width=P, host_inbox=64,
                             promise_rows=64, pipeline_depth=4)
    try:
        rows = h.spawn(acc, 64)
        echoes = h.spawn(echo, 32)
        old = h.runtime
        futs = [(h.ask(int(r), (0, [float(i + 1)]), timeout=30.0), i + 1)
                for i, r in enumerate(echoes)]
        lrow = h.spawn(late, 1)  # rebuild with the pump live
        assert h.runtime is not old
        assert h.runtime._graphs.captures == 1
        h.tell(int(lrow[0]), (0, [5.0]))
        for f, v in futs:
            assert float(f.result(30.0)[0]) == 2.0 * v
        h.step(2)
        a = h.read_state("acc", rows)
        assert np.unique(a).size == 1
        assert int(a[0]) == h.runtime._host_step
        assert float(h.read_state("seen", lrow)[0]) == 5.0
    finally:
        h.shutdown()


# ----------------- BASELINE configs 4 and 1, CRDT banks, device pipelines
@pytest.mark.parametrize("name", ["build_router", "build_router_api"])
def test_router_step_graph_matches_eager(card, name):
    """The router pool (producers routing through an index map, and
    through BatchedRouter.route) as graph replays against its eager twin:
    K1 once a step, hits bit-equal and closed-form."""
    build = getattr(tbb, name)
    g = build(n_producers=4096, n_routees=1000, device="cuda")
    e = build(n_producers=4096, n_routees=1000, device="cuda")
    e._eager = True
    g.warmup()
    cm.reset_launches()
    g.run(12)
    assert cm.LAUNCHES["ring_reduce"] == 12
    e.run(12)
    hits = g.read_state("hits")[:1000]
    np.testing.assert_array_equal(hits, e.read_state("hits")[:1000])
    assert int(hits.sum()) == 11 * 4096
    assert int(hits.max() - hits.min()) <= 11


def test_route_is_capturable_and_matches_eager(card):
    from akka_tpu_torch.routing.batched import BatchedRouter
    keys = torch.randint(-2**31, 2**31 - 1, (4096,), dtype=torch.int32,
                         device=card)
    step = torch.zeros((), dtype=torch.int32, device=card)
    for logic in BatchedRouter.LOGICS:
        r = BatchedRouter(logic, 7, 1000)
        want = r.route(keys, step)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            r.route(keys, step)  # warm
            graph.capture_begin()
            out = r.route(keys, step)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), logic
        np.testing.assert_array_equal(
            out.cpu().numpy(),
            r.route(keys.cpu(), step.cpu()).numpy())


def test_ping_pong_on_the_card_for_both_staging_paths(card):
    for native in (True, False):
        s = tbb.build_ping_pong(device="cuda", native_staging=native)
        s.tell(0, [1.0, 0, 0, 0])
        s.run(10)
        hits = s.read_state("hits")
        assert hits[0] + hits[1] == 10 and s.native_staging is native


def test_banks_on_cuda_tensors_match_the_cpu(card):
    from akka_tpu_torch.ddata import tensor as tt
    g = torch.Generator().manual_seed(2)
    a = torch.randint(-2**31, 2**31 - 1, (64, 4), generator=g,
                      dtype=torch.int32).view(torch.uint32)
    b = torch.randint(-2**31, 2**31 - 1, (64, 4), generator=g,
                      dtype=torch.int32).view(torch.uint32)
    pn = torch.randint(-2**31, 2**31 - 1, (64, 2, 4), generator=g,
                       dtype=torch.int32).view(torch.uint32)
    keys = torch.tensor([1, 1, 5, 63, 1])
    amounts = torch.tensor([-2**31, -2**31, 7, -1, 3], dtype=torch.int32)

    def same(fn, *args):
        got = fn(*(x.to(card) if isinstance(x, torch.Tensor) else x
                   for x in args))
        want = fn(*args)
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu().view(torch.int32)
                           if got.dtype == torch.uint32 else got.cpu(),
                           want.view(torch.int32)
                           if want.dtype == torch.uint32 else want)

    same(tt.gcounter_merge, a, b)
    same(tt.gcounter_value, a)
    same(tt.pncounter_merge, pn, pn.flip(0))
    same(tt.pncounter_value, pn)
    same(tt.gcounter_increment, a, 2, keys, amounts)
    same(tt.gset_merge, a.view(torch.int32) > 0, b.view(torch.int32) > 0)


def _chain(device, eager=False):
    from akka_tpu_torch.stream import DevicePipeline
    p = (DevicePipeline(device=device).map(lambda x: x * 3.0 - 1.0)
         .filter(lambda x: x > 0.5).map(lambda x: x * 0.5)
         .scan(lambda c, x: ((c[0] + (x != 0).sum(),
                              torch.maximum(c[1], x.max())),
                             x + c[0].to(torch.float32)),
               (torch.tensor(0, dtype=torch.int32), torch.tensor(0.0))))
    if eager:
        p._eager = True  # the eager twin of a chain on the card
    return p


def test_device_pipeline_replay_matches_eager(card):
    chunks = torch.randn((6, 4096), generator=torch.Generator(
        device="cuda").manual_seed(1), device=card)
    g, e, c = _chain(card), _chain(card, eager=True), _chain("cpu")
    for path in ("stacked", "iterable"):
        arg = chunks if path == "stacked" else list(chunks)
        (go, gm, gc), (eo, em, ec) = g.run(arg), e.run(arg)
        assert torch.equal(go, eo) and torch.equal(gm, em), path
        assert torch.equal(gc[0], ec[0]) and torch.equal(gc[1], ec[1])
        co, cmask, cc = c.run(chunks.cpu())
        assert torch.equal(gm.cpu(), cmask) and int(gc[0]) == int(cc[0])
    assert g.compile().captures == 1  # one shape, one capture
    with pytest.raises(ValueError, match="chunk 1"):  # not broadcast
        g.run([chunks[0], chunks[1, :1]])


def test_device_pipeline_that_syncs_cannot_be_captured(card):
    from akka_tpu_torch.batched.graphs import GraphCaptureError
    from akka_tpu_torch.stream import DevicePipeline

    def host_read(x):
        return x * float(x.sum().item())

    p = DevicePipeline(device=card).map(lambda x: x + 1).map(host_read)
    with pytest.raises(GraphCaptureError, match="op 1 .map host_read"):
        p.run(torch.ones((2, 8), device=card))


# ----------------------------------- failover and the elastic mesh (A10.1)
def _fo_sum():
    from akka_tpu_torch.batched import Emit, behavior

    @behavior("fo_sum", {"total": ((), torch.float32)})
    def fo_sum(state, inbox, ctx):
        return ({"total": state["total"] + inbox.sum[:, 0]},
                Emit.none(inbox.sum.shape[0], 1, 4, device=inbox.sum.device))
    return fo_sum


def _one_late_loss(hits) -> bool:
    """One scheduled loss, on the last of 4 slots, at step 6..16."""
    return len(hits) == 1 and hits[0][1] == 3 and 6 <= hits[0][0] <= 16


def _fo_drive(s, clk, sched, upto, staged):
    while s.host_step < upto:
        hs = s.host_step
        if hs in sched and hs not in staged:
            s.tell(sched[hs][0], [sched[hs][1], 0.0, 0.0, 0.0])
            staged.add(hs)
        clk["t"] += 0.1
        s.step(1)


@pytest.mark.parametrize("slots", [0, 2])
def test_sentinel_failover_on_the_card_matches_the_cpu(card, tmp_path,
                                                       slots):
    """One DeviceLossInjector schedule on a card sentinel and a CPU one
    (4 slots, 48 rows): both fail over 4 -> 3 at the same step, the card's
    first post-failover drain waited on its step's event (MTTR closed),
    the rebuild captured a graph for the survivors, and the totals are
    equal; the old system's graphs are gone."""
    from akka_tpu_torch.batched import MeshSentinel
    from akka_tpu_torch.testkit.chaos import (DeviceLossInjector,
                                              loss_schedule_np)
    seed = next(s for s in range(30000) if _one_late_loss(
        np.argwhere(loss_schedule_np(s, 41, 4, 0.012))))
    rng = np.random.default_rng(seed)
    sched = {s: (int(rng.integers(0, 8)), float(1 + s % 5))
             for s in range(0, 40, 3)}
    out = {}
    for dev in ("cuda", "cpu"):
        clk = {"t": 0.0}
        s = MeshSentinel(48, [_fo_sum()],
                         checkpoint_dir=str(tmp_path / dev), n_devices=4,
                         payload_width=4, checkpoint_interval_steps=4,
                         mailbox_slots=slots,
                         spill_capacity=0 if slots else None,
                         detector_threshold=3.0, heartbeat_interval=0.1,
                         acceptable_pause=0.3, failover_min_backoff=0.35,
                         clock=lambda: clk["t"], device=dev,
                         injector=DeviceLossInjector(seed, 4,
                                                     loss_rate=0.012))
        rows = s.spawn(0, 8)
        old = s.system
        _fo_drive(s, clk, sched, 40, set())
        st = s.failover_stats
        assert len(st) == 1 and st[0]["mttr_s"] is not None
        assert s.system is not old and not old._graphs.graphs
        out[dev] = (s.read_state("total", rows),
                    {k: st[0][k] for k in ("lost_shards", "survivors",
                                           "evicted_at_step",
                                           "restored_step")},
                    s.system._graphs.stats()["captures"])
        s.shutdown()
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0


def test_sentinel_scale_walk_on_the_card_keeps_asks_and_drops_graphs(
        card, tmp_path):
    """scale_to 2 -> 4 -> 8 -> 4 on the card with asks in flight: every
    reply arrives, every rebuild captures one graph and leaves the old
    system with none, and the snapshot writer's file holds the barrier
    state."""
    from akka_tpu_torch.batched import Emit, MeshSentinel, behavior
    from akka_tpu_torch.parallel import shard_slots

    @behavior("fo_echo", {"seen": ((), torch.float32)})
    def echo(state, inbox, ctx):
        body = torch.zeros_like(inbox.sum)
        body[:, 0] = inbox.sum[:, 0] * 2.0
        return ({"seen": state["seen"] + inbox.sum[:, 0]},
                Emit.single(inbox.sum[:, -1].to(torch.int32), body, 1, 4,
                            when=inbox.count > 0))

    s = MeshSentinel(64, [echo], checkpoint_dir=str(tmp_path), n_devices=2,
                     payload_width=4, promise_rows=8,
                     failover_min_backoff=0.0)
    rows = s.spawn(0, 16)
    pool = shard_slots(8)
    for w in (4, 8, 4):
        futs = [(i, s.ask(int(rows[i]), [float(i + 1)], timeout=10.0))
                for i in range(4)]
        s.step(1)
        old = s.system
        s.scale_to(pool[:w])
        assert not old._graphs.graphs and s.system._graphs.graphs
        s.step(3)
        for i, f in futs:
            assert float(f.result(10.0)[0]) == 2.0 * (i + 1)
    s.shutdown()


def test_region_failover_on_the_card_matches_the_cpu(card, tmp_path):
    """A region on 2 slots with both journals, 6 ask waves, a checkpoint,
    3 waves, failover to 1 slot and 3 waves: the card's replies and
    totals equal the CPU region's."""
    rng = np.random.default_rng(5)
    waves = [[(f"e{int(x)}", float(v)) for x, v in zip(
        rng.integers(0, 40, 16), rng.integers(1, 9, 16))]
        for _ in range(12)]
    got = {}
    for dev in ("cuda", "cpu"):
        r = DeviceShardRegion(DeviceEntity(
            "fo", counter_behavior(4), n_shards=4, entities_per_shard=32,
            n_devices=2, spare_blocks=2), device=dev)
        r.attach_journal(str(tmp_path / dev))
        r.attach_entity_journal(str(tmp_path / dev))
        replies = []

        def run(ws):
            for w in ws:
                refs = [r.entity_ref(n) for n, _ in w]
                outs = r.ask_many([(x.shard, x.index, [v])
                                   for x, (_, v) in zip(refs, w)])
                replies.append([float(o[0]) for o in outs])
        run(waves[:6])
        r.checkpoint()
        run(waves[6:9])
        step = r.failover(list(r.system.mesh.slots[:1]))
        run(waves[9:])
        got[dev] = (replies, step, r.system.n_shards,
                    r.system.read_state("total"))
    assert got["cuda"][:3] == got["cpu"][:3]
    assert got["cuda"][2] == 1
    np.testing.assert_array_equal(got["cuda"][3], got["cpu"][3])


def test_bank_convergence_on_the_card_matches_the_cpu(card):
    from akka_tpu_torch.ddata import tensor as tt
    from akka_tpu_torch.parallel import make_mesh
    g = torch.Generator().manual_seed(3)
    bank = torch.randint(0, 2**31 - 1, (4, 64, 4), generator=g,
                         dtype=torch.int32).view(torch.uint32)
    out = {}
    for dev in ("cuda", "cpu"):
        m = make_mesh(4, axis_name="replica", device=dev)
        rep = tt.replicate_bank(bank[0], m)
        assert rep.device.type == dev
        out[dev] = (tt.converge_over_mesh(bank.to(dev), m).cpu()
                    .view(torch.int32), rep.cpu().view(torch.int32))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


# ------------------------------------------------------------------ ranks
def _ring_carry(mesh=None, steps=6, slots=False):
    build = tbb.build_cross_shard_slots if slots else tbb.build_cross_shard
    s = build(8, 256, n_devices=4, mesh=mesh, device="cuda")
    tbb.seed_ring_full(s)
    s.run(steps)
    return numpy_carry(s), s


@pytest.mark.parametrize("slots", [False, True], ids=["ring", "slots"])
def test_gloo_ranks_on_the_card_match_one_card(card, slots):
    """Two gloo ranks (threads) with every tensor on the card, eager
    steps: every rank's global carry equals the one-card system's."""
    from akka_tpu_torch.parallel import make_mesh
    from torch_rank_fixture import run_ranks
    want, _ = _ring_carry(slots=slots)

    def rank(r, group):
        carry, s = _ring_carry(make_mesh(4, device="cuda:0", group=group),
                               slots=slots)
        assert s._eager and s.local_shards == 2
        return carry

    for carry in run_ranks(2, rank, f"card-gloo-{slots}"):
        for k, v in want.items():
            np.testing.assert_array_equal(carry[k], v, err_msg=k)


def test_nccl_world_one_captures_the_collective(card):
    """An NCCL group of world size 1 (initialize_distributed on
    127.0.0.1): the ranked system steps through a CUDA graph with its
    all_to_all_single inside, K1 once a step, equal to the one-card
    system; the group is destroyed after."""
    import socket

    import torch.distributed as dist

    from akka_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                         process_group, shutdown_distributed)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        want, _ = _ring_carry(steps=8)
        mesh = make_mesh(4, group=process_group())
        s = tbb.build_cross_shard(8, 256, n_devices=4, mesh=mesh)
        tbb.seed_ring_full(s)
        assert not s._eager and s.ranks.backend == "nccl"
        s.warmup()
        cm.reset_launches()
        s.run(8)
        assert cm.LAUNCHES["ring_reduce"] == 8
        assert s._graphs.stats()["captures"] == 1
        got = numpy_carry(s)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    finally:
        assert shutdown_distributed()
    assert not dist.is_initialized()


# ------------------- event-sourced typed actors over device counters

ES_ADD, ES_GET = 0, 1


def _es_counter():
    from akka_tpu_torch.batched import Emit, behavior, reply_dst

    @behavior("es_counter", {"count": ((), torch.float32)}, inbox="slots")
    def es_counter(state, mailbox, ctx):
        def apply(carry, t, pl):
            cnt, rdst = carry
            return (torch.where(t == ES_ADD, cnt + pl[:, 0], cnt),
                    torch.where(t == ES_GET, reply_dst(pl), rdst))

        n = ctx.actor_id.shape[0]
        dev = ctx.actor_id.device
        cnt, rdst = mailbox.fold(
            (state["count"], torch.full((n,), -1, dtype=torch.int32,
                                        device=dev)), apply)
        reply = torch.zeros((n, tbb.PAYLOAD_W), device=dev)
        reply[:, 0] = cnt
        return ({"count": cnt},
                Emit.single(rdst, reply, 1, tbb.PAYLOAD_W, when=rdst >= 0))
    return es_counter


def test_event_sourced_behavior_over_device_counters_recovers(card,
                                                              tmp_path):
    """A typed guardian spawns 64 device counters (bounded slots: K2)
    and one EventSourcedBehavior on the file journal and local snapshot
    store under tmp_path; each command adds to a counter, asks it through
    ctx.ask and persists the total it replied. Every reply and counter
    equals a host oracle, K2 launched; a fresh system on the same dirs
    recovers the ledger's state from its snapshot plus the tail."""
    from akka_tpu_torch.batched import device_props
    from akka_tpu_torch.pattern.ask import ask
    from akka_tpu_torch.persistence import (Effect, EventSourcedBehavior,
                                            PersistenceId,
                                            RetentionCriteria)
    from akka_tpu_torch.typed import ActorSystem, Behaviors

    counter = _es_counter()
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {"es-dispatcher": {
                        "type": "tpu-batched", "capacity": 4096,
                        "payload-width": tbb.PAYLOAD_W, "mailbox-slots": 2,
                        "spill-capacity": 0, "promise-rows": 32,
                        "host-inbox": 256}},
                    "persistence": {
                        "journal": {"plugin": "akka.persistence.journal.file",
                                    "file": {"dir": str(tmp_path / "j")}},
                        "snapshot-store": {
                            "plugin": "akka.persistence.snapshot-store.local",
                            "local": {"dir": str(tmp_path / "s")}}}}}

    def guardian():
        def setup(ctx):
            block = ctx.spawn(None, "counters", props=device_props(
                counter, n=64, dispatcher="akka.actor.es-dispatcher"))

            def on_command(state, cmd):
                if cmd[0] == "add":
                    _, k, v, reply_to = cmd
                    block[k].tell((ES_ADD, [v]))
                    ctx.ask(block[k], (ES_GET, [0.0]),
                            lambda got, exc: ("added", k, v,
                                              float(got[0]), reply_to),
                            10.0)
                    return Effect.none()
                if cmd[0] == "added":
                    _, k, v, total, reply_to = cmd
                    return Effect.persist((k, v, total)).then_reply(
                        reply_to, lambda _s: total)
                if cmd[0] == "state":
                    return Effect.reply(cmd[1], state)
                if cmd[0] == "block":
                    return Effect.reply(cmd[1], block)
                return Effect.none()

            return EventSourcedBehavior(
                PersistenceId.of("Ledger", "0"), (0, 0.0),
                on_command, lambda s, e: (s[0] + 1, s[1] + e[2]),
                retention=RetentionCriteria.snapshot_every_n(8))
        return Behaviors.setup(setup)

    rng = np.random.default_rng(3)
    oracle, want = np.zeros(64), (0, 0.0)
    system = ActorSystem.create(guardian(), "es-cuda-1", cfg)
    try:
        cm.reset_launches()
        for _ in range(3):
            picks = rng.choice(64, 7, replace=False)
            futs = []
            for k in picks:
                v = float(rng.integers(1, 50))
                oracle[k] += v
                futs.append((float(oracle[k]), ask(
                    system.guardian, lambda r, k=int(k), v=v:
                    ("add", k, v, r), 10.0, system.classic)))
            for total, f in futs:
                assert f.result(10.0) == total
                want = (want[0] + 1, want[1] + total)
        assert cm.LAUNCHES["ring_slots"] > 0
        block = ask(system.guardian, lambda r: ("block", r), 10.0,
                    system.classic).result(10.0)
        np.testing.assert_array_equal(block.read_state("count"),
                                      oracle.astype(np.float32))
        assert ask(system.guardian, lambda r: ("state", r), 10.0,
                   system.classic).result(10.0) == want
        deadline = time.monotonic() + 10.0   # the last snapshot's write
        while not any("-16-" in f for f in os.listdir(tmp_path / "s")):
            assert time.monotonic() < deadline, "no snapshot at 16"
            time.sleep(0.01)
    finally:
        system.terminate()
        assert system.await_termination(10.0)
    system = ActorSystem.create(guardian(), "es-cuda-2", cfg)
    try:
        assert ask(system.guardian, lambda r: ("state", r), 10.0,
                   system.classic).result(10.0) == want
    finally:
        system.terminate()
        assert system.await_termination(10.0)


# ------------------------------------------- the stream DSL on the card

def _stream_system(name, dispatchers=None):
    from akka_tpu_torch import ActorSystem
    return ActorSystem.create(name, {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0,
        "actor": dict(dispatchers or {})}})


def test_device_pipeline_as_flow_on_the_card_matches_run(card):
    """`as_flow` of a CUDA pipeline runs each element as a replay of the
    pipeline's captured step (one capture, nothing eager, nothing on the
    CPU): every (out, mask) and the final carry bit-equal to `run` of the
    same chain on the same chunks."""
    from akka_tpu_torch.stream import Sink, Source

    chunks = torch.randn((6, 4096), generator=torch.Generator(
        device="cuda").manual_seed(2), device=card)
    flow_pipe, run_pipe = _chain(card), _chain(card)
    system = _stream_system("as-flow-cuda")
    try:
        got = Source.from_iterable(chunks).via(flow_pipe.as_flow()) \
            .run_with(Sink.seq(), system).result(10.0)
    finally:
        system.terminate()
        assert system.await_termination(10.0)
    ro, rm, (rc, rx) = run_pipe.run(chunks)
    assert len(got) == 6
    for i, (o, m) in enumerate(got):
        assert o.is_cuda and m.is_cuda
        assert torch.equal(o, ro[i]) and torch.equal(m, rm[i]), i
    step = flow_pipe.compile()
    assert step.captures == 1
    ((c_n, c_max),) = [s.carry for s in step.slots.values()]
    assert torch.equal(c_n, rc) and torch.equal(c_max, rx)


def _ask_log():
    from akka_tpu_torch.batched import Emit, behavior, reply_dst

    @behavior("ask_log", {"total": ((), torch.float32)}, inbox="slots")
    def ask_log(state, mailbox, ctx):
        """Each message adds payload[0] in slot order; each gets its own
        reply, the total after it."""
        n, slots = mailbox.valid.shape
        dev = ctx.actor_id.device
        total = state["total"]
        dst = torch.full((n, slots), -1, dtype=torch.int32, device=dev)
        pay = torch.zeros((n, slots, tbb.PAYLOAD_W), device=dev)
        for j in range(slots):
            v = mailbox.valid[:, j]
            total = torch.where(v, total + mailbox.payload[:, j, 0], total)
            dst[:, j] = torch.where(v, reply_dst(mailbox.payload[:, j]), -1)
            pay[:, j, 0] = total
        return {"total": total}, Emit(dst=dst, payload=pay, valid=dst >= 0,
                                      type=torch.zeros_like(dst))
    return ask_log


def test_flow_ask_of_a_cuda_device_block_matches_the_oracle(card):
    """A stream asks device actors on the card (bounded slots: K2): map_async
    of a tell and an ask over 64 counters (Flow.ask's body over many refs;
    a row's asks never in flight together), then Flow().ask(4, ref) on one
    row whose behavior answers every message of a step. Every reply
    equals the host oracle in element order, and K2 launched."""
    from akka_tpu_torch.batched import device_props
    from akka_tpu_torch.pattern.ask import ask
    from akka_tpu_torch.stream import Flow, Sink, Source

    base = {"type": "tpu-batched", "capacity": 4096,
            "payload-width": tbb.PAYLOAD_W, "spill-capacity": 0,
            "promise-rows": 64, "host-inbox": 1024}
    system = _stream_system("flow-ask-cuda", {
        "many-dispatcher": {**base, "mailbox-slots": 2},
        "one-dispatcher": {**base, "mailbox-slots": 4, "out-degree": 4}})
    rng = np.random.default_rng(8)
    rows = np.tile(rng.permutation(64), 4)  # a row every 64 elements
    vals = rng.integers(1, 50, rows.shape[0]).astype(np.float64)
    oracle, want = np.zeros(64), []
    for r, v in zip(rows, vals):
        oracle[r] += v
        want.append(oracle[r])
    one_vals = rng.integers(1, 50, 40).astype(np.float64)
    try:
        block = system.actor_of(device_props(
            _es_counter(), n=64, dispatcher="akka.actor.many-dispatcher"),
            "counters")
        one = system.actor_of(device_props(
            _ask_log(), n=1, dispatcher="akka.actor.one-dispatcher"), "log")
        cm.reset_launches()

        def tell_ask(e):
            r, v = e
            block[r].tell((ES_ADD, [v]))
            return ask(block[r], (ES_GET, [0.0]), 10.0)
        got = Source.from_iterable(list(zip(rows.tolist(), vals.tolist()))) \
            .map_async(16, tell_ask).run_with(Sink.seq(), system) \
            .result(10.0)
        assert [float(g[0]) for g in got] == want
        got1 = Source.from_iterable([(ES_ADD, [v]) for v in one_vals]) \
            .via(Flow().ask(4, one, 10.0)).run_with(Sink.seq(), system) \
            .result(10.0)
        assert [float(g[0]) for g in got1] == np.cumsum(one_vals).tolist()
        assert cm.LAUNCHES["ring_slots"] > 0
        np.testing.assert_array_equal(block.read_state("count"),
                                      oracle.astype(np.float32))
    finally:
        system.terminate()
        assert system.await_termination(10.0)
