"""Card-only tests of the PyTorch port: the ring-mailbox CUDA kernels
against their plain versions, the delivery seam on CUDA tensors, and the
sharded system and the region's ask path through the kernels.

They skip without a CUDA device. On a machine with a card (and no JAX),
run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

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


def test_misaligned_payload_takes_the_scalar_path(card):
    m, n, p = 3001, 500, 4
    dst, mtype, payload, valid = _inputs(m, n, p, card, seed=11)
    # a contiguous [m, 4] view 4 bytes past a 16-byte boundary
    shifted = torch.empty(m * p + 1, device=card)[1:].view(m, p)
    shifted.copy_(payload)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _assert_kernels_match(dst, mtype, shifted, valid, n, 3)


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
