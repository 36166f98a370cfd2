"""Card-only tests of the PyTorch port: the ring-mailbox CUDA kernels
against their plain versions, and the delivery seam on CUDA tensors.

They skip without a CUDA device. On a machine with a card (and no JAX),
run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from akka_tpu_torch.ops import cuda_mailbox as cm
from akka_tpu_torch.ops import segment as tsg
from akka_tpu_torch.tools import bench_mailbox as bm

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
