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
    dst, mtype, payload, valid = _inputs(m, n, p, card, seed=m)
    got = cm.ring_reduce(dst, payload, valid, n)
    want = cm.ring_reduce_plain(dst, payload, valid, n)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
    got = cm.ring_slots(dst, mtype, payload, valid, n, slots)
    want = cm.ring_slots_plain(dst, mtype, payload, valid, n, slots)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[4], want[4], rtol=RTOL, atol=ATOL)
    assert cm.LAUNCHES == {"ring_reduce": 1, "ring_slots": 1}


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
