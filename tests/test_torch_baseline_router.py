"""BASELINE configs 4 (the router pool) and 1 (ping-pong) in the port
(akka_tpu_torch/models/baseline_benches.py) against the reference's
builders: the reference's own checks (tests/test_baseline_benches.py)
run on both packages, and the port's `hits` are bit-identical to the
reference's."""

import numpy as np
import pytest

from akka_tpu.models import baseline_benches as jbb
from akka_tpu_torch.models import baseline_benches as tbb

N_ROUTEES, N_PRODUCERS, STEPS = 64, 1024, 5


def _router_hits(build, **kw):
    s = build(n_producers=N_PRODUCERS, n_routees=N_ROUTEES, **kw)
    s.run(STEPS)
    s.block_until_ready()
    return s.read_state("hits")[:N_ROUTEES]


@pytest.mark.parametrize("name", ["build_router", "build_router_api"])
def test_router_spread_matches_the_reference(name):
    want = _router_hits(getattr(jbb, name))
    got = _router_hits(getattr(tbb, name), device="cpu")
    for hits in (want, got):
        assert hits.sum() == (STEPS - 1) * N_PRODUCERS
        # RoundRobin spreads evenly: every routee within 1 delivery-step
        assert hits.max() - hits.min() <= 4 * (N_PRODUCERS // N_ROUTEES)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_router_api_routes_like_the_hand_written_router():
    np.testing.assert_array_equal(
        _router_hits(tbb.build_router_api, device="cpu"),
        _router_hits(tbb.build_router, device="cpu"))


def test_router_producers_stay_dynamic():
    """The (id + step) term keeps the static-topology compiler off: the
    router delivers dynamically (through K1 on a card)."""
    s = tbb.build_router(n_producers=64, n_routees=8, device="cpu")
    assert s._core.topology is None


@pytest.mark.parametrize("native", [None, False])
def test_ping_pong_round_trip_matches_the_reference(native):
    ref = jbb.build_ping_pong()
    port = tbb.build_ping_pong(device="cpu", native_staging=native)
    for s in (ref, port):
        s.tell(0, [1.0, 0, 0, 0])
        s.run(10)
        s.block_until_ready()
    hits = port.read_state("hits")
    assert hits[0] + hits[1] == 10
    np.testing.assert_array_equal(hits, np.asarray(ref.read_state("hits")))
