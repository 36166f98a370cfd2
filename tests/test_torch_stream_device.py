"""The port's DevicePipeline (akka_tpu_torch/stream/device.py) against the
reference's (akka_tpu/stream/device.py): the fused ops and the scan
carry of tests/test_stream.py on the stacked and the iterable paths, a
tuple carry, mask-based filters, compact, and the refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_tpu.stream import DevicePipeline as JPipe
from akka_tpu_torch.stream import DevicePipeline as TPipe


def _fused(pipe_cls, **kw):
    return (pipe_cls(**kw).map(lambda x: x * 2)
            .filter(lambda x: x % 3 == 0)
            .map(lambda x: x + 1))


@pytest.mark.parametrize("path", ["stacked", "iterable"])
def test_device_pipeline_fused_ops(path):
    chunks = np.arange(32).reshape(4, 8)  # 4 chunks of 8
    ref = _fused(JPipe).run(jnp.asarray(chunks) if path == "stacked"
                            else list(chunks))
    port = _fused(TPipe, device="cpu").run(
        torch.from_numpy(chunks) if path == "stacked" else list(chunks))
    outs, masks, carry = port
    np.testing.assert_array_equal(outs.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref[1]))
    assert masks.dtype == torch.bool and int(carry) == 0
    got = TPipe.compact(outs, masks)
    expect = np.array([x * 2 + 1 for x in range(32) if (x * 2) % 3 == 0])
    assert (got == expect).all()
    np.testing.assert_array_equal(got, JPipe.compact(*ref[:2]))


def test_failing_lanes_are_zeroed_for_later_ops():
    pipe = (TPipe(device="cpu").filter(lambda x: x > 2)
            .map(lambda x: x + 10))
    outs, masks, _ = pipe.run(torch.arange(8).reshape(2, 4))
    assert outs.tolist() == [[10, 10, 10, 13], [14, 15, 16, 17]]
    assert masks.tolist() == [[False, False, False, True], [True] * 4]


@pytest.mark.parametrize("path", ["stacked", "iterable"])
def test_device_pipeline_scan_carry(path):
    """tests/test_stream.py:384 on both packages: a running sum across
    chunks; the int32 carry keeps its dtype (torch widens the sum)."""
    chunks = np.ones((3, 4), np.int32)
    ref = JPipe().scan(lambda c, x: (c + x.sum(), x + c), jnp.asarray(0))
    port = TPipe(device="cpu").scan(lambda c, x: (c + x.sum(), x + c),
                                    torch.tensor(0, dtype=torch.int32))
    r = ref.run(jnp.asarray(chunks) if path == "stacked" else list(chunks))
    outs, masks, carry = port.run(torch.from_numpy(chunks)
                                  if path == "stacked" else list(chunks))
    assert int(carry) == 12 and carry.dtype == torch.int32
    assert outs.dtype == torch.int32
    np.testing.assert_array_equal(outs.numpy(), np.asarray(r[0]))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(r[1]))
    assert int(carry) == int(r[2])
    assert (outs[0] == 1).all() and (outs[1] == 5).all() \
        and (outs[2] == 9).all()


@pytest.mark.parametrize("path", ["stacked", "iterable"])
def test_tuple_and_dict_carries_match_the_reference(path):
    """A scan carry of several tensors (a tuple holding a dict), after a
    filter, in float32: running count and sum of the kept lanes. The
    values are quarter-integers, so every sum is exact in either order
    and the comparison is bit for bit."""
    chunks = (np.random.default_rng(4).integers(-16, 17, (5, 16)) / 4) \
        .astype(np.float32)

    def body(c, x):
        n, st = c
        kept = (x != 0).sum()
        return ((n + kept, {"s": st["s"] + x.sum(), "m": st["m"]}),
                x * 0.5 + st["s"])

    ref = (JPipe().map(lambda x: x * 3.0).filter(lambda x: x > 0.1)
           .scan(lambda c, x: body(c, x),
                 (jnp.int32(0), {"s": jnp.float32(0), "m": jnp.float32(7)})))
    port = (TPipe(device="cpu").map(lambda x: x * 3.0)
            .filter(lambda x: x > 0.1)
            .scan(lambda c, x: body(c, x),
                  (torch.tensor(0, dtype=torch.int32),
                   {"s": torch.tensor(0.0), "m": torch.tensor(7.0)})))
    r = ref.run(jnp.asarray(chunks) if path == "stacked" else list(chunks))
    outs, masks, (n, st) = port.run(torch.from_numpy(chunks)
                                    if path == "stacked" else list(chunks))
    np.testing.assert_array_equal(outs.numpy(), np.asarray(r[0]))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(r[1]))
    rn, rst = r[2]
    assert n.dtype == torch.int32 and int(n) == int(rn)
    assert st["s"].dtype == torch.float32 and st["m"].item() == 7.0
    assert st["s"].item() == float(rst["s"]) != 0.0


def test_one_scan_per_pipeline_and_as_flow_waits_for_a12_5():
    """One scan per pipeline; `as_flow` (the stream DSL of ROADMAP A12.5)
    on the CPU emits what `run` returns, chunk by chunk, with the carry
    threaded across elements."""
    from akka_tpu_torch import ActorSystem
    from akka_tpu_torch.stream import Sink, Source

    pipe = TPipe(device="cpu").scan(lambda c, x: (c + x.sum(), x + c),
                                    torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="one scan"):
        pipe.scan(lambda c, x: (c, x), torch.tensor(0))
    chunks = [np.arange(i, i + 4, dtype=np.int32) for i in range(0, 12, 4)]
    outs, masks, carry = pipe.run(chunks)
    system = ActorSystem.create("as-flow", {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0}})
    try:
        got = Source.from_iterable(chunks).via(pipe.as_flow()) \
            .run_with(Sink.seq(), system).result(10.0)
    finally:
        system.terminate()
        assert system.await_termination(10.0)
    assert [o.tolist() for o, _ in got] == outs.tolist()
    assert [m.tolist() for _, m in got] == masks.tolist()
    assert all(o.dtype == torch.int32 and o.device.type == "cpu"
               for o, _ in got)
    assert int(carry) == 66


def test_compiled_step_is_the_chain():
    step = _fused(TPipe, device="cpu").compile()
    carry, (out, mask) = step(0, torch.arange(6))
    assert carry == 0
    assert out.tolist() == [1, 1, 1, 7, 1, 1]  # zeroed lanes, then + 1
    assert mask.tolist() == [True, False, False, True, False, False]


@pytest.mark.parametrize("ragged", ["one_element", "scalar", "dtype"])
def test_a_ragged_iterable_raises_as_stacking_it_does(ragged):
    """The reference stacks an iterable's chunks (jnp.stack), which a
    ragged one fails; the port refuses it too, on every path, instead of
    broadcasting or casting a later chunk into the first one's shape."""
    first = np.arange(4, dtype=np.int32)
    later = {"one_element": np.array([7], np.int32),
             "scalar": np.int32(7),
             "dtype": np.arange(4, dtype=np.float32)}[ragged]
    if ragged != "dtype":  # the reference promotes a dtype, not a shape
        with pytest.raises((ValueError, TypeError, IndexError)):
            _fused(JPipe).run([first, later])
    with pytest.raises(ValueError, match="chunk 1"):
        _fused(TPipe, device="cpu").run([first, later])
