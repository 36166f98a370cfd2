"""The port's wire instruments (akka_tpu_torch.remote.instrument) on the
CPU: tests/test_remote_instrument.py's in-process scenarios on the port
(the envelope's metadata section, the identifier range), the metadata
round trip held to the reference's both ways, a trace id stamped on one
system and read on the other over the in-proc transport written once
over a package namespace and run on both packages through `side_by_side`
(each package's systems on their own wire, equal traces), and the
port's refusal of an instrument class of the JAX package. The
reference's two-process scenario starts subprocesses, which tier-1
forbids: its port runs on `akka_tpu_torch.testkit.multi_process` in the
slow tier (tests/test_torch_multi_process.py).

Every system starts through the `nodes` fixture
(tests/torch_remote_fixture.py). Every wait is at most 10 s.
"""

import numpy as np
import pytest

from akka_tpu.remote import instrument as jins
from akka_tpu.remote import transport as jtransport

from akka_tpu_torch.remote import instrument as tins
from akka_tpu_torch.remote import transport as ttransport
from akka_tpu_torch.remote.instrument import (RemoteInstrument,
                                              RemoteInstruments)
from akka_tpu_torch.remote.transport import WireEnvelope

from torch_remote_fixture import WAIT, Nodes, addr_of, side_by_side


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


# ------------------------------------------------------------ wire format
def test_envelope_metadata_roundtrip():
    env = WireEnvelope(recipient="akka://sys@h:1/user/a", sender=None,
                       serializer_id=4, manifest="m", payload=b"xyz",
                       metadata={1: b"trace-123", 7: b"\x00\x01"})
    back = WireEnvelope.from_bytes(env.to_bytes())
    assert back.metadata == {1: b"trace-123", 7: b"\x00\x01"}
    assert back.payload == b"xyz"
    assert back.recipient == env.recipient


def test_envelope_without_metadata_unchanged():
    env = WireEnvelope(recipient="r", sender="s", serializer_id=2,
                       manifest="", payload=b"p")
    back = WireEnvelope.from_bytes(env.to_bytes())
    assert back.metadata is None
    assert back.sender == "s"
    assert env.to_bytes()[2] == 1   # metadata-free frames stay version 1


def test_identifier_range_enforced():
    class Bad(RemoteInstrument):
        identifier = 32

    with pytest.raises(ValueError, match="1..31"):
        RemoteInstruments([Bad()])

    class A(RemoteInstrument):
        identifier = 3

    with pytest.raises(ValueError, match="duplicate"):
        RemoteInstruments([A(), A()])


# --------------------------------------------- the two packages, same bytes
def _stamper(mod, key, seed):
    class Stamp(mod.RemoteInstrument):
        identifier = key

        def __init__(self):
            self.read = []

        def remote_write_metadata(self, recipient, message, sender):
            rng = np.random.default_rng(seed + len(message))
            return rng.bytes(int(rng.integers(0, 12))) or None

        def remote_read_metadata(self, recipient, message, sender, md):
            self.read.append((message, md))
    return Stamp()


def test_metadata_round_trip_matches_the_reference():
    """Both packages' instruments stamp the same bytes for the same
    messages; each package's envelope carries them, the other's reads
    them, and each side's instruments read back what was stamped."""
    keys = (1, 5, 31)
    sides = {}
    for name, mod in (("ref", jins), ("port", tins)):
        ins = [_stamper(mod, k, 100 + k) for k in keys]
        sides[name] = (mod.RemoteInstruments(ins), ins)
    for message in ("a", "bb", "ping", "x" * 40):
        md = {n: agg.write_metadata("r", message, None)
              for n, (agg, _) in sides.items()}
        assert md["port"] == md["ref"]
        for wmod, rmod, n in ((jtransport, ttransport, "port"),
                              (ttransport, jtransport, "ref")):
            env = wmod.WireEnvelope(recipient="r", sender=None,
                                    serializer_id=1, manifest="",
                                    payload=b"", metadata=md[n])
            back = rmod.WireEnvelope.from_bytes(env.to_bytes())
            assert back.metadata == md[n]
            sides[n][0].read_metadata("r", message, None, back.metadata)
    reads = {n: [i.read for i in ins] for n, (_, ins) in sides.items()}
    assert reads["port"] == reads["ref"]
    assert any(reads["port"])


def test_from_config_loads_port_classes_and_refuses_the_reference():
    got = RemoteInstruments.from_config(
        ["test_torch_remote_instrument:Stamp9"])
    assert len(got) == 1
    for spec in ("akka_tpu.remote.instrument:RemoteInstrument",
                 "akka_tpu:RemoteInstrument"):
        with pytest.raises(ValueError, match="JAX package"):
            RemoteInstruments.from_config([spec])


class Stamp9(RemoteInstrument):
    identifier = 9


# ------------------------------------ in-process two-system propagation
def trace_instrument(P):
    """A trace-id instrument of package P: it stamps `current` on every
    message it writes and records what it reads, sends and receives."""
    class TraceInstrument(P.instrument.RemoteInstrument):
        identifier = 9

        def __init__(self):
            self.current = None
            self.seen = []
            self.sent = []
            self.received = []

        def remote_write_metadata(self, recipient, message, sender):
            return self.current.encode() if self.current else None

        def remote_read_metadata(self, recipient, message, sender,
                                 metadata):
            self.seen.append((metadata.decode(), message))

        def remote_message_sent(self, recipient, message, sender, size):
            self.sent.append(size)

        def remote_message_received(self, recipient, message, sender,
                                    size):
            self.received.append(size)

    return TraceInstrument


def _propagation(P, nodes):
    class Echo(P.Actor):
        def receive(self, message):
            self.sender.tell(("echo", message), self.self_ref)

    a, b = nodes.node("insA", P=P), nodes.node("insB", P=P)
    ia, ib = trace_instrument(P)(), trace_instrument(P)()
    a.provider.remote_instruments.add(ia)
    b.provider.remote_instruments.add(ib)
    b.actor_of(P.Props.create(Echo), "echo")
    ref = a.provider.resolve_actor_ref(f"{addr_of(b)}/user/echo")
    ia.current = "trace-42"
    reply = P.ask_sync(ref, "ping", timeout=WAIT, system=a)
    return [reply, ("trace-42", "ping") in ib.seen, bool(ia.sent),
            bool(ib.received)]


def test_trace_id_propagates_between_systems(nodes):
    assert side_by_side(_propagation, nodes) == [
        ("echo", "ping"), True, True, True]
