"""The port's replicator keeps converging a key that is written without
pause, held to the JAX package's side by side (tests/torch_remote_fixture
`side_by_side`, each package on its own in-proc wire). A writer on node 0
adds an element to one ORSet every 50 ms; while it writes, a node that
joins late, and a node whose delta stream from node 0 has a gap, must
each come to hold every element written before it was checked. The
port's anti-entropy re-ships a key both sides hold only once it has
settled, so these cases hold that a peer lacking the key, or gapped on
it, is answered whatever the key's heat.

Every wait is at most 10 s.
"""

import threading
import time

import pytest

from test_torch_ddata import DDATA_CLUSTER, _cluster, _get, _node_id, ns
from torch_remote_fixture import WAIT, Nodes, config, side_by_side

WRITE_S = 0.05      # the writer's period
BEFORE = 20         # elements written before the late join or the gap


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


class Writer:
    """Adds e0, e1, ... to `key`'s ORSet on one replicator, one element
    every WRITE_S, on a thread of its own until stopped."""

    def __init__(self, P, system, dd, key):
        D = P.ddata
        self.written, self._stop = [], threading.Event()
        me, sink = _node_id(P, system), P.testkit.TestProbe(system)

        def write():
            while not self._stop.is_set():
                e = f"e{len(self.written)}"
                dd.replicator.tell(D.Update(
                    key, D.ORSet.empty(), D.WriteLocal(),
                    modify=lambda s, e=e: s.add(me, e)), sink.ref)
                self.written.append(e)
                time.sleep(WRITE_S)
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait_for(self, n: int) -> None:
        deadline = time.monotonic() + WAIT
        while len(self.written) < n:
            assert time.monotonic() < deadline, "the writer stalled"
            time.sleep(0.01)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def _holds(P, system, dd, key, want):
    got = _get(P, system, dd, key, 1.0)
    return isinstance(got, P.ddata.GetSuccess) and \
        set(want) <= set(got.data.elements)


def _converged_while_writing(P, system, dd, key, writer):
    """Waits, the writer writing on, until `system` holds every element
    written so far."""
    want = list(writer.written)
    P.testkit.await_condition(lambda: _holds(P, system, dd, key, want),
                              max_time=WAIT)
    return True


def _late_joiner(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes, n=2, stem="hj")
    key = D.Key("hot-join")
    writer = Writer(P, systems[0], dd[0], key)
    try:
        writer.wait_for(BEFORE)
        cfg = config("inproc", provider="cluster", cluster=DDATA_CLUSTER)
        if P.name == "akka_tpu_torch":
            late = nodes.port_system("hj2", cfg)
        else:
            late = P.ActorSystem.create("hj2", cfg)
            nodes.ref_nodes.append(late)
            nodes.ref_clusters.append((late, P.cluster.Cluster.get(late)))
        cluster = P.cluster.Cluster.get(late)
        cluster.join(str(systems[0].provider.local_address))
        P.testkit.await_condition(
            lambda: sum(1 for m in cluster.state.members
                        if m.status.value == "Up") == 3, max_time=WAIT)
        late_dd = D.DistributedData.get(late)
        return [_converged_while_writing(P, late, late_dd, key, writer),
                len(writer.written) > BEFORE]
    finally:
        writer.stop()


def test_late_joiner_converges_on_a_key_written_without_pause(nodes):
    assert side_by_side(_late_joiner, nodes) == [True, True]


def _gap_while_writing(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes, n=3, stem="hg")
    key = D.Key("hot-gap")
    origin = str(systems[0].provider.local_address)
    writer = Writer(P, systems[0], dd[0], key)
    try:
        writer.wait_for(BEFORE)
        uid = dd[0].replicator.cell.actor._delta_incarnation
        P.testkit.await_condition(
            lambda: _holds(P, systems[1], dd[1], key, writer.written[:5]),
            max_time=WAIT)
        # a delta of node 0's own incarnation far ahead of node 1's cursor:
        # node 1 marks the pair gapped and drops node 0's deltas of the key
        # until a full state arrives
        me = _node_id(P, systems[0])
        forged = D.ORSet.empty().add(me, "x").reset_delta().add(me, "forged")
        dd[1].replicator.tell(P.replicator._DeltaPropagation(
            {key.id: (10 ** 6, forged.delta)}, from_addr=origin,
            origin_uid=uid), dd[0].replicator)
        _get(P, systems[1], dd[1], key)  # read after the forged delta
        converged = _converged_while_writing(P, systems[1], dd[1], key,
                                             writer)
        got = _get(P, systems[1], dd[1], key, 1.0).data.elements
        return [converged, "forged" not in got and "x" not in got]
    finally:
        writer.stop()


def test_delta_gap_resyncs_while_the_key_is_written(nodes):
    assert side_by_side(_gap_while_writing, nodes) == [True, True]
