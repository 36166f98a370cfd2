"""TLS on the port's wire and its PKI (akka_tpu_torch.pki,
akka_tpu_torch.remote.transport.TlsTcpTransport) on the CPU:
tests/test_tls.py's 7 scenarios on the committed test PKI
(tests/data/torch_pki: a CA, two CA-signed node certificates and a rogue
self-signed one, made once with openssl as its README says) instead of
certificates made in subprocesses, and on 127.0.0.1 port 0 instead of
fixed ports. PEM decoding and key classification are held to the
reference's on the same files and inputs; the TLS scenarios are written
once over a package namespace and run on both packages through
`side_by_side`, each package's nodes on their own TLS wire (two
packages' nodes cannot share one), and the port's trace (member counts,
the rogue's refusal, the start-up error) must equal the reference's.

Every system starts through the `nodes` fixture
(tests/torch_remote_fixture.py). Every wait is at most 10 s.
"""

import time

import pytest

from akka_tpu import pki as jpki
from akka_tpu.pki import pem as jpem

from akka_tpu_torch import pki as tpki
from akka_tpu_torch.pki import pem as tpem

from torch_remote_fixture import (PKI, WAIT, Nodes, addr_of, config,
                                  side_by_side)

CERTS = ("ca", "node0", "node1", "rogue")
TLS_CLUSTER = {"gossip-interval": "0.1s", "leader-actions-interval": "0.1s",
               "failure-detector": {"heartbeat-interval": "0.2s",
                                    "acceptable-heartbeat-pause": "3s"}}


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return (type(x).__name__, tuple(sorted(vars(x).items())))


def _both(fn):
    """fn(pki package) on the reference and the port: equal results (or
    the same exception type name). Returns the port's."""
    out = {}
    for name, mod in (("ref", jpki), ("port", tpki)):
        try:
            out[name] = _plain(fn(mod))
        except Exception as e:  # noqa: BLE001 — compared below
            out[name] = ("raised", type(e).__name__)
    assert out["port"] == out["ref"], out
    return out["port"]


# ----------------------------------------------------------------- PKI
def test_pem_decode_and_key_classification():
    for stem in CERTS:
        certs = _both(lambda m: m.load_certificates(str(PKI / f"{stem}.crt")))
        assert certs[0][1][1] == ("label", "CERTIFICATE")
        assert dict(certs[0][1])["bytes"][:1] == b"\x30"  # DER SEQUENCE
        key = _both(lambda m: m.load_private_key(str(PKI / f"{stem}.key")))
        assert dict(key[1])["format"] == "PKCS#8"
        assert dict(key[1])["algorithm"] == "RSA"
    # a key file holds no certificate; a certificate no key
    _both(lambda m: m.load_certificates(str(PKI / "node0.key")))
    _both(lambda m: m.load_private_key(str(PKI / "node0.crt")))


def test_pem_decode_errors():
    bad = ["not pem at all",
           "-----BEGIN CERTIFICATE-----\n!!!\n-----END CERTIFICATE-----",
           "-----BEGIN CERTIFICATE-----\nQUJD\n-----END PRIVATE KEY-----"]
    for text in bad:
        for mod in (jpki, tpki):
            with pytest.raises(mod.PEMLoadingException):
                mod.decode(text)
        _both(lambda m: m.decode(text))
    for mod in (jpki, tpki):
        with pytest.raises(mod.PEMLoadingException):
            mod.DERPrivateKeyLoader.load(mod.decode(
                "-----BEGIN CERTIFICATE-----\nQUJD\n-----END CERTIFICATE-----"))
    # the DER parser's own errors, on truncated and mislabelled keys
    der = tpki.load_private_key(str(PKI / "node1.key")).der
    import base64
    for label, body in (("PRIVATE KEY", der[:40]), ("PRIVATE KEY", der[:1]),
                        ("RSA PRIVATE KEY", der), ("EC PRIVATE KEY", b"\x02"),
                        ("DSA PRIVATE KEY", der)):
        text = (f"-----BEGIN {label}-----\n"
                f"{base64.b64encode(body).decode()}\n-----END {label}-----")
        _both(lambda m: m.DERPrivateKeyLoader.load(m.decode(text)))


def test_oid_decoding_multibyte_first_arc():
    """OIDs under joint-iso-itu-t(2) with arc2 >= 40 pack the first
    subidentifier in several base-128 bytes; 2.999 encodes as 88 37."""
    for mod in (jpem, tpem):
        assert mod._decode_oid(bytes([0x88, 0x37])) == "2.999"
        assert mod._decode_oid(bytes([0x2A, 0x86, 0x48, 0x86, 0xF7, 0x0D,
                                      0x01, 0x01, 0x01])) == \
            "1.2.840.113549.1.1.1"
        assert mod._decode_oid(bytes([0x2B, 0x65, 0x70])) == "1.3.101.112"
        for bad in ([0x88], [0x2A, 0x80], [0x80], []):
            with pytest.raises(mod.PEMLoadingException):
                mod._decode_oid(bytes(bad))


def test_pem_decode_multiple_blocks():
    chain = (PKI / "node0.crt").read_text() + (PKI / "ca.crt").read_text()
    blocks = _both(lambda m: m.decode_all(chain))
    assert [dict(b[1])["label"] for b in blocks] == ["CERTIFICATE"] * 2
    assert _both(lambda m: m.decode_all("")) == []


# ------------------------------------------------------- TLS transport
def _tls_node(P, nodes, name, stem):
    return nodes.node(name, "tls-tcp", P, provider="cluster", tls=stem,
                      cluster=TLS_CLUSTER)


def _up_count(P, system):
    return sum(1 for m in P.cluster.Cluster.get(system).state.members
               if m.status is P.cluster.MemberStatus.UP)


def _forms_over_tls(P, nodes):
    a = _tls_node(P, nodes, "tlsA", "node0")
    b = _tls_node(P, nodes, "tlsB", "node1")
    seed = addr_of(a)
    P.cluster.Cluster.get(a).join(seed)
    P.cluster.Cluster.get(b).join(seed)
    P.testkit.await_condition(
        lambda: _up_count(P, a) == 2 and _up_count(P, b) == 2,
        max_time=WAIT, message="TLS cluster did not form")
    return [_up_count(P, a), _up_count(P, b)]


def test_cluster_forms_over_tls_with_client_certs(nodes):
    assert side_by_side(_forms_over_tls, nodes) == [2, 2]


def _rogue(P, nodes):
    a = _tls_node(P, nodes, "tlsC", "node0")
    rogue = _tls_node(P, nodes, "tlsR", "rogue")
    seed = addr_of(a)
    P.cluster.Cluster.get(a).join(seed)
    P.testkit.await_condition(lambda: _up_count(P, a) == 1, max_time=WAIT,
                              message="seed did not self-form")
    P.cluster.Cluster.get(rogue).join(seed)
    time.sleep(3.0)
    return [_up_count(P, a), _up_count(P, rogue) <= 1]


def test_bad_cert_is_rejected(nodes):
    """Mutual auth: a node presenting a self-signed (non-CA) certificate
    cannot join; the handshake fails and the cluster stays at 1 member."""
    assert side_by_side(_rogue, nodes) == [1, True]


def _misconfigured(P, nodes, bad):
    cfg = config("tls-tcp")
    cfg["akka"]["remote"]["tls"] = {"cert-file": bad, "key-file": bad,
                                    "ca-file": bad}
    try:
        P.ActorSystem.create("tlsBad", cfg)
    except P.pki.PEMLoadingException as e:
        system = _half_started(P, e)
        # the port terminates the system before re-raising (a port
        # addition); the reference leaves it running, so it is ended here
        assert system.await_termination(0.0) or P.name == "akka_tpu"
        system.terminate()
        assert system.await_termination(WAIT)
        return ["raised", type(e).__name__]
    return ["started"]


def _half_started(P, error):
    """The ActorSystem whose start raised `error` (its __init__ frame)."""
    tb = error.__traceback__
    while tb is not None:
        system = tb.tb_frame.f_locals.get("self")
        if isinstance(system, P.ActorSystem):
            return system
        tb = tb.tb_next
    raise AssertionError(f"no ActorSystem under {error!r}")


def test_tls_misconfiguration_fails_fast(nodes, tmp_path):
    """A bad PEM file fails at system start, on both packages; the port's
    system has terminated before the error propagates (the fixture checks
    that no thread is left)."""
    bad = tmp_path / "bad.pem"
    bad.write_text("garbage")
    assert side_by_side(_misconfigured, nodes, str(bad)) == [
        "raised", "PEMLoadingException"]
