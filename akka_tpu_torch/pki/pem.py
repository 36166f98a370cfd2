"""PEM / DER handling (akka-pki parity).

A copy of `akka_tpu/pki/pem.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference: akka-pki/src/main/scala/akka/pki/pem/PEMDecoder.scala:16 (RFC 7468
lax decoding of PEM into labeled DER blocks) and DERPrivateKeyLoader.scala:26
(turning DER into a usable private key, dispatching on the PEM label /
PKCS#1 vs PKCS#8 vs SEC.1 structure).

The decoder is a real RFC 7468 parser (no external deps); the key loader
parses just enough ASN.1 to classify the key (version / algorithm OID) and
hands the bytes to `ssl`/`cryptography` for actual use.
"""

from __future__ import annotations

import base64
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple


class PEMLoadingException(ValueError):
    """(reference: akka.pki.pem.PEMLoadingException)"""


@dataclass(frozen=True)
class PEMData:
    """One decoded PEM block (PEMDecoder.DERData analogue)."""

    label: str
    bytes: bytes


_PEM_RE = re.compile(
    r"-----BEGIN ([A-Z0-9 ]+)-----\s*(.*?)\s*-----END ([A-Z0-9 ]+)-----",
    re.DOTALL)


def decode(pem: str) -> PEMData:
    """Decode the FIRST PEM block (PEMDecoder.decode semantics: lax RFC
    7468 — whitespace anywhere in the base64 body is tolerated)."""
    blocks = decode_all(pem)
    if not blocks:
        raise PEMLoadingException("no PEM block found")
    return blocks[0]


def decode_all(pem: str) -> List[PEMData]:
    """Every PEM block in the input, in order (cert chains)."""
    out: List[PEMData] = []
    for m in _PEM_RE.finditer(pem):
        begin, body, end = m.group(1), m.group(2), m.group(3)
        if begin != end:
            raise PEMLoadingException(
                f"mismatched PEM labels: BEGIN {begin} / END {end}")
        b64 = re.sub(r"\s+", "", body)
        try:
            der = base64.b64decode(b64, validate=True)
        except Exception as e:  # noqa: BLE001
            raise PEMLoadingException(f"invalid base64 in PEM body: {e}") from e
        out.append(PEMData(label=begin, bytes=der))
    return out


# ---------------------------------------------------------------- minimal DER
def _read_tlv(data: bytes, off: int) -> Tuple[int, bytes, int]:
    """One ASN.1 TLV: returns (tag, value, next_offset)."""
    if off >= len(data):
        raise PEMLoadingException("truncated DER")
    tag = data[off]
    off += 1
    if off >= len(data):
        raise PEMLoadingException("truncated DER length")
    length = data[off]
    off += 1
    if length & 0x80:
        n = length & 0x7F
        if n == 0 or off + n > len(data):
            raise PEMLoadingException("bad DER length")
        length = int.from_bytes(data[off:off + n], "big")
        off += n
    if off + length > len(data):
        raise PEMLoadingException("DER value exceeds input")
    return tag, data[off:off + length], off + length


def _decode_oid(value: bytes) -> str:
    if not value:
        raise PEMLoadingException("empty OID")
    # every subidentifier — INCLUDING the first — is base-128 with
    # continuation bits; the first packs (arc1, arc2) as 40*arc1+arc2
    # with arc1 capped at 2 (X.690: arc1 = 2 whenever the value >= 80,
    # e.g. OID 2.999 encodes as 88 37)
    subids = []
    acc = 0
    pending = False
    for b in value:
        acc = (acc << 7) | (b & 0x7F)
        pending = bool(b & 0x80)
        if not pending:
            subids.append(acc)
            acc = 0
    if pending or not subids:
        # a trailing continuation byte with a zero payload leaves acc == 0,
        # so the flag — not acc's truthiness — is the truncation signal
        raise PEMLoadingException("truncated OID subidentifier")
    first = subids[0]
    arc1 = 2 if first >= 80 else first // 40
    arc2 = first - 40 * arc1
    return ".".join([str(arc1), str(arc2)] + [str(s) for s in subids[1:]])


_OID_NAMES = {
    "1.2.840.113549.1.1.1": "RSA",
    "1.2.840.10045.2.1": "EC",
    "1.3.101.112": "Ed25519",
    "1.3.101.110": "X25519",
    "1.2.840.10040.4.1": "DSA",
}


@dataclass(frozen=True)
class PrivateKeyInfo:
    """What DERPrivateKeyLoader derives before constructing the key."""

    format: str      # "PKCS#1" | "PKCS#8" | "SEC.1"
    algorithm: str   # RSA | EC | Ed25519 | ...
    der: bytes


class DERPrivateKeyLoader:
    """(reference: akka.pki.pem.DERPrivateKeyLoader.load:26 — dispatch on
    the PEM label, parse the DER enough to know what key it is)."""

    @staticmethod
    def load(data: PEMData) -> PrivateKeyInfo:
        label = data.label
        if label == "RSA PRIVATE KEY":  # PKCS#1
            DERPrivateKeyLoader._check_pkcs1(data.bytes)
            return PrivateKeyInfo("PKCS#1", "RSA", data.bytes)
        if label == "EC PRIVATE KEY":   # SEC.1
            DERPrivateKeyLoader._check_sequence(data.bytes)
            return PrivateKeyInfo("SEC.1", "EC", data.bytes)
        if label == "PRIVATE KEY":      # PKCS#8
            alg = DERPrivateKeyLoader._pkcs8_algorithm(data.bytes)
            return PrivateKeyInfo("PKCS#8", alg, data.bytes)
        raise PEMLoadingException(
            f"unsupported PEM label for a private key: {label!r}")

    @staticmethod
    def _check_sequence(der: bytes) -> bytes:
        tag, value, _ = _read_tlv(der, 0)
        if tag != 0x30:
            raise PEMLoadingException("private key DER is not a SEQUENCE")
        return value

    @staticmethod
    def _check_pkcs1(der: bytes) -> None:
        body = DERPrivateKeyLoader._check_sequence(der)
        tag, version, _ = _read_tlv(body, 0)
        if tag != 0x02:
            raise PEMLoadingException("PKCS#1 key missing version INTEGER")

    @staticmethod
    def _pkcs8_algorithm(der: bytes) -> str:
        body = DERPrivateKeyLoader._check_sequence(der)
        off = 0
        tag, _version, off = _read_tlv(body, off)       # version INTEGER
        if tag != 0x02:
            raise PEMLoadingException("PKCS#8 missing version")
        tag, alg_seq, off = _read_tlv(body, off)        # AlgorithmIdentifier
        if tag != 0x30:
            raise PEMLoadingException("PKCS#8 missing AlgorithmIdentifier")
        tag, oid, _ = _read_tlv(alg_seq, 0)
        if tag != 0x06:
            raise PEMLoadingException("PKCS#8 AlgorithmIdentifier missing OID")
        dotted = _decode_oid(oid)
        return _OID_NAMES.get(dotted, dotted)


def load_certificates(path: str) -> List[PEMData]:
    """All CERTIFICATE blocks from a PEM file (chain order preserved)."""
    with open(path, "r", encoding="utf-8") as f:
        blocks = decode_all(f.read())
    certs = [b for b in blocks if b.label == "CERTIFICATE"]
    if not certs:
        raise PEMLoadingException(f"no CERTIFICATE block in {path}")
    return certs


def load_private_key(path: str) -> PrivateKeyInfo:
    """The first private-key block from a PEM file, classified."""
    with open(path, "r", encoding="utf-8") as f:
        blocks = decode_all(f.read())
    for b in blocks:
        if b.label.endswith("PRIVATE KEY"):
            return DERPrivateKeyLoader.load(b)
    raise PEMLoadingException(f"no private key block in {path}")
