"""RemoteInstrument: user-pluggable per-message wire metadata hooks.

A copy of `akka_tpu/remote/instrument.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs). One change:
`RemoteInstruments.from_config` refuses a module of the JAX package.

Reference parity: akka-remote/src/main/scala/akka/remote/artery/
RemoteInstrument.scala:32 — each instrument owns a reserved identifier
(1..31) in the envelope's metadata section, writes opaque bytes at
serialize time on the sender (`remoteWriteMetadata`) and reads them back
at deliver time on the receiver (`remoteReadMetadata`), plus optional
sent/received timing callbacks. This is the seam tracing/telemetry
vendors plug into (context propagation across actor messages) without
touching payload serialization.

Register programmatically
(`provider.remote_instruments.add(instr)`) or via config:

    akka.remote.instruments = ["my.module:MyInstrument"]
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Dict, List, Optional

_log = logging.getLogger("akka_tpu_torch.remote.instrument")


class RemoteInstrument:
    """(reference: artery/RemoteInstrument.scala:32)"""

    #: reserved metadata key, 1..31; unique per instrument in a system
    identifier: int = 1

    def remote_write_metadata(self, recipient, message: Any,
                              sender) -> Optional[bytes]:
        """Called on the SENDING side for every outbound remote message.
        Return the metadata bytes to ride the envelope (None = nothing)."""
        return None

    def remote_read_metadata(self, recipient, message: Any, sender,
                             metadata: bytes) -> None:
        """Called on the RECEIVING side before delivery, with the bytes
        the same-identifier instrument wrote on the sender."""

    def remote_message_sent(self, recipient, message: Any, sender,
                            size: int) -> None:
        """Timing/accounting hook after a successful transport send."""

    def remote_message_received(self, recipient, message: Any, sender,
                                size: int) -> None:
        """Timing/accounting hook after inbound deserialization."""


class RemoteInstruments:
    """The per-provider aggregate: fans hooks out to every registered
    instrument and marshals the metadata dict that rides WireEnvelope
    (reference: artery/RemoteInstruments.scala — the composite that
    serializes all instruments' metadata into the envelope block)."""

    def __init__(self, instruments: Optional[List[RemoteInstrument]] = None):
        self._instruments: List[RemoteInstrument] = []
        for ins in instruments or []:
            self.add(ins)

    def add(self, instrument: RemoteInstrument) -> None:
        key = int(instrument.identifier)
        if not 1 <= key <= 31:
            raise ValueError(
                f"RemoteInstrument identifier {key} outside the reserved "
                f"1..31 range (RemoteInstrument.scala identifier contract)")
        if any(i.identifier == key for i in self._instruments):
            raise ValueError(f"duplicate RemoteInstrument identifier {key}")
        self._instruments.append(instrument)

    def __bool__(self) -> bool:
        return bool(self._instruments)

    def __len__(self) -> int:
        return len(self._instruments)

    # -- envelope integration ------------------------------------------------
    def write_metadata(self, recipient, message, sender
                       ) -> Optional[Dict[int, bytes]]:
        md: Dict[int, bytes] = {}
        for ins in self._instruments:
            try:
                b = ins.remote_write_metadata(recipient, message, sender)
            except Exception:  # noqa: BLE001 — instruments must not break sends
                _log.warning("RemoteInstrument %s remote_write_metadata "
                             "failed", type(ins).__name__, exc_info=True)
                continue
            if b:
                md[ins.identifier] = bytes(b)
        return md or None

    def read_metadata(self, recipient, message, sender,
                      metadata: Optional[Dict[int, bytes]]) -> None:
        if not metadata:
            return
        for ins in self._instruments:
            b = metadata.get(ins.identifier)
            if b is not None:
                try:
                    ins.remote_read_metadata(recipient, message, sender, b)
                except Exception:  # noqa: BLE001
                    _log.warning("RemoteInstrument %s remote_read_metadata "
                                 "failed", type(ins).__name__, exc_info=True)
                    continue

    def message_sent(self, recipient, message, sender, size: int) -> None:
        for ins in self._instruments:
            try:
                ins.remote_message_sent(recipient, message, sender, size)
            except Exception:  # noqa: BLE001
                _log.warning("RemoteInstrument %s remote_message_sent "
                             "failed", type(ins).__name__, exc_info=True)
                continue

    def message_received(self, recipient, message, sender,
                         size: int) -> None:
        for ins in self._instruments:
            try:
                ins.remote_message_received(recipient, message, sender, size)
            except Exception:  # noqa: BLE001
                _log.warning("RemoteInstrument %s remote_message_received "
                             "failed", type(ins).__name__, exc_info=True)
                continue

    @staticmethod
    def from_config(specs) -> "RemoteInstruments":
        """Build from config entries of the form "module.path:ClassName"
        (the create-instruments-by-FQCN seam of RemoteInstrument.scala).
        A module of the JAX package (`akka_tpu` or under it) is refused:
        importing it would load jax into the port."""
        out = RemoteInstruments()
        for spec in specs or []:
            mod_name, _, cls_name = str(spec).partition(":")
            if mod_name.split(".")[0] == "akka_tpu":
                raise ValueError(
                    f"remote instrument {spec!r}: a module of the JAX "
                    f"package; the port loads its own (akka_tpu_torch.)")
            cls = getattr(importlib.import_module(mod_name), cls_name)
            out.add(cls())
        return out
