"""The length-prefixed record log shared by every journal of the port.

A copy of `scan_record_log` and `repair_record_log` from
`akka_tpu/persistence/journal.py`: the reference module also holds the
actor-level `FileJournal`, which imports the host actor runtime, so only
these two functions are copied. The format is the reference's, byte for
byte: each record is an 8-byte little-endian length followed by a pickle
blob, so either package reads the other's logs.

The flight recorder (`journal_truncated(path, dropped)`,
event/flight_recorder.py) is optional and may be None.
"""

from __future__ import annotations

import os
import pickle

__all__ = ["scan_record_log", "repair_record_log"]


def scan_record_log(path: str):
    """Yield (end_offset, record) for every INTACT record in a
    length-prefixed record log, stopping at the first torn or corrupt tail
    (short header, short blob, or a blob pickle.loads rejects). The
    end_offset of the last yielded record is the byte length of the valid
    prefix — what repair_record_log truncates to."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        offset = 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            n = int.from_bytes(hdr, "little")
            if offset + 8 + n > size:
                # truncated tail, or garbage read as an absurd length
                # prefix: bound by the file size before allocating, so a
                # torn tail can never MemoryError the repair
                return
            blob = f.read(n)
            if len(blob) < n:
                return  # truncated tail (crash mid-append)
            try:
                obj = pickle.loads(blob)
            except Exception:  # noqa: BLE001 — torn/garbled tail record
                return
            offset += 8 + n
            yield offset, obj


def repair_record_log(path: str, flight_recorder=None) -> int:
    """Crash-safe open: truncate a torn tail record (a host killed
    mid-append leaves a partial length-prefix+blob) back to the last intact
    record, warning via the flight recorder (if any) instead of letting
    readers hit UnpicklingError. Returns the number of bytes dropped
    (0 = intact)."""
    if not os.path.exists(path):
        return 0
    good = 0
    for end, _obj in scan_record_log(path):
        good = end
    size = os.path.getsize(path)
    if size <= good:
        return 0
    with open(path, "r+b") as f:
        f.truncate(good)
        f.flush()
        os.fsync(f.fileno())
    dropped = size - good
    if flight_recorder is not None and getattr(
            flight_recorder, "enabled", False):
        flight_recorder.journal_truncated(path, dropped)
    return dropped
