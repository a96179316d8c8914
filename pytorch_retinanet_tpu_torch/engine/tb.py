"""TensorBoard event files written with the standard library alone.

Counterpart of ``pytorch_retinanet_tpu/engine/tb.py``: the scalar subset of
the event-file format, with no tensorboard or tensorflow dependency.

* **TFRecord framing**: each record is ``uint64 length (LE) ·
  masked_crc32c(length) · payload · masked_crc32c(payload)``, where
  ``masked(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32`` over the
  Castagnoli CRC-32C.
* **Event protobuf**: field 1 ``wall_time`` (double), field 2 ``step``
  (int64), oneof field 3 ``file_version`` (string, first record,
  ``"brain.Event:2"``) / field 5 ``summary``.
* **Summary protobuf**: repeated field 1 ``Value{tag=1 (string),
  simple_value=2 (float)}``.

:func:`read_events` is an independent reader that checks both CRCs.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, Iterable, List, Tuple

# --------------------------------------------------------------------------- #
# CRC-32C (Castagnoli), table-driven
# --------------------------------------------------------------------------- #

_CRC_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Minimal protobuf encoding (the wire format only, no schema compiler)
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _string(field: int, s: str) -> bytes:
    raw = s.encode("utf-8")
    return _key(field, 2) + _varint(len(raw)) + raw


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _message(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def scalar_summary(values: Iterable[Tuple[str, float]]) -> bytes:
    """Summary proto: one Value{tag, simple_value} per (tag, value) pair."""
    out = bytearray()
    for tag, value in values:
        out += _message(1, _string(1, tag) + _float(2, float(value)))
    return bytes(out)


def encode_event(
    wall_time: float,
    step: int = 0,
    *,
    summary: bytes | None = None,
    file_version: str | None = None,
) -> bytes:
    ev = _double(1, wall_time) + _int64(2, step)
    if file_version is not None:
        ev += _string(3, file_version)
    if summary is not None:
        ev += _message(5, summary)
    return ev


def frame_record(payload: bytes) -> bytes:
    """TFRecord framing: len · crc(len) · payload · crc(payload)."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


# --------------------------------------------------------------------------- #
# Writer
# --------------------------------------------------------------------------- #


class EventFileWriter:
    """Append-only ``events.out.tfevents.*`` writer, flushed per add so that
    an interrupted run loses nothing."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._write(
            encode_event(time.time(), 0, file_version="brain.Event:2")
        )

    def _write(self, event: bytes) -> None:
        with self._lock:
            self._f.write(frame_record(event))
            self._f.flush()

    def add_scalars(
        self, metrics: Dict[str, float], step: int, wall_time: float | None = None
    ) -> None:
        if not metrics:
            return
        self._write(
            encode_event(
                time.time() if wall_time is None else wall_time,
                step,
                summary=scalar_summary(sorted(metrics.items())),
            )
        )

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


# --------------------------------------------------------------------------- #
# Independent reader
# --------------------------------------------------------------------------- #


def read_events(path: str) -> List[Dict]:
    """Decode an event file back into dicts, checking every record's CRCs."""
    events: List[Dict] = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if masked_crc32c(header) != len_crc:
            raise ValueError(f"bad length crc at byte {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (data_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if masked_crc32c(payload) != data_crc:
            raise ValueError(f"bad payload crc at byte {pos}")
        events.append(_decode_event(payload))
        pos += 16 + length
    return events


def _decode_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 2:
            (ln, consumed) = _read_varint(buf, pos)
            pos = consumed
            val = buf[pos : pos + ln]
            pos += ln
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _read_varint(buf: bytes, pos: int):
    val = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _decode_event(payload: bytes) -> Dict:
    out: Dict = {"wall_time": None, "step": 0, "values": {}}
    for field, wire, val in _decode_fields(payload):
        if field == 1 and wire == 1:
            out["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2 and wire == 0:
            out["step"] = val
        elif field == 3 and wire == 2:
            out["file_version"] = val.decode("utf-8")
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _decode_fields(val):
                if f2 == 1 and w2 == 2:
                    tag, simple = None, None
                    for f3, w3, v3 in _decode_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            simple = struct.unpack("<f", v3)[0]
                    if tag is not None:
                        out["values"][tag] = simple
    return out
