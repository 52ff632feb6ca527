"""Binary event-file formats: AEDAT 3.1 and the N-MNIST ``.bin`` encoding
(the port's own copy of ``repro.data.formats``, numpy only).

Both parsers are chunked generators: they yield bounded
:class:`EventChunk` batches in file order, so the slot binner
(``data/binning.py``) folds a long recording into event frames with
O(chunk) memory. Both formats have writers too, so fixtures are written
offline and round trips are bit-exact. A file written by either package
reads to the same arrays in the other.

AEDAT 3.1 (the DVS128-Gesture distribution format)
    ASCII header lines starting with ``#`` (first line ``#!AER-DAT3.1``),
    then little-endian binary packets. Each packet: a 28-byte header
    (eventType i16, eventSource i16, eventSize i32, eventTSOffset i32,
    eventTSOverflow i32, eventCapacity i32, eventNumber i32, eventValid
    i32) and ``eventNumber`` events of ``eventSize`` bytes. Polarity
    events (type 1) are 8 bytes: a u32 data word (bit 0 valid, bit 1
    polarity, bits 2–16 y, bits 17–31 x) and a u32 timestamp in µs; bit
    31 of the full timestamp comes from the header's ``eventTSOverflow``.

N-MNIST ``.bin`` (the ATIS encoding)
    5-byte big-endian records: byte 0 x, byte 1 y, byte 2 = polarity
    (bit 7) | timestamp bits 22–16, bytes 3–4 = timestamp bits 15–0, µs.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Iterable, Iterator

import numpy as np

AEDAT31_MAGIC = b"#!AER-DAT3.1"
_PACKET_HEADER = struct.Struct("<hhiiiiii")
POLARITY_EVENT = 1          # AEDAT 3.1 eventType of DVS polarity events
_POLARITY_EVENT_SIZE = 8    # u32 data word + u32 timestamp

NMNIST_EVENT_BYTES = 5
NMNIST_SENSOR_HW = (34, 34)
DVS128_SENSOR_HW = (128, 128)


@dataclass(frozen=True)
class EventChunk:
    """One bounded batch of decoded events, in stream order.

    ``t`` µs int64, ``x``/``y`` int32 sensor coordinates, ``p`` int8
    polarity (1 = ON / brightness increase, 0 = OFF).
    """
    t: np.ndarray
    x: np.ndarray
    y: np.ndarray
    p: np.ndarray

    def __len__(self) -> int:
        return len(self.t)


def concat_chunks(chunks: Iterable[EventChunk]) -> EventChunk:
    """Materialize a chunk stream (tests / small records only)."""
    cs = list(chunks)
    if not cs:
        z = np.zeros(0)
        return EventChunk(z.astype(np.int64), z.astype(np.int32),
                          z.astype(np.int32), z.astype(np.int8))
    return EventChunk(*(np.concatenate([getattr(c, f) for c in cs])
                        for f in ("t", "x", "y", "p")))


# ---------------------------------------------------------------------------
# AEDAT 3.1
# ---------------------------------------------------------------------------

def _read_aedat31_header(f: BinaryIO) -> None:
    """Consume the ASCII ``#`` header, leaving ``f`` at the first packet."""
    first = f.readline()
    if not first.startswith(AEDAT31_MAGIC):
        raise ValueError(
            f"not an AEDAT 3.1 file (header {first[:16]!r}, expected "
            f"{AEDAT31_MAGIC!r}); AEDAT 2.0 is not supported")
    while True:
        pos = f.tell()
        line = f.readline()
        if not line.startswith(b"#"):
            f.seek(pos)
            return


def read_aedat31(path: str | Path, *, t_stop_us: int | None = None
                 ) -> Iterator[EventChunk]:
    """Yield one :class:`EventChunk` per polarity-event packet.

    Invalid events (data-word bit 0 clear) are dropped; non-polarity
    packets, and packets whose event size is not 8, are skipped; a
    truncated trailing packet ends the read. ``t_stop_us`` stops once a
    packet's first timestamp reaches it: packets are time-ordered, so a
    caller reading one labeled window never decodes the recording's tail.
    """
    with open(path, "rb") as f:
        _read_aedat31_header(f)
        while True:
            hdr = f.read(_PACKET_HEADER.size)
            if len(hdr) < _PACKET_HEADER.size:
                return
            (etype, _src, esize, _tsoff, overflow, _cap, num,
             _valid) = _PACKET_HEADER.unpack(hdr)
            body = f.read(esize * num)
            if len(body) < esize * num:
                return
            if etype != POLARITY_EVENT or esize != _POLARITY_EVENT_SIZE:
                continue
            raw = np.frombuffer(body, dtype="<u4").reshape(num, 2)
            data, ts = raw[:, 0], raw[:, 1].astype(np.int64)
            ts = ts + (np.int64(overflow) << 31)
            ok = (data & 1).astype(bool)
            chunk = EventChunk(
                t=ts[ok],
                x=((data[ok] >> 17) & 0x7FFF).astype(np.int32),
                y=((data[ok] >> 2) & 0x7FFF).astype(np.int32),
                p=((data[ok] >> 1) & 1).astype(np.int8))
            if len(chunk):
                if t_stop_us is not None and int(chunk.t[0]) >= t_stop_us:
                    return
                yield chunk


def write_aedat31(path: str | Path, events: EventChunk, *,
                  events_per_packet: int = 4096,
                  comment: str = "synthetic fixture") -> None:
    """Write polarity events as an AEDAT 3.1 file, the exact inverse of
    :func:`read_aedat31` for x/y < 2^15 and 0 <= t < 2^31."""
    t = np.asarray(events.t, dtype=np.int64)
    x = np.asarray(events.x, dtype=np.int64)
    y = np.asarray(events.y, dtype=np.int64)
    p = np.asarray(events.p, dtype=np.int64)
    if len(t) and (x.max() >= 1 << 15 or y.max() >= 1 << 15
                   or t.min() < 0 or t.max() >= 1 << 31):
        raise ValueError("event fields out of AEDAT 3.1 range")
    with open(path, "wb") as f:
        f.write(AEDAT31_MAGIC + b"\r\n")
        f.write(b"# " + comment.encode() + b"\r\n")
        for lo in range(0, len(t), events_per_packet):
            n = min(events_per_packet, len(t) - lo)
            f.write(_PACKET_HEADER.pack(POLARITY_EVENT, 0,
                                        _POLARITY_EVENT_SIZE, 4, 0, n, n, n))
            sl = slice(lo, lo + n)
            raw = np.empty((n, 2), dtype="<u4")
            raw[:, 0] = 1 | (p[sl] << 1) | (y[sl] << 2) | (x[sl] << 17)
            raw[:, 1] = t[sl]
            f.write(raw.tobytes())


# ---------------------------------------------------------------------------
# N-MNIST .bin
# ---------------------------------------------------------------------------

def read_nmnist_bin(path: str | Path, *, chunk_events: int = 65536
                    ) -> Iterator[EventChunk]:
    """Yield chunks of an N-MNIST ``.bin`` (ATIS 40-bit) event file."""
    with open(path, "rb") as f:
        while True:
            buf = f.read(NMNIST_EVENT_BYTES * chunk_events)
            if not buf:
                return
            n = len(buf) // NMNIST_EVENT_BYTES
            raw = np.frombuffer(buf[:n * NMNIST_EVENT_BYTES],
                                dtype=np.uint8).reshape(n, 5).astype(np.int64)
            t = ((raw[:, 2] & 0x7F) << 16) | (raw[:, 3] << 8) | raw[:, 4]
            yield EventChunk(t=t,
                             x=raw[:, 0].astype(np.int32),
                             y=raw[:, 1].astype(np.int32),
                             p=(raw[:, 2] >> 7).astype(np.int8))


def write_nmnist_bin(path: str | Path, events: EventChunk) -> None:
    """The exact inverse of :func:`read_nmnist_bin` for x/y < 2^8 and
    0 <= t < 2^23."""
    t = np.asarray(events.t, dtype=np.int64)
    x = np.asarray(events.x, dtype=np.int64)
    y = np.asarray(events.y, dtype=np.int64)
    p = np.asarray(events.p, dtype=np.int64)
    if len(t) and (x.max() >= 1 << 8 or y.max() >= 1 << 8
                   or t.min() < 0 or t.max() >= 1 << 23):
        raise ValueError("event fields out of N-MNIST .bin range")
    raw = np.empty((len(t), 5), dtype=np.uint8)
    raw[:, 0] = x
    raw[:, 1] = y
    raw[:, 2] = (p << 7) | ((t >> 16) & 0x7F)
    raw[:, 3] = (t >> 8) & 0xFF
    raw[:, 4] = t & 0xFF
    Path(path).write_bytes(raw.tobytes())
