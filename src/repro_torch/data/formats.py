"""Decoded DVS event batches (the port's own copy of the record type in
``repro.data.formats``; the file parsers come with the file-backed slice).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np


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
