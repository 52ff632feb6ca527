"""Slot binning: raw (t, x, y, p) event records ↔ per-slot event-count
frames (the port's own copy of ``repro.data.binning``).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.data.formats import EventChunk


def slot_us_for(t_intg_ms: float, n_sub: int) -> int:
    """Fine-slot width in µs for an integration time split into ``n_sub``
    sub-slots. Must be integral µs so timestamps bin exactly."""
    us = t_intg_ms * 1000.0 / n_sub
    if abs(us - round(us)) > 1e-6 or round(us) <= 0:
        raise ValueError(
            f"t_intg_ms={t_intg_ms} / n_sub={n_sub} is not a whole number "
            f"of microseconds — binning needs integral slots")
    return int(round(us))


def bin_chunks(chunks: Iterable[EventChunk], *, n_total: int, slot_us: int,
               sensor_hw: tuple[int, int], out_hw: tuple[int, int],
               t0_us: int = 0, t_stop_us: int | None = None) -> np.ndarray:
    """Accumulate an event-chunk stream into ``[n_total, H, W, 2]`` float32
    counts (channel 0 = ON, 1 = OFF). Events before ``t0_us``, past the
    last slot, or at/after ``t_stop_us`` are dropped; coordinates are
    downscaled ``sensor → out`` by integer scaling."""
    sh, sw = sensor_hw
    oh, ow = out_hw
    frames = np.zeros((n_total, oh, ow, 2), dtype=np.float32)
    for c in chunks:
        if not len(c):
            continue
        slot = (c.t - t0_us) // slot_us
        ok = (slot >= 0) & (slot < n_total)
        if t_stop_us is not None:
            ok &= c.t < t_stop_us
        if not ok.any():
            continue
        slot = slot[ok].astype(np.int64)
        y = (c.y[ok].astype(np.int64) * oh) // sh
        x = (c.x[ok].astype(np.int64) * ow) // sw
        ok2 = (y >= 0) & (y < oh) & (x >= 0) & (x < ow)
        slot, y, x = slot[ok2], y[ok2], x[ok2]
        pol = 1 - c.p[ok][ok2].astype(np.int64)   # p=1 (ON) → channel 0
        np.add.at(frames, (slot, y, x, pol), 1.0)
    return frames


def frames_to_events(frames: np.ndarray, slot_us: int, *,
                     rng: np.random.Generator | None = None) -> EventChunk:
    """Expand a ``[n_total, H, W, 2]`` count histogram into discrete
    (t, x, y, p) records: each count ``c`` at a cell becomes ``c`` events
    spread inside its slot (evenly, or uniformly with ``rng``), so
    re-binning at ``slot_us`` recovers ``frames`` exactly."""
    counts = np.rint(np.asarray(frames)).astype(np.int64)
    slot, y, x, pol = np.nonzero(counts)
    reps = counts[slot, y, x, pol]
    slot = np.repeat(slot, reps)
    y = np.repeat(y, reps)
    x = np.repeat(x, reps)
    pol = np.repeat(pol, reps)
    n = len(slot)
    if rng is None:
        # the k-th duplicate of a cell with count c offsets by k·slot_us//c
        rank = np.zeros(n, dtype=np.int64)
        if n:
            starts = np.repeat(np.cumsum(reps) - reps, reps)
            rank = np.arange(n) - starts
        cell_count = np.repeat(reps, reps)
        off = np.minimum(rank * slot_us // np.maximum(cell_count, 1),
                         slot_us - 1)
    else:
        off = rng.integers(0, slot_us, size=n)
    t = slot * slot_us + off
    order = np.argsort(t, kind="stable")
    return EventChunk(t=t[order].astype(np.int64),
                      x=x[order].astype(np.int32),
                      y=y[order].astype(np.int32),
                      p=(1 - pol[order]).astype(np.int8))
