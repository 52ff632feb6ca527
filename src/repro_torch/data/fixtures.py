"""On-disk dataset fixtures in the released layouts, written offline (the
port's own copy of ``repro.data.fixtures``).

A miniature DVS128-Gesture tree (AEDAT 3.1 recordings with
``*_labels.csv`` gesture windows) or N-MNIST tree (``<digit>/NNNNN.bin``,
or ``Train``/``Test``) populated from the analytic generator
(``data/events.py``): its count frames are expanded into discrete
(t, x, y, p) records (``binning.frames_to_events``), so the files carry
class-conditioned DVS statistics. File names, layout and the labels CSVs
equal the reference's for the same arguments (the CSVs byte for byte).
The events inside the files differ from the reference's: they are drawn
from a ``torch.Generator`` seeded with ``seed``, not from a JAX key.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.data import events as events_mod
from repro_torch.data.binning import frames_to_events
from repro_torch.data.formats import (
    DVS128_SENSOR_HW, EventChunk, NMNIST_SENSOR_HW, concat_chunks,
    write_aedat31, write_nmnist_bin,
)


def _sample_events(gen: torch.Generator, cfg, label: int, duration_ms: float,
                   slot_us: int, sensor_hw: tuple[int, int],
                   t0_us: int = 0) -> EventChunk:
    """One labeled recording as discrete events at the sensor resolution.
    The generator's grid is block-repeated up to the sensor's; where the
    sensor is an exact multiple of it (128/16, 34/17) the binner's
    integer downscale maps each block back onto its generator pixel."""
    n_total = int(round(duration_ms * 1000 / slot_us))
    frames = events_mod.sample_events(gen, cfg, [label], n_total, 1)
    frames = frames[0, :, 0].numpy()                     # [n, h, w, 2]
    sh, sw = sensor_hw
    ry, rx = sh // frames.shape[1], sw // frames.shape[2]
    frames = np.repeat(np.repeat(frames, ry, axis=1), rx, axis=2)
    ev = frames_to_events(frames, slot_us)
    return EventChunk(t=ev.t + t0_us, x=ev.x, y=ev.y, p=ev.p)


def make_dvs128_fixture(root: str | Path, *, n_recordings: int = 2,
                        trials_per_recording: int = 11,
                        duration_ms: float = 2000.0, gen_hw: int = 16,
                        slot_us: int = 50_000, seed: int = 0,
                        gap_us: int = 100_000) -> Path:
    """Write ``fixture_userNN.aedat`` recordings, each
    ``trials_per_recording`` gesture windows cycling through the 11
    classes ``gap_us`` apart, with ``*_labels.csv`` companions (1-indexed
    class, start and end µs)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    cfg = events_mod.dvs_gesture_like(gen_hw)
    gen = torch.Generator().manual_seed(seed)
    trial_us = int(duration_ms * 1000)
    for r in range(n_recordings):
        chunks, rows = [], []
        t0 = 0
        for k in range(trials_per_recording):
            label = k % cfg.n_classes
            chunks.append(_sample_events(gen, cfg, label, duration_ms,
                                         slot_us, DVS128_SENSOR_HW, t0_us=t0))
            rows.append((label + 1, t0, t0 + trial_us))
            t0 += trial_us + gap_us
        stem = f"fixture_user{r:02d}"
        write_aedat31(root / f"{stem}.aedat", concat_chunks(chunks),
                      comment="synthetic DVS128-Gesture fixture")
        lines = ["class,startTime_usec,endTime_usec"]
        lines += [f"{c},{a},{b}" for c, a, b in rows]
        (root / f"{stem}_labels.csv").write_text("\n".join(lines) + "\n")
    return root


def make_nmnist_fixture(root: str | Path, *, n_per_class: int = 2,
                        duration_ms: float = 300.0, gen_hw: int = 17,
                        slot_us: int = 10_000, seed: int = 0,
                        train_test_dirs: bool = False) -> Path:
    """Write ``<root>/<digit>/NNNNN.bin`` (or the released ``Train`` /
    ``Test`` layout with ``train_test_dirs``); ``gen_hw=17`` divides the
    34×34 ATIS sensor, so the events keep the generator's glyphs."""
    root = Path(root)
    cfg = events_mod.nmnist_like(gen_hw)
    gen = torch.Generator().manual_seed(seed)
    tops = [root / "Train", root / "Test"] if train_test_dirs else [root]
    for top in tops:
        for digit in range(cfg.n_classes):
            d = top / str(digit)
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n_per_class):
                ev = _sample_events(gen, cfg, digit, duration_ms, slot_us,
                                    NMNIST_SENSOR_HW)
                write_nmnist_bin(d / f"{i:05d}.bin", ev)
    return root
