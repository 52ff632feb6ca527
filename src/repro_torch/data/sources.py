"""Event sources: the contract the sweep engine and the serving engine
consume (the synthetic half of ``repro.data.sources``).

Two seams: ``source.sample_batch(gen, batch_size, t_intg_ms, n_sub)``
draws a training/eval batch, float32 events ``[B, n_slots, n_sub, H, W,
2]`` and int64 labels ``[B]`` on the CPU (the caller moves them to its
device); ``source.iter_event_chunks(gen, chunk_us=..., slot_us=...)``
replays one labeled sample as a timestamped live stream of raw ``(t, x,
y, p)`` chunks at the source's ``sensor_hw``; empty chunks are yielded
too, so a replay consumer's clock advances through event gaps.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterator

import numpy as np
import torch

from repro_torch.data import events as events_mod
from repro_torch.data.binning import frames_to_events
from repro_torch.data.formats import EventChunk

DATASETS = ("synthetic-gesture", "synthetic-nmnist")
FILE_BACKED = ("dvs128", "nmnist")
# default stream duration per dataset (the reference's: real N-MNIST
# recordings span about 300 ms)
DATASET_DURATIONS_MS = {"synthetic-gesture": 2000.0,
                        "synthetic-nmnist": 2000.0,
                        "dvs128": 2000.0,
                        "nmnist": 300.0}


class EventSource:
    """The engine-facing event-stream contract: ``name``, ``height``,
    ``width``, ``n_classes``, ``duration_ms``, ``sensor_hw``, the two batch
    samplers and the replay entry point :meth:`iter_event_chunks`."""
    name: str
    height: int
    width: int
    n_classes: int
    duration_ms: float
    sensor_hw: tuple[int, int]

    def n_slots(self, t_intg_ms: float) -> int:
        n = self.duration_ms / t_intg_ms
        if abs(n - round(n)) > 1e-6:
            raise ValueError(f"T_INTG {t_intg_ms} ms does not divide the "
                             f"stream duration {self.duration_ms} ms")
        return int(round(n))

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     t_intg_ms: float, n_sub: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(events [B, n_slots, n_sub, H, W, 2], labels [B]) on the CPU,
        drawn from ``gen``."""
        raise NotImplementedError

    def sample_batch_with_labels(self, gen: torch.Generator,
                                 labels: torch.Tensor, t_intg_ms: float,
                                 n_sub: int = 1
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Events for given labels (class-conditional analysis)."""
        raise NotImplementedError

    def iter_event_chunks(self, gen: torch.Generator, *, chunk_us: int,
                          slot_us: int | None = None
                          ) -> tuple[int, Iterator[EventChunk]]:
        """Replay one labeled sample: ``(label, chunks)`` with chunk ``i``
        holding the events of ``[i·chunk_us, (i+1)·chunk_us)`` µs."""
        raise NotImplementedError


def _replay_chunk_count(duration_ms: float, chunk_us: int) -> int:
    n = duration_ms * 1000.0 / chunk_us
    if abs(n - round(n)) > 1e-6 or round(n) < 1:
        raise ValueError(f"chunk_us={chunk_us} does not divide the stream "
                         f"duration {duration_ms} ms")
    return int(round(n))


def rechunk_events(ev: EventChunk, chunk_us: int, n_chunks: int
                   ) -> Iterator[EventChunk]:
    """Slice one event record (stream-relative µs) into ``n_chunks``
    fixed-width chunks; events at/after the stream end are dropped and
    gaps yield empty chunks."""
    order = np.argsort(ev.t, kind="stable")
    t, x, y, p = ev.t[order], ev.x[order], ev.y[order], ev.p[order]
    bounds = np.searchsorted(t, np.arange(n_chunks + 1, dtype=np.int64)
                             * chunk_us)
    for i in range(n_chunks):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        yield EventChunk(t=t[lo:hi], x=x[lo:hi], y=y[lo:hi], p=p[lo:hi])


class SyntheticSource(EventSource):
    """The analytic generator behind the :class:`EventSource` contract."""

    def __init__(self, cfg: events_mod.EventStreamConfig):
        self.cfg = cfg
        self.name = cfg.name
        self.height, self.width = cfg.height, cfg.width
        self.sensor_hw = (cfg.height, cfg.width)
        self.n_classes = cfg.n_classes
        self.duration_ms = cfg.duration_ms

    def sample_batch(self, gen, batch_size, t_intg_ms, n_sub=1):
        return events_mod.sample_batch(gen, self.cfg, batch_size, t_intg_ms,
                                       n_sub=n_sub)

    def sample_batch_with_labels(self, gen, labels, t_intg_ms, n_sub=1):
        return events_mod.sample_batch_with_labels(gen, self.cfg, labels,
                                                   t_intg_ms, n_sub=n_sub)

    def iter_event_chunks(self, gen, *, chunk_us, slot_us=None,
                          label: int | None = None):
        """Replay one synthetic sample: frames on the ``slot_us`` grid
        (default one slot per chunk) expanded into discrete events
        (re-binning at ``slot_us`` recovers the frames exactly), sliced
        into ``chunk_us`` chunks. Events are drawn on the first ``next()``,
        so a stream queued but not yet admitted costs nothing."""
        slot_us = chunk_us if slot_us is None else slot_us
        if chunk_us % slot_us:
            raise ValueError(f"chunk_us={chunk_us} must be a multiple of "
                             f"the generation grid slot_us={slot_us}")
        n_chunks = _replay_chunk_count(self.duration_ms, chunk_us)
        n_total = n_chunks * (chunk_us // slot_us)
        if label is None:
            label = int(torch.randint(0, self.n_classes, (1,), generator=gen))

        def lazy(lab=label):
            frames = events_mod.sample_events(gen, self.cfg, [lab], n_total, 1)
            ev = frames_to_events(frames[0, :, 0].numpy(), slot_us)
            yield from rechunk_events(ev, chunk_us, n_chunks)

        return label, lazy()


def as_source(data) -> EventSource:
    """The engines' ``data_cfg`` argument: an :class:`EventSource` passes
    through, a bare :class:`~repro_torch.data.events.EventStreamConfig` is
    wrapped in :class:`SyntheticSource`."""
    if isinstance(data, EventSource):
        return data
    if isinstance(data, events_mod.EventStreamConfig):
        return SyntheticSource(data)
    raise TypeError(f"expected EventSource or EventStreamConfig, "
                    f"got {type(data).__name__}")


def resolve_dataset(name: str, *, hw: int = 16, data_root: str | None = None,
                    duration_ms: float | None = None, split: str = "train"
                    ) -> EventSource:
    """Dataset name → an :class:`EventSource` (``synthetic-*`` names).
    ``duration_ms=None`` picks the dataset's default
    (:data:`DATASET_DURATIONS_MS`); ``data_root`` and ``split`` belong to
    the file-backed datasets, which raise."""
    if name in FILE_BACKED:
        raise NotImplementedError(
            f"dataset {name!r} is file-backed; the file-backed sources "
            f"(data/sources.py, data/fixtures.py, data/cache.py) come with "
            f"a later slice of the port — use synthetic-gesture or "
            f"synthetic-nmnist")
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r} (expected one of "
                         f"{DATASETS + FILE_BACKED})")
    if duration_ms is None:
        duration_ms = DATASET_DURATIONS_MS[name]
    base = (events_mod.dvs_gesture_like(hw) if name == "synthetic-gesture"
            else events_mod.nmnist_like(hw))
    return SyntheticSource(replace(base, duration_ms=duration_ms))


def resolve_eval_dataset(name: str, **kwargs
                         ) -> tuple[EventSource | None, str | None]:
    """Held-out eval source: ``(None, None)`` for the synthetic datasets
    (one generative stream, no split), as the reference returns; the
    file-backed datasets raise, as :func:`resolve_dataset` does."""
    if name not in FILE_BACKED:
        return None, None
    return resolve_dataset(name, split="val", **kwargs), "val"
