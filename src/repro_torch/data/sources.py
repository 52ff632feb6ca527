"""Event sources: one contract over synthetic and file-backed DVS streams
(the port's own copy of ``repro.data.sources``).

Two seams: ``source.sample_batch(gen, batch_size, t_intg_ms, n_sub)``
draws a training/eval batch, float32 events ``[B, n_slots, n_sub, H, W,
2]`` and int64 labels ``[B]`` on the CPU (the caller moves them to its
device); ``source.iter_event_chunks(gen, chunk_us=..., slot_us=...)``
replays one labeled sample as a timestamped live stream of raw ``(t, x,
y, p)`` chunks at the source's ``sensor_hw``; empty chunks are yielded
too, so a replay consumer's clock advances through event gaps.

The synthetic sources wrap the analytic generator (``data/events.py``).
The file-backed ones read DVS128-Gesture (AEDAT 3.1 recordings sliced by
their ``*_labels.csv`` gesture windows) and N-MNIST (per-digit ``.bin``
files): each sample streams through the chunked parsers
(``data/formats.py``), is folded into fine-slot frames by the binner
(``data/binning.py``) at the requested T_INTG and kept in the on-disk
frame cache (``data/cache.py``). Train/val membership is a hash of each
sample's identity, the reference's, so both packages split a dataset the
same way. Draws come from the caller's ``torch.Generator`` where the
reference splits a JAX key, so the same seed picks other samples; the
sample lists, the splits and the frames of a given sample index equal
the reference's.
"""
from __future__ import annotations

import csv
import hashlib
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.data import events as events_mod
from repro_torch.data.binning import bin_chunks, frames_to_events, slot_us_for
from repro_torch.data.cache import CACHE_DIRNAME, FrameCache
from repro_torch.data.formats import (
    DVS128_SENSOR_HW, EventChunk, NMNIST_SENSOR_HW, concat_chunks,
    read_aedat31, read_nmnist_bin,
)

DATASETS = ("synthetic-gesture", "synthetic-nmnist", "dvs128", "nmnist")
FILE_BACKED = ("dvs128", "nmnist")
SPLITS = ("train", "val", "all")
VAL_PERCENT = 20                     # deterministic hash-split fraction
# default stream duration per dataset (the reference's: DVS128-Gesture
# trials are cropped to 2 s; real N-MNIST recordings span about 300 ms)
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


# ---------------------------------------------------------------------------
# file-backed sources
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FileSample:
    """One labeled recording window: ``chunks()`` streams its events
    (time-limited where the format allows), ``t0_us`` is the window start
    subtracted at binning time, ``t1_us`` the labeled window's end
    (absolute µs; events at or after it belong to the next sample; None:
    the whole recording). ``split_id`` is the identity the train/val hash
    runs on (default ``sample_id``); a recording of many windows sets it
    to the recording's path, so all its windows land in one split."""
    sample_id: str
    label: int
    chunks: Callable[[], Iterator[EventChunk]] = field(compare=False)
    t0_us: int = 0
    t1_us: int | None = None
    split_id: str | None = None


def split_of(sample_id: str, val_percent: int = VAL_PERCENT) -> str:
    """Train/val membership: the first 4 bytes of the identity's sha1,
    big-endian, mod 100 under ``val_percent`` is val. Independent of
    enumeration order and absolute paths."""
    h = int.from_bytes(hashlib.sha1(sample_id.encode()).digest()[:4], "big")
    return "val" if h % 100 < val_percent else "train"


class FileEventSource(EventSource):
    """What the file-backed sources share: split filtering, cached
    per-sample binning, the two samplers and the replay."""

    def __init__(self, name: str, samples: list[FileSample], *,
                 sensor_hw: tuple[int, int], hw: int, n_classes: int,
                 duration_ms: float, split: str = "train",
                 cache: FrameCache | None = None):
        if split not in SPLITS:
            raise ValueError(f"split {split!r} not in {SPLITS}")
        if not samples:
            raise ValueError(f"dataset {name!r}: no samples found")
        self.name = name
        self.sensor_hw = sensor_hw
        self.height = self.width = hw
        self.n_classes = n_classes
        self.duration_ms = duration_ms
        self.split = split
        self.cache = cache
        self.samples = sorted(
            (s for s in samples
             if split == "all"
             or split_of(s.split_id or s.sample_id) == split),
            key=lambda s: s.sample_id)
        if not self.samples:
            raise ValueError(f"dataset {name!r}: split {split!r} is empty "
                             f"({len(samples)} samples total)")
        self._by_class: dict[int, list[int]] = {}
        for i, s in enumerate(self.samples):
            self._by_class.setdefault(s.label, []).append(i)

    def _sample_frames(self, i: int, slot_us: int, n_total: int
                       ) -> np.ndarray:
        s = self.samples[i]

        def build():
            return bin_chunks(s.chunks(), n_total=n_total, slot_us=slot_us,
                              sensor_hw=self.sensor_hw,
                              out_hw=(self.height, self.width),
                              t0_us=s.t0_us, t_stop_us=s.t1_us)

        if self.cache is None:
            return build()
        return self.cache.get_or_build(
            s.sample_id, build, slot_us=slot_us,
            out_hw=(self.height, self.width), n_total=n_total)

    def _gather(self, idx, t_intg_ms: float, n_sub: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Frames and labels of the samples ``idx``: float32 ``[B, n_slots,
        n_sub, H, W, 2]`` and int64 ``[B]``, on the CPU."""
        n_slots = self.n_slots(t_intg_ms)
        slot_us = slot_us_for(t_intg_ms, n_sub)
        n_total = n_slots * n_sub
        frames = np.stack([self._sample_frames(int(i), slot_us, n_total)
                           for i in idx])
        ev = frames.reshape((len(idx), n_slots, n_sub,
                             self.height, self.width, 2))
        labels = np.asarray([self.samples[int(i)].label for i in idx],
                            dtype=np.int64)
        return torch.from_numpy(ev), torch.from_numpy(labels)

    def sample_batch(self, gen, batch_size, t_intg_ms, n_sub=1):
        idx = torch.randint(0, len(self.samples), (batch_size,),
                            generator=gen)
        return self._gather(idx.tolist(), t_intg_ms, n_sub)

    def sample_batch_with_labels(self, gen, labels, t_intg_ms, n_sub=1):
        labels = torch.as_tensor(labels).long()
        idx = []
        for lab in labels.tolist():
            pool = self._by_class.get(lab)
            if not pool:
                raise ValueError(f"dataset {self.name!r}: no {self.split} "
                                 f"samples for class {lab}")
            j = int(torch.randint(0, len(pool), (1,), generator=gen))
            idx.append(pool[j])
        ev, _ = self._gather(idx, t_intg_ms, n_sub)
        return ev, labels

    def iter_event_chunks(self, gen, *, chunk_us, slot_us=None,
                          index: int | None = None):
        """Replay one recording window: its events (window-clipped,
        stream-relative µs) sliced into ``chunk_us`` chunks. ``index`` pins
        the sample; by default it is drawn from ``gen``. ``slot_us`` is
        ignored: recordings carry real timestamps. The file is read on the
        first ``next()``, so a stream queued but not yet admitted holds no
        events."""
        del slot_us
        n_chunks = _replay_chunk_count(self.duration_ms, chunk_us)
        if index is None:
            index = int(torch.randint(0, len(self.samples), (1,),
                                      generator=gen))
        s = self.samples[index]

        def lazy(i=index):
            yield from rechunk_events(self.sample_events(i), chunk_us,
                                      n_chunks)

        return s.label, lazy()

    def sample_events(self, index: int) -> EventChunk:
        """One sample's full event record, window-clipped and shifted to
        stream-relative µs (what the replay slices and the offline binner
        reads)."""
        s = self.samples[index]
        ev = concat_chunks(s.chunks())
        keep = ev.t >= s.t0_us
        if s.t1_us is not None:
            keep &= ev.t < s.t1_us
        return EventChunk(t=ev.t[keep] - s.t0_us, x=ev.x[keep],
                          y=ev.y[keep], p=ev.p[keep])


def _make_cache(root: Path, dataset: str,
                cache_root: str | Path | None) -> FrameCache:
    return FrameCache(cache_root if cache_root is not None
                      else root / CACHE_DIRNAME, dataset)


class DVSGestureSource(FileEventSource):
    """DVS128-Gesture: AEDAT 3.1 recordings with companion
    ``<name>_labels.csv`` files (``class,startTime_usec,endTime_usec``,
    classes 1-indexed); each labeled window is one sample, cropped to
    ``duration_ms``. The distribution's ``trials_to_train.txt`` /
    ``trials_to_test.txt``, where both exist, define the split; otherwise
    a hash of the recording's path does (all windows of a recording in
    one split)."""

    N_CLASSES = 11

    def __init__(self, root: str | Path, *, hw: int = 16,
                 duration_ms: float = 2000.0, split: str = "train",
                 cache_root: str | Path | None = None):
        root = Path(root)
        listed = self._listed_trials(root)
        samples = []
        for aedat in sorted(root.rglob("*.aedat")):
            csv_path = aedat.with_name(aedat.stem + "_labels.csv")
            if not csv_path.exists():
                continue
            rel = aedat.relative_to(root).as_posix()
            for k, (cls, t0, t1) in enumerate(self._read_labels(csv_path)):
                samples.append(FileSample(
                    sample_id=f"{rel}#{k}", label=cls - 1,
                    chunks=(lambda p=aedat, stop=t1:
                            read_aedat31(p, t_stop_us=stop)),
                    t0_us=t0, t1_us=t1, split_id=rel))
        if listed is not None:
            want = listed["train" if split != "val" else "test"]
            if split != "all":
                samples = [s for s in samples
                           if s.sample_id.split("#")[0].split("/")[-1]
                           in want]
            split_eff = "all"
        else:
            split_eff = split
        super().__init__("dvs128", samples, sensor_hw=DVS128_SENSOR_HW,
                         hw=hw, n_classes=self.N_CLASSES,
                         duration_ms=duration_ms, split=split_eff,
                         cache=_make_cache(root, "dvs128", cache_root))

    @staticmethod
    def _listed_trials(root: Path) -> dict[str, set[str]] | None:
        tr, te = root / "trials_to_train.txt", root / "trials_to_test.txt"
        if not (tr.exists() and te.exists()):
            return None
        return {"train": {ln.strip() for ln in tr.read_text().splitlines()
                          if ln.strip()},
                "test": {ln.strip() for ln in te.read_text().splitlines()
                         if ln.strip()}}

    @staticmethod
    def _read_labels(path: Path) -> list[tuple[int, int, int]]:
        rows = []
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row or not row[0].strip().isdigit():
                    continue    # header / blank lines
                rows.append((int(row[0]), int(row[1]), int(row[2])))
        return rows


class NMNISTSource(FileEventSource):
    """N-MNIST: ``<root>/(Train|Test)/<digit>/*.bin`` (the released
    layout: ``split`` train/val map onto Train/Test) or a flat
    ``<root>/<digit>/*.bin`` (the hash split, per file)."""

    N_CLASSES = 10

    def __init__(self, root: str | Path, *, hw: int = 16,
                 duration_ms: float = 2000.0, split: str = "train",
                 cache_root: str | Path | None = None):
        root = Path(root)
        if (root / "Train").is_dir():
            bases = ([root / "Train", root / "Test"] if split == "all"
                     else [root / ("Train" if split == "train" else "Test")])
            split_eff = "all"
        else:
            bases = [root]
            split_eff = split
        samples = []
        for base in bases:
            for b in sorted(base.rglob("*.bin")):
                try:
                    label = int(b.parent.name)
                except ValueError:
                    continue
                if not 0 <= label < self.N_CLASSES:
                    continue
                samples.append(FileSample(
                    sample_id=b.relative_to(root).as_posix(), label=label,
                    chunks=lambda p=b: read_nmnist_bin(p)))
        super().__init__("nmnist", samples, sensor_hw=NMNIST_SENSOR_HW,
                         hw=hw, n_classes=self.N_CLASSES,
                         duration_ms=duration_ms, split=split_eff,
                         cache=_make_cache(root, "nmnist", cache_root))


# ---------------------------------------------------------------------------
# dataset registry
# ---------------------------------------------------------------------------

def resolve_dataset(name: str, *, hw: int = 16, data_root: str | None = None,
                    duration_ms: float | None = None, split: str = "train",
                    cache_root: str | Path | None = None) -> EventSource:
    """Dataset name → an :class:`EventSource`. ``synthetic-*`` names need
    no files; ``dvs128`` / ``nmnist`` need ``data_root`` (docs/datasets.md
    gives the layouts). ``duration_ms=None`` picks the dataset's default
    (:data:`DATASET_DURATIONS_MS`)."""
    if duration_ms is None:
        if name not in DATASET_DURATIONS_MS:
            raise ValueError(f"unknown dataset {name!r} (expected one of "
                             f"{DATASETS})")
        duration_ms = DATASET_DURATIONS_MS[name]
    if name == "synthetic-gesture":
        return SyntheticSource(replace(events_mod.dvs_gesture_like(hw),
                                       duration_ms=duration_ms))
    if name == "synthetic-nmnist":
        return SyntheticSource(replace(events_mod.nmnist_like(hw),
                                       duration_ms=duration_ms))
    if name in FILE_BACKED:
        if data_root is None:
            raise ValueError(f"dataset {name!r} is file-backed: pass "
                             f"--data-root (or data_root=) pointing at it, "
                             f"or use its synthetic-* fallback")
        cls = DVSGestureSource if name == "dvs128" else NMNISTSource
        return cls(data_root, hw=hw, duration_ms=duration_ms, split=split,
                   cache_root=cache_root)
    raise ValueError(f"unknown dataset {name!r} (expected one of "
                     f"{DATASETS})")


def resolve_eval_dataset(name: str, **kwargs
                         ) -> tuple[EventSource | None, str | None]:
    """Held-out eval source of a file-backed dataset: ``(val source,
    "val")``, or ``(None, "train")`` when the val split is empty (the
    engine then evaluates on the training stream); ``(None, None)`` for
    the synthetic datasets (one generative stream, no split). Callers pass
    the source to ``run_grid(eval_data=)`` and record the split name."""
    if name not in FILE_BACKED:
        return None, None
    try:
        return resolve_dataset(name, split="val", **kwargs), "val"
    except ValueError:
        return None, "train"
