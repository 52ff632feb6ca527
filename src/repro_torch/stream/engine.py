"""Online event-stream serving with continuous batching, admission control
and optional paced real-time replay (``repro.stream.engine`` for one
deployment, in PyTorch).

Lifecycle of one stream:

  1. it is OFFERED (all at once, or trickled at ``offered_rate`` streams/s
     on the replay clock) into a bounded pending queue — or SHED when the
     queue is full;
  2. when a lane frees at a T_INTG window boundary it is ADMITTED: only
     now is its replay iterator opened and the lane's state zeroed;
  3. every replay tick a host worker pool bins each occupied lane's next
     chunk onto the fine sub-slot grid, one chunk ahead of the device, and
     ONE lane-batched ``fold`` advances every lane's leak ODE + deposit;
  4. at each T_INTG boundary one ``readout`` reads every lane and steps the
     backbone on lanes whose coarse window completed;
  5. after the stream's duration its prediction is finalized and its lane
     released for the pending queue.

Paced mode holds window ``k`` until wall clock ``t_start + k·t_intg`` and
counts a deadline miss whenever a readout completes after its boundary.
Predictions are identical to unpaced replay on the same seed: offers,
admission and shedding follow the window counter, never the wall clock.
The report is the reference's ``p2m-stream-serving/v5`` artifact.

**Registry mode** (``StreamEngine(Registry(...))``, ``stream/registry.py``)
serves a catalog of compat-equal variants from one lane table: streams
request a variant at offer time, admission binds each lane to an entry
(rejecting unresolvable requests), and ``register``/``retire`` hot-swap
entries mid-serve without touching lanes bound to other entries.

**Adaptation mode** (``adapt=AdaptConfig(...)``, ``stream/adapt.py``) gives
each lane persistent weight/threshold deltas that a local rule updates at
every labeled coarse-window readout; :meth:`StreamEngine.harvest` exports
them (``deploy.save_adapt_delta``).

**Sharding** (``executor=stream/shard.LaneExecutor(devices=n)``): the
capacity pads up to a multiple of n, each shard folds and reads out its
contiguous block of lanes on its own device (padding lanes are never
admitted), and the artifact's ``sharding`` block records the geometry and
each shard's admissions.
"""
from __future__ import annotations

import math
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Iterator

import numpy as np
import torch

from repro_torch.data.binning import bin_chunks, slot_us_for
from repro_torch.data.formats import EventChunk
from repro_torch.data.sources import EventSource
from repro_torch.serve.slots import ShardedSlots
from repro_torch.stream.accumulator import (entry_numerics,
                                            make_multi_stream_fns,
                                            make_stream_fns, stack_entries)
from repro_torch.stream.adapt import (AdaptConfig, adapt_entry_numerics,
                                      lane_stats, make_adapt_fns)
from repro_torch.stream.deploy import Deployment, tree_to
from repro_torch.stream.registry import (Registry, RegistryEntry,
                                         compat_digest, compat_key)
from repro_torch.stream.shard import LaneExecutor

STATS_SCHEMA = "p2m-stream-serving/v5"


class EntryTableFull(RuntimeError):
    """The engine's fixed-size per-entry param table has no reclaimable
    slot for a newly requested registry entry (every slot still has lanes
    bound to it). Admission rejects the stream; raise ``max_entries`` to
    co-serve more variants at once."""


def stream_generator(seed: int, stream_id: int) -> torch.Generator:
    """The replay generator of one stream: independent per (seed, id)."""
    state = np.random.SeedSequence((seed, stream_id)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2 ** 63 - 1))


@dataclass
class StreamResult:
    """Per-stream serving outcome."""
    stream_id: int
    label: int
    prediction: int
    correct: bool
    n_events: int
    n_readouts: int
    n_coarse_frames: int
    offered_window: int       # global window tick the stream was offered
    admitted_window: int      # global window tick the stream was admitted
    finished_window: int
    n_misses: int = 0         # paced mode: readouts past their deadline
    # worst miss margin over the stream's readouts, ms (None = unpaced)
    miss_margin_max_ms: float | None = None
    entry: str = "default"
    entry_uid: int = 0
    logits: list[float] = field(default_factory=list)  # rate-decoded mean


@dataclass
class _Lane:
    """Host-side state of one admitted stream."""
    stream_id: int
    label: int
    chunks: Iterator[EventChunk]
    n_windows: int
    offered_window: int = 0
    admitted_window: int = 0
    windows_done: int = 0
    n_events: int = 0
    t_cursor_us: int = 0
    n_misses: int = 0
    worst_margin_ms: float | None = None
    entry_name: str = "default"   # registry entry bound at admission
    entry_uid: int = 0
    entry_slot: int = 0           # engine param-table slot of that entry


class _BinWorker:
    """One host thread binning replay chunks ahead of the device fold. Jobs
    run in submission order; a lane's iterator only ever advances on the
    one worker that owns the lane. Exceptions surface at ``get()``."""

    _STOP = object()

    def __init__(self, index: int = 0):
        self._tasks: queue_mod.Queue = queue_mod.Queue()
        self._results: queue_mod.Queue = queue_mod.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"stream-bin-worker-{index}", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._tasks.get()
            if job is self._STOP:
                return
            try:
                self._results.put((job(), None))
            except BaseException as e:  # re-raised by get()
                self._results.put((None, e))

    def submit(self, job) -> None:
        self._tasks.put(job)

    def get(self):
        frames, err = self._results.get()
        if err is not None:
            raise err
        return frames

    def close(self) -> None:
        """Cancel queued jobs, stop and join the thread, drop results."""
        try:
            while True:
                self._tasks.get_nowait()
        except queue_mod.Empty:
            pass
        self._tasks.put(self._STOP)
        self._thread.join(timeout=10)
        try:
            while True:
                self._results.get_nowait()
        except queue_mod.Empty:
            pass


class _BinPool:
    """Fixed pool of :class:`_BinWorker` threads, one per contiguous lane
    slice; results are gathered in worker order, so the folded frames are
    the same for any worker count."""

    def __init__(self, n: int):
        self.workers = [_BinWorker(i) for i in range(n)]

    def submit(self, worker: int, job) -> None:
        self.workers[worker].submit(job)

    def get(self, worker: int):
        return self.workers[worker].get()

    def close(self) -> None:
        for w in self.workers:
            w.close()


@dataclass
class ServingReport:
    """Everything one serve() run produced; ``to_artifact()`` is the
    serving-stats JSON the launcher writes."""
    results: list[StreamResult]
    deployed: dict
    capacity: int
    chunks_per_window: int
    t_intg_ms: float
    wall_s: float
    total_events: int
    total_readouts: int
    total_layer1_spikes: float
    device: str = ""
    paced: bool = False
    offered_rate: float | None = None
    max_pending: int | None = None
    devices: int = 1              # lane-mesh shards (1 = unsharded)
    bin_workers: int = 1
    padded_capacity: int = 0      # lane axis after mesh padding
    lanes_per_shard: int = 0
    per_shard_admitted: list[int] = field(default_factory=list)
    n_offered: int = 0
    n_admitted: int = 0
    n_shed: int = 0               # rejected: pending queue was full
    # rejected at admission: variant request unresolvable (no match,
    # ambiguous, incompatible compat key, or entry table full)
    n_rejected: int = 0
    n_deferred: int = 0           # admitted later than their offer window
    # registry view: compat digest of the serving geometry, param-table
    # size, and one counter row per (name, uid) ever admitted
    registry_compat: str = ""
    registry_max_entries: int = 1
    entry_rows: list[dict] = field(default_factory=list)
    max_open_streams: int = 0     # peak concurrently-open replay iterators
    # adaptation view (None = served frozen): rule, update count, per-lane
    # delta rows, accuracy over the first and second half of the streams
    adaptation: dict | None = None
    n_misses: int = 0             # fleet-wide deadline misses (paced)
    miss_margin_ms: list[float] = field(default_factory=list)
    readout_s: list[float] = field(default_factory=list)
    fold_s: list[float] = field(default_factory=list)

    @property
    def accuracy(self) -> float:
        if not self.results:
            return 0.0
        return sum(r.correct for r in self.results) / len(self.results)

    @property
    def miss_rate(self) -> float:
        n = len(self.miss_margin_ms)
        return self.n_misses / n if n else 0.0

    def deadline_stats(self) -> dict:
        """Deadline counters, miss-margin percentiles and histogram."""
        m = np.asarray(self.miss_margin_ms, dtype=float)
        if m.size:
            pct = {q: float(np.percentile(m, int(q[1:])))
                   for q in ("p50", "p90", "p99")}
            pct["max"] = float(m.max())
            counts, edges = np.histogram(m, bins=8)
            hist = {"edges_ms": [float(e) for e in edges],
                    "counts": [int(c) for c in counts]}
        else:
            pct = {"p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0}
            hist = {"edges_ms": [], "counts": []}
        return {"n_deadlines": int(m.size), "n_misses": self.n_misses,
                "miss_rate": self.miss_rate, "margin_ms": pct,
                "histogram": hist}

    def to_artifact(self) -> dict:
        lat = lambda xs, q: (float(np.percentile(xs, q) * 1e3)  # noqa: E731
                             if xs else 0.0)
        wall = max(self.wall_s, 1e-9)
        return {
            "schema": STATS_SCHEMA,
            "deployed": self.deployed,
            "device": self.device,
            "n_streams": len(self.results),
            "capacity": self.capacity,
            "chunks_per_window": self.chunks_per_window,
            "t_intg_ms": self.t_intg_ms,
            "accuracy": self.accuracy,
            "paced": self.paced,
            "sharding": {
                "devices": self.devices,
                "bin_workers": self.bin_workers,
                "padded_capacity": self.padded_capacity,
                "lanes_per_shard": self.lanes_per_shard,
                "per_shard_admitted": list(self.per_shard_admitted),
            },
            "admission": {
                "offered_rate": self.offered_rate,
                "max_pending": self.max_pending,
                "n_offered": self.n_offered,
                "n_admitted": self.n_admitted,
                "n_shed": self.n_shed,
                "n_rejected": self.n_rejected,
                "n_deferred": self.n_deferred,
                "max_open_streams": self.max_open_streams,
            },
            "registry": {
                "compat": self.registry_compat,
                "max_entries": self.registry_max_entries,
                "entries": [
                    {**row,
                     "accuracy": (row["n_correct"] / row["n_finished"]
                                  if row["n_finished"] else 0.0),
                     "events_per_s": row["n_events"] / wall}
                    for row in self.entry_rows
                ],
            },
            "adaptation": (self.adaptation if self.adaptation is not None
                           else {"enabled": False, "rule": None,
                                 "lr_w": 0.0, "lr_theta": 0.0,
                                 "n_updates": 0, "accuracy_pre": None,
                                 "accuracy_post": None, "lanes": []}),
            "deadlines": self.deadline_stats(),
            "streams": [asdict(r) for r in self.results],
            "latency_ms": {
                "readout_p50": lat(self.readout_s, 50),
                "readout_p99": lat(self.readout_s, 99),
                "readout_mean": (float(np.mean(self.readout_s) * 1e3)
                                 if self.readout_s else 0.0),
                "fold_p50": lat(self.fold_s, 50),
                "fold_p99": lat(self.fold_s, 99),
            },
            "throughput": {
                "wall_s": self.wall_s,
                "events_per_s": self.total_events / wall,
                "events_per_s_per_device": (self.total_events / wall
                                            / max(self.devices, 1)),
                "readouts_per_s": self.total_readouts / wall,
                "streams_per_s": len(self.results) / wall,
                "layer1_spikes_per_s": self.total_layer1_spikes / wall,
            },
        }


class StreamEngine:
    """Continuous-batching online inference over one deployment, or over a
    :class:`~repro_torch.stream.registry.Registry` of compat-equal
    deployments with per-stream variant selection.

    ``capacity`` is the fixed lane count of the batched steps;
    ``chunks_per_window`` how many raw-event chunks arrive per T_INTG window
    (must divide ``n_sub``; default one per fine sub-slot). ``fold_mode``
    picks the streaming-fold kernel (``"deposit"`` or ``"mac"``); ``None``
    means ``"deposit"``, or with ``adapt`` the adaptation's own per-lane
    fold (a kernel mode with ``adapt`` raises). ``prefetch=False`` bins
    chunks inline on the serving thread instead of on ``bin_workers`` host
    threads (the folded numbers are identical). The engine runs on
    ``device`` (default ``cuda``).

    **Registry mode**: the first registered entry anchors the serving
    geometry (compat key); per-lane numerics live in a table of
    ``max_entries`` slots whose stacked bundle is an argument of the
    multi-variant steps, so ``register``/``retire`` mid-serve re-stacks it
    without touching lanes bound to other entries. A retired entry stays
    in its slot until the last lane bound to it releases. Admission
    resolves each stream's request (``serve(variants=...)``); an
    unresolvable one (no match, ambiguous, other compat key, table full)
    rejects the stream. Mixed-variant serving is bit-identical per stream
    to single-variant serving of each stream's entry.

    **Adaptation** (``adapt``): per-lane deltas persist across serve()
    calls (``adapt_state``); a lane's deltas reset when it rebinds to
    another entry uid, its traces at every admission.
    """

    def __init__(self, dep: "Deployment | Registry", *, capacity: int = 4,
                 chunks_per_window: int | None = None,
                 fold_mode: str | None = None, prefetch: bool = True,
                 bin_workers: int | None = None,
                 device: str | torch.device | None = None,
                 executor: LaneExecutor | None = None,
                 max_entries: int | None = None,
                 default_entry: str | None = None,
                 adapt: AdaptConfig | None = None):
        if isinstance(dep, Registry):
            if len(dep) == 0:
                raise ValueError(
                    "registry is empty — register at least one entry "
                    "before building a serving engine")
            self.registry: Registry | None = dep
            anchor = next(dep.entries())
            self.compat = anchor.compat
            self.dep = anchor.dep
            self.default_entry = default_entry
            self.max_entries = (max(len(dep) + 1, 2)
                                if max_entries is None else max_entries)
            if self.max_entries < len(dep):
                raise ValueError(
                    f"max_entries={self.max_entries} cannot hold the "
                    f"{len(dep)} already-registered entries")
        else:
            if max_entries is not None or default_entry is not None:
                raise ValueError("max_entries/default_entry require a "
                                 "registry-backed engine")
            self.registry = None
            self.dep = dep
            self.compat = compat_key(dep)
            self.default_entry = None
            self.max_entries = 1
        cfg = self.dep.model_cfg.p2m
        dep = self.dep
        self.capacity = capacity
        self.executor = executor or LaneExecutor()
        self.padded_capacity = self.executor.padded_size(capacity)
        self.lanes_per_shard = self.padded_capacity // self.executor.devices
        if bin_workers is not None and bin_workers < 1:
            raise ValueError(f"bin_workers must be >= 1, got {bin_workers}")
        self.bin_workers = (self.executor.devices if bin_workers is None
                            else bin_workers)
        self.n_sub = cfg.n_sub
        self.chunks_per_window = (self.n_sub if chunks_per_window is None
                                  else chunks_per_window)
        if self.n_sub % self.chunks_per_window:
            raise ValueError(
                f"chunks_per_window={self.chunks_per_window} must divide "
                f"n_sub={self.n_sub}")
        self.chunk_slots = self.n_sub // self.chunks_per_window
        self.slot_us = slot_us_for(cfg.t_intg_ms, cfg.n_sub)
        self.chunk_us = self.slot_us * self.chunk_slots
        self.group = dep.model_cfg.coarsen_group()
        self.prefetch = prefetch
        self.adapt = adapt
        lanes = dict(capacity=self.padded_capacity,
                     chunk_slots=self.chunk_slots, device=device,
                     executor=self.executor)
        if adapt is not None:
            self.fold_mode = fold_mode
            self.fns = make_adapt_fns(dep, adapt=adapt, fold_mode=fold_mode,
                                      registry=self.registry is not None,
                                      **lanes)
            # per-lane deltas and traces, resident across serve() calls so
            # a lane keeps learning over stream turnover and harvest works
            # after the run
            self.adapt_state = self.fns.init_adapt()
            # entry uid each lane's deltas were learned against (-1 = never
            # admitted): rebinding to another uid voids them
            self._lane_entry_uid = np.full((self.padded_capacity,), -1,
                                           np.int64)
            self._lane_base: list[Deployment | None] = \
                [None] * self.padded_capacity
            self._lane_base_name = ["default"] * self.padded_capacity
            self._labels = np.full((self.padded_capacity,), -1, np.int32)
        else:
            self.fold_mode = fold_mode or "deposit"
            make = (make_stream_fns if self.registry is None
                    else make_multi_stream_fns)
            self.fns = make(dep, fold_mode=self.fold_mode, **lanes)
        self.device = self.fns.device
        self._places = self.executor.bind(self.device)
        if self.registry is not None:
            # fixed-size param table: slot i holds the numerics of one
            # (name, uid) registration; refcounts count the resident lanes
            # bound to it, so a hot-swap keeps a retired entry's weights
            # until its last lane drains. Unused slots hold the anchor's
            # numerics as shape placeholders.
            anchor_nb = self._entry_numerics(dep)
            self._entry_slots: list[tuple[str, int] | None] = \
                [None] * self.max_entries
            self._entry_refs = [0] * self.max_entries
            self._entry_nbs = [anchor_nb] * self.max_entries
            self._bundle = self._stack()
            self._entry_of = np.zeros((self.padded_capacity,), np.int32)

    def _stack(self) -> dict:
        """The table's bundle, one copy on each shard's device."""
        return self.executor.replicate(stack_entries(self._entry_nbs),
                                       self._places)

    def _entry_numerics(self, dep: Deployment) -> dict:
        """One table slot's numerics on the engine's device (with the leak
        coefficients when adapting)."""
        if self.adapt is not None:
            return adapt_entry_numerics(dep, self.device)
        with torch.no_grad():
            return tree_to(entry_numerics(dep), self.device)

    # -- registry param-table bookkeeping ------------------------------
    def _slot_stale(self, slot: int) -> bool:
        """True when the slot's (name, uid) is no longer live in the
        registry (retired, or the name re-registered under a new uid)."""
        key = self._entry_slots[slot]
        if key is None:
            return True
        name, uid = key
        return name not in self.registry or self.registry.get(name).uid != uid

    def _bind_entry(self, entry: RegistryEntry) -> int:
        """Bind one more lane to ``entry``, installing its numerics on first
        use (re-stacking the bundle). A free slot is taken stale-first,
        then live-but-unused; :class:`EntryTableFull` when every slot still
        has lanes bound to it."""
        key = (entry.name, entry.uid)
        for i, k in enumerate(self._entry_slots):
            if k == key:
                self._entry_refs[i] += 1
                return i
        victim = None
        for i in range(self.max_entries):
            if self._entry_refs[i] == 0 and self._slot_stale(i):
                victim = i
                break
        if victim is None:  # evict a live-but-unused cached entry
            for i in range(self.max_entries):
                if self._entry_refs[i] == 0:
                    victim = i
                    break
        if victim is None:
            raise EntryTableFull(
                f"all {self.max_entries} entry slots have resident lanes "
                f"(bound: {[k for k in self._entry_slots if k]}) — raise "
                f"max_entries to co-serve more variants")
        self._entry_slots[victim] = key
        self._entry_nbs[victim] = self._entry_numerics(entry.dep)
        self._entry_refs[victim] = 1
        self._bundle = self._stack()
        return victim

    def _unbind_entry(self, slot: int) -> None:
        assert self._entry_refs[slot] > 0
        self._entry_refs[slot] -= 1

    # ------------------------------------------------------------------
    def open_stream(self, source: EventSource, gen: torch.Generator,
                    stream_id: int) -> _Lane:
        """Open one replayed sample into an admission-ready lane record —
        at admission time, so resident iterators never exceed capacity."""
        h, w = self.fns.in_hw
        if (source.height, source.width) != (h, w):
            raise ValueError(
                f"source resolution {(source.height, source.width)} does "
                f"not match the deployed model's input {(h, w)}")
        if source.n_classes > self.fns.n_classes:
            raise ValueError(
                f"source has {source.n_classes} classes but the deployed "
                f"head predicts {self.fns.n_classes}")
        n_windows = source.n_slots(self.dep.t_intg_ms)
        if n_windows % self.group:
            raise ValueError(
                f"stream duration {source.duration_ms:g} ms yields "
                f"{n_windows} T_INTG windows, not a multiple of the "
                f"deployed coarse group {self.group} (coarse_window_ms="
                f"{self.dep.model_cfg.coarse_window_ms:g}) — the backbone "
                f"would never step")
        label, chunks = source.iter_event_chunks(
            gen, chunk_us=self.chunk_us, slot_us=self.slot_us)
        return _Lane(stream_id=stream_id, label=label, chunks=chunks,
                     n_windows=n_windows)

    def _bin_chunk(self, source: EventSource, lane: _Lane) -> np.ndarray:
        """Next replay chunk of ``lane`` → frames [chunk_slots, H, W, 2]."""
        chunk = next(lane.chunks)
        lane.n_events += len(chunk)
        frames = bin_chunks([chunk], n_total=self.chunk_slots,
                            slot_us=self.slot_us, sensor_hw=source.sensor_hw,
                            out_hw=self.fns.in_hw, t0_us=lane.t_cursor_us)
        lane.t_cursor_us += self.chunk_us
        return frames

    def _worker_of(self, lane: int) -> int:
        """Owning bin worker of a lane: contiguous balanced slices."""
        return lane * self.bin_workers // self.padded_capacity

    def _partition(self, occupied: list[tuple[int, _Lane]]
                   ) -> list[list[tuple[int, _Lane]]]:
        parts: list[list[tuple[int, _Lane]]] = [
            [] for _ in range(self.bin_workers)]
        for lane_i, lane in occupied:
            parts[self._worker_of(lane_i)].append((lane_i, lane))
        return parts

    def _bin_part(self, source: EventSource,
                  lanes: list[tuple[int, _Lane]]
                  ) -> list[tuple[int, np.ndarray]]:
        return [(lane_i, self._bin_chunk(source, lane))
                for lane_i, lane in lanes]

    def _assemble(self, parts: list[list[tuple[int, np.ndarray]]]
                  ) -> torch.Tensor:
        """Workers' per-lane blocks → the fold's [padded_capacity,
        chunk_slots, H, W, 2] batch on the host (unoccupied lanes stay
        zero); the fold moves each shard's block to its device."""
        h, w = self.fns.in_hw
        frames = np.zeros((self.padded_capacity, self.chunk_slots, h, w, 2),
                          np.float32)
        for part in parts:
            for lane_i, block in part:
                frames[lane_i] = block
        return torch.from_numpy(frames)

    # ------------------------------------------------------------------
    def serve(self, source: EventSource, n_streams: int, *, seed: int = 0,
              paced: bool = False, offered_rate: float | None = None,
              max_pending: int | None = None, variants=None,
              on_window=None, log=None) -> ServingReport:
        """Serve ``n_streams`` replayed samples of ``source``.

        ``offered_rate`` trickles the offers at that many streams/s on the
        replay clock (default: all up front); ``max_pending`` bounds the
        pending queue and sheds offers beyond it (``None`` = unbounded).
        Stream ``i`` replays from :func:`stream_generator` ``(seed, i)``.

        ``variants`` (registry mode) carries each stream's variant request
        (an entry name, a matcher dict, or ``None`` for ``default_entry``)
        as a sequence of ``n_streams`` or a callable ``stream_id ->
        request``, resolved at admission against the live registry;
        unresolvable requests reject the stream (``n_rejected``).
        ``on_window(window)`` runs at the top of every window iteration, on
        the serving thread, before that window's admissions: the hook for
        a hot-swap (``register``/``retire``) mid-serve.
        """
        if offered_rate is not None and offered_rate <= 0:
            raise ValueError(f"offered_rate must be > 0 streams/s, got "
                             f"{offered_rate}")
        if max_pending is not None and max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        if variants is None:
            req_of = lambda sid: None                         # noqa: E731
        elif self.registry is None:
            raise ValueError("variants requires a registry-backed engine")
        elif callable(variants):
            req_of = variants
        else:
            vlist = list(variants)
            if len(vlist) != n_streams:
                raise ValueError(f"variants has {len(vlist)} requests for "
                                 f"n_streams={n_streams}")
            req_of = lambda sid: vlist[sid]                   # noqa: E731
        t_intg_s = self.dep.t_intg_ms * 1e-3
        offers_per_window = (None if offered_rate is None
                             else offered_rate * t_intg_s)

        def offer_window(i: int) -> int:
            return (0 if offers_per_window is None
                    else int(math.floor(i / offers_per_window)))

        slots: ShardedSlots[_Lane] = ShardedSlots(self.capacity,
                                                  self.executor.devices)
        pending: deque[tuple[int, int]] = deque()  # (stream_id, offered_w)
        results: list[StreamResult] = []
        report = ServingReport(
            results=results, deployed=self.dep.deployed_meta(),
            capacity=self.capacity, chunks_per_window=self.chunks_per_window,
            t_intg_ms=self.dep.t_intg_ms, wall_s=0.0, total_events=0,
            total_readouts=0, total_layer1_spikes=0.0,
            device=str(self.device), paced=paced, offered_rate=offered_rate,
            max_pending=max_pending, devices=self.executor.devices,
            bin_workers=self.bin_workers,
            padded_capacity=self.padded_capacity,
            lanes_per_shard=self.lanes_per_shard,
            per_shard_admitted=[0] * self.executor.devices,
            registry_compat=compat_digest(self.compat),
            registry_max_entries=self.max_entries)
        # per-(name, uid) counter rows, created at first admission and
        # shared with report.entry_rows
        rows: dict[tuple[str, int], dict] = {}

        def row_of(lane: _Lane) -> dict:
            k = (lane.entry_name, lane.entry_uid)
            if k not in rows:
                rows[k] = {"name": k[0], "uid": k[1], "n_admitted": 0,
                           "n_finished": 0, "n_correct": 0, "n_misses": 0,
                           "n_events": 0, "n_readouts": 0}
                report.entry_rows.append(rows[k])
            return rows[k]

        def extra() -> tuple:
            """Registry mode: the per-lane entry slots and the param
            bundle ride along as step arguments."""
            return (() if self.registry is None
                    else (self._entry_of.copy(), self._bundle))

        # warm-up: one fold + readout on a throwaway state (builds the
        # kernels and fills the library caches) so the latency percentiles
        # measure steady-state serving; registry engines fold every lane
        # under slot 0, so the warm-up folds launch one kernel too
        h, w = self.fns.in_hw
        idle = np.zeros((self.padded_capacity,), bool)
        wframes = torch.zeros((self.padded_capacity, self.chunk_slots, h, w,
                               2))
        wx = (() if self.registry is None else
              (np.zeros((self.padded_capacity,), np.int32), self._bundle))
        if self.adapt is None:
            ws = self.fns.fold(self.fns.init_state(), wframes,
                               idle if self.registry is None else ~idle, *wx)
            ws, _ = self.fns.readout(ws, idle, ~idle, *wx)
        else:
            ws, wa = self.fns.fold(self.fns.init_state(),
                                   self.fns.init_adapt(), wframes, idle, *wx)
            ws, _, _ = self.fns.readout(ws, wa, idle, idle,
                                        np.full_like(self._labels, -1), *wx)
        ws["logits"].cpu()
        state = self.fns.init_state()
        pool = _BinPool(self.bin_workers) if self.prefetch else None
        next_offer = 0
        window = 0
        t_start = time.perf_counter()
        try:
            while (next_offer < n_streams or pending
                   or not slots.is_empty()):
                # ---- ops hook (hot-swap point) -------------------------
                if on_window is not None:
                    on_window(window)
                # ---- offers arriving at this window boundary ----------
                while (next_offer < n_streams
                       and offer_window(next_offer) <= window):
                    report.n_offered += 1
                    if (max_pending is not None
                            and len(pending) >= max_pending + slots.n_free):
                        report.n_shed += 1
                        if log is not None:
                            log(f"[admission] shed stream {next_offer} at "
                                f"window {window} (pending full)")
                    else:
                        pending.append((next_offer, window))
                    next_offer += 1
                # ---- lazy admission into free lanes -------------------
                while pending and not slots.is_full():
                    sid, offered_w = pending.popleft()
                    entry = None
                    if self.registry is not None:
                        # resolve against the live registry; unresolvable
                        # requests are rejected, never guessed
                        try:
                            entry = self.registry.resolve(
                                req_of(sid), compat=self.compat,
                                default=self.default_entry)
                            slot_e = self._bind_entry(entry)
                        except (LookupError, ValueError, TypeError,
                                EntryTableFull) as e:
                            report.n_rejected += 1
                            if log is not None:
                                log(f"[admission] rejected stream {sid} at "
                                    f"window {window}: {e}")
                            continue
                    lane = self.open_stream(source,
                                            stream_generator(seed, sid), sid)
                    lane.offered_window = offered_w
                    lane.admitted_window = window
                    if window > offered_w:
                        report.n_deferred += 1
                    lane_i = slots.admit(lane)
                    if entry is not None:
                        lane.entry_name = entry.name
                        lane.entry_uid = entry.uid
                        lane.entry_slot = slot_e
                        self._entry_of[lane_i] = slot_e
                    state = self.fns.reset_lane(state, lane_i)
                    if self.adapt is not None:
                        self._admit_adapt(lane_i, lane, entry)
                    report.n_admitted += 1
                    row_of(lane)["n_admitted"] += 1
                    report.per_shard_admitted[slots.shard_of(lane_i)] += 1
                report.max_open_streams = max(report.max_open_streams,
                                              slots.n_occupied)
                occupied = list(slots.occupied())
                active = np.asarray(slots.active_mask())
                ex = extra()
                # ---- paced: hold until this window's wall-clock start -
                if paced:
                    delay = (t_start + window * t_intg_s
                             - time.perf_counter())
                    if delay > 0:
                        time.sleep(delay)
                # ---- fold the window's replay chunks ------------------
                # binning runs one chunk ahead on the worker pool; the
                # folds stay in flight — the window's only host↔device
                # sync is the readout below
                parts_by_worker = self._partition(occupied)
                if pool is not None:
                    for _ in range(self.chunks_per_window):
                        for wi, lanes in enumerate(parts_by_worker):
                            pool.submit(wi, lambda ls=lanes:
                                        self._bin_part(source, ls))
                for _ in range(self.chunks_per_window):
                    t0 = time.perf_counter()
                    parts = ([pool.get(wi) for wi in range(self.bin_workers)]
                             if pool is not None else
                             [self._bin_part(source, ls)
                              for ls in parts_by_worker])
                    frames = self._assemble(parts)
                    if self.adapt is None:
                        state = self.fns.fold(state, frames, active, *ex)
                    else:
                        state, self.adapt_state = self.fns.fold(
                            state, self.adapt_state, frames, active, *ex)
                    report.fold_s.append(time.perf_counter() - t0)
                # ---- readout at the T_INTG boundary -------------------
                coarse_mask = np.zeros((self.padded_capacity,), bool)
                for lane_i, lane in occupied:
                    coarse_mask[lane_i] = \
                        (lane.windows_done + 1) % self.group == 0
                t0 = time.perf_counter()
                if self.adapt is None:
                    state, out = self.fns.readout(state, active, coarse_mask,
                                                  *ex)
                else:
                    state, self.adapt_state, out = self.fns.readout(
                        state, self.adapt_state, active, coarse_mask,
                        self._labels.copy(), *ex)
                n_spikes = out["n_spikes"].cpu().numpy()  # window sync point
                t_done = time.perf_counter()
                report.readout_s.append(t_done - t0)
                margin_ms = ((t_done - (t_start + (window + 1) * t_intg_s))
                             * 1e3 if paced else None)
                window += 1
                for lane_i, lane in occupied:
                    lane.windows_done += 1
                    report.total_readouts += 1
                    row = row_of(lane)
                    row["n_readouts"] += 1
                    report.total_layer1_spikes += float(n_spikes[lane_i])
                    if margin_ms is not None:
                        report.miss_margin_ms.append(margin_ms)
                        lane.worst_margin_ms = (
                            margin_ms if lane.worst_margin_ms is None
                            else max(lane.worst_margin_ms, margin_ms))
                        if margin_ms > 0:
                            lane.n_misses += 1
                            report.n_misses += 1
                            row["n_misses"] += 1
                    if lane.windows_done < lane.n_windows:
                        continue
                    # stream complete: finalize rate-decoded prediction
                    n_c = int(state["n_coarse"][lane_i])
                    logits = (state["logits"][lane_i].cpu().numpy()
                              / max(n_c, 1))
                    pred = int(np.argmax(logits))
                    report.total_events += lane.n_events
                    row["n_finished"] += 1
                    row["n_correct"] += int(pred == lane.label)
                    row["n_events"] += lane.n_events
                    results.append(StreamResult(
                        stream_id=lane.stream_id, label=lane.label,
                        prediction=pred, correct=pred == lane.label,
                        n_events=lane.n_events,
                        n_readouts=lane.windows_done, n_coarse_frames=n_c,
                        offered_window=lane.offered_window,
                        admitted_window=lane.admitted_window,
                        finished_window=window, n_misses=lane.n_misses,
                        miss_margin_max_ms=lane.worst_margin_ms,
                        entry=lane.entry_name, entry_uid=lane.entry_uid,
                        logits=[float(v) for v in logits]))
                    slots.release(lane_i)
                    if self.adapt is not None:
                        self._labels[lane_i] = -1
                    if self.registry is not None:
                        self._unbind_entry(lane.entry_slot)
                    if log is not None:
                        log(f"[stream {lane.stream_id}] label={lane.label} "
                            f"pred={pred} readouts={lane.windows_done} "
                            f"events={lane.n_events}"
                            + (f" misses={lane.n_misses}" if paced else ""))
        finally:
            # on the exception path too: drain and join every bin worker so
            # no thread keeps an open replay iterator
            if pool is not None:
                pool.close()
        report.wall_s = time.perf_counter() - t_start
        if self.adapt is not None:
            report.adaptation = self._adaptation_block(results)
        return report

    def _admit_adapt(self, lane_i: int, lane: _Lane,
                     entry: RegistryEntry | None) -> None:
        """Adaptation bookkeeping of an admission: learned deltas persist
        across streams on the lane (it models one physical sensor) but are
        void against another base entry uid."""
        uid = entry.uid if entry is not None else 0
        if self._lane_entry_uid[lane_i] == uid:
            self.fns.reset_lane_transient(self.adapt_state, lane_i)
        else:
            self.fns.reset_lane_full(self.adapt_state, lane_i)
        self._lane_entry_uid[lane_i] = uid
        self._lane_base[lane_i] = entry.dep if entry is not None else self.dep
        self._lane_base_name[lane_i] = lane.entry_name
        self._labels[lane_i] = lane.label

    def _adaptation_block(self, results: list[StreamResult]) -> dict:
        """The v5 artifact's ``adaptation`` block: rule, learning rates,
        update count, per-lane delta rows, and the accuracy over the first
        and second half of this run's streams in finish order (a cheap
        online signal that adaptation helps)."""
        lanes = lane_stats(self.adapt_state)

        def acc(rs: list[StreamResult]) -> float | None:
            return sum(r.correct for r in rs) / len(rs) if rs else None

        half = len(results) // 2
        return {"enabled": True, "rule": self.adapt.rule,
                "lr_w": self.adapt.lr_w, "lr_theta": self.adapt.lr_theta,
                "n_updates": sum(r["n_updates"] for r in lanes),
                "accuracy_pre": acc(results[:half]),
                "accuracy_post": acc(results[half:]), "lanes": lanes}

    # ------------------------------------------------------------------
    def harvest(self, lane: int) -> dict:
        """One adapted lane's learned deltas and base identity, ready for
        ``deploy.save_adapt_delta`` and re-registration. The deltas are
        relative to the base entry's quantized layer-1 weights and deployed
        threshold, as the lane served them. A lane that never updated
        harvests zero deltas; a lane that never served raises."""
        if self.adapt is None:
            raise ValueError("engine was built without adapt= — nothing "
                             "to harvest")
        if not 0 <= lane < self.padded_capacity:
            raise ValueError(f"lane {lane} out of range "
                             f"[0, {self.padded_capacity})")
        base = self._lane_base[lane]
        if base is None:
            raise ValueError(f"lane {lane} never served a stream — no "
                             f"base entry to delta against")
        ast = self.adapt_state
        return {
            "lane": lane,
            "dw": ast["dw"][lane].cpu().numpy(),
            "dtheta": float(ast["dtheta"][lane]),
            "n_updates": int(ast["n_updates"][lane]),
            "base_name": self._lane_base_name[lane],
            "base_uid": int(self._lane_entry_uid[lane]),
            "base": base,
        }
