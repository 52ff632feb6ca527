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

The deployment registry, online adaptation and lane sharding of the
reference engine come with later slices of the port.
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
from repro_torch.stream.accumulator import make_stream_fns
from repro_torch.stream.deploy import Deployment, compat_digest

STATS_SCHEMA = "p2m-stream-serving/v5"


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
    bin_workers: int = 1
    n_offered: int = 0
    n_admitted: int = 0
    n_shed: int = 0               # rejected: pending queue was full
    n_deferred: int = 0           # admitted later than their offer window
    registry_compat: str = ""
    max_open_streams: int = 0     # peak concurrently-open replay iterators
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
        n_correct = sum(r.correct for r in self.results)
        n_events = sum(r.n_events for r in self.results)
        # the single deployment is the artifact's one registry row
        row = {"name": "default", "uid": 0, "n_admitted": self.n_admitted,
               "n_finished": len(self.results), "n_correct": n_correct,
               "n_misses": self.n_misses, "n_events": n_events,
               "n_readouts": self.total_readouts}
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
                "devices": 1,
                "bin_workers": self.bin_workers,
                "padded_capacity": self.capacity,
                "lanes_per_shard": self.capacity,
                "per_shard_admitted": [self.n_admitted],
            },
            "admission": {
                "offered_rate": self.offered_rate,
                "max_pending": self.max_pending,
                "n_offered": self.n_offered,
                "n_admitted": self.n_admitted,
                "n_shed": self.n_shed,
                "n_rejected": 0,
                "n_deferred": self.n_deferred,
                "max_open_streams": self.max_open_streams,
            },
            "registry": {
                "compat": self.registry_compat,
                "max_entries": 1,
                "entries": ([{**row,
                              "accuracy": (n_correct / len(self.results)
                                           if self.results else 0.0),
                              "events_per_s": n_events / wall}]
                            if self.n_admitted else []),
            },
            "adaptation": {"enabled": False, "rule": None, "lr_w": 0.0,
                           "lr_theta": 0.0, "n_updates": 0,
                           "accuracy_pre": None, "accuracy_post": None,
                           "lanes": []},
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
                "events_per_s_per_device": self.total_events / wall,
                "readouts_per_s": self.total_readouts / wall,
                "streams_per_s": len(self.results) / wall,
                "layer1_spikes_per_s": self.total_layer1_spikes / wall,
            },
        }


class StreamEngine:
    """Continuous-batching online inference over one deployment.

    ``capacity`` is the fixed lane count of the batched steps;
    ``chunks_per_window`` how many raw-event chunks arrive per T_INTG window
    (must divide ``n_sub``; default one per fine sub-slot). ``fold_mode``
    picks the streaming-fold kernel (``"deposit"`` or ``"mac"``).
    ``prefetch=False`` bins chunks inline on the serving thread instead of
    on ``bin_workers`` host threads (the folded numbers are identical).
    The engine runs on ``device`` (default ``cuda``).
    """

    def __init__(self, dep: Deployment, *, capacity: int = 4,
                 chunks_per_window: int | None = None,
                 fold_mode: str = "deposit", prefetch: bool = True,
                 bin_workers: int = 1,
                 device: str | torch.device | None = None,
                 adapt=None, executor=None):
        if not isinstance(dep, Deployment):
            raise NotImplementedError(
                "registry serving (stream/registry.py) comes with a later "
                "slice of the port; pass one Deployment")
        if adapt is not None:
            raise NotImplementedError(
                "online adaptation (stream/adapt.py) comes with a later "
                "slice of the port")
        if executor is not None:
            raise NotImplementedError(
                "lane sharding (stream/shard.py) comes with a later slice "
                "of the port")
        if bin_workers < 1:
            raise ValueError(f"bin_workers must be >= 1, got {bin_workers}")
        cfg = dep.model_cfg.p2m
        self.dep = dep
        self.capacity = capacity
        self.bin_workers = bin_workers
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
        self.fns = make_stream_fns(dep, capacity=capacity,
                                   chunk_slots=self.chunk_slots,
                                   fold_mode=fold_mode, device=device)
        self.device = self.fns.device

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
        return lane * self.bin_workers // self.capacity

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
        """Workers' per-lane blocks → the fold's [capacity, chunk_slots, H,
        W, 2] batch on the device (unoccupied lanes stay zero)."""
        h, w = self.fns.in_hw
        frames = np.zeros((self.capacity, self.chunk_slots, h, w, 2),
                          np.float32)
        for part in parts:
            for lane_i, block in part:
                frames[lane_i] = block
        return torch.from_numpy(frames).to(self.device)

    # ------------------------------------------------------------------
    def serve(self, source: EventSource, n_streams: int, *, seed: int = 0,
              paced: bool = False, offered_rate: float | None = None,
              max_pending: int | None = None, log=None) -> ServingReport:
        """Serve ``n_streams`` replayed samples of ``source``.

        ``offered_rate`` trickles the offers at that many streams/s on the
        replay clock (default: all up front); ``max_pending`` bounds the
        pending queue and sheds offers beyond it (``None`` = unbounded).
        Stream ``i`` replays from :func:`stream_generator` ``(seed, i)``.
        """
        if offered_rate is not None and offered_rate <= 0:
            raise ValueError(f"offered_rate must be > 0 streams/s, got "
                             f"{offered_rate}")
        if max_pending is not None and max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        t_intg_s = self.dep.t_intg_ms * 1e-3
        offers_per_window = (None if offered_rate is None
                             else offered_rate * t_intg_s)

        def offer_window(i: int) -> int:
            return (0 if offers_per_window is None
                    else int(math.floor(i / offers_per_window)))

        slots: ShardedSlots[_Lane] = ShardedSlots(self.capacity)
        pending: deque[tuple[int, int]] = deque()  # (stream_id, offered_w)
        results: list[StreamResult] = []
        report = ServingReport(
            results=results, deployed=self.dep.deployed_meta(),
            capacity=self.capacity, chunks_per_window=self.chunks_per_window,
            t_intg_ms=self.dep.t_intg_ms, wall_s=0.0, total_events=0,
            total_readouts=0, total_layer1_spikes=0.0,
            device=str(self.device), paced=paced, offered_rate=offered_rate,
            max_pending=max_pending, bin_workers=self.bin_workers,
            registry_compat=compat_digest(self.dep))

        # warm-up: one fold + readout on a throwaway state (builds the
        # kernels and fills the library caches) so the latency percentiles
        # measure steady-state serving
        h, w = self.fns.in_hw
        idle = np.zeros((self.capacity,), bool)
        ws = self.fns.fold(self.fns.init_state(),
                           torch.zeros((self.capacity, self.chunk_slots, h, w,
                                        2)), idle)
        ws, _ = self.fns.readout(ws, idle, ~idle)
        ws["logits"].cpu()
        state = self.fns.init_state()
        pool = _BinPool(self.bin_workers) if self.prefetch else None
        next_offer = 0
        window = 0
        t_start = time.perf_counter()
        try:
            while (next_offer < n_streams or pending
                   or not slots.is_empty()):
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
                    lane = self.open_stream(source,
                                            stream_generator(seed, sid), sid)
                    lane.offered_window = offered_w
                    lane.admitted_window = window
                    if window > offered_w:
                        report.n_deferred += 1
                    lane_i = slots.admit(lane)
                    state = self.fns.reset_lane(state, lane_i)
                    report.n_admitted += 1
                report.max_open_streams = max(report.max_open_streams,
                                              slots.n_occupied)
                occupied = list(slots.occupied())
                active = np.asarray(slots.active_mask())
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
                    state = self.fns.fold(state, self._assemble(parts),
                                          active)
                    report.fold_s.append(time.perf_counter() - t0)
                # ---- readout at the T_INTG boundary -------------------
                coarse_mask = np.zeros((self.capacity,), bool)
                for lane_i, lane in occupied:
                    coarse_mask[lane_i] = \
                        (lane.windows_done + 1) % self.group == 0
                t0 = time.perf_counter()
                state, out = self.fns.readout(state, active, coarse_mask)
                n_spikes = out["n_spikes"].cpu().numpy()  # window sync point
                t_done = time.perf_counter()
                report.readout_s.append(t_done - t0)
                margin_ms = ((t_done - (t_start + (window + 1) * t_intg_s))
                             * 1e3 if paced else None)
                window += 1
                for lane_i, lane in occupied:
                    lane.windows_done += 1
                    report.total_readouts += 1
                    report.total_layer1_spikes += float(n_spikes[lane_i])
                    if margin_ms is not None:
                        report.miss_margin_ms.append(margin_ms)
                        lane.worst_margin_ms = (
                            margin_ms if lane.worst_margin_ms is None
                            else max(lane.worst_margin_ms, margin_ms))
                        if margin_ms > 0:
                            lane.n_misses += 1
                            report.n_misses += 1
                    if lane.windows_done < lane.n_windows:
                        continue
                    # stream complete: finalize rate-decoded prediction
                    n_c = int(state["n_coarse"][lane_i])
                    logits = (state["logits"][lane_i].cpu().numpy()
                              / max(n_c, 1))
                    pred = int(np.argmax(logits))
                    report.total_events += lane.n_events
                    results.append(StreamResult(
                        stream_id=lane.stream_id, label=lane.label,
                        prediction=pred, correct=pred == lane.label,
                        n_events=lane.n_events,
                        n_readouts=lane.windows_done, n_coarse_frames=n_c,
                        offered_window=lane.offered_window,
                        admitted_window=lane.admitted_window,
                        finished_window=window, n_misses=lane.n_misses,
                        miss_margin_max_ms=lane.worst_margin_ms,
                        logits=[float(v) for v in logits]))
                    slots.release(lane_i)
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
        return report
