#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no ``ok`` line):

  1. device  — the card's name and power limit; TF32 off for conv/matmul;
  2. build   — every kernel under src/repro_torch/csrc, one nvcc each;
  3. kernels — each streaming-fold kernel at the serving shapes
               (N = 16·128·128, F = 16, K = 18; S ∈ {1, 4}) against its
               plain PyTorch version on the card, with its time, its plain
               version's, the least time the card needs (bound) and one
               PyTorch library call's where one computes the same function;
  4. slice   — the paper's full-width configuration (configs/p2m_dvs.CONFIG)
               as a fresh seeded deployment (backbone gain doubled so its
               head spikes, see ``awake``), saved and reloaded through the
               checkpoint store, serving 16 synthetic-gesture streams on 16
               lanes through each fold kernel in turn, with the launch
               counters set to 0 before and read after each serve;
  5. parity  — the reduced() configuration served on cuda and on the CPU
               from the same seeded streams.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, fp32 non-tensor
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
N_LANES, HW, F, K = 16, 128, 16, 18
STREAM_MS = 2000.0        # the config's 4000 ms DATA duration, cut in half
LOGIT_ATOL, GAP = 1e-4, 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, reps: int = 25, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up;
    ``flush`` (not timed) runs before each, to start from a cold L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch, sf, ref) -> dict:
    """Both kernels against their plain versions at the serving shapes."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    N = N_LANES * HW * HW
    scratch = torch.empty(32 * 2 ** 20, device=dev)       # 128 MB > L2
    flush = scratch.zero_
    # ~1 s of memory traffic first, so the first kernel timed does not run
    # while the card's clocks are still ramping up from idle
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(50):
            flush()
        torch.cuda.synchronize()
    rows = {}
    for S in (1, 4):
        x0 = (torch.randn((N, F), generator=gen) * 0.05).to(dev)
        dep = (torch.randn((S, N, F), generator=gen) * 0.01).to(dev)
        a = torch.exp(-torch.rand(F, generator=gen) * 0.01).to(dev)
        got = sf.stream_fold_cuda(x0, dep, a)
        want = ref.stream_fold_ref(x0, dep, a)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"stream_fold S={S} is not bit-exact (max |diff| {err})")
        b, by = bound_ms((S + 2) * N * F * 4 + F * 4, 2 * S * N * F)
        row = {"name": "stream_fold", "S": S, "max_abs_err": err,
               "ms": time_ms(lambda: sf.stream_fold_cuda(x0, dep, a), torch,
                             flush=flush),
               "plain_ms": time_ms(lambda: ref.stream_fold_ref(x0, dep, a),
                                   torch, flush=flush),
               "bound_ms": b, "bound_by": by,
               "library_ms": (time_ms(lambda: torch.addcmul(dep[0], x0, a),
                                      torch, flush=flush)
                              if S == 1 else None)}
        rows[("fold", S)] = row

        patches = torch.poisson(torch.full((S, N, K), 0.3), generator=gen
                                ).to(dev)
        patches += torch.rand((S, N, K), generator=gen).to(dev) * 0.01
        w = (torch.round(torch.rand((K, F), generator=gen) * 16 - 8) / 8
             ).to(dev)
        got = sf.stream_fold_mac_cuda(x0, patches, w, a, dv_unit=0.01)
        want = ref.stream_fold_mac_ref(x0, patches, w, a, dv_unit=0.01)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= 1e-5:
            fail(f"stream_fold_mac S={S} max |diff| {err} > 1e-5")
        b, by = bound_ms((S * K + 2 * F) * N * 4 + K * F * 4 + F * 4,
                         S * N * F * (2 * K + 3))
        row = {"name": "stream_fold_mac", "S": S, "max_abs_err": err,
               "ms": time_ms(lambda: sf.stream_fold_mac_cuda(
                   x0, patches, w, a, dv_unit=0.01), torch, flush=flush),
               "plain_ms": time_ms(lambda: ref.stream_fold_mac_ref(
                   x0, patches, w, a, dv_unit=0.01), torch, flush=flush),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        rows[("fold_mac", S)] = row
    for row in rows.values():
        lib = ("-" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"[kernels] {row['name']:16s} S={row['S']} N={N} F={F}"
              f"{' K=%d' % K if row['name'].endswith('mac') else ''}: "
              f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
              f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})  "
              f"library {lib}  max|diff| {row['max_abs_err']:.3g}")
    return rows


class Prerecorded:
    """The synthetic source's streams drawn once, in stream-id order, with
    the generators the engine would give them, and replayed to every
    serve: the engine opens streams in id order, so serve ``k``'s stream
    ``i`` is recording ``i``. Drawing up front keeps event synthesis (host
    work) out of the serving wall time."""

    def __init__(self, source, n_streams: int, seed: int, chunk_us: int,
                 slot_us: int, stream_generator):
        for attr in ("name", "height", "width", "n_classes", "duration_ms",
                     "sensor_hw"):
            setattr(self, attr, getattr(source, attr))
        self.n_slots = source.n_slots
        self.recordings = []
        for sid in range(n_streams):
            label, chunks = source.iter_event_chunks(
                stream_generator(seed, sid), chunk_us=chunk_us,
                slot_us=slot_us)
            self.recordings.append((label, list(chunks)))
        self._opened = 0

    def replay(self) -> "Prerecorded":
        self._opened = 0
        return self

    def iter_event_chunks(self, gen, *, chunk_us, slot_us=None):
        label, chunks = self.recordings[self._opened]
        self._opened += 1
        return label, iter(chunks)


def serve_counted(torch, sf, engine, source, n_streams: int) -> tuple:
    """One main-path serve with the launch counters zeroed just before
    and read just after."""
    for k in sf.LAUNCHES:
        sf.LAUNCHES[k] = 0
    report = engine.serve(source.replay(), n_streams, seed=0)
    torch.cuda.synchronize()
    return report, dict(sf.LAUNCHES)


def awake(dep, gain: float = 2.0):
    """A fresh He-init backbone goes silent by its third layer on these
    streams (every logit exactly 0, which would make the logit checks
    vacuous); doubling the BN scales and the fc0 weights keeps spikes
    flowing to the head."""
    bb = dep.params["backbone"]
    for k, v in bb.items():
        if k.startswith("bn"):
            v["scale"].mul_(gain)
    bb["fc0"]["w"].mul_(gain)
    return dep


def check_logits(got, want, what: str) -> float:
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if not np.abs(want).max() > 0.05:
        fail(f"{what}: the head never spiked (max |logit| "
             f"{np.abs(want).max()}), the comparison would be vacuous")
    diff = float(np.abs(got - want).max())
    if not diff <= LOGIT_ATOL:
        fail(f"{what}: logits differ by {diff} > {LOGIT_ATOL}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    if (np.argmax(got, -1) != np.argmax(want, -1))[clear].any():
        fail(f"{what}: predictions differ where the top-two gap > {GAP}")
    return diff


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    t_all = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.backend import resolve_device
    resolve_device("cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is still on after resolve_device('cuda')")

    # 2. build
    secs = _build.build()
    print(f"[build] {', '.join(_build.sources())} -> {_build.BUILD_DIR} "
          f"in {secs:.1f} s")

    # 3. kernels at the serving shapes
    from repro_torch.kernels.stream_fold import ref
    from repro_torch.kernels.stream_fold import stream_fold as sf
    rows = phase_kernels(torch, sf, ref)
    print(f"[kernels] after timing: clocks.sm, power.draw, temperature = "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    # 4. the slice at full width, through each fold kernel
    from repro_torch.configs import p2m_dvs
    from repro_torch.data import sources
    from repro_torch.stream import deploy
    from repro_torch.stream.engine import StreamEngine, stream_generator

    ckpt = ROOT / "build" / "chip_smoke" / "deploy"
    dep = awake(deploy.fresh_deployment(p2m_dvs.CONFIG, seed=0,
                                        device="cuda"))
    deploy.save_deployment(ckpt, dep)
    dep = deploy.load_deployment(ckpt, device="cuda")
    print(f"[slice] {p2m_dvs.CONFIG.backbone.input_hw} input, "
          f"{p2m_dvs.CONFIG.p2m.out_channels} in-pixel filters, backbone "
          f"{p2m_dvs.CONFIG.backbone.channels} fc "
          f"{p2m_dvs.CONFIG.backbone.fc_hidden}; stream duration cut from "
          f"{p2m_dvs.DATA.duration_ms:g} to {STREAM_MS:g} ms (two coarse "
          f"frames)")
    engines = {m: StreamEngine(dep, capacity=N_LANES, fold_mode=m,
                               device="cuda") for m in ("deposit", "mac")}
    e0 = engines["deposit"]
    t0 = time.perf_counter()
    src = Prerecorded(sources.resolve_dataset("synthetic-gesture", hw=HW,
                                              duration_ms=STREAM_MS),
                      N_LANES, 0, e0.chunk_us, e0.slot_us, stream_generator)
    print(f"[slice] drew {N_LANES} synthetic-gesture streams on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    reports, launches = {}, {}
    for mode, counter in (("deposit", "fold"), ("mac", "fold_mac")):
        rep, counts = serve_counted(torch, sf, engines[mode], src, N_LANES)
        expected = len(rep.fold_s) + 1                 # + the warm-up fold
        if len(rep.results) != N_LANES:
            fail(f"{mode}: {len(rep.results)} of {N_LANES} streams finished")
        if not np.isfinite([r.logits for r in rep.results]).all():
            fail(f"{mode}: non-finite logits")
        if counts[counter] != expected or sum(counts.values()) != expected:
            fail(f"{mode}: launches {counts}, expected {expected} of "
                 f"{counter}")
        art = rep.to_artifact()
        lat, thr = art["latency_ms"], art["throughput"]
        print(f"[slice] fold={mode} on {kind}: {len(rep.results)} streams, "
              f"{rep.total_events} events, {thr['events_per_s']:.0f} "
              f"events/s, readout p50 {lat['readout_p50']:.3f} ms p99 "
              f"{lat['readout_p99']:.3f} ms, fold p50 {lat['fold_p50']:.3f} "
              f"ms p99 {lat['fold_p99']:.3f} ms, wall {rep.wall_s:.2f} s, "
              f"launches {counts}")
        reports[mode], launches[counter] = rep, counts[counter]
    diff = check_logits([r.logits for r in reports["mac"].results],
                        [r.logits for r in reports["deposit"].results],
                        "fold=mac vs fold=deposit")
    print(f"[slice] fold=mac vs deposit: max |logit diff| {diff:.3g}")

    # 5. the same seeded streams on cuda and on the CPU, at reduced()
    cfg, data = p2m_dvs.reduced()
    runs = {}
    for device in ("cuda", "cpu"):
        d = awake(deploy.fresh_deployment(cfg, seed=0, device=device))
        eng = StreamEngine(d, capacity=8, device=device)
        rsrc = Prerecorded(sources.resolve_dataset(
            "synthetic-gesture", hw=cfg.backbone.input_hw[0],
            duration_ms=data.duration_ms), N_LANES, 1, eng.chunk_us,
            eng.slot_us, stream_generator)
        runs[device] = eng.serve(rsrc.replay(), N_LANES, seed=1)
    by_id = {dv: sorted(r.results, key=lambda x: x.stream_id)
             for dv, r in runs.items()}
    diff = check_logits([r.logits for r in by_id["cuda"]],
                        [r.logits for r in by_id["cpu"]], "cuda vs cpu")
    print(f"[parity] reduced(): {N_LANES} streams on 8 lanes, cuda vs cpu "
          f"max |logit diff| {diff:.3g}, predictions "
          f"{[r.prediction for r in by_id['cuda']]}")

    names = {"fold": ("stream_fold", "src/repro/kernels/stream_fold/"
                                     "stream_fold.py:81"),
             "fold_mac": ("stream_fold_mac", "src/repro/kernels/stream_fold/"
                                             "stream_fold.py:115")}
    kernels = []
    for counter, (name, replaces) in names.items():
        row = rows[(counter, 1)]             # serving runs S = 1 per chunk
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/stream_fold.cu",
            "replaces": replaces, "launches": launches[counter],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
