#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no ``ok`` line):

  1. device   — the card's name and power limit; TF32 off for conv/matmul;
  2. build    — every kernel under src/repro_torch/csrc, one nvcc each, all
                at once;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                with its time, its plain version's, the least time the card
                needs (bound) and one PyTorch library call's where one
                computes the same function: the streaming-fold kernels at
                the serving shapes (N = 16·128·128, F = 16, K = 18;
                S ∈ {1, 4}; the deposit fold's vector route, and its scalar
                route on the same values with the deposits copied off the
                16-byte grid; the MAC fold on the event frames [16, S, 128,
                128, 2], its TMA route and, with x0 off the 16-byte grid,
                its cp.async route, and one fold_chunk(mode="mac") call's
                device time); the P²M conv kernel's quotient against
                __fdiv_rn over every float32 of magnitude ≤ 1, and both its
                routes (tensor cores, and FMA on events off the 16-byte
                grid) on the physics batch (4
                synthetic-gesture samples × 4000 ms at 128×128, drawn on the
                host first) for the three paper circuits and for one; the
                LIF kernel in float32 and bfloat16, soft and hard reset, at
                the backbone's largest LIF call (T 4, N 524,288, wide
                lanes; also off the 16-byte grid, narrow lanes), at T 64,
                N 16,384 and at N odd (narrow lanes), timed beside a device
                copy of the same bytes; the
                flash-attention kernel through gqa_attention at the
                internlm2-1.8b prefill (q/k/v [1, 2048, 16, 128], causal;
                bfloat16 held per element, see ``fa_limit``), without the
                mask, at d 64 and 32, at zamba2-7b's shared block (q [1,
                2048, 32, 112]) and the gemma-7b prefill (q [1, 2048, 16,
                256]) (bf16 runs both its kernels, see ``FA_CASES``), and
                the SSD kernel at the mamba2-780m prefill (x [1, 2048, 48,
                64], n 128, g 1, chunk 128) and the zamba2-7b prefill (x
                [1, 2048, 112, 64], n 64), each with one call's device time
                split over its three passes, each in float32 and bfloat16
                and on padded shapes (K5: Sq 100, G 2, with B 1 and B 2, d
                256, 128, 112, 32 and 16; K6: s 200 with b 1 g 1 and b 2
                g 2);
  4. slice    — the paper's full-width configuration (configs/p2m_dvs.CONFIG)
                as a fresh seeded deployment (backbone gain doubled so its
                head spikes, see ``awake``), saved and reloaded through the
                checkpoint store, serving 16 synthetic-gesture streams on 16
                lanes through each fold kernel in turn, with the launch
                counters set to 0 before and read after each serve;
  5. parity   — the reduced() configuration served on cuda and on the CPU
                from the same seeded streams;
  5b. registry — circuits a and b beside the [slice] deployment (c) in one
                registry, the 16 streams round-robin on 16 lanes through
                K2 and through K3 (one launch per served entry per chunk,
                counted), each stream bit-identical to the single-variant
                serve of its entry; a hot-swap (b retired, b2 registered
                mid-serve) and EntryTableFull rejections at max_entries=2,
                the artifacts through tools/check_stream_stats.py
                (``phase_registry``);
  5c. adapt   — the [slice] deployment under benchmarks/stream_adapt.py's
                leak drift, 16 adapting lanes (surrogate, lr_w 1.0) beside
                the frozen engine: ms a window, peak memory, updates on
                every lane; the most-updated lane harvested into a delta
                checkpoint, applied, registered beside its base and served
                through K3 and K2 (``phase_adapt``);
  5d. registry and adapt parity — both at reduced() on cuda and on the CPU
                from the same streams (``phase_registry_parity``,
                ``phase_adapt_parity``);
  5e. shard   — the lane and variant axes over several shards, all placed
                on the one card (``phase_shard``): the [slice] serves over
                2 shards through K2 and K3 bit-identical to phase 4's, with
                2 x (chunks + warm-up) launches on the fast routes; registry
                and adaptive serving over 2 shards; reduced() with one lane
                a shard; the sweep at reduced() over 3 shards (records
                equal); both launchers refusing more --devices than cards;
  6. physics  — the full-width model evaluated on the physics batch with
                ``make_eval_fn`` in kernel mode (the P²M conv kernel) and in
                scan mode for each paper circuit, one kernel-mode eval under
                torch.profiler (device time by kernel, busy share),
                ``p2m_apply_stacked`` in kernel mode against one scan per
                circuit, and the LIF op on the backbone's first LIF input,
                counters set to 0 before and read after;
  6b. train   — the training step at full width on the physics batch:
                fresh seeded weights, adamw(1e-3), 3 unfrozen steps then 3
                under freeze_p2m (host-clock step ms, peak device memory,
                one step under torch.profiler), no kernel launched, layer 1
                bit-identical over the frozen steps; the trained params
                evaluated in kernel and scan mode, logits equal;
  6c. sweep   — the co-design sweep at full width (``phase_sweep``:
                fast grid, both protocols, steps cut, widths not), no
                kernel launched, its p2m-codesign-sweep/v3 artifact
                checked, per cell the step time and its host sampling
                share, eval seconds, peak memory, one profiled step;
      deploy  — the frozen 10 ms record deployed, reloaded against the
                artifact and served to the recorded streams through K3
                and K2 (counters zeroed before and read after each), the
                serving artifact through tools/check_stream_stats.py;
  6d. files   — file-backed data at full width (``phase_files``): a
                DVS128 fixture the port writes (5 recordings x 4 trials,
                AEDAT 3.1 + labels CSVs, under build/, removed after),
                ``sample_batch`` cold and warm through the frame cache
                (equal, counts equal to the AEDAT windows), the fast-grid
                sweep on its train split with its val split as eval, the
                frozen 10 ms record's val batch in kernel (K1) and scan
                mode, 16 recordings served through K3 and K2 (counters
                zeroed before and read after each), stream 0 held to the
                offline forward;
  7. physics parity — the reduced() model evaluated in kernel mode on
                cuda and on the CPU from the same seeded batch; then 3
                train steps at reduced() on cuda and on the CPU (loss,
                gnorm and params within TRAIN_RTOL); then the sweep at
                reduced() on both (``phase_sweep_parity``);
  8. lm       — LM request serving at full published width, each of
                ``LM_ARCHS`` (serving numerics, bf16, seeded weights):
                internlm2-1.8b, phi4-mini-3.8b (padded heads), gemma-7b
                (GeGLU, head dim 256), qwen3-32b (qk-norm, 64 layers),
                granite-moe-1b-a400m and grok-1-314b (MoE; grok cut to 4
                of 64 layers, ``LM_DEPTH``) through the flash-attention
                kernel, mamba2-780m through the SSD kernel, zamba2-7b
                (hybrid) through both: SlotServer with batch 4, 8 requests
                of 2048 prompt tokens and 32 generated, counters set to 0
                before and read after, one prefill and one decode step
                under torch.profiler, peak device memory; then, in float32
                compute, prefill S tokens and decode token S against the
                last logits of a prefill of S + 1;
  9. lm parity — every architecture's smoke variant served on cuda and on
                the CPU from the same weights and prompts (float32
                compute): the same generated tokens;
 10. lm train — LM training at full published width through
                ``train.loop.run`` (``phase_lm_train``): mamba2-780m (4
                steps, batch 8 x 2048, K6 through ssd_trainable, 2 launches
                a layer a step under remat="full") and internlm2-1.8b (3
                steps, batch 4 x 2048, no kernel; donated update, peak
                under LM_TRAIN_PEAK_GB), fresh seeded params on the card,
                counters set to 0 before and read after each run: step ms,
                tokens/s, peak memory, loss and gnorm per step; then both
                smoke variants for 3 steps on cuda against the CPU, float32
                and bf16 compute; ssd_trainable against ssd_chunked at a
                full-width layer's scan; a restart from an async checkpoint
                on the card; launch/train.py's exit codes.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only registry,adapt`` runs phases 1, 2, 4 and
the named ones of 5b-5e (``--only shard`` the shards), and prints no
``ok`` line; ``--only files``
runs phases 1, 2 and 6d (with registry or adapt also named, 6d comes
before phase 4); ``--only lm_train`` runs phases 1, 2 and 10 (first, when
others are named too); ``--only lm`` runs phases 1, 2, 8 and 9 (before
any other named).

``python3 chip_smoke.py --measure-tree ROOT`` runs none of this: it times
K1, the MAC-mode fold_chunk and K4 as the checkout at ROOT has them (see
``measure_tree``), to compare two commits in one call.
``python3 chip_smoke.py --ptxas`` runs none of it either: it prints each
kernel's registers and spills as ``nvcc -Xptxas -v`` reports them (see
``ptxas_report``).
"""
from __future__ import annotations

import contextlib
import json
import math
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
PHYS_B = 4                # physics batch: samples at the full DATA duration
SPIN_CYCLES = 200_000     # ~100 us at the H100's 1980 MHz SM clock
V_RTOL, V_ATOL, BAND = 1e-5, 1e-6, 1e-5    # K1 v_pre; spikes off the band
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_TC_FLOPS = 989e12
# K5 float32 max |diff| against its float32 plain version (bfloat16 is
# held per element, see fa_limit); K6 relative error
FA_ATOL = 2e-3
SSD_RTOL = 1e-3
# the served LM architectures; the first two are also trained ([lm train])
LM_TRAINED = ("internlm2-1.8b", "mamba2-780m")
LM_ARCHS = LM_TRAINED + ("phi4-mini-3.8b", "gemma-7b", "qwen3-32b",
                         "granite-moe-1b-a400m", "grok-1-314b", "zamba2-7b")
# depth cuts, widths unchanged: grok-1-314b's 64 layers are 589.5 GiB in
# bf16, more than one card (or four) holds; 4 layers are ~42 GB
LM_DEPTH = {"grok-1-314b": 4}
LM_BATCH, LM_REQUESTS, LM_PROMPT, LM_GEN = 4, 8, 2048, 32
LM_LOGIT_ATOL = 1e-3      # full-width prefill(S) + decode vs prefill(S + 1)
TRAIN_STEPS = 3           # unfrozen steps, then as many under freeze_p2m
# train steps on cuda vs the CPU: float32 convolutions summed in another
# order; loss and gnorm relative, params relative to a leaf's largest
TRAIN_RTOL = 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, reps: int = 25, flush=None, spin: bool = True
            ) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up;
    ``flush`` (not timed) runs before each, to start from a cold L2. With
    ``spin`` the card busy-waits ~100 us before the start event, so the
    host's work to launch ``fn`` (checks, allocation, ctypes: tens of us
    for a wrapper written in Python) happens while the card is busy and the
    events bracket the device's time alone."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes: float, n_flops: float, peak: float = FP32_FLOPS
             ) -> tuple[float, str]:
    """The least time for the work: bytes over the HBM rate or operations
    over ``peak`` (fp32 non-tensor unless the work is tensor-core work),
    whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def misaligned(torch, t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_kernels(torch, sf, ref, flush, write_flush) -> dict:
    """Both fold kernels against their plain versions at the serving
    shapes."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    N = N_LANES * HW * HW
    rows = {}
    for S in (1, 4):
        x0 = (torch.randn((N, F), generator=gen) * 0.05).to(dev)
        dep = (torch.randn((S, N, F), generator=gen) * 0.01).to(dev)
        a = torch.exp(-torch.rand(F, generator=gen) * 0.01).to(dev)
        # the same deposits off the 16-byte grid take the scalar route
        dep_off = misaligned(torch, dep)
        for r, d in (("vector", dep), ("scalar", dep_off)):
            if sf.fold_route(x0, d, a) != r:
                fail(f"stream_fold S={S} at the serving shape does not take "
                     f"the {r} route")
        want = ref.stream_fold_ref(x0, dep, a)
        for r, d in (("vector", dep), ("scalar", dep_off)):
            got = sf.stream_fold_cuda(x0, d, a)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                fail(f"stream_fold S={S} {r} route is not bit-exact (max "
                     f"|diff| {err})")
        b, by = bound_ms((S + 2) * N * F * 4 + F * 4, 2 * S * N * F)
        row = {"name": "stream_fold", "S": S, "max_abs_err": err,
               "ms": time_ms(lambda: sf.stream_fold_cuda(x0, dep, a), torch,
                             flush=flush),
               "scalar_ms": time_ms(lambda: sf.stream_fold_cuda(
                   x0, dep_off, a), torch, flush=flush),
               "plain_ms": time_ms(lambda: ref.stream_fold_ref(x0, dep, a),
                                   torch, flush=flush),
               "bound_ms": b, "bound_by": by,
               "library_ms": (time_ms(lambda: torch.addcmul(dep[0], x0, a),
                                      torch, flush=flush)
                              if S == 1 else None)}
        rows[("fold", S)] = row

        # K3 on the chunk's event frames [B, S, H, W, Cin], as fold_chunk
        # hands them over (counts plus a non-integer part: the dot
        # products are inexact, so the 1e-5 limit is what holds)
        frames = torch.poisson(torch.full((N_LANES, S, HW, HW, 2), 0.3),
                               generator=gen).to(dev)
        frames += torch.rand(frames.shape, generator=gen).to(dev) * 0.01
        w = (torch.round(torch.rand((K, F), generator=gen) * 16 - 8) / 8
             ).to(dev)
        mac = dict(stride=1, dv_unit=0.01)
        # x0 off the 16-byte grid takes the cp.async route
        x0_off = misaligned(torch, x0)
        for x, r in ((x0, "tma"), (x0_off, "cp")):
            if sf.mac_route(x, frames, w) != r:
                fail(f"stream_fold_mac S={S} at the serving shape does not "
                     f"take the {r} route")
        want = ref.stream_fold_mac_frames_ref(x0, frames, w, a, **mac)
        for x, r in ((x0_off, "cp"), (x0, "tma")):
            got = sf.stream_fold_mac_cuda(x, frames, w, a, **mac)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= 1e-5:
                fail(f"stream_fold_mac S={S} {r} route: max |diff| {err} > "
                     f"1e-5")
        # the frames are read once: (B S H W Cin + 2 N F) floats, w and a
        b, by = bound_ms((frames.numel() + 2 * N * F) * 4 + K * F * 4 + F * 4,
                         S * N * F * (2 * K + 3))
        row = {"name": "stream_fold_mac", "S": S, "max_abs_err": err,
               "ms": time_ms(lambda: sf.stream_fold_mac_cuda(
                   x0, frames, w, a, **mac), torch, flush=flush),
               "cp_ms": time_ms(lambda: sf.stream_fold_mac_cuda(
                   x0_off, frames, w, a, **mac), torch, flush=flush),
               "plain_ms": time_ms(lambda: ref.stream_fold_mac_frames_ref(
                   x0, frames, w, a, **mac), torch, flush=flush),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        rows[("fold_mac", S)] = row
        fc = fold_chunk_device_ms(torch, S)
        print(f"[kernels] fold_chunk(mode=\"mac\") S={S} at the serving shape,"
              f" one call's device time (torch.profiler, 5 calls): "
              + (", ".join(f"{k} {v:.4f}" for k, v in fc)
                 + f"; sum {sum(v for _, v in fc):.4f} ms" if fc
                 else "not measured (no device rows in the trace)"))
    for row in rows.values():
        print_row(row, f"S={row['S']} N={N} F={F}"
                  f"{' K=%d' % K if row['name'].endswith('mac') else ''}")
        if "cp_ms" in row:
            print(f"[kernels] stream_fold_mac  S={row['S']}: TMA route "
                  f"{row['ms']:.4f} ms, cp.async route {row['cp_ms']:.4f} ms "
                  f"on the same values (x0 off the 16-byte grid), both "
                  f"within 1e-5")
        if "scalar_ms" in row:
            print(f"[kernels] stream_fold      S={row['S']}: vector route "
                  f"{row['ms']:.4f} ms, scalar route {row['scalar_ms']:.4f} "
                  f"ms on the same values (deposits off the 16-byte grid), "
                  f"both bit-exact")
    # the timing method itself: the same launch after a write flush, and
    # without the spin (host launch work inside the timed window)
    dep1 = dep[:1].contiguous()
    fold = lambda: sf.stream_fold_cuda(x0, dep1, a)  # noqa: E731
    print(f"[kernels] stream_fold      S=1 method check: "
          f"{time_ms(fold, torch, flush=flush):.4f} ms as timed, "
          f"{time_ms(fold, torch, flush=write_flush):.4f} ms after a 128 MB "
          f"write flush, {time_ms(fold, torch, flush=flush, spin=False):.4f} "
          f"ms without the spin")
    return rows


def print_row(row: dict, shape: str) -> None:
    lib = ("-" if row["library_ms"] is None
           else f"{row['library_ms']:.4f} ms")
    print(f"[kernels] {row['name']:16s} {shape}: kernel {row['ms']:.4f} ms  "
          f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms'] * 1e3:.2f} "
          f"us ({row['bound_by']})  library {lib}  max|diff| "
          f"{row['max_abs_err']:.3g}")


def l2_flushers(torch):
    """Two callables that each move 128 MB (more than the 50 MB L2): a
    read, which leaves the L2 full of clean lines (the flush every kernel
    is timed after), and a write, which leaves it full of dirty lines that
    the next kernel must write back first (kept to show that cost). Runs
    ~1 s of such traffic first, so the first kernel timed does not run
    while the card's clocks are still ramping up from idle."""
    scratch = torch.zeros(32 * 2 ** 20, device="cuda")
    sink = torch.empty((), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(50):
            scratch.zero_()
        torch.cuda.synchronize()
    return (lambda: torch.sum(scratch, 0, out=sink)), scratch.zero_


def check_p2m_conv(torch, got, want, theta, what: str) -> float:
    """K1's tolerance: v_pre rtol 1e-5 / atol 1e-6, spikes equal wherever
    |v_pre - theta| > 1e-5. Returns max |v_pre diff| (0 when bit-exact)."""
    (s, v), (s_ref, v_ref) = got, want
    if torch.equal(v, v_ref) and torch.equal(s, s_ref):
        return 0.0
    diff = (v - v_ref).abs_()
    err = diff.max().item()
    if (diff > V_ATOL + V_RTOL * v_ref.abs()).any():
        fail(f"{what}: v_pre differs by up to {err}")
    del diff
    th = theta.reshape((theta.shape[0],) + (1,) * (v_ref.dim() - 2)
                       + (theta.shape[1],))
    if ((s != s_ref) & ((v_ref - th).abs() > BAND)).any():
        fail(f"{what}: spikes differ off the threshold band")
    return err


def phase_p2m_conv(torch, ops, pc, events, params, p2m_cfg, circuits,
                   flush) -> dict:
    """K1 on the physics batch, for the three paper circuits in one launch
    and for the config's own circuit alone (the eval's shape)."""
    B, T, n_sub, H, W, Cin = events.shape
    half_swing = p2m_cfg.analog.vdd / 2.0
    t0 = time.perf_counter()
    bad = pc.quotient_check(half_swing)
    print(f"[kernels] p2m_conv         quotient v / {half_swing:g} (Markstein's "
          f"step, __fdiv_rn below |v| = 2^-100) against __fdiv_rn over "
          f"every float32 with |v| <= 1 (2,130,706,434 values): {bad} "
          f"mismatches, {time.perf_counter() - t0:.2f} s")
    if bad:
        fail(f"p2m_conv's quotient differs from __fdiv_rn for {bad} values")
    rows = {}
    # the same events off the 16-byte grid take the FMA route
    events_off = misaligned(torch, events)
    for lcs in (tuple(circuits), (p2m_cfg.leak,)):
        w2, v_inf, decay, theta, consts = ops._prepare(params, p2m_cfg, lcs)
        args = (events, w2, v_inf, decay, theta, params["pv_gain"],
                params["pv_offset"])
        args_off = (events_off,) + args[1:]
        n_cfg, (K, F) = len(lcs), w2.shape
        for a, r in ((args, "mma"), (args_off, "fma")):
            if pc.conv_route(a[0], w2, p2m_cfg.kernel_size) != r:
                fail(f"p2m_conv n_cfg={n_cfg} on the physics batch does not "
                     f"take the {r} route")
        want = ops.p2m_conv_events_ref(*args, **consts)
        for a, r in ((args, "mma"), (args_off, "fma")):
            err = check_p2m_conv(torch, pc.p2m_conv_cuda(*a, **consts), want,
                                 theta, f"p2m_conv n_cfg={n_cfg} {r} route")
            if err:
                fail(f"p2m_conv n_cfg={n_cfg} {r} route is not bit-exact on "
                     f"event counts (max |v_pre diff| {err})")
            torch.cuda.empty_cache()
        del want
        torch.cuda.empty_cache()
        ho, wo = -(-H // p2m_cfg.stride), -(-W // p2m_cfg.stride)
        sites = B * T * ho * wo * F
        n_bytes = 4 * (events.numel() + w2.numel() + 3 * v_inf.numel()
                       + 2 * F + 2 * n_cfg * sites)
        # per (site, filter, sub-slot): the K-term dot product and its
        # scale once, ~13 ops of update per config; per window the offset
        # and the comparator per config
        n_flops = sites * (n_sub * (2 * K + 1 + 13 * n_cfg) + 2 * n_cfg)
        b, by = bound_ms(n_bytes, n_flops)
        rows[n_cfg] = {
            "name": "p2m_conv", "n_cfg": n_cfg, "max_abs_err": 0.0,
            "ms": time_ms(lambda: pc.p2m_conv_cuda(*args, **consts), torch,
                          flush=flush),
            "fma_ms": time_ms(lambda: pc.p2m_conv_cuda(*args_off, **consts),
                              torch, flush=flush),
            "plain_ms": time_ms(lambda: ops.p2m_conv_events_ref(
                *args, **consts), torch, flush=flush),
            "bound_ms": b, "bound_by": by, "library_ms": None}
        torch.cuda.empty_cache()
        print_row(rows[n_cfg], f"n_cfg={n_cfg} B={B} T={T} n_sub={n_sub} "
                               f"{H}x{W}x{Cin} F={F}")
        print(f"[kernels] p2m_conv         n_cfg={n_cfg}: tensor-core route "
              f"{rows[n_cfg]['ms']:.4f} ms, FMA route {rows[n_cfg]['fma_ms']:.4f}"
              f" ms on the same values (events off the 16-byte grid), both "
              f"bit-exact")
    del events_off
    torch.cuda.empty_cache()
    return rows


# K4's cases: (T, N); each in float32 and bfloat16, soft and hard reset.
# The backbone's largest LIF call takes the wide lanes (16 bytes a
# thread), T 64 N 16,384 the narrow ones (4 bytes: few columns), N odd
# the narrow or one-element lanes; the first two are timed
LIF_CASES = ((4, 524288), (64, 16384), (4, 524287))


def phase_lif(torch, lif, lif_ref, flush) -> dict:
    """K4 bit-exact against its plain version on each of ``LIF_CASES`` in
    both types and both resets, and, at the backbone's shape, on a copy
    off the 16-byte grid (narrow lanes); each case's route asserted. The
    aligned cases are timed (soft reset) beside the plain version and a
    device copy of the same bytes (``x.clone()``, a floor for any kernel
    that reads x and writes as much), with both bounds printed."""
    gen = torch.Generator().manual_seed(2)
    rows = {}
    for T, N in LIF_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = (torch.randn((T, N), generator=gen) * 1.5).to("cuda", dtype)
            want_route = "lif" if (T, N) == (4, 524288) else "lif_narrow"
            cases = [(x, want_route)]
            if (T, N) == (4, 524288):
                cases.append((misaligned(torch, x), "lif_narrow"))
            for xi, route in cases:
                if lif.lif_route(xi) != route:
                    fail(f"lif T={T} N={N} {name} (offset "
                         f"{xi.data_ptr() % 16}) takes {lif.lif_route(xi)},"
                         f" not {route}")
                for soft in (True, False):
                    got = lif.lif_cuda(xi, soft_reset=soft)
                    want = lif_ref(xi, soft_reset=soft)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"lif T={T} N={N} {name} {route} soft_reset="
                             f"{soft} is not bit-exact")
            if N % 4:
                print(f"[kernels] lif              T={T} N={N} {name}: "
                      f"{want_route} bit-exact, soft and hard reset")
                continue
            b, by = bound_ms(2 * T * N * x.element_size(), 7 * T * N)
            row = {"name": "lif", "route": want_route, "max_abs_err": 0.0,
                   "ms": time_ms(lambda: lif.lif_cuda(x), torch, flush=flush),
                   "plain_ms": time_ms(lambda: lif_ref(x), torch,
                                       flush=flush),
                   "copy_ms": time_ms(lambda: x.clone(), torch, flush=flush),
                   "bound_ms": b, "bound_by": by, "library_ms": None}
            if len(cases) > 1:
                xo = cases[1][0]
                row["narrow_ms"] = time_ms(lambda: lif.lif_cuda(xo), torch,
                                           flush=flush)
            rows[(T, N, dtype)] = row
            print_row(row, f"T={T} N={N} {name}")
            print(f"[kernels] lif              T={T} N={N} {name}: route "
                  f"{want_route}, bound {b * 1e3:.2f} us ({by}: "
                  f"{2 * T * N * x.element_size() / 1e6:.2f} MB at 3.35 "
                  f"TB/s), device copy of the same bytes {row['copy_ms']:.4f}"
                  f" ms"
                  + (f", narrow route on the copy off the 16-byte grid "
                     f"{row['narrow_ms']:.4f} ms" if "narrow_ms" in row
                     else "") + "; bit-exact, soft and hard reset")
    return rows


def fa_limit(want, abs_attn, dtype, torch):
    """K5's per-element limit against the float32 plain version ``want``.
    float32: FA_ATOL. bfloat16: the kernel rounds each p to bfloat16 before
    PV, a relative error of at most u = 2^-8 each, so at most u times the
    attention of |v| (``abs_attn``) per element, and rounds the output, at
    most u |o|; the limit is their sum, with 2^-6 of the first and 1e-5 to
    spare for float32 summation order."""
    if dtype == torch.float32:
        return torch.full_like(want, FA_ATOL)
    u = 2.0 ** -8
    return u * want.abs() + u * (1 + 2.0 ** -6) * abs_attn + 1e-5


# K5's cases: (B, S, H, KV, d, causal, timed row or None). bf16 runs the
# wgmma kernel at d 64 and 128 and the mma.sync kernel at d 16, 32, 112
# and 256; the padded cases put Sq off the 128-row tile, and with B 2 a
# row read or stored past Sq would land in the next batch
FA_CASES = (
    (1, LM_PROMPT, 16, 16, 128, True, ""),          # the internlm2 prefill
    (1, LM_PROMPT, 16, 16, 128, False, "_noncausal"),
    (1, LM_PROMPT, 16, 16, 64, True, "_d64"),
    (1, LM_PROMPT, 16, 16, 32, True, "_d32"),
    (1, LM_PROMPT, 32, 32, 112, True, "_d112"),     # zamba2's shared block
    (1, LM_PROMPT, 16, 16, 256, True, "_d256"),     # the gemma-7b prefill
    (1, 100, 16, 8, 112, True, None),
    (1, 100, 16, 8, 256, True, None),
    (1, 100, 16, 8, 128, True, None),
    (2, 100, 16, 8, 128, True, None),
    (2, 100, 16, 8, 32, True, None),
    (2, 100, 16, 8, 16, False, None),
)


def phase_flash_attention(torch, ops, fa_ref, flush) -> dict:
    """K5 through ``ops.gqa_attention`` on each of ``FA_CASES`` in float32
    and bfloat16: the internlm2-1.8b prefill (q/k/v [1, 2048, 16, 128] as
    project_qkv lays them out: one 2048-token prompt, its 16 physical
    heads, G = 1, causal), the same shape without the mask and at d 64 and
    32, zamba2-7b's shared block (q [1, 2048, 32, 112]) and the gemma-7b
    prefill (q [1, 2048, 16, 256]), and padded shapes (Sq 100, G 2, B 1
    and 2; d 112 and 256 too). Each is held per
    element against attention_ref on the same values reshaped to
    [B H, S, d] (K/V repeated to every query head); the 2048-token ones
    are timed beside the op's plain version and
    scaled_dot_product_attention. Rows are keyed by type and case, the
    serving shape's by type alone."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(3)
    rows = {}
    for B, S, H, KV, d, causal, tag in FA_CASES:
        G = H // KV
        mask = "causal" if causal else "non-causal"
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q = torch.randn((B, S, H, d), generator=gen).to("cuda", dtype)
            k, v = (torch.randn((B, S, KV, d), generator=gen).to("cuda", dtype)
                    for _ in range(2))
            got = ops.gqa_attention(q, k, v, causal=causal)
            bh = [t.float().repeat_interleave(H // t.shape[2], dim=2)
                  .transpose(1, 2).reshape(B * H, S, d) for t in (q, k, v)]
            want = fa_ref.attention_ref(*bh, causal=causal)
            abs_attn = fa_ref.attention_ref(bh[0], bh[1], bh[2].abs(),
                                            causal=causal)
            got = got.float().transpose(1, 2).reshape(B * H, S, d)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            share = (diff / fa_limit(want, abs_attn, dtype, torch)).max().item()
            err = diff.max().item()
            if not share <= 1.0:
                fail(f"flash_attention q [{B}, {S}, {H}, {d}] G {G} {mask} "
                     f"{name}: max |diff| {err}, {share:.3g} times the limit")
            del got, want, abs_attn, bh, diff
            print(f"[kernels] flash_attention  q [{B}, {S}, {H}, {d}] G {G} "
                  f"{mask} {name}: max|diff| {err:.3g}, at most "
                  f"{share:.3g} of the per-element limit")
            if tag is None:
                continue
            # QK^T and PV: 4 d flops for each (q, k) pair the mask keeps;
            # the bf16 work belongs on the tensor cores, float32 on the
            # CUDA cores
            pairs = S * (S + 1) // 2 if causal else S * S
            b, by = bound_ms(2 * (H + KV) * B * S * d * q.element_size(),
                             4 * B * H * d * pairs,
                             BF16_TC_FLOPS if dtype == torch.bfloat16
                             else FP32_FLOPS)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row = {"name": "flash_attention", "max_abs_err": err,
                   "limit_share": share,
                   "ms": time_ms(lambda: ops.gqa_attention(q, k, v,
                                                           causal=causal),
                                 torch, flush=flush),
                   "plain_ms": time_ms(lambda: fa_ref.gqa_attention_ref(
                       q, k, v, causal=causal), torch, flush=flush),
                   "bound_ms": b, "bound_by": by,
                   "library_ms": time_ms(
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=causal),
                       torch, flush=flush)}
            rows[name + tag] = row
            print_row(row, f"q [{B}, {S}, {H}, {d}] {mask} {name}")
            del q, k, v, qt, kt, vt
    return rows


def ssd_work(b, s, h, p, g, n, esize, chunk=128) -> tuple[int, int]:
    """(bytes, flops) of one chunked SSD scan: x and y, B and C, dt, A and
    the final state moved once; per chunk of Lc steps the lower triangle of
    C B^T (n terms) and of W x (p terms), C state^T and the state update
    (n p terms each per step)."""
    n_bytes = (2 * b * s * h * p + 2 * b * s * g * n) * esize \
        + 4 * (b * s * h + h + b * h * p * n)
    fmas = 0
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        fmas += lc * (lc + 1) // 2 * (n + p) + 2 * lc * n * p
    return n_bytes, 2 * fmas * b * h


# K6's cases: (b, s, h, p, g, n, timed row or None); the mamba2-780m
# prefill and zamba2-7b's (112 heads, state 64) are timed, the others put
# s off the 128-step chunk, with b 2 and g 2 in the last (a row past s, or
# a head's group, read wrong lands in another batch or group)
SSD_CASES = (
    (1, LM_PROMPT, 48, 64, 1, 128, ""),
    (1, LM_PROMPT, 112, 64, 1, 64, "_zamba2"),
    (1, 200, 48, 64, 1, 128, None),
    (2, 200, 48, 64, 2, 128, None),
)


def device_split(torch, fn, kernels: int, calls: int = 5, tries: int = 3
                 ) -> list[tuple[str, float]]:
    """(kernel name, device ms per launch) of each of the ``kernels``
    kernels that ``fn`` launches, from torch.profiler's device rows over
    ``calls`` calls (each kernel's total over its own count). A trace of
    such short calls sometimes holds no device rows, or not all of them,
    so it is taken again, up to ``tries`` times; what the last one held is
    returned."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = []
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                m = re.search(r"::(\w+)", e.key)
                out.append((m.group(1) if m else e.key[:40],
                            e.self_device_time_total / e.count / 1e3))
        if len(out) >= kernels:
            break
    return out


def fold_chunk_device_ms(torch, S: int) -> list[tuple[str, float]]:
    """(kernel name, device ms) of each kernel one ``fold_chunk(mode="mac")``
    call runs at the serving shape (16 lanes, 128x128, Cin 2, F 16, S
    sub-slots), from torch.profiler over 5 calls: the MAC kernel and
    whatever the tree's fold_chunk runs before it."""
    from repro_torch.kernels.stream_fold import ops
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn((N_LANES, HW, HW, F), generator=gen) * 0.05).cuda()
    frames = torch.poisson(torch.full((N_LANES, S, HW, HW, 2), 0.3),
                           generator=gen).cuda()
    w_q = (torch.round(torch.rand((3, 3, 2, F), generator=gen) * 16 - 8) / 8
           ).cuda()
    a = torch.exp(-torch.rand(F, generator=gen) * 0.01).cuda()
    return device_split(torch, lambda: ops.fold_chunk(
        x, frames, w_q, a, stride=1, dv_unit=0.01, mode="mac"), 1)


def phase_ssd(torch, sd, ssd_ref, flush) -> dict:
    """K6 against its plain version on each of ``SSD_CASES`` (the
    mamba2-780m prefill, x [1, 2048, 48, 64], n 128, g 1, chunk 128, the
    zamba2-7b prefill, x [1, 2048, 112, 64], n 64, and padded shapes, s
    200, with b 1 g 1 and b 2 g 2), in float32 and
    bfloat16: y and state within relative error 1e-3 of the largest
    magnitude (a bfloat16 y also within one bfloat16 step of its own value,
    the rounding of the output). The prefill shapes are timed, and one
    call's device time is split over its three passes (torch.profiler).
    Rows are keyed by type and case, mamba2's by type alone."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(4)
    rows = {}
    for b, s, h, p, g, n, tag in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn((b, s, h, p), generator=gen).to("cuda", dtype)
            dt = F.softplus(torch.randn((b, s, h), generator=gen)).to("cuda")
            A = -torch.exp(torch.randn(h, generator=gen) * 0.3).to("cuda")
            B, C = (torch.randn((b, s, g, n), generator=gen).to("cuda", dtype)
                    for _ in range(2))
            args = (x, dt, A, B, C)
            y, st = sd.ssd_cuda(*args, chunk=128)
            y_r, st_r = ssd_ref(*args)
            torch.cuda.synchronize()
            dy = (y.float() - y_r.float()).abs()
            ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
            y_top = y_r.float().abs().max().item()
            st_err = (st - st_r).abs().max().item() / st_r.abs().max().item()
            if ((dy > SSD_RTOL * y_top + ulp * y_r.float().abs()).any()
                    or not st_err <= SSD_RTOL):
                fail(f"ssd [{b}, {s}, {h}, {p}] g {g} n {n} {name}: y max "
                     f"|diff| {dy.max().item()} (max |y| {y_top}), state "
                     f"relative error {st_err}")
            err = dy.max().item()
            share = (dy / (SSD_RTOL * y_top + ulp * y_r.float().abs())
                     ).max().item()
            if tag is None:
                print(f"[kernels] ssd              [{b}, {s}, {h}, {p}] g {g} "
                      f"n {n} {name}: y max|diff| {err:.3g}, at most "
                      f"{share:.3g} of the per-element limit, state rel err "
                      f"{st_err:.3g} (pad case)")
                continue
            # the bf16 products belong on the tensor cores, float32 on the
            # CUDA cores
            bb, by = bound_ms(*ssd_work(b, s, h, p, g, n, x.element_size()),
                              BF16_TC_FLOPS if dtype == torch.bfloat16
                              else FP32_FLOPS)
            row = {"name": "ssd", "max_abs_err": err,
                   "ms": time_ms(lambda: sd.ssd_cuda(*args, chunk=128), torch,
                                 flush=flush),
                   "plain_ms": time_ms(lambda: ssd_ref(*args), torch, reps=5,
                                       flush=flush),
                   "bound_ms": bb, "bound_by": by, "library_ms": None}
            rows[name + tag] = row
            print_row(row, f"[{b}, {s}, {h}, {p}] n={n} {name}")
            print(f"[kernels] ssd              state rel err {st_err:.3g}, y "
                  f"max |y| {y_top:.3g}, at most {share:.3g} of the "
                  f"per-element limit")
            split = device_split(torch,
                                 lambda: sd.ssd_cuda(*args, chunk=128), 3)
            if len(split) < 3:
                print(f"[kernels] ssd              {name} one call by pass: "
                      f"not measured (the trace held {len(split)} of the 3 "
                      f"kernels)")
            else:
                print(f"[kernels] ssd              {name} one call by pass "
                      f"(torch.profiler, device ms a launch, 5 calls): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in split)
                      + f"; sum {sum(v for _, v in split):.4f}")
    return rows


def zero(counters) -> None:
    for c in counters:
        for k in c:
            c[k] = 0


def read(counters) -> dict:
    return {k: v for c in counters for k, v in c.items()}


def lm_config(arch: str):
    """The arch's config, at the depth ``LM_DEPTH`` cuts it to."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in LM_DEPTH:
        cfg = replace(cfg, n_layers=LM_DEPTH[arch])
    return cfg


def lm_launches(cfg) -> dict:
    """Kernel launches of one prefill: K5 once per self-attention call
    (every layer of dense and moe, the shared block after each hybrid
    group), K6 once per SSM block."""
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}[cfg.family]
    ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": attn, "ssd": ssm}


def phase_lm(torch, arch: str, counters) -> dict:
    """One architecture at full published width (grok-1-314b at the depth
    ``LM_DEPTH`` cuts it to) behind the serving entry point: seeded bf16
    weights drawn on the card, a SlotServer of 4 lanes serving 8 requests
    of 2048 prompt tokens and 32 generated tokens with every counter set
    to 0 just before and read just after; one prefill and one decode step
    under torch.profiler; then the float32-compute check that prefill(S) +
    decode(token S) gives the last logits of prefill(S + 1). Peak device
    memory is read after the serve and after the check."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SlotServer, make_requests, serve
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    cfg = lm_config(arch)
    max_len = LM_PROMPT + LM_GEN + 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = SlotServer(cfg, LM_BATCH, max_len, device="cuda")
    scfg = server.cfg
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            scfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    cut = (f" (cut from {get_config(arch).n_layers})" if arch in LM_DEPTH
           else "")
    print(f"[lm] {arch}: family {scfg.family}, {scfg.n_layers} layers{cut}, "
          f"d_model {scfg.d_model}, heads {scfg.n_heads}/{scfg.n_kv_heads} "
          f"(physical {scfg.phys_heads}/{scfg.phys_kv_heads}) of "
          f"{scfg.head_dim}, vocab {scfg.vocab_size} (physical "
          f"{scfg.phys_vocab}), {n_params / 1e9:.3f} G parameters in "
          f"{scfg.param_dtype} drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    server.load(params)
    serve(server, make_requests(1, 64, 2, scfg.vocab_size, seed=2))  # warm-up
    server.timings = {"prefill": [], "decode": []}
    reqs = make_requests(LM_REQUESTS, LM_PROMPT, LM_GEN, scfg.vocab_size,
                         seed=1)
    zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps = serve(server, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    peak_serve = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(r.generated) for r in done)
    toks = [t for r in done for t in r.generated]
    if len(done) != LM_REQUESTS or n_tok != LM_REQUESTS * LM_GEN:
        fail(f"{arch}: {len(done)} requests, {n_tok} tokens")
    if not all(0 <= t < scfg.vocab_size for t in toks):
        fail(f"{arch}: a generated token lies outside the vocabulary")
    want = {k: 0 for k in launches}
    for name, n in lm_launches(scfg).items():
        want[name] = n * LM_REQUESTS
    if launches != want:
        fail(f"{arch}: launches {launches}, expected {want}")
    pre, dec = server.timings["prefill"], sorted(server.timings["decode"])
    out = {"launches": launches, "wall_s": wall, "tok_s": n_tok / wall,
           "prefill_ms": 1e3 * sum(pre) / len(pre),
           "decode_ms": 1e3 * dec[len(dec) // 2], "steps": steps,
           "head_dim": scfg.head_dim}
    print(f"[lm] {arch} serve: {len(done)} requests, {n_tok} tokens, "
          f"{steps} decode steps, wall {wall:.2f} s = {out['tok_s']:.1f} "
          f"tok/s; prefill {out['prefill_ms']:.1f} ms per request "
          f"({LM_PROMPT} tokens, host clock), decode step {out['decode_ms']:.2f} ms "
          f"(median), launches {launches}, peak device memory "
          f"{peak_serve:.2f} GB")

    prompt = reqs[0].prompt.to("cuda")[None]
    profile_eval(torch, lm.prefill, (params, prompt, scfg, max_len), top=8,
                 tag="lm", what=f"{arch} prefill of {LM_PROMPT} tokens")
    tokens = torch.zeros((LM_BATCH, 1), dtype=torch.long, device="cuda")
    profile_eval(torch, lm.decode_step,
                 (params, tokens, server.pos, server.cache, scfg),
                 tag="lm", what=f"{arch} decode step at batch {LM_BATCH}")
    del server

    # consistency in float32 compute: the kernel path (prefill) against the
    # plain path (decode) for one more token
    cfg32 = replace(scfg, compute_dtype="float32")
    S = LM_PROMPT
    tok = torch.cat([reqs[0].prompt, torch.tensor(reqs[0].generated[:1])]
                    ).to("cuda")[None]
    _, cache = lm.prefill(params, tok[:, :S], cfg32, max_len=S + 8)
    dec_logits, _ = lm.decode_step(params, tok[:, S:], torch.tensor(
        S, device="cuda"), cache, cfg32)
    del cache
    longer, _ = lm.prefill(params, tok, cfg32)
    V = scfg.vocab_size
    a, b = dec_logits[0, 0, :V], longer[0, :V]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"{arch}: non-finite logits in float32 compute")
    diff = (a - b).abs().max().item()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not diff <= LM_LOGIT_ATOL:
        fail(f"{arch}: prefill({S}) + decode vs prefill({S + 1}) logits "
             f"differ by {diff} > {LM_LOGIT_ATOL}")
    out.update(consistency=diff, peak_serve_gb=peak_serve, peak_gb=peak,
               phase_s=time.perf_counter() - t_phase)
    print(f"[lm] {arch} float32 compute: prefill({S}) + decode(token {S}) vs "
          f"prefill({S + 1}): max |logit diff| {diff:.3g} (max |logit| "
          f"{b.abs().max().item():.3g}), argmax equal: "
          f"{int(a.argmax()) == int(b.argmax())}; peak device memory "
          f"{peak:.2f} GB; phase {out['phase_s']:.1f} s")
    del params, dec_logits, longer
    torch.cuda.empty_cache()
    return out


def phase_lm_all(torch, counters) -> dict:
    """Phases 8 and 9: every architecture of ``LM_ARCHS`` served at full
    width, then every smoke variant on cuda and on the CPU."""
    t0 = time.perf_counter()
    runs = {arch: phase_lm(torch, arch, counters) for arch in LM_ARCHS}
    print(f"[lm] phase {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{a} {r['phase_s']:.1f} s" for a, r in runs.items()))
    t0 = time.perf_counter()
    phase_lm_parity(torch)
    print(f"[lm parity] phase {time.perf_counter() - t0:.1f} s")
    return runs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_parity(torch) -> None:
    """Each architecture's smoke variant served on cuda and on the CPU from
    the same weights and prompts, float32 compute: the same tokens."""
    from dataclasses import replace
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import lm
    from repro_torch.serve.steps import serve_config
    for arch in LM_ARCHS:
        cfg = replace(smoke_variant(get_config(arch)), compute_dtype="float32")
        params = lm.init_params(torch.Generator().manual_seed(0),
                                serve_config(cfg), "cpu")
        gen = torch.Generator().manual_seed(5)
        prompts = [torch.randint(0, cfg.vocab_size, (20 + 37 * i,),
                                 generator=gen) for i in range(5)]
        out = {}
        for device in ("cuda", "cpu"):
            server = SlotServer(cfg, 2, 200, device=device)
            server.load(lm._tree_map(lambda t: t.to(device), params))
            reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
            serve(server, reqs)
            out[device] = [r.generated for r in reqs]
        if out["cuda"] != out["cpu"]:
            fail(f"{arch} smoke: cuda and cpu generate different tokens: "
                 f"{out['cuda']} vs {out['cpu']}")
        print(f"[lm parity] {arch} smoke variant, 5 requests (prompts 20-168 "
              f"tokens) on 2 lanes: cuda and cpu generate the same "
              f"{sum(map(len, out['cuda']))} tokens")


# LM training at full published width: (arch, batch, steps) at seq 2048;
# mamba2 takes the loop's default donate=True like internlm2
LM_TRAIN = (("mamba2-780m", 8, 4), ("internlm2-1.8b", 4, 3))
LM_TRAIN_SEQ = 2048
# a donated update keeps params, grads and both moments (4 x 8.0 GB for
# internlm2-1.8b) plus one layer's working set; two copies of the state
# alive at once would pass this
LM_TRAIN_PEAK_GB = 60.0
# card against the CPU, 3 smoke-variant steps from the same params and
# batches. float32: loss relative, and params and moments at the train
# step's tolerance (the reference's own grad-accumulation test). bf16:
# loss and gnorm relative, and the whole-tree relative L2 distance of the
# params' change over the 3 steps (the port against the reference, both
# on the CPU, measured 1.1e-4, 1.3e-4 and 0.047-0.058; a dropped update
# gives ~0.33)
LM_TRAIN_F32 = dict(loss=1e-4, rtol=2e-4, atol=2e-5)
LM_TRAIN_BF16 = dict(loss=1e-3, gnorm=1e-2, update=0.2)
# ssd_trainable against ssd_chunked on the card: both differentiate
# ssd_chunked, so the gradients are expected to be the same bits
SSD_GRAD_RTOL = 1e-6


def lm_train_run(torch, arch: str, batch: int, steps: int, counters,
                 ckpt_dir: Path) -> dict:
    """``train.loop.run`` at full published width: fresh seeded params on
    the card, the port's token stream, no checkpoint at this size; every
    counter set to 0 just before and read just after."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.loop import LoopConfig, run
    cfg = get_config(arch)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    loop = LoopConfig(total_steps=steps, log_every=1, ckpt_every=10 ** 9,
                      ckpt_dir=str(ckpt_dir))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    res = run(cfg, ShapeConfig("chip", "train", LM_TRAIN_SEQ, batch), loop,
              log=lambda line: print(f"[lm train] {arch} {line}"),
              device="cuda")
    launches = read(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if res.final_step != steps or res.restored_from is not None:
        fail(f"{arch} train: ran to step {res.final_step} of {steps}, "
             f"restored from {res.restored_from}")
    if not all(map(math.isfinite, res.losses + res.gnorms)):
        fail(f"{arch} train: loss {res.losses}, gnorm {res.gnorms}")
    want = {k: 0 for k in launches}
    if cfg.family == "ssm":        # remat="full": forward + recompute
        want["ssd"] = 2 * cfg.n_layers * steps
    if launches != want:
        fail(f"{arch} train: launches {launches}, expected {want}")
    step_s = sorted(res.step_s[1:])[(steps - 1) // 2]
    out = {"step_ms": 1e3 * step_s, "tok_s": batch * LM_TRAIN_SEQ / step_s,
           "peak_gb": peak, "launches": launches}
    print(f"[lm train] {arch} on the card: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.phys_vocab}, {cfg.param_dtype} params, "
          f"{cfg.compute_dtype} compute, remat {cfg.remat}, batch {batch} x "
          f"{LM_TRAIN_SEQ}: step {out['step_ms']:.1f} ms (median of steps "
          f"2-{steps}, host clock from drawing the batch to the loss; step 1 "
          f"{1e3 * res.step_s[0]:.1f} ms), {out['tok_s']:.0f} tokens/s, peak "
          f"{peak:.2f} GB allocated; loss {res.losses}, gnorm {res.gnorms}; "
          f"K6 launches {launches['ssd']} = "
          f"{launches['ssd'] / steps:g} a step")
    if cfg.family == "dense" and peak > LM_TRAIN_PEAK_GB:
        fail(f"{arch} train: peak {peak:.2f} GB > {LM_TRAIN_PEAK_GB} GB: the "
             f"donated update is not in place")
    del res
    profile_train_step(torch, cfg, batch)
    return out


def profile_train_step(torch, cfg, batch: int) -> None:
    """One train step at ``lm_train_run``'s shape under torch.profiler
    (after one step to warm up), from fresh seeded params: the device's
    busy share and time by kernel. Its launches are not the main path's
    (the counters were read before)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStreamConfig, sample_batch
    from repro_torch.models import lm
    from repro_torch.train.steps import build_train_step
    torch.cuda.empty_cache()
    step, _, opt = build_train_step(
        cfg, ShapeConfig("chip", "train", LM_TRAIN_SEQ, batch), device="cuda")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    state = opt.init(params)
    data = {k: v.cuda() for k, v in sample_batch(TokenStreamConfig(
        cfg.vocab_size, LM_TRAIN_SEQ, batch), 0).items()}
    step(params, state, data)
    profile_eval(torch, step, (params, state, data), top=8, tag="lm train",
                 what=f"{cfg.name} one train step (batch {batch} x "
                      f"{LM_TRAIN_SEQ})")
    del params, state
    torch.cuda.empty_cache()


def lm_train_parity(torch, counters) -> None:
    """Both smoke variants, 3 steps (lr 1e-3, batch 4 x 128) on the card
    and on the CPU from the same params and token-stream batches, in
    float32 and in bf16 compute, held to LM_TRAIN_F32 / LM_TRAIN_BF16; K6
    must have launched in the card's mamba2 runs."""
    from dataclasses import replace
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStreamConfig, sample_batch
    from repro_torch.models import lm
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map, tree_paths
    shape = ShapeConfig("parity", "train", 128, 4)
    for arch in LM_TRAINED:
        for compute in ("float32", "bfloat16"):
            cfg = replace(smoke_variant(get_config(arch)),
                          compute_dtype=compute)
            p0 = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
            batches = [sample_batch(TokenStreamConfig(cfg.vocab_size, 128,
                                                      4), i)
                       for i in range(3)]
            out = {}
            for device in ("cuda", "cpu"):
                step, _, opt = build_train_step(cfg, shape, lr=1e-3,
                                                device=device)
                p = tree_map(lambda t: t.to(device, copy=True), p0)
                o = opt.init(p)
                zero(counters)
                ms = []
                for b in batches:
                    p, o, m = step(p, o, {k: v.to(device)
                                          for k, v in b.items()})
                    ms.append((float(m["loss"]), float(m["gnorm"])))
                out[device] = (ms, tree_map(lambda t: t.cpu(),
                                            {"params": p, "opt": o}),
                               read(counters)["ssd"])
            (mc, sc, kc), (mp, sp, _) = out["cuda"], out["cpu"]
            if cfg.family == "ssm" and kc != 3 * cfg.n_layers:
                fail(f"{arch} {compute} parity: K6 launched {kc} times on "
                     f"the card, expected {3 * cfg.n_layers}")
            loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in
                           zip(mc, mp))
            gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in
                         zip(mc, mp))
            if compute == "float32":
                want = dict(tree_paths(sp))
                worst = max(float(((a - want[k]).abs()
                                   / (LM_TRAIN_F32["atol"] + LM_TRAIN_F32[
                                       "rtol"] * want[k].abs())).max())
                            for k, a in tree_paths(sc))
                ok = loss_rel <= LM_TRAIN_F32["loss"] and worst <= 1.0
                what = (f"params and moments at most {worst:.3g} of the "
                        f"rtol {LM_TRAIN_F32['rtol']} / atol "
                        f"{LM_TRAIN_F32['atol']} limit")
            else:
                num = den = 0.0
                for (_, c), (_, q), (_, q0) in zip(tree_paths(sc["params"]),
                                                   tree_paths(sp["params"]),
                                                   tree_paths(p0)):
                    num += float((c - q).square().sum())
                    den += float((q - q0).square().sum())
                upd = (num / den) ** 0.5
                ok = (loss_rel <= LM_TRAIN_BF16["loss"]
                      and gn_rel <= LM_TRAIN_BF16["gnorm"]
                      and upd <= LM_TRAIN_BF16["update"])
                what = f"params' change {upd:.3g} apart (relative L2)"
            line = (f"{arch} smoke {compute}, 3 steps cuda vs cpu: loss "
                    f"{loss_rel:.3g} apart (relative), gnorm {gn_rel:.3g}, "
                    f"{what}; K6 launches on the card {kc}")
            if not ok:
                fail(f"[lm train parity] {line}")
            print(f"[lm train parity] {line}")


def ssd_trainable_check(torch) -> None:
    """ssd_trainable at one mamba2-780m training layer's scan (x [8, 2048,
    48, 64], g 1, n 128, bf16) against ssd_chunked on the card: y within
    K6's limit (SSD_RTOL of the largest |y| plus one bf16 step), the five
    gradients within SSD_GRAD_RTOL of each one's largest magnitude; both
    routes forward + backward timed (CUDA events)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd.ops import ssd_trainable
    from repro_torch.nn.ssm import ssd_chunked
    gen = torch.Generator().manual_seed(9)
    b, s, h, p, g, n = 8, LM_TRAIN_SEQ, 48, 64, 1, 128
    x = torch.randn((b, s, h, p), generator=gen).to("cuda", torch.bfloat16)
    dt = F.softplus(torch.randn((b, s, h), generator=gen)).to("cuda")
    A = -torch.exp(torch.randn(h, generator=gen) * 0.3).to("cuda")
    B, C = (torch.randn((b, s, g, n), generator=gen).to("cuda",
                                                          torch.bfloat16)
            for _ in range(2))
    gy = torch.randn((b, s, h, p), generator=gen).to("cuda", torch.bfloat16)
    args = (x, dt, A, B, C)

    def grads(fn):
        live = [a.detach().requires_grad_() for a in args]
        y = fn(*live)
        return y.detach(), torch.autograd.grad(y, live, gy)

    y, got = grads(ssd_trainable)
    y_p, want = grads(lambda *a: ssd_chunked(*a, 128)[0])
    dy = (y.float() - y_p.float()).abs()
    top = y_p.float().abs().max().item()
    share = (dy / (SSD_RTOL * top + 2.0 ** -8 * y_p.float().abs())).max(
        ).item()
    errs = {name: ((a.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
            for name, a, w in zip("x dt A B C".split(), got, want)}
    if not share <= 1.0 or max(errs.values()) > SSD_GRAD_RTOL:
        fail(f"ssd_trainable [{b}, {s}, {h}, {p}] bf16: y at {share:.3g} of "
             f"its limit, gradients apart by {errs} (relative)")
    ms = time_ms(lambda: grads(ssd_trainable), torch, reps=5)
    plain_ms = time_ms(lambda: grads(lambda *a: ssd_chunked(*a, 128)[0]),
                       torch, reps=5)
    print(f"[lm train] ssd_trainable [{b}, {s}, {h}, {p}] g {g} n {n} bf16 "
          f"vs ssd_chunked on the card: y at most {share:.3g} of K6's "
          f"per-element limit, gradients apart by at most "
          f"{max(errs.values()):.3g} of their largest (relative); forward + "
          f"backward {ms:.3f} ms (plain route {plain_ms:.3f} ms; CUDA "
          f"events)")


def lm_train_restart(torch) -> None:
    """The loop at mamba2-780m's smoke variant on the card: 6 steps in one
    run, and one cut at step 3 then restarted from its async checkpoint,
    with the same losses and the same final checkpoint, bit for bit."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.utils import tree_paths
    cfg = smoke_variant(get_config("mamba2-780m"))
    shape = ShapeConfig("restart", "train", 128, 4)
    root = ROOT / "build" / "chip_smoke" / "lm_restart"
    shutil.rmtree(root, ignore_errors=True)

    def loop(name, total):
        return run(cfg, shape, LoopConfig(total_steps=total, ckpt_every=3,
                                          log_every=100, lr=1e-3,
                                          ckpt_dir=str(root / name)),
                   log=lambda _: None, device="cuda")
    whole = loop("whole", 6)
    cut = loop("cut", 3)
    rest = loop("cut", 6)
    a, _ = load_checkpoint(root / "whole", 6)
    b, _ = load_checkpoint(root / "cut", 6)
    same = all((x == y).all() for (_, x), (_, y) in zip(tree_paths(a),
                                                        tree_paths(b)))
    if rest.restored_from != 3 or cut.losses + rest.losses != whole.losses \
            or not same:
        fail(f"restart on the card: restored from {rest.restored_from}, "
             f"losses {cut.losses} + {rest.losses} vs {whole.losses}, final "
             f"checkpoints equal: {same}")
    shutil.rmtree(root)
    print(f"[lm train] restart on the card ({cfg.name} smoke, 6 steps; cut at "
          f"3 and resumed from its async checkpoint): losses and final "
          f"params bit-identical ({whole.losses[-1]:.6f})")


def lm_train_launcher(tmp: Path) -> None:
    """launch/train.py on the card: --smoke trains (exit 0);
    --production-mesh prints error: and exits 2."""
    import io
    import shutil
    from repro_torch.launch import train as launcher
    shutil.rmtree(tmp, ignore_errors=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launcher.main(["--smoke", "--steps", "4", "--batch", "2",
                            "--seq", "128", "--ckpt-dir", str(tmp)])
    if rc != 0 or "[train] done at step 4" not in out.getvalue():
        fail(f"launch/train.py --smoke: exit {rc}, {out.getvalue()!r}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = launcher.main(["--production-mesh", "--ckpt-dir", str(tmp)])
    if rc != 2 or not err.getvalue().startswith("error:"):
        fail(f"launch/train.py --production-mesh: exit {rc}, "
             f"{err.getvalue()!r}")
    shutil.rmtree(tmp)
    print(f"[lm train] launch/train.py --smoke --steps 4 --batch 2 --seq 128: "
          f"exit 0 ({out.getvalue().strip().splitlines()[-1]}); "
          f"--production-mesh: exit 2, {err.getvalue().strip()[:60]}...")


def phase_lm_train(torch, counters) -> dict:
    """[lm train]: both architectures trained at full published width
    through ``train.loop.run`` (``lm_train_run``), then card-against-CPU
    parity at the smoke variants, ``ssd_trainable`` at a full-width
    layer's scan, a restart on the card and the launcher. Returns the
    launches of the full-width runs by kernel."""
    tmp = ROOT / "build" / "chip_smoke"
    runs = {arch: lm_train_run(torch, arch, batch, steps, counters,
                               tmp / f"lm_train_{arch}")
            for arch, batch, steps in LM_TRAIN}
    lm_train_parity(torch, counters)
    ssd_trainable_check(torch)
    torch.cuda.empty_cache()
    lm_train_restart(torch)
    lm_train_launcher(tmp / "lm_train_launcher")
    total = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


class Prerecorded:
    """A source's streams drawn once, in stream-id order, with the
    generators the engine would give them, and replayed to every serve:
    each stream is found by its generator's seed, so stream ``i`` replays
    recording ``i`` whatever order the engine opens streams in (a
    rejected stream is never opened). Drawing (or reading the files) up
    front keeps host work out of the serving wall time. ``index`` pins a
    file-backed source's sample for each stream id."""

    def __init__(self, source, n_streams: int, seed: int, chunk_us: int,
                 slot_us: int, stream_generator, index=None):
        for attr in ("name", "height", "width", "n_classes", "duration_ms",
                     "sensor_hw"):
            setattr(self, attr, getattr(source, attr))
        self.n_slots = source.n_slots
        self.recordings = {}
        for sid in range(n_streams):
            gen = stream_generator(seed, sid)
            key = gen.initial_seed()
            pin = {} if index is None else {"index": index(sid)}
            label, chunks = source.iter_event_chunks(
                gen, chunk_us=chunk_us, slot_us=slot_us, **pin)
            self.recordings[key] = (label, list(chunks))

    def replay(self) -> "Prerecorded":
        return self

    def iter_event_chunks(self, gen, *, chunk_us, slot_us=None):
        label, chunks = self.recordings[gen.initial_seed()]
        return label, iter(chunks)


def serve_counted(torch, sf, engine, source, n_streams: int) -> tuple:
    """One main-path serve with the launch counters zeroed just before
    and read just after."""
    zero((sf.LAUNCHES,))
    report = engine.serve(source.replay(), n_streams, seed=0)
    torch.cuda.synchronize()
    return report, dict(sf.LAUNCHES)


def awake(params: dict, gain: float = 2.0) -> dict:
    """A fresh He-init backbone goes silent by its third layer on these
    streams (every logit exactly 0, which would make the logit checks
    vacuous); doubling the BN scales and the fc0 weights keeps spikes
    flowing to the head."""
    bb = params["backbone"]
    for k, v in bb.items():
        if k.startswith("bn"):
            v["scale"].mul_(gain)
    bb["fc0"]["w"].mul_(gain)
    return params


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


def with_mode(cfg, mode: str, leak=None):
    """``cfg`` with layer 1 in ``mode`` (and circuit ``leak``, if given)."""
    from dataclasses import replace
    p2m = replace(cfg.p2m, mode=mode, leak=leak or cfg.p2m.leak)
    return replace(cfg, p2m=p2m)


def phase_physics(torch, cfg, params, state, events, labels, counters
                  ) -> dict:
    """The main path of the physics slice at full width, with every kernel
    counter set to 0 just before and read just after. Returns the K1 and
    K4 launch counts and the per-(circuit, mode) eval results."""
    import numpy as np
    from repro_torch.core import codesign, leakage, p2m_layer, snn
    from repro_torch.kernels.lif import ops as lif_ops
    circuits = leakage.paper_circuits()
    for mode in ("kernel", "scan"):       # first calls: allocator, cuDNN
        codesign.make_eval_fn(with_mode(cfg, mode), device="cuda")(
            params, state, events, labels)
    zero(counters)
    evals = {}
    for lc in circuits:
        for mode in ("kernel", "scan"):
            fn = codesign.make_eval_fn(with_mode(cfg, mode, lc),
                                       device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, aux = fn(params, state, events, labels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            evals[(lc.circuit.value, mode)] = (metrics, aux, wall)
            print(f"[physics] circuit {lc.circuit.value} mode={mode}: eval "
                  f"{wall * 1e3:.1f} ms = {len(labels) / wall:.2f} samples/s,"
                  f" acc {float(metrics['acc']):.2f}, spikes/p2m "
                  f"{float(aux['spikes/p2m']):.0f}, events/in "
                  f"{float(aux['events/in']):.0f}")
        (mk, ak, _), (ms, as_, _) = (evals[(lc.circuit.value, "kernel")],
                                     evals[(lc.circuit.value, "scan")])
        got, want = mk["logits"].cpu().numpy(), ms["logits"].cpu().numpy()
        if not np.isfinite(got).all():
            fail(f"circuit {lc.circuit.value}: non-finite logits")
        diff = float(np.abs(got - want).max())
        if not diff <= LOGIT_ATOL:
            fail(f"circuit {lc.circuit.value}: kernel vs scan logits differ "
                 f"by {diff} > {LOGIT_ATOL}")
        for key in ("spikes/p2m", "events/in", "macs/p2m"):
            if float(ak[key]) != float(as_[key]):
                fail(f"circuit {lc.circuit.value}: aux {key} kernel "
                     f"{float(ak[key])} vs scan {float(as_[key])}")
        print(f"[physics] circuit {lc.circuit.value}: kernel vs scan max "
              f"|logit diff| {diff:.3g}, max |logit| "
              f"{float(np.abs(want).max()):.3g}, aux equal")
    top = max(float(evals[(lc.circuit.value, "scan")][0]["logits"].abs()
                    .max()) for lc in circuits)
    if not top > 0.05:
        fail(f"the head never spiked under any circuit (max |logit| {top}); "
             f"the logit checks would be vacuous")
    profile_eval(torch, codesign.make_eval_fn(with_mode(cfg, "kernel"),
                                              device="cuda"),
                 (params, state, events, labels))
    k1_evals = counters[0]["p2m_conv"] - 1           # - the profiled eval
    if k1_evals != len(circuits):
        fail(f"{k1_evals} p2m_conv launches for {len(circuits)} kernel-mode "
             f"evals")

    # the multi-circuit validator: one launch for all three circuits
    t0 = time.perf_counter()
    s_m, v_m = p2m_layer.p2m_apply_stacked(
        params["p2m"], events, with_mode(cfg, "kernel").p2m, circuits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    theta = torch.tensor([leakage.resolve_v_threshold(lc, cfg.p2m.v_threshold)
                          for lc in circuits], device="cuda")[:, None]
    errs = []
    for i, lc in enumerate(circuits):
        s_i, v_i = p2m_layer.p2m_apply(params["p2m"], events,
                                       with_mode(cfg, "scan", lc).p2m)
        errs.append(check_p2m_conv(
            torch, (s_m[i:i + 1], v_m[i:i + 1]), (s_i[None], v_i[None]),
            theta[i:i + 1].expand(1, v_i.shape[-1]),
            f"p2m_apply_stacked vs scan, circuit {lc.circuit.value}"))
        del s_i, v_i
    print(f"[physics] p2m_apply_stacked(kernel) over {len(circuits)} circuits"
          f" in {wall * 1e3:.1f} ms vs one scan per circuit: max |v_pre diff| "
          f"{max(errs):.3g}, spikes {[float(x) for x in s_m.sum((1, 2, 3, 4, 5))]}")

    # the LIF op on the backbone's first LIF input (circuit c's spikes)
    bb, bcfg = params["backbone"], cfg.backbone
    spikes = s_m[2]
    del v_m
    B, T = spikes.shape[:2]
    pooled = snn.max_pool(spikes.reshape((B * T,) + spikes.shape[2:]))
    coarse = p2m_layer.coarsen_spikes(pooled.reshape((B, T) + pooled.shape[1:]),
                                      cfg.coarsen_group())
    del s_m, spikes, pooled
    Tc = coarse.shape[1]
    x = coarse.transpose(0, 1).reshape((Tc * B,) + coarse.shape[2:])
    y = snn.bn_apply_eval(bb["bn1"], state["bn1"], snn.conv_apply(bb["conv1"], x))
    y = y.reshape((Tc, B) + y.shape[1:]).contiguous()
    got = lif_ops.lif_over_time(y, bcfg.lif)
    want = snn.lif_over_time(y, bcfg.lif)
    if not torch.equal(got, want):
        fail("the LIF op differs from snn.lif_over_time on the backbone")
    print(f"[physics] LIF op on conv1's input {tuple(y.shape)}: equal to "
          f"snn.lif_over_time, {float(got.sum()):.0f} spikes")
    torch.cuda.synchronize()
    launches = {"p2m_conv": counters[0]["p2m_conv"], "lif": counters[1]["lif"]}
    # three kernel-mode evals, the profiled one and the stacked launch, all
    # on the tensor-core route; one LIF op call, on the wide lanes; no fold
    if (launches != {"p2m_conv": len(circuits) + 2, "lif": 1}
            or counters[0]["p2m_conv_fma"] or counters[1]["lif_narrow"]
            or any(counters[2].values())):
        fail(f"physics launches {launches}, lif {counters[1]}, folds "
             f"{counters[2]}: expected {len(circuits) + 2} p2m_conv, 1 lif "
             f"on the wide lanes and no fold")
    return launches


def profile_eval(torch, fn, args, top: int = 6, tag: str = "physics",
                 what: str = "one kernel-mode eval (circuit c)") -> None:
    """One call under torch.profiler: device time by kernel (the largest
    ``top``) and the share of the call's wall time the device was busy.
    Only device-side rows count (kernels, copies, fills): an operator's
    row repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        print(f"[{tag}] profile: no device time recorded, the breakdown "
              f"is not measured")
        return
    print(f"[{tag}] profile of {what}: wall {wall_us / 1e3:.2f} ms under the "
          f"profiler, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f} %)")
    for e in kernels[:top]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:4d}x  {e.key[:90]}")


def phase_physics_parity(torch) -> float:
    """The reduced() model in kernel mode on cuda and on the CPU, same
    seeded weights and batch."""
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign
    from repro_torch.data import events as ev_mod
    from repro_torch.stream.deploy import tree_to
    cfg, data = p2m_dvs.reduced()
    ev, labels = ev_mod.sample_batch(torch.Generator().manual_seed(1), data,
                                     PHYS_B, cfg.p2m.t_intg_ms, cfg.p2m.n_sub)
    logits = {}
    for device in ("cuda", "cpu"):
        params, state = codesign.model_init(torch.Generator().manual_seed(0),
                                            cfg)
        params = awake(tree_to(params, torch.device(device)))
        metrics, _ = codesign.make_eval_fn(with_mode(cfg, "kernel"),
                                           device=device)(
            params, tree_to(state, torch.device(device)), ev, labels)
        logits[device] = metrics["logits"].cpu()
    return check_logits(logits["cuda"], logits["cpu"],
                        "physics reduced() cuda vs cpu")


def phase_train(torch, cfg, events, labels, counters) -> dict:
    """The training step at full width on the physics batch: fresh seeded
    weights (``awake``), ``adamw(1e-3)``, ``TRAIN_STEPS`` unfrozen steps
    then as many under ``freeze_p2m``, each timed on the host clock around
    synchronised calls, with every kernel counter set to 0 before and read
    after (training runs none: layer 1 trains through curvefit, the LIF
    through snn.lif_over_time); one more step under torch.profiler, its
    result discarded; then the trained params evaluated with make_eval_fn
    in kernel mode (one K1 launch, counted) and in scan mode."""
    import math
    from repro_torch.core import codesign
    from repro_torch.optim import adamw
    from repro_torch.stream.deploy import tree_to
    params, state = codesign.model_init(torch.Generator().manual_seed(1), cfg)
    params = awake(tree_to(params, torch.device("cuda")))
    state = tree_to(state, torch.device("cuda"))
    opt = adamw(1e-3)
    ostate = opt.init(params)
    steps = {fz: codesign.make_train_step(cfg, opt, freeze_p2m=fz,
                                          device="cuda")
             for fz in (False, True)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    out = {"step_ms": {False: [], True: []}}
    p2m0 = fc1_0 = None
    for i in range(2 * TRAIN_STEPS):
        frozen = i >= TRAIN_STEPS
        if frozen and p2m0 is None:
            p2m0 = {k: v.clone() for k, v in params["p2m"].items()}
            fc1_0 = params["backbone"]["fc1"]["w"].clone()
        t0 = time.perf_counter()
        params, ostate, state, m, aux = steps[frozen](params, ostate, state,
                                                      events, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["step_ms"][frozen].append(ms)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train step {i}: loss {loss}, gnorm {gnorm}")
        print(f"[train] step {i} freeze_p2m={frozen}: {ms:.1f} ms (host "
              f"clock), loss {loss:.6f}, gnorm {gnorm:.6f}, acc "
              f"{float(m['acc']):.2f}, spikes/p2m "
              f"{float(aux['spikes/p2m']):.0f}, spikes/fc0 "
              f"{float(aux['spikes/fc0']):.0f}")
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = read(counters)
    if any(launched.values()):
        fail(f"training launched kernels: {launched}")
    for k, v in p2m0.items():
        if not torch.equal(params["p2m"][k], v):
            fail(f"freeze_p2m moved layer 1's {k}")
    if torch.equal(params["backbone"]["fc1"]["w"], fc1_0):
        fail("the frozen steps left fc1 where it was")
    warm = sorted(out["step_ms"][False][1:])      # the first allocates
    frz = sorted(out["step_ms"][True])
    print(f"[train] {TRAIN_STEPS} unfrozen + {TRAIN_STEPS} frozen steps at "
          f"batch {len(labels)}: unfrozen step {warm[len(warm) // 2]:.1f} ms "
          f"(median after the first, host clock), frozen step "
          f"{frz[len(frz) // 2]:.1f} ms (median), "
          f"peak device memory {out['peak_gib']:.2f} GiB "
          f"(max_memory_allocated); no kernel launched; layer 1 "
          f"bit-identical over the frozen steps, fc1 moved")
    profile_eval(torch, steps[False], (params, ostate, state, events, labels),
                 top=8, tag="train", what="one unfrozen train step")

    zero(counters)
    evals = {}
    for mode in ("kernel", "scan"):
        fn = codesign.make_eval_fn(with_mode(cfg, mode), device="cuda")
        evals[mode] = fn(params, state, events, labels)
    torch.cuda.synchronize()
    (mk, ak), (ms_, as_) = evals["kernel"], evals["scan"]
    got, want = mk["logits"].cpu(), ms_["logits"].cpu()
    if not torch.isfinite(got).all():
        fail("trained params: non-finite kernel-mode logits")
    diff = float((got - want).abs().max())
    if not diff <= LOGIT_ATOL:
        fail(f"trained params: kernel vs scan logits differ by {diff}")
    for key in ak:
        if float(ak[key]) != float(as_[key]):
            fail(f"trained params: aux {key} kernel {float(ak[key])} vs "
                 f"scan {float(as_[key])}")
    if not float(ak["spikes/p2m"]) > 0:
        fail("trained params: layer 1 never fired, the comparison would be "
             "vacuous")
    k1 = read(counters)
    if k1 != {**{k: 0 for k in k1}, "p2m_conv": 1}:
        fail(f"trained-params eval launches {k1}: expected one p2m_conv")
    out["eval_diff"] = diff
    print(f"[train] trained params, make_eval_fn kernel vs scan: max |logit "
          f"diff| {diff:.3g} (max |logit| {float(want.abs().max()):.3g}), "
          f"every aux counter equal (spikes/p2m "
          f"{float(ak['spikes/p2m']):.0f}), launches {k1}")
    return out


def phase_train_parity(torch) -> dict:
    """TRAIN_STEPS unfrozen steps at reduced() on cuda and on the CPU from
    the same seeded weights and batches: per step loss and gnorm within
    TRAIN_RTOL, and the params after the last step within TRAIN_RTOL of
    each leaf's largest magnitude. The conv biases are held apart: train
    BN subtracts them, so their exact gradient is 0, each device returns
    roundoff, and Adam turns that into steps of up to about lr either way
    (|Δ| ≤ 2·lr per step)."""
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign
    from repro_torch.data import events as ev_mod
    from repro_torch.optim import adamw
    from repro_torch.stream.deploy import tree_to
    from repro_torch.utils import tree_paths
    cfg, data = p2m_dvs.reduced()
    batches = [ev_mod.sample_batch(torch.Generator().manual_seed(2 + i), data,
                                   PHYS_B, cfg.p2m.t_intg_ms, cfg.p2m.n_sub)
               for i in range(TRAIN_STEPS)]
    runs = {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        params, state = codesign.model_init(torch.Generator().manual_seed(0),
                                            cfg)
        params, state = awake(tree_to(params, dev)), tree_to(state, dev)
        opt = adamw(1e-3)
        ostate = opt.init(params)
        step = codesign.make_train_step(cfg, opt, freeze_p2m=False,
                                        device=device)
        rec = []
        for ev, lab in batches:
            params, ostate, state, m, _ = step(params, ostate, state, ev, lab)
            rec.append((float(m["loss"]), float(m["gnorm"])))
        runs[device] = (rec, dict(tree_paths(tree_to(params,
                                                     torch.device("cpu")))))
    worst = 0.0
    for i, ((lc, gc), (lp, gp)) in enumerate(zip(runs["cuda"][0],
                                                 runs["cpu"][0])):
        for what, a, b in (("loss", lc, lp), ("gnorm", gc, gp)):
            rel = abs(a - b) / abs(b)
            worst = max(worst, rel)
            if not rel <= TRAIN_RTOL:
                fail(f"train parity step {i}: {what} cuda {a} vs cpu {b}")
    pc, pp = runs["cuda"][1], runs["cpu"][1]
    leaf_worst = 0.0
    for path, want in pp.items():
        err = float((pc[path] - want).abs().max())
        if path.startswith("backbone/conv") and path.endswith("/b"):
            if not err <= 2 * 1e-3 * TRAIN_STEPS:
                fail(f"train parity: conv bias {path} differs by {err}")
            continue
        rel = err / float(want.abs().max())
        leaf_worst = max(leaf_worst, rel)
        if not rel <= TRAIN_RTOL:
            fail(f"train parity: {path} differs by {err} ({rel:.3g} of its "
                 f"largest magnitude)")
    print(f"[train parity] reduced(), {TRAIN_STEPS} unfrozen steps of batch "
          f"{PHYS_B}: cuda vs cpu loss/gnorm max relative diff {worst:.3g}, "
          f"params max diff {leaf_worst:.3g} of a leaf's largest magnitude "
          f"(limit {TRAIN_RTOL:g}); losses cuda "
          f"{[round(x, 6) for x, _ in runs['cuda'][0]]}")
    return {"rel": worst, "params": leaf_worst}


SWEEP_STEPS = dict(batch_size=4, pretrain_steps=2, finetune_steps=2,
                   eval_batches=1)      # step counts cut; widths are not
# the sweep on cuda vs the CPU at reduced(): records' bandwidth, sensor
# energy and retention relative, and the backend energies of one eval of
# the same trained params; the records' backend energies (which read the
# backbone's spike counts, moved by a few roundoff-trained weights) and
# the trained params are held as tests/sweep_parity.py says
SWEEP_RTOL = 1e-5
SWEEP_RECORD_KEYS = (
    "label", "circuit", "null_mismatch", "protocol", "t_intg_ms", "n_sub",
    "variant", "accuracy", "train_time_s", "train_time_per_step_s",
    "bandwidth_ratio", "backend_energy_conventional_j",
    "backend_energy_p2m_j", "sensor_energy_p2m_j", "layer1_spikes",
    "input_events", "retention_err_v", "retention_surface_v",
    "bandwidth_norm", "train_time_norm", "energy_improvement")


def awake_init(codesign):
    """``codesign.model_init`` with ``awake`` applied, so the sweep's fresh
    seeded weights keep spikes flowing to the head as ``[train]``'s do;
    returns the original to restore."""
    init = codesign.model_init

    def woken(gen, cfg):
        params, state = init(gen, cfg)
        return awake(params), state

    codesign.model_init = woken
    return init


def check_sweep_artifact(art: dict, labels: list, n_records: int) -> None:
    """The merged ``p2m-codesign-sweep/v3`` artifact: schema, protocols,
    labels, the records in the reference's order with every key of
    docs/sweep.md's schema, all values finite; it dumps as JSON."""
    import math
    json.dumps(art)
    if art["schema"] != "p2m-codesign-sweep/v3":
        fail(f"sweep artifact schema {art['schema']!r}")
    if art["protocols"] != ["frozen", "unfrozen"]:
        fail(f"sweep artifact protocols {art['protocols']}")
    if art["grid"]["labels"] != labels:
        fail(f"sweep artifact labels {art['grid']['labels']}")
    order = [(p, t, lab) for p in ("frozen", "unfrozen")
             for t in art["grid"]["t_intg_grid_ms"] for lab in labels]
    got = [(r["protocol"], r["t_intg_ms"], r["label"])
           for r in art["records"]]
    if len(got) != n_records or got != order:
        fail(f"sweep records {got}, expected {order}")

    def finite(v):
        if isinstance(v, dict):
            return all(finite(x) for x in v.values())
        if isinstance(v, list):
            return all(finite(x) for x in v)
        return not isinstance(v, float) or math.isfinite(v)

    for r in art["records"]:
        missing = [k for k in SWEEP_RECORD_KEYS if k not in r]
        if missing or not finite(r):
            fail(f"sweep record {r['label']} {r['t_intg_ms']}: missing "
                 f"{missing} or a non-finite value")
    if not finite(art["retention"]):
        fail("sweep artifact retention is not finite")


def print_sweep_cells(tag: str, results: dict, scfg) -> None:
    """Per protocol and cell: the record's train time per step (host
    clock) and the share of it that ``sample_batch`` took on the host, eval
    seconds, peak device memory."""
    for proto, res in results.items():
        for (t_ms, ns), tm in res.timings.items():
            rec = next(r for r in res.records if r["t_intg_ms"] == t_ms)
            step_ms = rec["train_time_per_step_s"] * 1e3
            sample_ms = tm["train_sample_s"] / scfg.finetune_steps * 1e3
            print(f"[{tag}] {proto} T_INTG {t_ms:g} ms: train "
                  f"{step_ms:.1f} ms/step (host clock, {scfg.finetune_steps} "
                  f"steps of {len(res.labels)} variants), of which "
                  f"sample_batch {sample_ms:.1f} ms/step on the host "
                  f"({100 * sample_ms / step_ms:.1f} %); eval "
                  f"{tm['eval_s']:.3f} s (sample_batch "
                  f"{tm['eval_sample_s']:.3f} s); peak device memory "
                  f"{tm['peak_bytes'] / 2 ** 30:.2f} GiB")
        peak = max(tm["peak_bytes"] for tm in res.timings.values())
        print(f"[{tag}] {proto}: peak device memory {peak / 2 ** 30:.2f} "
              f"GiB (max_memory_allocated over its cells)")


def phase_sweep(torch, counters, events, labels) -> dict:
    """The co-design sweep at full width: configs/p2m_dvs CONFIG and DATA,
    fresh seeded weights (``awake``), ``fast_grid()`` (circuits a, b,
    c@m=0.06 × T_INTG 10 and 1000 ms), both protocols off one pretrain,
    ``keep_params=True``, every kernel counter set to 0 before and read
    after (the sweep trains and evaluates through the curve-fit forward:
    no kernel). Per protocol and cell: the record's train time per step,
    the eval and ``sample_batch`` host seconds, peak device memory, and
    one finetune step on the physics batch (10 ms) or a fresh one
    (1000 ms) under torch.profiler. Writes and checks the merged
    artifact."""
    from dataclasses import replace
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, sweep
    from repro_torch.data import events as ev_mod
    from repro_torch.optim import adamw
    cfg = p2m_dvs.CONFIG
    grid = sweep.fast_grid()
    scfg = codesign.SweepConfig(t_intg_grid_ms=grid.t_intg_grid_ms,
                                **SWEEP_STEPS)
    print(f"[sweep] {cfg.backbone.input_hw} input, {cfg.p2m.out_channels} "
          f"in-pixel filters, n_sub {cfg.p2m.n_sub}, backbone "
          f"{cfg.backbone.channels} fc {cfg.backbone.fc_hidden}, "
          f"{p2m_dvs.DATA.duration_ms:g} ms streams; fast grid "
          f"{[c.value for c in grid.circuits]} x {grid.t_intg_grid_ms} ms; "
          f"cut: steps only, {SWEEP_STEPS}")
    init = awake_init(codesign)
    zero(counters)
    t0 = time.perf_counter()
    try:
        results = sweep.run_protocols(p2m_dvs.DATA, cfg, scfg, grid,
                                      protocols=("frozen", "unfrozen"),
                                      keep_params=True, device="cuda",
                                      log=lambda m: print(f"  {m}"))
    finally:
        codesign.model_init = init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = read(counters)
    if any(launched.values()):
        fail(f"the sweep launched kernels: {launched}")
    labels_g = list(results["frozen"].labels)
    print_sweep_cells("sweep", results, scfg)
    art = sweep.protocols_artifact(results, extra_meta={"wall_s": wall})
    out = ROOT / "build" / "chip_smoke" / "codesign_grid_fast.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(art, indent=2))
    check_sweep_artifact(json.loads(out.read_text()), labels_g, 12)
    for r in art["records"]:
        print(f"[sweep] {r['protocol']:8s} {r['label']:9s} "
              f"{r['t_intg_ms']:6g} ms: acc {r['accuracy']:.3f} bw "
              f"{r['bandwidth_norm']:.3f}x energy "
              f"{r['energy_improvement']:.3f}x "
              f"retention {r['retention_err_v'] * 1e3:.2f} mV")
    print(f"[sweep] artifact {out.relative_to(ROOT)}: 12 records, schema, "
          f"labels {labels_g}, keys and values checked; wall {wall:.1f} s, "
          f"no kernel launched")

    # one finetune step per protocol and cell under the profiler
    ev_1000, lab_1000 = ev_mod.sample_batch(torch.Generator().manual_seed(3),
                                            p2m_dvs.DATA, len(labels), 1000.0,
                                            cfg.p2m.n_sub)
    batches = {10.0: (events, labels), 1000.0: (ev_1000, lab_1000)}
    opt = adamw(scfg.lr)
    leak_cfgs = sweep.expand_leak_configs(grid, cfg.p2m.leak)
    for proto, res in results.items():
        o = (sweep.joint_optimizer(opt, opt) if proto == "unfrozen" else opt)
        for (t_ms, ns), fp in res.final_params.items():
            cfg_t = replace(cfg, p2m=replace(cfg.p2m, t_intg_ms=t_ms,
                                             n_sub=ns))
            step = sweep.make_batched_finetune_step(
                cfg_t, leak_cfgs, o, protocol=proto, device="cuda")
            trained = ({"p2m": fp["p2m"], "backbone": fp["backbone"]}
                       if proto == "unfrozen" else fp["backbone"])
            ostate = sweep._map_cfgs(o.init, trained)
            ev, lab = batches[t_ms]
            args = (fp["p2m"], fp["backbone"], ostate, fp["state"], ev, lab)
            step(*args)                       # allocations, cuDNN choice
            profile_eval(torch, step, args, top=5, tag="sweep",
                         what=f"one {proto} finetune step at T_INTG "
                              f"{t_ms:g} ms ({len(leak_cfgs)} variants)")
    del batches, ev_1000
    torch.cuda.empty_cache()
    return {"results": results, "artifact": art, "path": out}


def phase_deploy(torch, sf, sweep_out: dict, src) -> dict:
    """Deploy from the full-width sweep: ``select_record`` per protocol at
    T_INTG 10 ms, ``deploy_from_sweep`` → ``load_deployment(...,
    artifact=)`` on cuda; the frozen checkpoint serves the 16 recorded
    synthetic-gesture streams through the MAC fold (K3) and then the
    deposit fold (K2), counters set to 0 before and read after each; the
    readouts agree; the serving artifact passes
    tools/check_stream_stats.py."""
    import numpy as np
    from repro_torch.configs import p2m_dvs
    from repro_torch.stream import deploy
    from repro_torch.stream.engine import StreamEngine
    results, art = sweep_out["results"], sweep_out["artifact"]
    deps = {}
    for proto, res in results.items():
        rec = deploy.select_record(res.records, protocol=proto,
                                   t_intg_ms=10.0)
        ckpt = ROOT / "build" / "chip_smoke" / f"ckpt_{proto}"
        deploy.deploy_from_sweep(res, p2m_dvs.CONFIG, rec, ckpt,
                                 meta={"dataset": "synthetic-gesture"})
        deps[proto] = deploy.load_deployment(ckpt, device="cuda",
                                             artifact=sweep_out["path"])
        print(f"[deploy] {proto}: {rec['label']} at {rec['t_intg_ms']:g} ms "
              f"(acc {rec['accuracy']:.3f}) -> {ckpt.relative_to(ROOT)}, "
              f"loaded against the artifact")
    dep = deps["frozen"]
    reports, launches = {}, {}
    for mode, counter in (("mac", "fold_mac"), ("deposit", "fold")):
        eng = StreamEngine(dep, capacity=N_LANES, fold_mode=mode,
                           device="cuda")
        rep, counts = serve_counted(torch, sf, eng, src, N_LANES)
        expected = len(rep.fold_s) + 1                # + the warm-up fold
        if len(rep.results) != N_LANES:
            fail(f"deploy {mode}: {len(rep.results)} of {N_LANES} streams")
        if not np.isfinite([r.logits for r in rep.results]).all():
            fail(f"deploy {mode}: non-finite logits")
        if counts[counter] != expected or sum(counts.values()) != expected:
            fail(f"deploy {mode}: launches {counts}, expected {expected} of "
                 f"{counter} and none of any other kernel")
        thr = rep.to_artifact()["throughput"]
        print(f"[deploy] frozen checkpoint, fold={mode}: {len(rep.results)} "
              f"streams, {thr['events_per_s']:.0f} events/s, wall "
              f"{rep.wall_s:.2f} s, launches {counts}")
        reports[mode], launches[counter] = rep, counts[counter]
    diff = check_logits([r.logits for r in reports["mac"].results],
                        [r.logits for r in reports["deposit"].results],
                        "deployed checkpoint fold=mac vs fold=deposit")
    served = reports["deposit"].to_artifact()
    served["data"] = {"dataset": "synthetic-gesture", "hw": HW,
                      "n_classes": src.n_classes, "duration_ms": STREAM_MS}
    path = ROOT / "build" / "chip_smoke" / "stream_serving_deployed.json"
    path.write_text(json.dumps(served, indent=2, default=float))
    gate = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "check_stream_stats.py"),
                           "--streams", str(N_LANES), str(path)],
                          capture_output=True, text=True, timeout=120)
    if gate.returncode != 0:
        fail(f"check_stream_stats on the deployed serve: {gate.stdout}"
             f"{gate.stderr}")
    print(f"[deploy] fold=mac vs deposit max |logit diff| {diff:.3g}; "
          f"{gate.stdout.strip()}")
    print(f"[deploy] main-path launches: {launches}")
    return launches


# [files]: the DVS128 fixture the port writes (fixture_user04 hashes to
# val), its sampling batch, and the replay guarantee of
# tests/test_streaming.py (online readout vs the offline forward)
FILES_RECORDINGS, FILES_TRIALS, FILES_B = 5, 4, 4
REPLAY_RTOL = REPLAY_ATOL = 1e-5
FILES_FREE_BYTES = 8 * 2 ** 30    # fixture + the 10 ms frame cache, ~2 GB


def dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def disk_free(path: Path) -> int:
    import shutil
    return shutil.disk_usage(path).free


def phase_files(torch, sf, pc, counters) -> dict:
    """File-backed data at full width (configs/p2m_dvs.CONFIG, 128×128):
    (1) ``make_dvs128_fixture`` writes 5 recordings × 4 trials of 2000 ms
    under build/; (2) ``DVSGestureSource(hw=128)`` train and val, one
    ``sample_batch`` at T_INTG 10 ms, n_sub 4, batch 4 cold (parse and
    bin) and warm (the frame cache), warm equal to cold, each sample's
    count equal to its AEDAT's events in its window; (3) the fast-grid
    sweep (both protocols, ``SWEEP_STEPS``) on the train split with
    ``resolve_eval_dataset``'s val source, no kernel launched, the
    artifact checked and its ``data`` block dvs128 / val; (4) the frozen
    10 ms record deployed, a val batch evaluated in kernel mode (K1) and
    scan mode; (5) 16 fixture recordings served through K3 and K2, every
    kernel counter zeroed just before and read just after each of (4)
    and (5), and stream 0's logits held to ``offline_forward`` on the
    ``bin_chunks`` frames of its recording. Returns the launches of K1,
    K2 and K3. The directory is removed at the end."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, sweep
    from repro_torch.data import binning, fixtures, formats, sources
    from repro_torch.stream import deploy
    from repro_torch.stream.engine import StreamEngine, stream_generator
    cfg = p2m_dvs.CONFIG
    n_sub, t_ms = cfg.p2m.n_sub, cfg.p2m.t_intg_ms
    hw = cfg.backbone.input_hw[0]
    base = ROOT / "build" / "chip_smoke"
    base.mkdir(parents=True, exist_ok=True)
    free = disk_free(base)
    if free < FILES_FREE_BYTES:
        fail(f"[files] needs {FILES_FREE_BYTES / 2 ** 30:.0f} GiB free under "
             f"{base}, has {free / 2 ** 30:.1f}")
    root = Path(tempfile.mkdtemp(prefix="files-", dir=base))
    launches = {}
    try:
        # 1. the fixture
        t0 = time.perf_counter()
        fixtures.make_dvs128_fixture(root, n_recordings=FILES_RECORDINGS,
                                     trials_per_recording=FILES_TRIALS)
        secs = time.perf_counter() - t0
        recordings = {}
        for f in sorted(root.glob("*.aedat")):
            recordings[f.name] = formats.concat_chunks(
                formats.read_aedat31(f))
            print(f"[files] {f.name}: {f.stat().st_size} bytes, "
                  f"{len(recordings[f.name])} events")
        print(f"[files] wrote {FILES_RECORDINGS} recordings x {FILES_TRIALS} "
              f"trials of 2000 ms ({dir_bytes(root)} bytes with the labels "
              f"CSVs, {sum(map(len, recordings.values()))} events) in "
              f"{secs:.1f} s")

        # 2. sampling, cold and warm
        train = sources.DVSGestureSource(root, hw=hw, split="train")
        val, split = sources.resolve_eval_dataset("dvs128", hw=hw,
                                                  data_root=str(root))
        if split != "val" or val is None:
            fail(f"[files] the val split is empty ({split})")
        print(f"[files] DVSGestureSource(hw={hw}): train "
              f"{len(train.samples)} samples, val {len(val.samples)} "
              f"({sorted({x.split_id for x in val.samples})})")
        n_total = train.n_slots(t_ms) * n_sub
        print(f"[files] one sample at T_INTG {t_ms:g} ms is [{n_total}, "
              f"{hw}, {hw}, 2] float32 = {n_total * hw * hw * 2 * 4} bytes "
              f"in the cache; {free} bytes free under build/")
        got = {}
        for when in ("cold", "warm"):
            t0 = time.perf_counter()
            got[when] = train.sample_batch(torch.Generator().manual_seed(0),
                                           FILES_B, t_ms, n_sub)
            got[when + "_ms"] = (time.perf_counter() - t0) * 1e3
        cache_bytes = dir_bytes(root / sources.CACHE_DIRNAME)
        (ev, labels), (ev_w, labels_w) = got["cold"], got["warm"]
        if not (torch.equal(ev, ev_w) and torch.equal(labels, labels_w)):
            fail("[files] warm frames differ from cold frames")
        idx = torch.randint(0, len(train.samples), (FILES_B,),
                            generator=torch.Generator().manual_seed(0))
        for b, i in enumerate(idx.tolist()):
            smp = train.samples[i]
            rec = recordings[smp.split_id]
            stop = min(smp.t1_us, smp.t0_us + n_total * binning.slot_us_for(
                t_ms, n_sub))
            want = int(((rec.t >= smp.t0_us) & (rec.t < stop)).sum())
            have = float(ev[b].double().sum())
            if have != want or int(labels[b]) != smp.label:
                fail(f"[files] sample {smp.sample_id}: {have} counted, its "
                     f"AEDAT holds {want} events in the window")
        del recordings
        print(f"[files] sample_batch(B={FILES_B}, T_INTG {t_ms:g} ms, n_sub "
              f"{n_sub}) {tuple(ev.shape)}: cold {got['cold_ms']:.1f} ms "
              f"(parse + bin + cache write), warm {got['warm_ms']:.1f} ms "
              f"(the cache), host clock; cache {cache_bytes} bytes on disk; "
              f"warm equal to cold; counts equal to the AEDAT windows "
              f"({float(ev.double().sum()):.0f} events)")

        # 3. the sweep on the files
        grid = sweep.fast_grid()
        scfg = codesign.SweepConfig(t_intg_grid_ms=grid.t_intg_grid_ms,
                                    dataset="dvs128", data_root=str(root),
                                    **SWEEP_STEPS)
        init = awake_init(codesign)
        zero(counters)
        t0 = time.perf_counter()
        try:
            results = sweep.run_protocols(
                train, cfg, scfg, grid, protocols=("frozen", "unfrozen"),
                eval_data=val, keep_params=True, device="cuda",
                log=lambda m: print(f"  {m}"))
        finally:
            codesign.model_init = init
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(read(counters).values()):
            fail(f"[files] the sweep launched kernels: {read(counters)}")
        print_sweep_cells("files", results, scfg)
        art = sweep.protocols_artifact(results, extra_meta={
            "wall_s": wall,
            "data": {"name": train.name, "dataset": "dvs128",
                     "data_root": str(root), "hw": train.height,
                     "n_classes": train.n_classes,
                     "duration_ms": train.duration_ms, "eval_split": split}})
        path = base / "codesign_grid_files.json"
        path.write_text(json.dumps(art, indent=2))
        art = json.loads(path.read_text())
        labels_g = list(results["frozen"].labels)
        check_sweep_artifact(art, labels_g, 12)
        if (art["data"]["dataset"], art["data"]["eval_split"],
                art["data"]["n_classes"]) != ("dvs128", "val", 11):
            fail(f"[files] sweep artifact data block {art['data']}")
        for r in art["records"]:
            print(f"[files] {r['protocol']:8s} {r['label']:9s} "
                  f"{r['t_intg_ms']:6g} ms: acc {r['accuracy']:.3f} bw "
                  f"{r['bandwidth_norm']:.3f}x energy "
                  f"{r['energy_improvement']:.3f}x input events "
                  f"{r['input_events']:.0f}")
        print(f"[files] sweep artifact {path.relative_to(ROOT)}: 12 records "
              f"checked, data {art['data']['dataset']} / eval split "
              f"{art['data']['eval_split']}; wall {wall:.1f} s, no kernel "
              f"launched")

        # 4. the deployed 10 ms record's physics eval on a val batch
        rec = deploy.select_record(results["frozen"].records,
                                   protocol="frozen", t_intg_ms=t_ms)
        ckpt = base / "ckpt_files"
        deploy.deploy_from_sweep(results["frozen"], cfg, rec, ckpt,
                                 meta={"dataset": "dvs128",
                                       "sensor_hw": list(train.sensor_hw)})
        dep = deploy.load_deployment(ckpt, device="cuda", artifact=path)
        del results
        ev_v, lab_v = val._gather(list(range(FILES_B)), t_ms, n_sub)
        evals = {}
        for mode in ("kernel", "scan"):
            fn = codesign.make_eval_fn(with_mode(dep.model_cfg, mode),
                                       device="cuda")
            fn(dep.params, dep.bn_state, ev_v, lab_v)  # allocator, cuDNN
            zero(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, aux = fn(dep.params, dep.bn_state, ev_v, lab_v)
            torch.cuda.synchronize()
            evals[mode] = (metrics, aux, time.perf_counter() - t0,
                           read(counters))
        (mk, ak, wk, ck), (ms, as_, ws, cs) = evals["kernel"], evals["scan"]
        for key in ("spikes/p2m", "events/in", "macs/p2m"):
            if float(ak[key]) != float(as_[key]):
                fail(f"[files] eval aux {key} kernel {float(ak[key])} vs "
                     f"scan {float(as_[key])}")
        diff = check_logits(mk["logits"].cpu().numpy(),
                            ms["logits"].cpu().numpy(),
                            "[files] val batch kernel vs scan")
        if ck.get("p2m_conv") != 1 or sum(ck.values()) != 1 \
                or any(cs.values()):
            fail(f"[files] eval launches kernel {ck}, scan {cs}: expected "
                 f"one p2m_conv in kernel mode and none in scan mode")
        launches["p2m_conv"] = ck["p2m_conv"]
        print(f"[files] {rec['label']} at {t_ms:g} ms (acc "
              f"{rec['accuracy']:.3f}) on {FILES_B} val windows "
              f"{tuple(ev_v.shape)}: kernel {wk * 1e3:.1f} ms, scan "
              f"{ws * 1e3:.1f} ms, spikes/p2m {float(ak['spikes/p2m']):.0f} "
              f"equal, max |logit diff| {diff:.3g}, launches {ck}")

        # 5. serving fixture recordings through K3 and K2
        src_all = sources.resolve_dataset("dvs128", hw=hw,
                                          data_root=str(root), split="all")
        n_rec = len(src_all.samples)
        reports = {}
        for mode, counter in (("mac", "fold_mac"), ("deposit", "fold")):
            eng = StreamEngine(dep, capacity=N_LANES, fold_mode=mode,
                               device="cuda")
            src = Prerecorded(src_all, N_LANES, 0, eng.chunk_us, eng.slot_us,
                              stream_generator, index=lambda i: i % n_rec)
            rep, counts = serve_counted(torch, sf, eng, src, N_LANES)
            expected = expected_fold_launches(rep, eng.chunks_per_window)
            if len(rep.results) != N_LANES:
                fail(f"[files] {mode}: {len(rep.results)} of {N_LANES} "
                     f"streams finished")
            if counts[counter] != expected or \
                    sum(counts.values()) != expected:
                fail(f"[files] {mode}: launches {counts}, expected "
                     f"{expected} of {counter} and none of any other")
            gate = stats_gate(rep.to_artifact(), f"stream_serving_files_"
                              f"{mode}.json", N_LANES, src_all, "dvs128")
            print(f"[files] fold={mode}: {len(rep.results)} fixture "
                  f"recordings, {rep.total_events} events, "
                  f"{serve_line(rep)}, launches {counts}; {gate}")
            launches[counter] = counts[counter]
            reports[mode] = rep
        diff = check_logits(
            [r.logits for r in sorted(reports["mac"].results,
                                      key=lambda r: r.stream_id)],
            [r.logits for r in sorted(reports["deposit"].results,
                                      key=lambda r: r.stream_id)],
            "[files] fold=mac vs deposit")
        n_slots = src_all.n_slots(t_ms)
        frames = binning.bin_chunks(
            [src_all.sample_events(0)], n_total=n_slots * n_sub,
            slot_us=binning.slot_us_for(t_ms, n_sub),
            sensor_hw=src_all.sensor_hw, out_hw=(hw, hw))
        off = deploy.offline_forward(dep, torch.from_numpy(frames.reshape(
            1, n_slots, n_sub, hw, hw, 2)))["logits"][0].cpu().numpy()
        for mode, rep in reports.items():
            r = next(x for x in rep.results if x.stream_id == 0)
            got = np.asarray(r.logits)
            err = np.abs(got - off) - REPLAY_RTOL * np.abs(off)
            if (err > REPLAY_ATOL).any() or r.prediction != int(
                    np.argmax(off)) or r.n_readouts != n_slots \
                    or r.label != src_all.samples[0].label:
                fail(f"[files] fold={mode}: stream 0 online vs offline "
                     f"forward: max |diff| {np.abs(got - off).max()}, "
                     f"prediction {r.prediction} vs {int(np.argmax(off))}, "
                     f"{r.n_readouts} readouts")
            print(f"[files] fold={mode}: stream 0 "
                  f"({src_all.samples[0].sample_id}) online vs "
                  f"offline_forward on bin_chunks "
                  f"frames: max |logit diff| {np.abs(got - off).max():.3g} "
                  f"(rtol {REPLAY_RTOL:g}, atol {REPLAY_ATOL:g}), "
                  f"{r.n_readouts} readouts, prediction {r.prediction}")
        print(f"[files] fold=mac vs deposit max |logit diff| {diff:.3g}; "
              f"main-path launches {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_sweep_parity(torch) -> None:
    """The fast-grid sweep (both protocols) at reduced() on cuda and on the
    CPU from the same seeded initial params and generator: accuracy,
    spike counts and labels equal; bandwidth, sensor energy and retention
    within SWEEP_RTOL; backend energies within COUNTER_RTOL, and within
    SWEEP_RTOL (accuracy and spikes equal) when both devices evaluate the
    CPU's trained params on one batch at 10 ms. Trained params as
    tests/sweep_parity.py holds them: within TRAIN_RTOL of each leaf's
    largest magnitude, but for the elements whose gradient is as small as
    its roundoff (exact zeros under train-mode BN, measured from the CPU
    run's constant channels, and the elements two more sound CPU runs
    move), which Adam steps by about lr either way and are held to 2·lr
    a step, at most MAX_MASKED_SHARE of all elements. Then three
    planted faults on the card, each with the same batches, must fail the
    params check, and their backend energies must read above
    COUNTER_RTOL in both protocols: every update dropped (the state left
    as pretrained), the warm-up step's update dropped, the last finetune
    step's update dropped."""
    sys.path.insert(0, str(ROOT / "tests"))
    import sweep_parity as parity
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, sweep
    from repro_torch.stream.deploy import tree_to
    cfg, data = p2m_dvs.reduced()
    grid = sweep.fast_grid()
    scfg = codesign.SweepConfig(t_intg_grid_ms=grid.t_intg_grid_ms,
                                batch_size=2, pretrain_steps=2,
                                finetune_steps=2, eval_batches=1)
    steps = scfg.pretrain_steps + 1 + scfg.finetune_steps

    def run(device, source=data):
        return sweep.run_protocols(source, cfg, scfg, grid, device=device,
                                   keep_params=True, log=lambda *_: None)

    init = awake_init(codesign)
    try:
        cpu, masks = parity.cpu_reference(lambda src: run("cpu", src), data,
                                          n_pre=scfg.pretrain_steps,
                                          steps=1 + scfg.finetune_steps,
                                          rtol=TRAIN_RTOL)
        runs = {"cuda": run("cuda"), "cpu": cpu}
        controls = {}
        for name, calls in (("every update dropped", None),
                            ("warm-up update dropped", [0]),
                            ("last finetune update dropped",
                             [scfg.finetune_steps])):
            with parity.skip_updates(calls):
                controls[name] = run("cuda")
    finally:
        codesign.model_init = init
    worst = {"records": 0.0, "counters": 0.0}
    for proto in ("frozen", "unfrozen"):
        rc, rp = runs["cuda"][proto], runs["cpu"][proto]
        for a, b in zip(rc.records, rp.records):
            what = f"{proto} {b['label']} {b['t_intg_ms']:g} ms"
            for k in ("label", "variant", "accuracy", "layer1_spikes",
                      "input_events"):
                if a[k] != b[k]:
                    fail(f"sweep parity {what}: {k} cuda {a[k]} vs cpu "
                         f"{b[k]}")
            for k, lim, slot in (
                    ("bandwidth_ratio", SWEEP_RTOL, "records"),
                    ("sensor_energy_p2m_j", SWEEP_RTOL, "records"),
                    ("retention_err_v", SWEEP_RTOL, "records"),
                    ("backend_energy_conventional_j", parity.COUNTER_RTOL,
                     "counters"),
                    ("backend_energy_p2m_j", parity.COUNTER_RTOL,
                     "counters")):
                rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                worst[slot] = max(worst[slot], rel)
                if not rel <= lim:
                    fail(f"sweep parity {what}: {k} cuda {a[k]} vs cpu "
                         f"{b[k]} ({rel:.3g} > {lim:g})")
    par = parity.compare_runs(runs["cuda"], cpu, masks, lr=scfg.lr,
                              steps=steps, rtol=TRAIN_RTOL)
    if par.failures:
        fail("sweep parity params: " + "; ".join(par.failures[:5]))
    for name, res in controls.items():
        ctl = parity.compare_runs(res, cpu, masks, lr=scfg.lr, steps=steps,
                                  rtol=TRAIN_RTOL)
        reading = parity.energy_reading(res, cpu)
        print(f"[sweep parity] control, {name}: params check fails "
              f"({len(ctl.failures)} leaves, e.g. {ctl.failures[:1]}); "
              f"backend energies max rel diff "
              + ", ".join(f"{p} {r:.3g}" for p, r in reading.items())
              + f" (limit {parity.COUNTER_RTOL:g})")
        if not ctl.failures:
            fail(f"sweep parity control '{name}' passed the params check")
        if not min(reading.values()) > parity.COUNTER_RTOL:
            fail(f"sweep parity control '{name}': backend energies within "
                 f"COUNTER_RTOL {parity.COUNTER_RTOL:g} ({reading})")
    # one eval of the same trained params on both devices
    from dataclasses import replace
    from repro_torch.core import energy
    from repro_torch.data import events as ev_mod
    from repro_torch.kernels import backend
    ev, lab = ev_mod.sample_batch(torch.Generator().manual_seed(5), data, 2,
                                  10.0, cfg.p2m.n_sub)
    cfg_t = replace(cfg, p2m=replace(cfg.p2m, t_intg_ms=10.0))
    lcs = sweep.expand_leak_configs(grid, cfg.p2m.leak)
    for proto in ("frozen", "unfrozen"):
        fp = runs["cpu"][proto].final_params[(10.0, cfg.p2m.n_sub)]
        outs = {}
        for d in ("cuda", "cpu"):
            t = tree_to(fp, backend.resolve_device(d))
            m, aux, l1 = sweep.make_batched_eval(cfg_t, lcs, proto, device=d)(
                t["p2m"], t["backbone"], t["state"], ev, lab)
            macs = float(l1["macs/p2m"])
            outs[d] = [(float(m["acc"][g]), float(l1["spikes/p2m"][g]),
                        energy.backend_energy_p2m(
                            {k: float(aux[k][g]) for k in sorted(aux)},
                            float(l1["spikes/p2m"][g]), macs),
                        energy.backend_energy_conventional(
                            {k: float(aux[k][g]) for k in sorted(aux)}, macs))
                       for g in range(len(lcs))]
        for (ac, sc, pc, cc), (ap, sp, pp, cp) in zip(outs["cuda"],
                                                      outs["cpu"]):
            if (ac, sc) != (ap, sp):
                fail(f"sweep parity eval {proto}: acc/spikes cuda "
                     f"{(ac, sc)} vs cpu {(ap, sp)}")
            for a, b in ((pc, pp), (cc, cp)):
                rel = abs(a - b) / max(abs(b), 1e-30)
                worst["eval"] = max(worst.get("eval", 0.0), rel)
                if not rel <= SWEEP_RTOL:
                    fail(f"sweep parity eval {proto}: energy cuda {a} vs "
                         f"cpu {b}")
    print(f"[sweep parity] one eval of the CPU's trained params at 10 ms "
          f"on both devices: accuracy and spikes equal, energies max rel "
          f"diff {worst['eval']:.3g} (limit {SWEEP_RTOL:g})")
    print(f"[sweep parity] reduced(), fast grid, both protocols, cuda vs "
          f"cpu: accuracy, spikes and labels equal; bandwidth/sensor "
          f"energy/retention max rel diff {worst['records']:.3g} (limit "
          f"{SWEEP_RTOL:g}), backend energies {worst['counters']:.3g} "
          f"(limit {parity.COUNTER_RTOL:g}), {par.summary()}")


# benchmarks/stream_adapt.py's injected drift: the nullifier's residual
# mismatch grows ~6x and every filter's tau spreads log-normally
ADAPT_DRIFT = {"null_mismatch": 0.35, "sigma": 0.3}
# [adapt parity]: dw / dtheta on cuda vs the CPU, of the largest element
# (the gradient pass runs cuDNN's convolutions against the CPU's)
ADAPT_RTOL = 1e-4
SWAP_WINDOW = 6           # [registry] hot-swap: b retired, b2 registered
ONLY: set = set()         # --only: the phases of registry_and_adapt to run


def expected_fold_launches(report, chunks_per_window: int) -> int:
    """One fold launch per served entry per chunk (the distinct entries
    bound to an active lane in each window), + the warm-up's one."""
    windows: dict[int, set] = {}
    for r in report.results:
        for w in range(r.admitted_window, r.finished_window):
            windows.setdefault(w, set()).add((r.entry, r.entry_uid))
    return chunks_per_window * sum(map(len, windows.values())) + 1


def stats_gate(art: dict, name: str, n_streams: int, src,
               dataset: str = "synthetic-gesture") -> str:
    """Write ``art`` under build/chip_smoke/ and pass it through
    tools/check_stream_stats.py; its summary line."""
    art["data"] = {"dataset": dataset, "hw": src.height,
                   "n_classes": src.n_classes,
                   "duration_ms": src.duration_ms}
    path = ROOT / "build" / "chip_smoke" / name
    path.write_text(json.dumps(art, indent=2, default=float))
    gate = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "check_stream_stats.py"),
                           "--streams", str(n_streams), str(path)],
                          capture_output=True, text=True, timeout=120)
    if gate.returncode != 0:
        fail(f"check_stream_stats on {name}: {gate.stdout}{gate.stderr}")
    return gate.stdout.strip()


def circuit_deployments(torch, cfg, device: str, seeds: dict) -> dict:
    """Fresh seeded (``awake``) deployments of ``cfg``, one per paper
    circuit named in ``seeds`` (c at mismatch 0.06), each leak set through
    ``leak_config_from_variant``: compat-equal, so one registry co-serves
    them."""
    from dataclasses import replace
    from repro_torch.stream import deploy
    out = {}
    for name, (circuit, seed) in seeds.items():
        leak = deploy.leak_config_from_variant(
            {"circuit": circuit, "null_mismatch": 0.06,
             "v_threshold": cfg.p2m.v_threshold, "sigma": 0.0},
            cfg.p2m.leak)
        d = deploy.fresh_deployment(replace(cfg, p2m=replace(cfg.p2m,
                                                              leak=leak)),
                                    seed=seed, device=device)
        awake(d.params)
        out[name] = d
    return out


def serve_line(rep) -> str:
    art = rep.to_artifact()
    lat, thr = art["latency_ms"], art["throughput"]
    return (f"{thr['events_per_s']:.0f} events/s, readout p50 "
            f"{lat['readout_p50']:.3f} ms p99 {lat['readout_p99']:.3f} ms, "
            f"wall {rep.wall_s:.2f} s")


def check_bit_identical(rep, singles: dict, what: str) -> int:
    """Every stream of ``rep`` bit-identical to the single-variant serve
    of its entry (``singles``: entry name → report); the count checked."""
    import numpy as np
    by = {n: {r.stream_id: r for r in s.results} for n, s in singles.items()}
    n = 0
    for r in rep.results:
        if r.entry not in by:
            continue
        want = by[r.entry][r.stream_id]
        if not np.array_equal(np.asarray(r.logits), np.asarray(want.logits)):
            fail(f"{what}: stream {r.stream_id} on {r.entry} differs from "
                 f"its single-variant serve by "
                 f"{np.abs(np.subtract(r.logits, want.logits)).max()}")
        n += 1
    return n


def phase_registry(torch, sf, dep_c, src, singles_c: dict) -> dict:
    """Multi-variant serving at full width: circuits a and b (fresh,
    seeded) beside the [slice] deployment (circuit c at mismatch 0.06) in
    one registry; the 16 recorded streams requested round-robin a/b/c on
    16 lanes, once through K2 and once through K3, counters zeroed before
    and read after each serve (one launch per served entry per chunk);
    every stream bit-identical to the single-variant serve of its entry
    (c's are the [slice] serves); a hot-swap (b retired, b2 registered at
    window SWAP_WINDOW while the streams trickle in one a window) leaving
    every other lane bit-identical; EntryTableFull rejections at
    max_entries=2; the artifacts through tools/check_stream_stats.py."""
    import numpy as np
    from repro_torch.configs import p2m_dvs
    from repro_torch.stream.engine import StreamEngine
    from repro_torch.stream.registry import Registry
    deps = {**circuit_deployments(torch, p2m_dvs.CONFIG, "cuda",
                                  {"a": ("a", 1), "b": ("b", 2)}),
            "c": dep_c}
    names = ("a", "b", "c")
    variants = [names[i % 3] for i in range(N_LANES)]
    counters = {"deposit": "fold", "mac": "fold_mac"}
    singles = {"deposit": {"c": singles_c["deposit"]},
               "mac": {"c": singles_c["mac"]}}
    out = {}
    for mode, counter in counters.items():
        for name in ("a", "b"):
            eng = StreamEngine(deps[name], capacity=N_LANES, fold_mode=mode,
                               device="cuda")
            singles[mode][name] = serve_counted(torch, sf, eng, src,
                                                N_LANES)[0]
        reg = Registry()
        for name in names:
            reg.register(name, deps[name])
        eng = StreamEngine(reg, capacity=N_LANES, fold_mode=mode,
                           device="cuda")
        zero((sf.LAUNCHES,))
        rep = eng.serve(src.replay(), N_LANES, seed=0, variants=variants)
        torch.cuda.synchronize()
        counts = dict(sf.LAUNCHES)
        expected = expected_fold_launches(rep, eng.chunks_per_window)
        if counts[counter] != expected or sum(counts.values()) != expected:
            fail(f"registry {mode}: launches {counts}, expected {expected} "
                 f"of {counter} (chunks x served entries + the warm-up) "
                 f"and none of any other kernel")
        if len(rep.results) != N_LANES or not np.isfinite(
                [r.logits for r in rep.results]).all():
            fail(f"registry {mode}: {len(rep.results)} of {N_LANES} "
                 f"streams, or non-finite logits")
        n = check_bit_identical(rep, singles[mode], f"registry {mode}")
        vac = float(np.abs([r.logits for r in rep.results]).max())
        if not vac > 0.05:
            fail(f"registry {mode}: the heads never spiked (max |logit| "
                 f"{vac}), the comparison would be vacuous")
        print(f"[registry] fold={mode}, 3 entries round-robin on "
              f"{N_LANES} lanes: {serve_line(rep)}, launches {counts} "
              f"(expected {expected}); {n} streams bit-identical to their "
              f"entry's single-variant serve")
        for name in names:
            print(f"[registry]   single {name} fold={mode}: "
                  f"{serve_line(singles[mode][name])}")
        out[mode] = (rep, counts[counter])
    gate = stats_gate(out["deposit"][0].to_artifact(),
                      "stream_serving_registry.json", N_LANES, src)
    print(f"[registry] mixed artifact: {gate}")

    # hot-swap mid-serve, through K2
    reg = Registry()
    for name in names:
        reg.register(name, deps[name])
    b2 = circuit_deployments(torch, p2m_dvs.CONFIG, "cuda",
                             {"b2": ("b", 3)})["b2"]

    def swap(window):
        if window == SWAP_WINDOW and "b" in reg:
            reg.retire("b")
            reg.register("b2", b2)

    def request(sid):
        n = names[sid % 3]
        return "b2" if n == "b" and sid >= SWAP_WINDOW else n

    eng = StreamEngine(reg, capacity=N_LANES, device="cuda")
    zero((sf.LAUNCHES,))
    rep = eng.serve(src.replay(), N_LANES, seed=0, variants=request,
                    on_window=swap,
                    offered_rate=1e3 / p2m_dvs.CONFIG.p2m.t_intg_ms)
    torch.cuda.synchronize()
    expected = expected_fold_launches(rep, eng.chunks_per_window)
    if sf.LAUNCHES["fold"] != expected:
        fail(f"hot-swap: {dict(sf.LAUNCHES)} launches, expected {expected}")
    bound = {r.stream_id: r.entry for r in rep.results}
    want = {sid: request(sid) for sid in range(N_LANES)}
    if bound != want:
        fail(f"hot-swap: bindings {bound}, expected {want}")
    n = check_bit_identical(rep, singles["deposit"], "hot-swap")
    rows = {e["name"]: e["n_finished"]
            for e in rep.to_artifact()["registry"]["entries"]}
    print(f"[registry] hot-swap at window {SWAP_WINDOW} (b retired, b2 "
          f"registered; one stream offered a window): {serve_line(rep)}; "
          f"finished per entry {rows}; {n} streams on a, b and c "
          f"bit-identical to their single-variant serves, launches "
          f"{sf.LAUNCHES['fold']}")

    # a full entry table rejects at admission
    reg = Registry()
    for name in ("a", "b"):
        reg.register(name, deps[name])

    def add_c(window):
        if window == 0 and "c" not in reg:
            reg.register("c", deps["c"])

    msgs: list[str] = []
    eng = StreamEngine(reg, capacity=N_LANES, max_entries=2, device="cuda")
    rep = eng.serve(src.replay(), N_LANES, seed=0, variants=variants,
                    on_window=add_c, log=msgs.append)
    full = [m for m in msgs if "entry slots have resident lanes" in m]
    art = rep.to_artifact()
    n_c = variants.count("c")
    if art["admission"]["n_rejected"] != n_c or len(full) != n_c:
        fail(f"max_entries=2: {art['admission']['n_rejected']} rejected, "
             f"{len(full)} for a full table; expected {n_c}")
    check_bit_identical(rep, singles["deposit"], "max_entries=2")
    gate = stats_gate(art, "stream_serving_registry_full.json",
                      len(rep.results), src)
    print(f"[registry] max_entries=2 with a, b resident: "
          f"{art['admission']['n_rejected']} requests for c rejected "
          f"(EntryTableFull), in the artifact's admission block; {gate}")
    return {mode: launches for mode, (_, launches) in out.items()}


def window_ms(rep, chunks_per_window: int) -> tuple[float, float, float]:
    """Host-clock ms a window: the window's folds (enqueued), its readout
    (which ends in the window's one synchronisation), and their sum."""
    import numpy as np
    folds = np.add.reduceat(np.asarray(rep.fold_s),
                            np.arange(0, len(rep.fold_s), chunks_per_window))
    reads = np.asarray(rep.readout_s)
    return (float(folds.mean() * 1e3), float(reads.mean() * 1e3),
            float((folds + reads).mean() * 1e3))


def phase_adapt(torch, sf, dep_c, src) -> None:
    """Per-lane adaptation at full width: the [slice] deployment under
    benchmarks/stream_adapt.py's leak drift, surrogate rule, lr_w 1.0, the
    16 recorded (labeled) streams on 16 lanes, beside the frozen engine on
    the same drift (K2): ms a window, peak memory, updates on every lane;
    then the lane with the most updates harvested, saved, loaded against
    its base, applied, registered beside the base and served frozen through
    K3 and K2 (counters zeroed before and read after). The adaptation
    artifact through tools/check_stream_stats.py; fold_mode='mac' with
    adapt raises."""
    from dataclasses import replace
    import numpy as np
    from repro_torch.stream import deploy
    from repro_torch.stream.adapt import AdaptConfig
    from repro_torch.stream.engine import StreamEngine
    from repro_torch.stream.registry import Registry
    cfg = dep_c.model_cfg
    drifted = replace(dep_c, model_cfg=replace(cfg, p2m=replace(
        cfg.p2m, leak=replace(cfg.p2m.leak, **ADAPT_DRIFT))))
    try:
        StreamEngine(drifted, capacity=N_LANES, fold_mode="mac",
                     adapt=AdaptConfig(), device="cuda")
    except ValueError as e:
        print(f"[adapt] fold_mode='mac' with adapt refused: {e}")
    else:
        fail("fold_mode='mac' with adapt did not raise")
    runs = {}
    for name, kw in (("frozen", {}),
                     ("adapt", {"adapt": AdaptConfig(rule="surrogate",
                                                     lr_w=1.0)})):
        eng = StreamEngine(drifted, capacity=N_LANES, device="cuda", **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero((sf.LAUNCHES,))
        rep = eng.serve(src.replay(), N_LANES, seed=0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = dict(sf.LAUNCHES)
        want = len(rep.fold_s) + 1 if name == "frozen" else 0
        if counts["fold"] != want or sum(counts.values()) != want:
            fail(f"adapt {name}: launches {counts}, expected {want} of "
                 f"fold (the adapting engine runs its own per-lane fold)")
        if len(rep.results) != N_LANES or not np.isfinite(
                [r.logits for r in rep.results]).all():
            fail(f"adapt {name}: {len(rep.results)} streams or non-finite "
                 f"logits")
        f_ms, r_ms, w_ms = window_ms(rep, eng.chunks_per_window)
        art = rep.to_artifact()
        print(f"[adapt] {name} on the drift {ADAPT_DRIFT}: "
              f"{serve_line(rep)}; ms a window: folds {f_ms:.3f} + readout "
              f"{r_ms:.3f} = {w_ms:.3f} (readout p99 "
              f"{art['latency_ms']['readout_p99']:.3f}); peak "
              f"{peak:.2f} GiB; accuracy {rep.accuracy:.3f}; launches "
              f"{counts}")
        runs[name] = (eng, rep)
    eng, rep = runs["adapt"]
    n_upd = eng.adapt_state["n_updates"].cpu().numpy()
    labeled = np.array([r.label >= 0 for r in rep.results])
    if not labeled.all() or (n_upd[:N_LANES] <= 0).any():
        fail(f"adapt: updates per lane {n_upd.tolist()} (every lane serves "
             f"a labeled stream and must update)")
    art = rep.to_artifact()
    gate = stats_gate(art, "stream_serving_adapt.json", N_LANES, src)
    if "adapting (surrogate)" not in gate:
        fail(f"adapt: the stats gate saw no live adaptation block: {gate}")
    ad = art["adaptation"]
    print(f"[adapt] {ad['n_updates']} updates on {len(ad['lanes'])} lanes, "
          f"|dw| {min(r['dw_norm'] for r in ad['lanes']):.3g}-"
          f"{max(r['dw_norm'] for r in ad['lanes']):.3g}, accuracy first "
          f"half {ad['accuracy_pre']} second {ad['accuracy_post']}; {gate}")

    # close the loop: harvest -> delta checkpoint -> re-serve through K3/K2
    lane = int(np.argmax(n_upd))
    h = eng.harvest(lane)
    d = ROOT / "build" / "chip_smoke" / "adapt_delta"
    deploy.save_adapt_delta(d, h["base"], dw=h["dw"], dtheta=h["dtheta"],
                            base_name=h["base_name"],
                            base_uid=h["base_uid"], lane=lane,
                            n_updates=h["n_updates"], rule="surrogate")
    delta = deploy.load_adapt_delta(d, drifted, expect_uid=h["base_uid"])
    adapted = deploy.apply_adapt_delta(drifted, delta)
    reg = Registry()
    reg.register("base", drifted)
    reg.register("base+adapt", adapted)
    reports = {}
    for mode, counter in (("mac", "fold_mac"), ("deposit", "fold")):
        eng2 = StreamEngine(reg, capacity=N_LANES, fold_mode=mode,
                            default_entry="base+adapt", device="cuda")
        zero((sf.LAUNCHES,))
        r2 = eng2.serve(src.replay(), N_LANES, seed=0)
        torch.cuda.synchronize()
        counts = dict(sf.LAUNCHES)
        expected = expected_fold_launches(r2, eng2.chunks_per_window)
        if counts[counter] != expected or sum(counts.values()) != expected:
            fail(f"re-serve {mode}: launches {counts}, expected {expected}")
        if {r.entry for r in r2.results} != {"base+adapt"}:
            fail(f"re-serve {mode}: bindings {[r.entry for r in r2.results]}")
        print(f"[adapt] harvested lane {lane} ({h['n_updates']} updates, "
              f"|dw| {np.linalg.norm(h['dw']):.3g}, dtheta "
              f"{h['dtheta']:.3g}) -> delta checkpoint -> applied -> "
              f"registered beside its base, fold={mode}: {serve_line(r2)}, "
              f"accuracy {r2.accuracy:.3f}, launches {counts}")
        reports[mode] = r2
    diff = check_logits([r.logits for r in reports["mac"].results],
                        [r.logits for r in reports["deposit"].results],
                        "adapted entry fold=mac vs fold=deposit")
    print(f"[adapt] adapted entry fold=mac vs deposit max |logit diff| "
          f"{diff:.3g}")


def phase_registry_parity(torch) -> None:
    """reduced(): the three circuits in one registry, 16 streams requested
    round-robin with one unknown name, on cuda and on the CPU from the
    same recordings: logits within LOGIT_ATOL, predictions (where the
    top-two gap exceeds GAP), bindings and rejections equal."""
    from repro_torch.configs import p2m_dvs
    from repro_torch.data import sources
    from repro_torch.stream.engine import StreamEngine, stream_generator
    from repro_torch.stream.registry import Registry
    rcfg, rdata = p2m_dvs.reduced()
    variants = [("a", "b", "c")[i % 3] for i in range(N_LANES)]
    variants[4] = "nope"
    runs = {}
    for device in ("cuda", "cpu"):
        deps = circuit_deployments(torch, rcfg, device, {
            "a": ("a", 1), "b": ("b", 2), "c": ("c", 0)})
        reg = Registry()
        for name, d in deps.items():
            reg.register(name, d)
        eng = StreamEngine(reg, capacity=8, device=device)
        rsrc = Prerecorded(sources.resolve_dataset(
            "synthetic-gesture", hw=rcfg.backbone.input_hw[0],
            duration_ms=rdata.duration_ms), N_LANES, 1, eng.chunk_us,
            eng.slot_us, stream_generator)
        runs[device] = eng.serve(rsrc.replay(), N_LANES, seed=1,
                                 variants=variants)
    by = {dv: sorted(r.results, key=lambda x: x.stream_id)
          for dv, r in runs.items()}
    bindings = {dv: [(r.stream_id, r.entry) for r in rs]
                for dv, rs in by.items()}
    if bindings["cuda"] != bindings["cpu"]:
        fail("registry parity: bindings differ between cuda and cpu")
    if not runs["cuda"].n_rejected == runs["cpu"].n_rejected == 1:
        fail(f"registry parity: rejections {runs['cuda'].n_rejected} vs "
             f"{runs['cpu'].n_rejected}, expected 1")
    diff = check_logits([r.logits for r in by["cuda"]],
                        [r.logits for r in by["cpu"]],
                        "registry cuda vs cpu")
    print(f"[registry parity] reduced(): 3 entries, {N_LANES} requests (1 "
          f"rejected) on 8 lanes, cuda vs cpu max |logit diff| {diff:.3g}, "
          f"predictions {[r.prediction for r in by['cuda']]}")


def phase_adapt_parity(torch) -> None:
    """reduced(): surrogate adaptation (lr_w 1.0, lr_theta 0.01) of 16
    streams on 8 lanes on cuda and on the CPU: update counts equal; dw and
    dtheta within ADAPT_RTOL of their largest element; logits within
    LOGIT_ATOL. Then on the card, lr 0 against the frozen K2 serve: logits
    within LOGIT_ATOL, predictions equal, the gap printed."""
    import numpy as np
    from repro_torch.configs import p2m_dvs
    from repro_torch.data import sources
    from repro_torch.stream.adapt import AdaptConfig
    from repro_torch.stream.engine import StreamEngine, stream_generator
    rcfg, rdata = p2m_dvs.reduced()

    def serve(device, adapt):
        dep = circuit_deployments(torch, rcfg, device,
                                  {"c": ("c", 0)})["c"]
        eng = StreamEngine(dep, capacity=8, device=device, adapt=adapt)
        rsrc = Prerecorded(sources.resolve_dataset(
            "synthetic-gesture", hw=rcfg.backbone.input_hw[0],
            duration_ms=rdata.duration_ms), N_LANES, 1, eng.chunk_us,
            eng.slot_us, stream_generator)
        rep = eng.serve(rsrc.replay(), N_LANES, seed=1)
        st = ({k: v.cpu().numpy() for k, v in eng.adapt_state.items()}
              if adapt is not None else None)
        return sorted(rep.results, key=lambda r: r.stream_id), st

    cfg = AdaptConfig(rule="surrogate", lr_w=1.0, lr_theta=0.01)
    (cres, cst), (pres, pst) = serve("cuda", cfg), serve("cpu", cfg)
    if not (cst["n_updates"] == pst["n_updates"]).all() or \
            pst["n_updates"].min() <= 0:
        fail(f"adapt parity: updates {cst['n_updates'].tolist()} vs "
             f"{pst['n_updates'].tolist()}")
    errs = {}
    for key in ("dw", "dtheta"):
        scale = float(np.abs(pst[key]).max())
        errs[key] = float(np.abs(cst[key] - pst[key]).max()) / scale
        if not (scale > 0 and errs[key] <= ADAPT_RTOL):
            fail(f"adapt parity: {key} differs by {errs[key]:.3g} of its "
                 f"largest ({scale:.3g}) > {ADAPT_RTOL}")
    diff = check_logits([r.logits for r in cres], [r.logits for r in pres],
                        "adapt cuda vs cpu")
    off, _ = serve("cuda", AdaptConfig(lr_w=0.0))
    frozen, _ = serve("cuda", None)
    gap = check_logits([r.logits for r in off], [r.logits for r in frozen],
                       "adapt lr 0 vs frozen K2 on the card")
    if [r.prediction for r in off] != [r.prediction for r in frozen]:
        fail("adapt lr 0 vs frozen on the card: predictions differ")
    print(f"[adapt parity] reduced(): {int(pst['n_updates'].sum())} updates "
          f"on 8 lanes, cuda vs cpu: dw {errs['dw']:.3g}, dtheta "
          f"{errs['dtheta']:.3g} of their largest (limit {ADAPT_RTOL}), "
          f"max |logit diff| {diff:.3g}; on the card lr 0 (per-lane tap-sum "
          f"fold) vs frozen (K2): max |logit diff| {gap:.3g}, predictions "
          f"equal")


# [shard]: the sweep's record fields that are host-clock times
SWEEP_TIMING = {"train_time_s", "train_time_per_step_s", "train_time_norm"}


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms for a comparison of two runs that
    differentiate: its default backward algorithms may sum with atomics,
    so two unsharded runs could differ in their last bits."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det


def shard_places(n: int) -> tuple[str, ...]:
    """``n`` shards on the one card: the split, the padding and the
    per-shard launches of a lane or variant mesh, with no multi-card
    speed to show."""
    return ("cuda:0",) * n


def same_streams(got, want, what: str) -> None:
    """Every stream of ``got`` equal to ``want``'s: labels, predictions,
    counters, entries, logits bit-identical; and the ledgers equal."""
    import numpy as np
    a = sorted(want.results, key=lambda r: r.stream_id)
    b = sorted(got.results, key=lambda r: r.stream_id)
    if len(a) != len(b):
        fail(f"{what}: {len(b)} streams finished, expected {len(a)}")
    worst, top = 0.0, 0.0
    for x, y in zip(a, b):
        for f in ("label", "prediction", "n_events", "n_readouts",
                  "n_coarse_frames", "admitted_window", "finished_window",
                  "entry", "entry_uid"):
            if getattr(x, f) != getattr(y, f):
                fail(f"{what}: stream {x.stream_id} {f} "
                     f"{getattr(y, f)} vs {getattr(x, f)}")
        worst = max(worst, float(np.abs(np.subtract(x.logits,
                                                    y.logits)).max()))
        top = max(top, float(np.abs(x.logits).max()))
    if not top > 0.05:
        fail(f"{what}: the head never spiked (max |logit| {top}), the "
             f"comparison would be vacuous")
    if worst > 0.0:
        fail(f"{what}: logits differ by {worst} (largest {top})")
    for k in ("n_offered", "n_admitted", "n_shed", "n_rejected",
              "n_deferred", "total_events", "total_readouts",
              "total_layer1_spikes"):
        if getattr(want, k) != getattr(got, k):
            fail(f"{what}: {k} {getattr(got, k)} vs {getattr(want, k)}")


def batched_backbone_gap(torch, dep) -> dict:
    """Why the readout steps the backbone lane by lane
    (``accumulator.backbone_lanes``): one batched step of 16 lanes on the
    card against the same lanes stepped in blocks of 8 and of 1, on
    seeded coarse counts and membranes; per block size the largest
    difference of the logits and of each layer's membrane."""
    from repro_torch.core import snn
    from repro_torch.stream.accumulator import entry_numerics
    from repro_torch.stream.deploy import tree_to
    cfg = dep.model_cfg.backbone
    nb = tree_to(entry_numerics(dep), torch.device("cuda"))
    gen = torch.Generator().manual_seed(3)
    hp = cfg.input_hw[0] // dep.model_cfg.p2m.stride // 2
    coarse = torch.randint(0, 3, (N_LANES, hp, hp,
                                  dep.model_cfg.p2m.out_channels),
                           generator=gen).float().cuda()
    mem = {k: (torch.rand(v.shape, generator=gen) * 0.5).cuda()
           for k, v in snn.spiking_cnn_stream_init(
               cfg, N_LANES, torch.device("cpu")).items()}

    def step(lo, hi):
        return snn.spiking_cnn_stream_step(
            nb["backbone"], nb["bn_state"],
            {k: v[lo:hi] for k, v in mem.items()}, coarse[lo:hi], cfg)

    full = step(0, N_LANES)
    gaps = {}
    for block in (8, 1):
        parts = [step(i, i + block) for i in range(0, N_LANES, block)]
        lg = torch.cat([p[0] for p in parts])
        gap = {"logits": float((lg - full[0]).abs().max())}
        for k in full[1]:
            got = torch.cat([p[1][k] for p in parts])
            gap[k] = float((got - full[1][k]).abs().max())
        gaps[block] = gap
    return gaps


def phase_shard(torch, sf, dep, src, reports) -> dict:
    """The lane axis and the variant axis over several shards, all on the
    one card (``places``; the CLIs' ``--devices N`` takes N cards):

    - the [slice] deployment serving its 16 recorded streams at capacity 16
      over 2 shards through K2 and through K3, each stream bit-identical
      to the [slice] serve (devices=1); launches equal to 2 x (chunks + the
      warm-up), all on the fast route (``fold``, ``fold_mac``): a
      misaligned shard would take ``fold_scalar`` / ``fold_mac_cp``;
      events/s and the fold step's host p50 beside devices=1's;
    - registry serving (circuits a, b beside c, round-robin, K2) and
      adaptive serving (surrogate, lr_w 1.0; both runs under cuDNN's
      deterministic algorithms) over 2 shards against devices=1: every
      stream equal, the adapted deltas bit-identical;
    - reduced() with 4 lanes over 4 shards (one lane each) against
      devices=1: every stream bit-identical; beside it, how far a batched
      backbone step of 16 lanes is from the same lanes in blocks of 8
      and of 1 on the card (why the readout steps lane by lane);
    - the sweep at reduced() (fast grid, both protocols) over 3 shards
      against devices=1: records equal, timing fields apart, under
      cuDNN's deterministic algorithms for both runs (its default weight
      gradients sum with atomics, so two unsharded runs would differ);
    - both launchers given more --devices than there are cards: ``error:``
      and exit 2 before any compute.

    Returns the K2/K3 launches of the sharded serves (this path's)."""
    import io
    import numpy as np
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, sweep
    from repro_torch.core.sweep_exec import SweepExecutor
    from repro_torch.data import sources
    from repro_torch.stream.adapt import AdaptConfig
    from repro_torch.stream.engine import StreamEngine, stream_generator
    from repro_torch.stream.registry import Registry
    from repro_torch.stream.shard import LaneExecutor
    smi = nvidia_smi()
    two = LaneExecutor(devices=2, places=shard_places(2))
    launches = {}
    for mode, counter in (("deposit", "fold"), ("mac", "fold_mac")):
        eng = StreamEngine(dep, capacity=N_LANES, fold_mode=mode,
                           device="cuda", executor=two)
        rep, counts = serve_counted(torch, sf, eng, src, N_LANES)
        expected = 2 * (len(rep.fold_s) + 1)
        if counts[counter] != expected or sum(counts.values()) != expected:
            fail(f"shard {mode}: launches {counts}, expected {expected} of "
                 f"{counter} (2 shards x (chunks + the warm-up)) and none "
                 f"of any other route or kernel")
        same_streams(rep, reports[mode], f"shard {mode} 2 shards vs 1")
        sh = rep.to_artifact()["sharding"]
        if sh != {"devices": 2, "bin_workers": 2, "padded_capacity": N_LANES,
                  "lanes_per_shard": N_LANES // 2,
                  "per_shard_admitted": [N_LANES // 2] * 2}:
            fail(f"shard {mode}: sharding block {sh}")
        for tag, r in (("1 shard ", reports[mode]), ("2 shards", rep)):
            art = r.to_artifact()
            print(f"[shard] fold={mode} {tag} on one card ({smi}): "
                  f"{art['throughput']['events_per_s']:.0f} events/s, fold "
                  f"step host p50 {art['latency_ms']['fold_p50']:.3f} ms, "
                  f"readout p50 {art['latency_ms']['readout_p50']:.3f} ms")
        print(f"[shard] fold={mode}: {N_LANES} streams on 2 shards "
              f"bit-identical to devices=1, launches {counts} (expected "
              f"{expected}, fast route)")
        launches[counter] = counts[counter]

    # registry (K2) and adaptation over 2 shards against devices=1
    deps = {**circuit_deployments(torch, p2m_dvs.CONFIG, "cuda",
                                  {"a": ("a", 1), "b": ("b", 2)}), "c": dep}
    variants = [("a", "b", "c")[i % 3] for i in range(N_LANES)]
    runs = {}
    for ex in (None, two):
        reg = Registry()
        for name, d in deps.items():
            reg.register(name, d)
        eng = StreamEngine(reg, capacity=N_LANES, device="cuda", executor=ex)
        zero((sf.LAUNCHES,))
        runs[ex] = eng.serve(src.replay(), N_LANES, seed=0,
                             variants=variants)
        torch.cuda.synchronize()
        runs[(ex, "launches")] = dict(sf.LAUNCHES)
    same_streams(runs[two], runs[None], "shard registry 2 shards vs 1")
    got = runs[(two, "launches")]
    if got["fold"] == 0 or sum(got.values()) != got["fold"]:
        fail(f"shard registry: launches {got}, expected K2's fast route "
             f"only")
    launches["fold"] += got["fold"]
    print(f"[shard] registry (a, b, c round-robin, K2) on 2 shards: "
          f"{serve_line(runs[two])}; devices=1 {serve_line(runs[None])}; "
          f"every stream bit-identical, launches {got} (devices=1 "
          f"{runs[(None, 'launches')]['fold']})")
    acfg = AdaptConfig(rule="surrogate", lr_w=1.0, lr_theta=0.01)
    adapted = {}
    for ex in (None, two):
        eng = StreamEngine(dep, capacity=N_LANES, device="cuda",
                           executor=ex, adapt=acfg)
        zero((sf.LAUNCHES,))
        with deterministic_cudnn(torch):
            rep = eng.serve(src.replay(), N_LANES, seed=0)
            torch.cuda.synchronize()
        if any(sf.LAUNCHES.values()):
            fail(f"shard adapt: launches {dict(sf.LAUNCHES)}, expected none")
        adapted[ex] = (rep, {k: v.cpu().numpy()
                             for k, v in eng.adapt_state.items()})
    same_streams(adapted[two][0], adapted[None][0], "shard adapt")
    for k, v in adapted[None][1].items():
        if not np.array_equal(v, adapted[two][1][k]):
            fail(f"shard adapt: {k} differs by "
                 f"{np.abs(v - adapted[two][1][k]).max()}")
    n_upd = int(adapted[None][1]["n_updates"].sum())
    if not n_upd > 0:
        fail("shard adapt: no update applied")
    print(f"[shard] adapt (surrogate, lr_w 1.0) on 2 shards: "
          f"{serve_line(adapted[two][0])}; devices=1 "
          f"{serve_line(adapted[None][0])}; every stream and the {n_upd} "
          f"updates' dw, dtheta bit-identical")

    # one lane a shard, at reduced()
    rcfg, rdata = p2m_dvs.reduced()
    rdep = circuit_deployments(torch, rcfg, "cuda", {"c": ("c", 0)})["c"]
    one = {}
    for ex in (None, LaneExecutor(devices=4, places=shard_places(4))):
        eng = StreamEngine(rdep, capacity=4, device="cuda", executor=ex)
        rsrc = Prerecorded(sources.resolve_dataset(
            "synthetic-gesture", hw=rcfg.backbone.input_hw[0],
            duration_ms=rdata.duration_ms), 8, 1, eng.chunk_us,
            eng.slot_us, stream_generator)
        one[ex is None] = eng.serve(rsrc.replay(), 8, seed=1)
    same_streams(one[False], one[True], "shard reduced() 4 lanes on 4 "
                 "shards")
    gaps = batched_backbone_gap(torch, dep)
    print(f"[shard] reduced(), 4 lanes on 4 shards (one each) vs 1: every "
          f"stream bit-identical; a batched backbone step of 16 lanes vs "
          f"blocks of 8 / 1 on the card, max |diff| "
          + "; ".join(f"{b}: " + ", ".join(f"{k} {v:.3g}"
                                            for k, v in g.items())
                      for b, g in gaps.items())
          + " (the readout steps lane by lane)")

    # the sweep's variant axis over 3 shards
    grid = sweep.fast_grid()
    scfg = codesign.SweepConfig(t_intg_grid_ms=grid.t_intg_grid_ms,
                                batch_size=2, pretrain_steps=2,
                                finetune_steps=2, eval_batches=1)
    init = awake_init(codesign)
    res = {}
    try:
        for ex in (None, SweepExecutor(devices=3,
                                       places=shard_places(3))):
            t0 = time.perf_counter()
            with deterministic_cudnn(torch):
                res[ex is None] = sweep.run_protocols(
                    rdata, rcfg, scfg, grid, device="cuda", executor=ex,
                    keep_params=True, log=lambda *_: None)
            res[(ex is None, "s")] = time.perf_counter() - t0
    finally:
        codesign.model_init = init
    n_rec = 0
    for proto in ("frozen", "unfrozen"):
        a, b = res[True][proto], res[False][proto]
        if len(a.records) != len(b.records):
            fail(f"shard sweep {proto}: {len(b.records)} records vs "
                 f"{len(a.records)}")
        for x, y in zip(a.records, b.records):
            for k in x:
                if k not in SWEEP_TIMING and x[k] != y[k]:
                    fail(f"shard sweep {proto} {x['label']} "
                         f"{x['t_intg_ms']:g} ms: {k} {y[k]} vs {x[k]}")
            n_rec += 1
        for cell, fp in a.final_params.items():
            gb = b.final_params[cell]
            for k in ("backbone", "state"):
                for va, vb in zip(_leaves(fp[k]), _leaves(gb[k])):
                    if va.shape != vb.shape or not torch.equal(va, vb):
                        fail(f"shard sweep {proto} {cell}: {k} differs")
    print(f"[shard] sweep reduced(), fast grid, both protocols, 4 variants "
          f"on 3 shards (padded to 6) vs 1: {n_rec} records equal (timing "
          f"apart), final params unpadded and bit-identical; "
          f"{res[(False, 's')]:.1f} s vs {res[(True, 's')]:.1f} s on one "
          f"card ({smi})")

    # more --devices than cards: error and exit 2 before any compute
    more = str(torch.cuda.device_count() + 1)
    from repro_torch.launch import stream as stream_cli
    from repro_torch.launch import sweep as sweep_cli
    out = ROOT / "build" / "chip_smoke" / "shard_cli"
    for name, cli, argv in (
            ("sweep", sweep_cli, ["--grid", "fast"]),
            ("stream", stream_cli, ["--config", "reduced"])):
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--devices", more, "--out", str(out)])
        if rc != 2 or not err.getvalue().startswith("error: ") or \
                out.exists():
            fail(f"shard: {name} launcher --devices {more}: exit {rc}, "
                 f"stderr {err.getvalue()!r}")
        print(f"[shard] {name} launcher --devices {more} on "
              f"{torch.cuda.device_count()} card(s): exit 2 in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{err.getvalue().strip()!r}")
    return launches


def registry_and_adapt(torch, sf, dep, src, reports) -> dict:
    """5b-5e: registry serving and adaptation at full width, then both at
    reduced() on cuda against the CPU, then the shards; the [shard]
    phase's K2/K3 launches."""
    out = {}
    for name, phase in (
            ("registry", lambda: phase_registry(torch, sf, dep, src,
                                                reports)),
            ("adapt", lambda: phase_adapt(torch, sf, dep, src)),
            ("registry parity", lambda: phase_registry_parity(torch)),
            ("adapt parity", lambda: phase_adapt_parity(torch)),
            ("shard", lambda: out.update(phase_shard(torch, sf, dep, src,
                                                     reports)))):
        if ONLY and name.split()[0] not in ONLY:
            continue
        t0 = time.perf_counter()
        phase()
        torch.cuda.empty_cache()
        print(f"[{name}] phase {time.perf_counter() - t0:.1f} s")
    return out


def measure_tree(torch) -> None:
    """``--measure-tree ROOT``: K1, the MAC-mode fold_chunk and K4 as the
    checkout at ROOT has them (its src/ first on the path, its kernels
    built into ROOT/build), so two commits are timed on one card in one
    call: K1 on the physics batch for the three paper circuits and for one
    (CUDA events, as phase_p2m_conv), one fold_chunk(mode="mac") call's
    device time at S 1 and 4 (torch.profiler), and K4 at its two timed
    shapes in both types (CUDA events, as phase_lif)."""
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, leakage
    from repro_torch.data import events as ev_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import ops, p2m_conv as pc
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.stream import deploy
    resolve_device("cuda")
    _build.build(["p2m_conv", "stream_fold", "lif"])
    cfg = p2m_dvs.CONFIG
    ev, _ = ev_mod.sample_batch(torch.Generator().manual_seed(0),
                                p2m_dvs.DATA, PHYS_B, cfg.p2m.t_intg_ms,
                                cfg.p2m.n_sub)
    ev = ev.to("cuda")
    params, _ = codesign.model_init(torch.Generator().manual_seed(0), cfg)
    p2m = deploy.tree_to(params, torch.device("cuda"))["p2m"]
    flush, _ = l2_flushers(torch)
    tree = SRC.parent.name
    for lcs in (tuple(leakage.paper_circuits()), (cfg.p2m.leak,)):
        w2, v_inf, decay, theta, consts = ops._prepare(p2m, cfg.p2m, lcs)
        args = (ev, w2, v_inf, decay, theta, p2m["pv_gain"], p2m["pv_offset"])
        ms = time_ms(lambda: pc.p2m_conv_cuda(*args, **consts), torch,
                     flush=flush)
        torch.cuda.empty_cache()
        print(f"[tree {tree}] p2m_conv n_cfg={len(lcs)}: {ms:.4f} ms")
    for S in (1, 4):
        fc = fold_chunk_device_ms(torch, S)
        print(f"[tree {tree}] fold_chunk(mode=\"mac\") S={S}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in fc)
              + f"; sum {sum(v for _, v in fc):.4f} ms")
    from repro_torch.kernels.lif import lif
    gen = torch.Generator().manual_seed(2)
    for T, N in LIF_CASES[:2]:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((T, N), generator=gen) * 1.5).to("cuda", dtype)
            ms = time_ms(lambda: lif.lif_cuda(x), torch, flush=flush)
            print(f"[tree {tree}] lif T={T} N={N} "
                  f"{str(dtype).split('.')[-1]}: {ms:.4f} ms")


def _drop_args(sig: str) -> str:
    """A demangled signature without its trailing argument list (template
    arguments such as ``(int)128`` hold parentheses too)."""
    depth = 0
    for i in range(len(sig) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(sig[i], 0)
        if depth == 0 and sig[i] == "(":
            return sig[:i]
    return sig


def ptxas_report() -> None:
    """``--ptxas``: compile each source under src/repro_torch/csrc with
    the build's flags and ``-Xptxas -v`` (to an object file in a temporary
    directory) and print, per kernel, its registers, stack frame and
    spill bytes."""
    import re
    import tempfile
    from repro_torch.kernels import _build
    nvcc = _build.nvcc()
    filt = Path(nvcc).with_name("cu++filt")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    for name in _build.sources():
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [nvcc, *flags, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / "k.o"), str(_build.CSRC / f"{name}.cu")],
                capture_output=True, text=True, timeout=600)
        if out.returncode:
            fail(f"nvcc {name}.cu: {out.stderr[-2000:]}")
        kernel, frame = None, ""
        for line in out.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
                if filt.exists():
                    kernel = _drop_args(subprocess.run(
                        [str(filt), kernel], capture_output=True, text=True
                    ).stdout.strip())
            elif "spill" in line:
                frame = line.strip()
            elif "registers" in line and kernel:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"[ptxas] {name}.cu {kernel}: {regs} registers; "
                      f"{frame}")
                kernel, frame = None, ""


def main() -> int:
    global SRC, ONLY
    if sys.argv[1:2] == ["--measure-tree"]:
        SRC = Path(sys.argv[2]).resolve() / "src"
    if sys.argv[1:2] == ["--only"]:
        ONLY = set(sys.argv[2].split(","))
        if not ONLY <= {"registry", "adapt", "shard", "files", "lm_train",
                        "lm"}:
            fail(f"--only takes registry, adapt, shard, files, lm_train "
                 f"and/or lm, got {sys.argv[2]}")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if sys.argv[1:2] == ["--ptxas"]:
        print(f"[device] nvidia-smi: {nvidia_smi()}")
        ptxas_report()
        return 0
    if sys.argv[1:2] == ["--measure-tree"]:
        print(f"[device] nvidia-smi: {nvidia_smi()}")
        measure_tree(torch)
        return 0
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

    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, leakage
    from repro_torch.data import events as ev_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.lif import lif
    from repro_torch.kernels.p2m_conv import p2m_conv as pc
    from repro_torch.kernels.ssd import ssd as sd
    from repro_torch.kernels.stream_fold import stream_fold as sf
    from repro_torch.stream import deploy
    cfg = p2m_dvs.CONFIG
    all_counters = (pc.LAUNCHES, lif.LAUNCHES, sf.LAUNCHES, fa.LAUNCHES,
                    sd.LAUNCHES)
    if "lm" in ONLY:
        phase_lm_all(torch, all_counters)
        ONLY.discard("lm")
        if not ONLY:
            print(f"[done] --only lm in {time.perf_counter() - t_all:.1f} s "
                  f"(no ok line)")
            return 0
    if "lm_train" in ONLY:
        t0 = time.perf_counter()
        phase_lm_train(torch, all_counters)
        print(f"[lm train] phase {time.perf_counter() - t0:.1f} s")
        ONLY.discard("lm_train")
        if not ONLY:
            print(f"[done] --only lm_train in "
                  f"{time.perf_counter() - t_all:.1f} s (no ok line)")
            return 0
    if "files" in ONLY:
        t0 = time.perf_counter()
        phase_files(torch, sf, pc, all_counters)
        print(f"[files] phase {time.perf_counter() - t0:.1f} s")
        ONLY.discard("files")
        if not ONLY:
            print(f"[done] --only files in {time.perf_counter() - t_all:.1f}"
                  f" s (no ok line)")
            return 0
    # --only: none of the physics batch, the kernel timings, or the
    # phases after the slice but the ones named
    if not ONLY:
        # the physics batch and model, drawn on the host before any timing
        t0 = time.perf_counter()
        ev_host, labels = ev_mod.sample_batch(
            torch.Generator().manual_seed(0), p2m_dvs.DATA, PHYS_B,
            cfg.p2m.t_intg_ms, cfg.p2m.n_sub)
        print(f"[physics] drew {PHYS_B} synthetic-gesture samples x "
              f"{p2m_dvs.DATA.duration_ms:g} ms {tuple(ev_host.shape)} on the "
              f"host in {time.perf_counter() - t0:.1f} s, "
              f"{float(ev_host.sum()):.0f} events")
        events = ev_host.to("cuda")
        del ev_host
        params, state = codesign.model_init(torch.Generator().manual_seed(0), cfg)
        params = awake(deploy.tree_to(params, torch.device("cuda")))
        state = deploy.tree_to(state, torch.device("cuda"))

        # 3. kernels against their plain versions
        from repro_torch.kernels.lif.ref import lif_ref
        from repro_torch.kernels.p2m_conv import ops as conv_ops
        from repro_torch.kernels.stream_fold import ref
        flush, write_flush = l2_flushers(torch)
        rows = phase_kernels(torch, sf, ref, flush, write_flush)
        k1_rows = phase_p2m_conv(torch, conv_ops, pc, events, params["p2m"],
                                 cfg.p2m, leakage.paper_circuits(), flush)
        lif_rows = phase_lif(torch, lif, lif_ref, flush)
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.ssd.ref import ssd_ref
        fa_rows = phase_flash_attention(torch, fa_ops, fa_ref, flush)
        ssd_rows = phase_ssd(torch, sd, ssd_ref, flush)
        del flush, write_flush
        print(f"[kernels] after timing: clocks.sm, power.draw, temperature = "
              f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    # 4. the slice at full width, through each fold kernel
    from repro_torch.data import sources
    from repro_torch.stream.engine import StreamEngine, stream_generator

    ckpt = ROOT / "build" / "chip_smoke" / "deploy"
    dep = deploy.fresh_deployment(p2m_dvs.CONFIG, seed=0, device="cuda")
    awake(dep.params)
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
        # the deposit fold counts its two routes apart: serving must take
        # the float4 one on every chunk, the one-float one never
        if counts[counter] != expected or sum(counts.values()) != expected:
            fail(f"{mode}: launches {counts}, expected {expected} of "
                 f"{counter} and none of any other kernel")
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

    if ONLY:
        registry_and_adapt(torch, sf, dep, src, reports)
        print(f"[done] --only {','.join(sorted(ONLY))} in "
              f"{time.perf_counter() - t_all:.1f} s (no ok line)")
        return 0

    # 5. the same seeded streams on cuda and on the CPU, at reduced()
    rcfg, rdata = p2m_dvs.reduced()
    runs = {}
    for device in ("cuda", "cpu"):
        d = deploy.fresh_deployment(rcfg, seed=0, device=device)
        awake(d.params)
        eng = StreamEngine(d, capacity=8, device=device)
        rsrc = Prerecorded(sources.resolve_dataset(
            "synthetic-gesture", hw=rcfg.backbone.input_hw[0],
            duration_ms=rdata.duration_ms), N_LANES, 1, eng.chunk_us,
            eng.slot_us, stream_generator)
        runs[device] = eng.serve(rsrc.replay(), N_LANES, seed=1)
    by_id = {dv: sorted(r.results, key=lambda x: x.stream_id)
             for dv, r in runs.items()}
    diff = check_logits([r.logits for r in by_id["cuda"]],
                        [r.logits for r in by_id["cpu"]], "cuda vs cpu")
    print(f"[parity] reduced(): {N_LANES} streams on 8 lanes, cuda vs cpu "
          f"max |logit diff| {diff:.3g}, predictions "
          f"{[r.prediction for r in by_id['cuda']]}")
    shard = registry_and_adapt(torch, sf, dep, src, reports)

    # 6. the physics slice at full width, through K1 and K4
    print(f"[physics] {cfg.backbone.input_hw} input, {cfg.p2m.out_channels} "
          f"in-pixel filters, n_sub {cfg.p2m.n_sub}, T_INTG "
          f"{cfg.p2m.t_intg_ms:g} ms, backbone {cfg.backbone.channels} fc "
          f"{cfg.backbone.fc_hidden}, coarse window {cfg.coarse_window_ms:g} "
          f"ms; batch {PHYS_B} x {p2m_dvs.DATA.duration_ms:g} ms")
    phys = phase_physics(torch, cfg, params, state, events, labels,
                         (pc.LAUNCHES, lif.LAUNCHES, sf.LAUNCHES))
    print(f"[physics] main-path launches: {phys}")
    del params, state
    torch.cuda.empty_cache()

    # 6b. the training step at full width, on the same batch
    t0 = time.perf_counter()
    train = phase_train(torch, cfg, events, labels, all_counters)
    print(f"[train] phase {time.perf_counter() - t0:.1f} s")

    # 6c. the co-design sweep at full width (both protocols), then
    # deploying and serving a checkpoint that it trained
    t0 = time.perf_counter()
    sweep_out = phase_sweep(torch, all_counters, events, labels)
    print(f"[sweep] phase {time.perf_counter() - t0:.1f} s")
    del events
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_deploy(torch, sf, sweep_out, src)
    print(f"[deploy] phase {time.perf_counter() - t0:.1f} s")
    del sweep_out
    torch.cuda.empty_cache()

    # 6d. file-backed data at full width: fixture, cache, sweep, eval, serve
    t0 = time.perf_counter()
    files = phase_files(torch, sf, pc, all_counters)
    print(f"[files] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 7. the physics eval on cuda and on the CPU, at reduced()
    diff = phase_physics_parity(torch)
    print(f"[physics parity] reduced(), kernel mode: cuda vs cpu max "
          f"|logit diff| {diff:.3g}")
    t0 = time.perf_counter()
    phase_train_parity(torch)
    print(f"[train parity] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sweep_parity(torch)
    print(f"[sweep parity] {time.perf_counter() - t0:.1f} s")

    # 8. LM request serving at full width, through K5 and K6; 9. every
    # smoke variant on cuda and on the CPU
    counters = (sf.LAUNCHES, pc.LAUNCHES, lif.LAUNCHES, fa.LAUNCHES,
                sd.LAUNCHES)
    lm_runs = phase_lm_all(torch, counters)

    # 10. LM training at full width (K6 through ssd_trainable), parity,
    # restart and the launcher
    t0 = time.perf_counter()
    lm_train = phase_lm_train(torch, counters)
    print(f"[lm train] phase {time.perf_counter() - t0:.1f} s")

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
            "replaces": replaces,
            "launches": launches[counter] + files[counter] + shard[counter],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    for row, source, replaces in (
            (k1_rows[1], "p2m_conv.cu", "p2m_conv/p2m_conv.py:72"),
            (lif_rows[(4, 524288, torch.float32)], "lif.cu", "lif/lif.py:41")):
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": phys[row["name"]] + files.get(row["name"], 0),
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    # K5 by head dim (d 64 and 128 take the wgmma route, 112 and 256 the
    # mma.sync one) and K6 by shape: launches of the serves whose prefills
    # ran at that shape, plus training's
    by_dim = {112: "_d112", 256: "_d256"}
    fa_launches = {"": lm_train["flash_attention"], "_d112": 0, "_d256": 0}
    for run in lm_runs.values():
        fa_launches[by_dim.get(run["head_dim"], "")] += \
            run["launches"]["flash_attention"]
    lm_kernels = [(fa_rows["bfloat16" + tag], "flash_attention" + tag,
                   "flash_attention.cu", "flash_attention/flash_attention.py:73",
                   n) for tag, n in fa_launches.items()]
    lm_kernels += [
        (ssd_rows["bfloat16"], "ssd", "ssd.cu", "ssd/ssd.py:85",
         lm_runs["mamba2-780m"]["launches"]["ssd"] + lm_train["ssd"]),
        (ssd_rows["bfloat16_zamba2"], "ssd_zamba2", "ssd.cu", "ssd/ssd.py:85",
         lm_runs["zamba2-7b"]["launches"]["ssd"])]
    for row, name, source, replaces, n in lm_kernels:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": n,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
