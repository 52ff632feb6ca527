"""PyTorch port: streaming-fold kernels against the JAX package's pure-XLA
references (the CUDA kernels against their plain versions on the card are
in tests/test_torch_cuda.py).

On the CPU the port's wrappers run their plain versions, so the
cross-framework checks here pin the arithmetic the CUDA kernels must
reproduce: plain fold ≤ 1e-6 abs from ``lax.scan`` (float32 rounding of
the same op sequence in two frameworks), fold_chunk in both modes and
both strides ≤ 1e-6 abs (the conv sums in another order)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.p2m_conv.ops import _extract_patches as jax_patches
from repro.kernels.stream_fold import ops as jax_ops
from repro.kernels.stream_fold import ref as jax_ref
from repro_torch.kernels.p2m_conv.ops import _extract_patches
from repro_torch.kernels.stream_fold import ops, ref, stream_fold as sf
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _fold_inputs(seed, S, N, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    dep = (rng.standard_normal((S, N, F)) * 0.01).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, dep, a


def _mac_inputs(seed, S, N, K, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    patches = rng.poisson(0.5, (S, N, K)).astype(np.float32)
    w = (np.round(rng.uniform(-1, 1, (K, F)) * 8) / 8).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, patches, w, a


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _chunk_inputs(seed, B, S, hw, cin, F):
    rng = np.random.default_rng(seed)
    frames = rng.poisson(0.4, (B, S, hw, hw, cin)).astype(np.float32)
    w_q = (np.round(rng.uniform(-1, 1, (3, 3, cin, F)) * 8) / 8
           ).astype(np.float32)
    a = np.exp(-rng.uniform(0, 0.5, F)).astype(np.float32)
    return frames, w_q, a


@pytest.mark.parametrize("S,N,F", [(1, 8, 3), (4, 37, 5), (6, 64, 16)])
def test_stream_fold_ref_matches_jax(S, N, F):
    x0, dep, a = _fold_inputs(S * 1000 + N, S, N, F)
    want = np.asarray(jax_ref.stream_fold_ref(*map(jnp.asarray, (x0, dep, a))))
    got = sf.stream_fold(*_t(x0, dep, a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S,N,K,F", [(1, 40, 18, 16), (3, 29, 8, 4)])
def test_stream_fold_mac_ref_matches_jax(S, N, K, F):
    x0, patches, w, a = _mac_inputs(S + N, S, N, K, F)
    want = np.asarray(jax_ref.stream_fold_mac_ref(
        *map(jnp.asarray, (x0, patches, w, a)), dv_unit=0.01))
    got = ref.stream_fold_mac_ref(*_t(x0, patches, w, a), dv_unit=0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["deposit", "mac", "mac_frames_ref"])
@pytest.mark.parametrize("stride", [1, 2])
def test_fold_chunk_matches_jax(mode, stride):
    """fold_chunk in each mode, and the MAC kernel's plain version on the
    frames (its contract) called directly, against the reference's
    fold_chunk."""
    B, S, hw, cin, F = 2, 4, 12, 2, 8
    frames, w_q, a = _chunk_inputs(7 * stride, B, S, hw, cin, F)
    ho = hw // stride
    x = (np.random.default_rng(stride).standard_normal((B, ho, ho, F))
         * 0.05).astype(np.float32)
    want = np.asarray(jax_ops.fold_chunk(
        jnp.asarray(x), jnp.asarray(frames), jnp.asarray(w_q), jnp.asarray(a),
        stride=stride, dv_unit=0.01,
        mode="mac" if mode.startswith("mac") else mode, use_ref=True))
    if mode == "mac_frames_ref":
        got = ref.stream_fold_mac_frames_ref(
            *_t(x.reshape(-1, F), frames, w_q.reshape(-1, F), a),
            stride=stride, dv_unit=0.01).numpy().reshape(x.shape)
    else:
        got = ops.fold_chunk(*_t(x, frames, w_q, a), stride=stride,
                             dv_unit=0.01, mode=mode).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("stride,hw", [(1, 12), (2, 12), (2, 13)])
def test_extract_patches_matches_jax(stride, hw):
    rng = np.random.default_rng(hw + stride)
    frames = rng.poisson(0.5, (3, hw, hw, 2)).astype(np.float32)
    want, want_hw = jax_patches(jnp.asarray(frames), 3, stride)
    got, got_hw = _extract_patches(torch.from_numpy(frames), 3, stride)
    assert got_hw == tuple(want_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_chunk_modes_agree():
    """The two modes fold the same deposits (≤ 1e-5: matmul vs conv order)."""
    frames, w_q, a = _chunk_inputs(3, 3, 2, 10, 2, 16)
    x = torch.zeros((3, 10, 10, 16))
    args = (x, *_t(frames, w_q, a))
    dep = ops.fold_chunk(*args, stride=1, dv_unit=0.01, mode="deposit")
    mac = ops.fold_chunk(*args, stride=1, dv_unit=0.01, mode="mac")
    np.testing.assert_allclose(mac.numpy(), dep.numpy(), rtol=0, atol=1e-5)


def test_fold_chunk_rejects_unknown_mode():
    frames, w_q, a = _chunk_inputs(0, 1, 1, 6, 2, 4)
    with pytest.raises(ValueError, match="unknown stream_fold mode"):
        ops.fold_chunk(torch.zeros((1, 6, 6, 4)), *_t(frames, w_q, a),
                       stride=1, dv_unit=0.01, mode="scan")


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = dict(sf.LAUNCHES)
    x0, dep, a = _fold_inputs(0, 2, 5, 3)
    out = sf.stream_fold(*_t(x0, dep, a))
    np.testing.assert_array_equal(
        out.numpy(), ref.stream_fold_ref(*_t(x0, dep, a)).numpy())
    assert sf.LAUNCHES == before


# ---------------------------------------------------------------------------
# K1's order of work (csrc/p2m_conv.cu) emulated on the CPU
# ---------------------------------------------------------------------------

V_RTOL, V_ATOL = 1e-5, 1e-6          # chip_smoke.py's K1 tolerance
HALF_SWING = 0.4
_K1_CONSTS = dict(kernel_size=3, dv_unit=0.01, half_swing=HALF_SWING,
                  v_lo=-0.4, v_hi=0.4)


def _rn32(x: np.ndarray, err: np.ndarray | None = None) -> np.ndarray:
    """float64 x (+ the exact float64 remainder ``err``, with |err| tiny
    against x) rounded once to float32: a midpoint of two float32s that x
    hits exactly goes the way ``err`` points."""
    t = x.astype(np.float32)
    if err is None:
        return t
    up = np.nextafter(t, np.float32(np.inf))
    dn = np.nextafter(t, np.float32(-np.inf))
    t = np.where((x == (t.astype(np.float64) + up) / 2) & (err > 0), up, t)
    return np.where((x == (t.astype(np.float64) + dn) / 2) & (err < 0), dn, t)


def _fma32(a, b, c) -> np.ndarray:
    """fmaf(a, b, c) on float32 arrays: a·b is exact in float64 and the sum
    is rounded once (TwoSum keeps what float64 drops)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    s = p + c.astype(np.float64)
    z = s - p
    err = (p - (s - z)) + (c.astype(np.float64) - z)
    return _rn32(s, err)


def _kernel_quotient(v: np.ndarray, half_swing: float) -> np.ndarray:
    """The kernel's v / half_swing: Markstein's step q = v r, e = fma(-q,
    half_swing, v), t = fma(e, r, q) with r = RN(1 / half_swing) and v's
    sign, and the true division for 0 < |v| < 2^-100."""
    from repro_torch.kernels.p2m_conv.p2m_conv import reciprocal
    hs, r = np.float32(half_swing), np.float32(reciprocal(half_swing))
    v = np.asarray(v, np.float32)
    q = v * r
    e = _fma32(-q, np.full_like(v, hs), v)
    t = np.copysign(_fma32(e, np.full_like(v, r), q), v)
    tiny = (np.abs(v) < np.float32(2.0 ** -100)) & (v != 0)
    return np.where(tiny, v / hs, t)


def _p2m_conv_emulation(events, w, v_inf, decay, theta, pvg, pvo, *, stride,
                        kernel_size, dv_unit, half_swing, v_lo, v_hi,
                        nonlinear=True, w_bf16=False):
    """float32 emulation of K1's order of work on numpy inputs: im2col,
    each filter's dot product as fmaf in k order from 0 (a thread's item
    is one site and 4 filters; the order is per filter), then the update
    op by op (the kernel's quotient for v / half_swing). ``w_bf16`` rounds
    w to bf16 once, the negative control of a single-term tensor-core
    operand. Returns (spikes, v_pre) [n_cfg, B, T, H', W', F]."""
    from repro_torch.kernels.p2m_conv.ops import _extract_patches
    B, T, n_sub, H, W, Cin = events.shape
    K, F = w.shape
    if w_bf16:
        w = torch.from_numpy(w).bfloat16().float().numpy()
    patches, (ho, wo) = _extract_patches(
        torch.from_numpy(events.reshape(-1, H, W, Cin)), kernel_size, stride)
    p = patches.numpy().reshape(B, T, n_sub, ho * wo, K)
    f32 = np.float32
    v = np.zeros((v_inf.shape[0], B, T, ho * wo, F), f32)
    vi, de = v_inf[:, None, None, None], decay[:, None, None, None]
    for s in range(n_sub):
        acc = np.zeros((B, T, ho * wo, F), f32)
        for k in range(K):
            acc = _fma32(np.broadcast_to(p[:, :, s, :, k, None], acc.shape),
                         np.broadcast_to(w[k], acc.shape), acc)
        ideal = acc * f32(dv_unit)
        v = vi + (v - vi) * de
        step = np.broadcast_to(ideal, v.shape)
        if nonlinear:
            t = _kernel_quotient(v, half_swing)
            step = step * np.clip(f32(1) - t * t, f32(0.05), f32(1))
        v = np.clip(v + step * pvg, f32(v_lo), f32(v_hi))
    v_pre = (v + pvo).reshape(-1, B, T, ho, wo, F)
    return ((v_pre > theta[:, None, None, None, None]).astype(f32), v_pre)


def _k1_inputs(variant, seed=0, B=2, T=3, n_sub=4, hw=(9, 10), F=8, n_cfg=3):
    rng = np.random.default_rng(seed)
    ev = rng.poisson(0.7, (B, T, n_sub) + hw + (2,)).astype(np.float32)
    w = np.round(rng.uniform(-1, 1, (18, F)) * 8) / 8          # eighths
    if variant == "non_integer":
        ev += rng.uniform(0, 0.3, ev.shape).astype(np.float32)
    elif variant in ("fine_weights", "bf16_w_control"):
        # weights on a 2^-12 grid: exact in float32, not in bf16; with
        # counts <= 3 every dot product is still exact
        ev = np.minimum(ev, 3)
        w = np.round(rng.uniform(-1, 1, (18, F)) * 4096) / 4096
    w = w.astype(np.float32)
    v_inf = rng.uniform(-0.4, 0.3, (n_cfg, F)).astype(np.float32)
    decay = np.exp(-rng.uniform(0, 0.5, (n_cfg, F))).astype(np.float32)
    theta = rng.uniform(0.005, 0.03, (n_cfg, 1)).repeat(F, 1).astype(np.float32)
    pvg = (1 + 0.02 * rng.standard_normal(F)).astype(np.float32)
    pvo = (1.5e-3 * rng.standard_normal(F)).astype(np.float32)
    return ev, w, v_inf, decay, theta, pvg, pvo


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("variant", ["eighths", "fine_weights", "non_integer",
                                     "bf16_w_control"])
def test_p2m_conv_order_of_work(variant, stride):
    """K1's dot-product order and update, emulated in float32, against its
    plain version (ops.p2m_conv_events_ref): bit for bit on event counts
    times eighths and times 2^-12 weights (exact dot products), within
    chip_smoke.py's V_RTOL / V_ATOL on non-integer events; w rounded once
    to bf16 (one tensor-core term, no hi/mid/lo split) is not bit-exact."""
    from repro_torch.kernels.p2m_conv.ops import p2m_conv_events_ref
    args = _k1_inputs(variant, seed=stride)
    s_ref, v_ref = (x.numpy() for x in p2m_conv_events_ref(
        *_t(*args), stride=stride, **_K1_CONSTS))
    s, v = _p2m_conv_emulation(*args, stride=stride, **_K1_CONSTS,
                               w_bf16=variant == "bf16_w_control")
    assert 0 < s_ref.sum() < s_ref.size
    exact = np.array_equal(v, v_ref) and np.array_equal(s, s_ref)
    if variant == "bf16_w_control":
        assert not exact
    elif variant == "non_integer":
        np.testing.assert_allclose(v, v_ref, rtol=V_RTOL, atol=V_ATOL)
    else:
        assert exact, f"max |v_pre diff| {np.abs(v - v_ref).max()}"


def _rn32_exact(x) -> np.float32:
    """A Fraction rounded to the nearest float32, ties to even."""
    from fractions import Fraction
    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - x)
        if (best is None or d < best[0]
                or (d == best[0] and int(cand.view(np.uint32)) % 2 == 0)):
            best = (d, cand)
    return best[1]


def test_kernel_quotient_is_the_true_division():
    """The kernel's v / half_swing (Markstein's step with r = RN(1 /
    half_swing), evaluated exactly with fractions, and as the emulation
    computes it) equals float32 true division bit for bit, on 0, ±v_lo,
    ±v_hi, ±1, neighbours of multiples of 0.4, values around the 2^-100
    switch to __fdiv_rn, subnormals and a seeded sample of voltages."""
    from fractions import Fraction
    from repro_torch.kernels.p2m_conv.p2m_conv import reciprocal
    hs, r = np.float32(HALF_SWING), np.float32(reciprocal(HALF_SWING))
    assert r == _rn32_exact(1 / Fraction(float(hs)))
    f32 = np.float32
    edge = [f32(0), f32(-0.0), f32(1), f32(-1), f32(2.0 ** -100),
            f32(2.0 ** -126), f32(1e-45), f32(3e-39)]
    for m in (f32(0.4), f32(-0.4), f32(0.8), f32(-0.8)):
        x = m
        for _ in range(4):
            edge += [x]
            x = np.nextafter(x, f32(np.inf))
        x = m
        for _ in range(3):
            x = np.nextafter(x, f32(-np.inf))
            edge += [x]
    x = f32(2.0 ** -100)
    for _ in range(3):
        x = np.nextafter(x, f32(-np.inf))
        edge += [x]
    rng = np.random.default_rng(16)
    sample = np.concatenate([
        rng.uniform(-0.45, 0.45, 400), rng.uniform(-1, 1, 200),
        np.exp2(rng.uniform(-99, 0, 200)) * rng.choice([-1, 1], 200),
    ]).astype(np.float32)
    v = np.concatenate([np.array(edge, np.float32), sample])
    want = v / hs
    got = _kernel_quotient(v, HALF_SWING)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    for vi in v:                       # the same steps, exactly
        if abs(vi) < 2.0 ** -100:      # the true division, or 0
            continue
        q = _rn32_exact(Fraction(float(vi)) * Fraction(float(r)))
        e = _rn32_exact(Fraction(float(vi)) - Fraction(float(q))
                        * Fraction(float(hs)))
        t = _rn32_exact(Fraction(float(e)) * Fraction(float(r))
                        + Fraction(float(q)))
        assert t.view(np.uint32) == (vi / hs).view(np.uint32), vi


def _lif_sweep() -> np.ndarray:
    """float32 values for K4's quotient checks: signed zeros, both sides
    of the subnormal boundary, subnormals, the 2^±100 switches of
    Markstein's range, and a seeded sample of bit patterns over every
    finite magnitude."""
    f32 = np.float32
    edge = [f32(0), f32(-0.0), f32(1e-45), f32(-1e-45), f32(3e-39),
            f32(2.0 ** -126), f32(2.0 ** -100), f32(2.0 ** 100), f32(1),
            f32(-1), f32(3.4e38), f32(-3.4e38)]
    for m in (f32(2.0 ** -126), f32(2.0 ** -100), f32(2.0 ** 100)):
        edge += [np.nextafter(m, f32(0)), np.nextafter(m, f32(np.inf))]
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 0x7f800000, 4000, dtype=np.uint32)
    sample = bits.view(np.float32) * rng.choice([-1, 1], 4000).astype(f32)
    small = rng.uniform(-4, 4, 1000).astype(f32)
    return np.concatenate([np.array(edge, f32), sample, small])


@pytest.mark.parametrize("tau", [2.0, 4.0, 0.5, 1.0, 2.0 ** -3, 2.0 ** 10])
def test_lif_quotient_power_of_two_tau_is_a_multiply(tau):
    """K4's quotient rule for a power-of-two tau: x · (1/tau) rounds the
    same real number as x / tau, so the two agree in every bit over the
    sweep, subnormal inputs and results included."""
    from repro_torch.kernels.lif.lif import quotient_mode
    assert quotient_mode(tau) == 0
    x = _lif_sweep()
    with np.errstate(over="ignore", under="ignore"):
        got = x * np.float32(1.0 / tau)
        want = x / np.float32(tau)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("tau", [1.5, 3.0, 0.7, 1000.0])
def test_lif_quotient_markstein_is_the_true_division(tau):
    """K4's quotient for tau not a power of two (Markstein's step from r
    = RN(1/tau) where 2^-100 ≤ |d| < 2^100 or d = 0, the true division
    elsewhere), emulated as the kernel computes it, equals float32 true
    division in every bit over the sweep."""
    from repro_torch.kernels.lif.lif import quotient_mode
    assert quotient_mode(tau) == 1
    t, r = np.float32(tau), np.float32(1.0) / np.float32(tau)
    d = _lif_sweep()
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        q = d * r
        e = _fma32(-q, np.full_like(d, t), d)
        mark = np.copysign(_fma32(e, np.full_like(d, r), q), d)
        want = d / t
    a = np.abs(d)
    fast = (a == 0) | ((a >= np.float32(2.0 ** -100))
                       & (a < np.float32(2.0 ** 100)))
    got = np.where(fast, mark, want)
    assert fast.sum() > 1000
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_lif_quotient_mode_and_lanes():
    """quotient_mode: a multiply only where 1/tau is a normal float32
    power of two, Markstein's step within [2^-20, 2^20], else the true
    division. lif_lane: the widest lane the layout and thread count allow
    (MIN_THREADS), one element for bfloat16 rows off the 4-byte grid."""
    from repro_torch.kernels.lif import lif
    assert [lif.quotient_mode(t) for t in
            (2.0, 2.0 ** 126, 2.0 ** 127, 2.0 ** -127, 1.5, 2.0 ** 21 * 3,
             -2.0, 0.0, float("inf"))] == [0, 0, 2, 0, 1, 2, 2, 2, 2]
    f32 = torch.zeros((4, 524288))
    assert lif.lif_lane(f32) == 16 and lif.lif_route(f32) == "lif"
    assert lif.lif_lane(torch.zeros((16, 131072))) == 8
    assert lif.lif_lane(torch.zeros((64, 16384))) == 4
    assert lif.lif_route(torch.zeros((64, 16384))) == "lif_narrow"
    assert lif.lif_lane(torch.zeros((5, 262145))) == 4
    bf = torch.zeros((5, 262145), dtype=torch.bfloat16)
    assert lif.lif_lane(bf) == 2
    assert lif.lif_lane(torch.zeros((4, 524289))[:, 1:].contiguous()) == 16
    view = torch.zeros(4 * 524288 + 1)[1:].view(4, 524288)
    assert view.data_ptr() % 16 == 4 and lif.lif_lane(view) == 4
