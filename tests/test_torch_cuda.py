"""PyTorch port: the CUDA kernels (streaming fold, P²M conv, LIF, flash
attention, SSD) against their plain versions, on the card, the LM
training path around K6 (``ssd_trainable``, remat, the donated step; MoE
with drops and the hybrid's groups against the CPU; one train step of
the qk-norm, GeGLU, padded-head, vlm and enc-dec smoke variants against
the CPU, with no K5 launch) and
the served LM families' smoke variants (the cross-attention ones through
the model API) on the card against the CPU.
Imports no JAX, so it runs on the machine with the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a GPU every test here skips."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.stream_fold import ref, stream_fold as sf


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _fold_inputs(seed, S, N, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    dep = (rng.standard_normal((S, N, F)) * 0.01).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, dep, a


def _mac_inputs(seed, B, S, hw, cin, F, exact=False):
    """x0 [B·Ho·Wo, F] for stride 1 (the caller reshapes for others),
    frames [B, S, H, W, Cin] (event counts, plus a small non-integer part
    unless ``exact``), w [9·Cin, F] in eighths, a [F]."""
    rng = np.random.default_rng(seed)
    frames = rng.poisson(0.5, (B, S) + hw + (cin,)).astype(np.float32)
    if not exact:
        frames += rng.uniform(0, 0.01, frames.shape).astype(np.float32)
    w = (np.round(rng.uniform(-1, 1, (9 * cin, F)) * 8) / 8).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return frames, w, a


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels.backend import resolve_device
    return resolve_device("cuda")


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    k = 4 // t.element_size()
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("S,N,F,misaligned,route", [
    (1, 4099, 16, False, "vector"),
    (4, 1000, 5, False, "scalar"),
    (4, 1000, 3, False, "scalar"),        # F % 4 != 0
    (3, 777, 8, True, "scalar"),          # deposits off the 16-byte grid
    (9, 513, 16, False, "vector"),        # S > 8: two batches of loads
    (1, 262144, 16, False, "vector"),     # the serving shape
])
def test_cuda_fold_bit_exact_vs_plain(cuda_device, S, N, F, misaligned,
                                      route):
    """Each route of the deposit-mode fold bit-exact with the plain fold:
    the one its shape chooses, counted under its own name, and, where that
    is the vector route, the scalar one on the same values through a copy
    of the deposits off the 16-byte grid."""
    x0, dep, a = [t.to(cuda_device) for t in _t(*_fold_inputs(S, S, N, F))]
    if misaligned:
        dep = _misaligned(dep)
    assert sf.fold_route(x0, dep, a) == route
    want = ref.stream_fold_ref(x0, dep, a)
    counter = {"vector": "fold", "scalar": "fold_scalar"}[route]
    before = dict(sf.LAUNCHES)
    got = sf.stream_fold(x0, dep, a)
    assert sf.LAUNCHES == {**before, counter: before[counter] + 1}
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if route == "vector":
        off = _misaligned(dep)
        assert sf.fold_route(x0, off, a) == "scalar"
        torch.testing.assert_close(sf.stream_fold(x0, off, a), want,
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,hw,cin,F,stride,case", [
    (1, 1, (1, 4099), 2, 16, 1, ""),      # N 4099, K 18
    (4, 10, (10, 10), 2, 8, 1, ""),       # N 1000, K 18
    (2, 3, (13, 11), 2, 16, 2, ""),       # stride 2, H and W odd
    (2, 3, (13, 14), 2, 16, 2, ""),       # stride 2, W even
    (3, 2, (19, 21), 2, 16, 1, "misaligned"),  # x0 off the 16-byte grid
    (2, 2, (9, 12), 2, 6, 1, ""),         # F % 4 != 0: one filter a thread
    (2, 2, (12, 9), 1, 8, 2, ""),         # Cin 1: the generic-K kernel
    (4, 2, (20, 34), 2, 16, 1, "exact"),  # event counts: bit-exact
    (1, 16, (128, 128), 2, 16, 1, ""),    # the serving shape
])
def test_cuda_fold_mac_vs_plain(cuda_device, S, B, hw, cin, F, stride,
                                case):
    """The MAC-mode fold on event frames against its plain version
    (im2col + the patch fold): within 1e-5, and bit for bit on event
    counts (exact dot products); one launch a call of the route the shape
    chooses, counted under its own name, and where that is the TMA route,
    the cp.async route too, on the same values through a copy of x0 off
    the 16-byte grid."""
    frames, w, a = _mac_inputs(S + B, B, S, hw, cin, F,
                               exact=case == "exact")
    ho, wo = -(-hw[0] // stride), -(-hw[1] // stride)
    x0 = (np.random.default_rng(S).standard_normal((B * ho * wo, F)) * 0.05
          ).astype(np.float32)
    x0, frames, w, a = [t.to(cuda_device) for t in _t(x0, frames, w, a)]
    if case == "misaligned":
        x0 = _misaligned(x0)
    route = sf.mac_route(x0, frames, w)
    assert route == ("tma" if cin == 2 and F % 8 == 0 and hw[1] % 2 == 0
                     and case != "misaligned" else "cp")
    want = ref.stream_fold_mac_frames_ref(x0, frames, w, a, stride=stride,
                                          dv_unit=0.01)
    runs = [(x0, route)] + ([(_misaligned(x0), "cp")] if route == "tma"
                            else [])
    for x, r in runs:
        counter = {"tma": "fold_mac", "cp": "fold_mac_cp"}[r]
        before = dict(sf.LAUNCHES)
        got = sf.stream_fold_mac(x, frames, w, a, stride=stride,
                                 dv_unit=0.01)
        assert sf.LAUNCHES == {**before, counter: before[counter] + 1}
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=0 if case == "exact" else 1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    x0, dep, a = [t.to(cuda_device) for t in _t(*_fold_inputs(0, 2, 8, 4))]
    with pytest.raises(TypeError):
        sf.stream_fold(x0.double(), dep, a)
    with pytest.raises(ValueError):
        sf.stream_fold(x0, dep, a.cpu())
    with pytest.raises(ValueError):
        sf.stream_fold(x0.t().contiguous().t(), dep[:, :, :3], a)


@pytest.mark.cuda
def test_cuda_fold_mac_rejects_bad_inputs(cuda_device):
    frames, w, a = [t.to(cuda_device) for t in _t(*_mac_inputs(
        0, 2, 1, (6, 6), 2, 4))]
    x0 = torch.zeros((2 * 36, 4), device=cuda_device)
    n = dict(sf.LAUNCHES)
    kw = dict(stride=1, dv_unit=0.01)
    with pytest.raises(TypeError):
        sf.stream_fold_mac(x0, frames.double(), w, a, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        sf.stream_fold_mac(x0, frames, w.cpu(), a, **kw)
    with pytest.raises(ValueError, match="shape"):
        sf.stream_fold_mac(x0[:-1], frames, w, a, **kw)
    with pytest.raises(ValueError, match="k·k·Cin"):
        sf.stream_fold_mac(x0, frames, w[:17], a, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sf.stream_fold_mac(x0, frames.transpose(2, 3).contiguous()
                           .transpose(2, 3), w, a, **kw)
    assert sf.LAUNCHES == n


# ---------------------------------------------------------------------------
# K1: the P²M conv kernel against its plain version
# ---------------------------------------------------------------------------

def _conv_inputs(seed, B, T, n_sub, hw, cin, F, n_cfg):
    """Event counts and quantized weights (exact dot products), leak legs
    and thresholds per config: numpy arrays in the kernel's argument
    order."""
    rng = np.random.default_rng(seed)
    ev = rng.poisson(0.5, (B, T, n_sub) + hw + (cin,)).astype(np.float32)
    w = (np.round(rng.uniform(-1, 1, (9 * cin, F)) * 8) / 8).astype(np.float32)
    v_inf = rng.uniform(-0.4, 0.3, (n_cfg, F)).astype(np.float32)
    decay = np.exp(-rng.uniform(0, 0.5, (n_cfg, F))).astype(np.float32)
    theta = rng.uniform(0.005, 0.03, (n_cfg, 1)).repeat(F, 1).astype(np.float32)
    pvg = (1 + 0.02 * rng.standard_normal(F)).astype(np.float32)
    pvo = (1.5e-3 * rng.standard_normal(F)).astype(np.float32)
    return ev, w, v_inf, decay, theta, pvg, pvo


_CONSTS = dict(kernel_size=3, dv_unit=0.01, half_swing=0.4, v_lo=-0.4,
               v_hi=0.4)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,stride,n_cfg,nonlinear,F,cin", [
    ((7, 9), 1, 1, True, 16, 2),
    ((12, 12), 2, 3, True, 16, 2),
    ((13, 11), 2, 3, False, 5, 2),
    ((20, 17), 1, 8, True, 8, 2),
    ((9, 10), 2, 2, True, 6, 1),           # the kernel's generic-K path
    ((8, 8), 1, 2, True, 40, 2),           # 10 filter groups a site
    ((12, 20), 1, 8, True, 64, 2),         # the most filters and configs
    ((37, 46), 1, 1, True, 16, 2),         # H, W off the 8x16 tile
    ((37, 46), 2, 3, True, 16, 2),
])
def test_cuda_p2m_conv_vs_plain(cuda_device, hw, stride, n_cfg, nonlinear, F,
                                cin):
    """Bit-exact on exact inputs (event counts x eighths), through the route
    the shape chooses, counted under its own name; where that is the
    tensor-core route, the FMA route too, on the same values through a copy
    of the events off the 16-byte grid."""
    from repro_torch.kernels.p2m_conv import ops, p2m_conv
    ts = [t.to(cuda_device) for t in _t(*_conv_inputs(
        hw[0] + n_cfg, 2, 3, 4, hw, cin, F, n_cfg))]
    kw = dict(_CONSTS, stride=stride, nonlinear=nonlinear)
    route = p2m_conv.conv_route(ts[0], ts[1], 3)
    assert route == ("mma" if cin == 2 and F % 8 == 0 and hw[1] % 2 == 0
                     else "fma")
    s_ref, v_ref = ops.p2m_conv_events_ref(*ts, **kw)
    ho, wo = -(-hw[0] // stride), -(-hw[1] // stride)
    runs = [(ts[0], route)]
    if route == "mma":
        runs.append((_misaligned(ts[0]), "fma"))
    for events, r in runs:
        assert p2m_conv.conv_route(events, ts[1], 3) == r
        counter = {"mma": "p2m_conv", "fma": "p2m_conv_fma"}[r]
        before = dict(p2m_conv.LAUNCHES)
        s, v = p2m_conv.p2m_conv_cuda(events, *ts[1:], **kw)
        assert p2m_conv.LAUNCHES == {**before, counter: before[counter] + 1}
        torch.cuda.synchronize()
        assert tuple(v.shape) == (n_cfg, 2, 3, ho, wo, F)
        torch.testing.assert_close(v, v_ref, rtol=0, atol=0)
        torch.testing.assert_close(s, s_ref, rtol=0, atol=0)
    assert 0 < float(s.sum()) < s.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fine_weights", "fractional_events",
                                  "both"])
def test_cuda_p2m_conv_split_terms(cuda_device, case):
    """The tensor-core route's bf16 terms: weights on a 2^-12 grid (hi +
    mid + lo terms of w) with counts <= 3 keep every dot product exact, so
    the kernel is still bit-exact; non-integer events (their terms too) are
    within chip_smoke.py's K1 tolerance (v_pre rtol 1e-5, atol 1e-6,
    spikes equal off a 1e-5 band around theta)."""
    from repro_torch.kernels.p2m_conv import ops, p2m_conv
    ev, w, *rest = _conv_inputs(11, 2, 3, 4, (20, 24), 2, 16, 3)
    rng = np.random.default_rng(12)
    if case in ("fine_weights", "both"):
        ev = np.minimum(ev, 3)
        w = (np.round(rng.uniform(-1, 1, w.shape) * 4096) / 4096
             ).astype(np.float32)
    if case in ("fractional_events", "both"):
        ev = ev + rng.uniform(0, 0.3, ev.shape).astype(np.float32)
    ts = [t.to(cuda_device) for t in _t(ev, w, *rest)]
    kw = dict(_CONSTS, stride=1)
    assert p2m_conv.conv_route(ts[0], ts[1], 3) == "mma"
    s, v = p2m_conv.p2m_conv_cuda(*ts, **kw)
    s_ref, v_ref = ops.p2m_conv_events_ref(*ts, **kw)
    torch.cuda.synchronize()
    if case == "fine_weights":
        torch.testing.assert_close(v, v_ref, rtol=0, atol=0)
        torch.testing.assert_close(s, s_ref, rtol=0, atol=0)
    else:
        torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
        band = (v_ref - ts[4][:, None, None, None, None]).abs() > 1e-5
        assert torch.equal(s[band], s_ref[band])
    assert 0 < float(s.sum()) < s.numel()


@pytest.mark.cuda
def test_cuda_p2m_quotient_is_the_true_division(cuda_device):
    """The kernel's v / half_swing (Markstein's correction step, __fdiv_rn
    below |v| = 2^-100) equals __fdiv_rn bit for bit for every float32
    with |v| <= 1, both signs: one launch over 2,130,706,434 values."""
    from repro_torch.kernels.p2m_conv import p2m_conv
    n = p2m_conv.LAUNCHES["p2m_conv"]
    assert p2m_conv.quotient_check(0.4, cuda_device) == 0
    assert p2m_conv.LAUNCHES["p2m_conv"] == n


@pytest.mark.cuda
def test_cuda_p2m_conv_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels.p2m_conv import p2m_conv
    ts = [t.to(cuda_device) for t in _t(*_conv_inputs(0, 1, 1, 2, (6, 6), 2,
                                                      4, 2))]
    kw = dict(_CONSTS, stride=1)
    n = p2m_conv.LAUNCHES["p2m_conv"]
    with pytest.raises(TypeError):
        p2m_conv.p2m_conv_cuda(ts[0].double(), *ts[1:], **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        p2m_conv.p2m_conv_cuda(ts[0], ts[1].cpu(), *ts[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        p2m_conv.p2m_conv_cuda(ts[0].transpose(3, 4).contiguous()
                               .transpose(3, 4), *ts[1:], **kw)
    with pytest.raises(ValueError, match="1 to 8 configs"):
        p2m_conv.p2m_conv_cuda(ts[0], ts[1], *[t.repeat(5, 1)
                                               for t in ts[2:5]],
                               *ts[5:], **kw)
    with pytest.raises(ValueError, match="shape"):
        p2m_conv.p2m_conv_cuda(ts[0], ts[1][:9], *ts[2:], **kw)
    with pytest.raises(ValueError, match="1 to 64 filters"):
        p2m_conv.p2m_conv_cuda(ts[0], ts[1].repeat(1, 17), *ts[2:], **kw)
    assert p2m_conv.LAUNCHES["p2m_conv"] == n


@pytest.mark.cuda
def test_cuda_p2m_apply_stacked_kernel_vs_scan(cuda_device):
    """The model path on the card: one launch for all three circuits,
    equal to one scan per circuit."""
    import dataclasses
    from repro_torch.core import leakage, p2m_layer
    from repro_torch.kernels.p2m_conv import p2m_conv
    cfg = p2m_layer.P2MConfig(out_channels=8, n_sub=4, mode="kernel")
    params = p2m_layer.p2m_init(torch.Generator().manual_seed(0), cfg)
    params = {k: v.to(cuda_device) for k, v in params.items()}
    ev = torch.from_numpy(np.random.default_rng(1).poisson(
        0.4, (2, 3, 4, 16, 16, 2)).astype(np.float32)).to(cuda_device)
    n = p2m_conv.LAUNCHES["p2m_conv"]
    s_m, v_m = p2m_layer.p2m_apply_stacked(params, ev, cfg,
                                           leakage.paper_circuits())
    assert p2m_conv.LAUNCHES["p2m_conv"] == n + 1
    for i, lc in enumerate(leakage.paper_circuits()):
        s_i, v_i = p2m_layer.p2m_apply(
            params, ev, dataclasses.replace(cfg, mode="scan", leak=lc))
        torch.testing.assert_close(v_m[i], v_i, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(s_m[i], s_i, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K4: the LIF kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soft_reset", [True, False])
@pytest.mark.parametrize("T,N,tau", [(4, 4096, 2.0), (9, 1003, 3.0),
                                     (64, 16384, 2.0), (4, 524288, 2.0),
                                     (11, 2 ** 19 + 8, 2.5)])
def test_cuda_lif_bit_exact_vs_plain(cuda_device, dtype, soft_reset, T, N,
                                     tau):
    from repro_torch.kernels.lif import lif, ref as lif_ref
    x = torch.from_numpy((np.random.default_rng(T + N).standard_normal(
        (T, N)) * 1.5).astype(np.float32)).to(cuda_device, dtype)
    before = dict(lif.LAUNCHES)
    got = lif.lif(x, tau=tau, v_th=1.0, soft_reset=soft_reset)
    route = lif.lif_route(x)
    assert lif.LAUNCHES == {**before, route: before[route] + 1}
    want = lif_ref.lif_ref(x, tau=tau, v_th=1.0, soft_reset=soft_reset)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert 0 < float(got.float().sum()) < got.numel()


def _offset_copy(t, nbytes):
    """A contiguous copy of ``t`` starting ``nbytes`` past a 16-byte
    boundary."""
    k = nbytes // t.element_size()
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    base = (-buf.data_ptr() % 16) // t.element_size()
    out = buf[base + k:base + k + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes
    return out


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,N,offset,lane", [
    (_F32, 4, 524288, 0, 16),     # the backbone's largest call: wide lanes
    (_BF16, 4, 524288, 0, 16),
    (_F32, 16, 131072, 0, 8),     # fewer columns: narrower lanes
    (_BF16, 16, 131072, 0, 4),
    (_F32, 64, 16384, 0, 4),      # chip_smoke's second shape
    (_BF16, 64, 16384, 0, 4),
    (_F32, 300, 4096, 0, 4),      # long T, several chunks of loads
    (_BF16, 300, 4096, 0, 4),
    (_F32, 5, 262145, 0, 4),      # N odd
    (_BF16, 5, 262145, 0, 2),     # bfloat16 rows off 4 bytes: one column
    (_F32, 4, 524288, 4, 4),      # a view 4 bytes off the 16-byte grid
    (_BF16, 4, 524288, 4, 4),
    (_BF16, 3, 1001, 2, 2),       # bfloat16 2 bytes off
])
def test_cuda_lif_routes_bit_exact(cuda_device, dtype, T, N, offset, lane):
    """Each lane width the wrapper picks, bit-exact with the plain version
    under soft and hard reset, counted under its route."""
    from repro_torch.kernels.lif import lif, ref as lif_ref
    x = torch.from_numpy((np.random.default_rng(T + N).standard_normal(
        (T, N)) * 1.5).astype(np.float32)).to(cuda_device, dtype)
    if offset:
        x = _offset_copy(x, offset)
    assert lif.lif_lane(x) == lane
    route = "lif" if lane >= 8 else "lif_narrow"
    assert lif.lif_route(x) == route
    for soft_reset in (True, False):
        before = dict(lif.LAUNCHES)
        got = lif.lif(x, soft_reset=soft_reset)
        assert lif.LAUNCHES == {**before, route: before[route] + 1}
        want = lif_ref.lif_ref(x, soft_reset=soft_reset)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert 0 < float(got.float().sum()) < got.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tau,mode", [(2.0, 0), (0.5, 0), (1.5, 1), (3.0, 1),
                                      (3 * 2.0 ** -30, 2)])
@pytest.mark.parametrize("scale,v_th", [(1.5, 1.0), (1e-38, 1e-38)])
def test_cuda_lif_quotients_bit_exact(cuda_device, dtype, tau, mode, scale,
                                      v_th):
    """Every quotient rule — a multiply by 1/tau (tau 2, 0.5), Markstein's
    step (1.5, 3) and the true division alone (3·2^-30, outside Markstein's
    range, where the membrane overflows) — bit-exact with the plain
    version's division, also where the inputs and the membrane are
    subnormal (scale 1e-38)."""
    from repro_torch.kernels.lif import lif, ref as lif_ref
    assert lif.quotient_mode(float(torch.tensor(tau, dtype=dtype))) == mode
    x = (torch.from_numpy((np.random.default_rng(7).standard_normal(
        (6, 4096)) * 1.5).astype(np.float32)) * scale).to(cuda_device, dtype)
    for soft_reset in (True, False):
        got = lif.lif(x, tau=tau, v_th=v_th, soft_reset=soft_reset)
        want = lif_ref.lif_ref(x, tau=tau, v_th=v_th, soft_reset=soft_reset)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_lif_op_matches_snn(cuda_device):
    from repro_torch.core import snn
    from repro_torch.kernels.lif import ops
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 2, 8, 8, 16)).astype(np.float32) * 2).to(cuda_device)
    got = ops.lif_over_time(x, snn.LIFConfig())
    torch.testing.assert_close(got, snn.lif_over_time(x, snn.LIFConfig()),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_lif_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels.lif import lif
    x = torch.zeros((4, 8), device=cuda_device)
    n = dict(lif.LAUNCHES)
    with pytest.raises(TypeError):
        lif.lif(x.half())
    with pytest.raises(ValueError, match="CUDA tensor"):
        lif.lif_cuda(x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        lif.lif(torch.zeros((8, 4), device=cuda_device).t())
    with pytest.raises(ValueError, match=r"\[T, N\]"):
        lif.lif(x[None])
    assert lif.LAUNCHES == n


# ---------------------------------------------------------------------------
# K5: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

def _fa_limit(want, abs_attn, dtype):
    """Per-element limit against the float32 plain version. float32: 2e-3
    (float32 sums in another order). bfloat16: the kernel rounds each p to
    bfloat16 before PV (relative error <= u = 2^-8 each, so <= u times the
    attention of |v|) and rounds the output (<= u |o|); the limit is their
    sum, with 2^-6 of the first and 1e-5 to spare for float32 order."""
    if dtype == torch.float32:
        return torch.full_like(want, 2e-3)
    u = 2.0 ** -8
    return u * want.abs() + u * (1 + 2.0 ** -6) * abs_attn + 1e-5


def _qkv(seed, shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        device, dtype) for s in shapes]


def _check_gqa(q, k, v, causal, kv_len):
    """One launch of gqa_attention on the card, held per element against
    attention_ref on the same values reshaped to [B H, S, d]; returns the
    kernel's output."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import gqa_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, Sq, H, d = q.shape
    before, key = dict(fa.LAUNCHES), fa.launch_key(causal)
    out = gqa_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert fa.LAUNCHES == {**before, key: before[key] + 1}
    assert out.dtype == q.dtype and out.shape == q.shape
    bh = [t.float().repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2)
          .reshape(B * H, t.shape[1], d) for t in (q, k, v)]
    want = attention_ref(*bh, causal=causal, kv_len=kv_len)
    abs_attn = attention_ref(bh[0], bh[1], bh[2].abs(), causal=causal,
                             kv_len=kv_len)
    got = out.float().transpose(1, 2).reshape(B * H, Sq, d)
    torch.cuda.synchronize()
    limit = _fa_limit(want, abs_attn, q.dtype)
    assert ((got - want).abs() <= limit).all(), (
        f"max |diff| {(got - want).abs().max().item()}")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,skv,H,d,causal,kv_len", [
    (2, 64, 64, 3, 16, True, None),
    (2, 100, 130, 3, 64, False, None),    # Sq and Skv off the tiles: pad
    (2, 200, 200, 3, 128, True, None),
    (2, 1, 96, 3, 128, False, 40),        # decode-like, kv_len masks the tail
    (2, 128, 128, 3, 32, True, 70),       # causal and kv_len together
    (2, 300, 300, 2, 128, True, None),    # B 2, Sq off the 128-row tile
    (2, 300, 300, 2, 64, False, None),
    (2, 130, 260, 2, 128, True, 40),      # kv_len inside the first kv tile
    (2, 260, 260, 2, 128, False, 128),    # kv_len on a kv tile boundary
    (2, 260, 260, 2, 64, True, 256),
    (1, 2048, 2048, 16, 128, True, None),  # the internlm2-1.8b prefill
])
def test_cuda_flash_attention_vs_plain(cuda_device, dtype, B, sq, skv, H, d,
                                       causal, kv_len):
    """G = 1, in gqa_attention's [B, S, H, d] layout (a row stride of H d,
    as at serving); with B = 2 a row or store that strayed into the next
    batch would show."""
    q, k, v = _qkv(d + sq, [(B, sq, H, d), (B, skv, H, d), (B, skv, H, d)],
                   dtype, cuda_device)
    _check_gqa(q, k, v, causal, kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 50)])
@pytest.mark.parametrize("G,d", [(1, 64), (2, 64), (4, 128), (8, 128),
                                 (2, 32)])
def test_cuda_gqa_attention_groups(cuda_device, dtype, causal, kv_len, G, d):
    """G query heads per kv head, indexed in the kernel."""
    q, k, v = _qkv(5 + G, [(2, 77, 8, d), (2, 77, 8 // G, d),
                           (2, 77, 8 // G, d)], dtype, cuda_device)
    _check_gqa(q, k, v, causal, kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,skv,H,KV,d,causal,kv_len", [
    (1, 300, 300, 4, 4, 112, True, None),     # zamba2's shared block
    (2, 100, 130, 4, 2, 112, False, None),    # G 2, Sq and Skv off tiles
    (2, 260, 260, 4, 4, 112, True, 200),
    (1, 300, 300, 2, 2, 256, True, None),     # gemma
    (2, 100, 130, 4, 2, 256, False, None),
    (2, 1, 96, 2, 2, 256, False, 40),         # decode-like
    # B 2 causal with Sq off the 128-row TMA tile: a row read or stored
    # past Sq would land in the next batch
    (2, 100, 100, 4, 2, 112, True, None),
    (2, 100, 100, 4, 2, 256, True, None),
    (2, 1, 96, 2, 2, 112, False, 40),         # decode-like
    # kv_len inside a 64-key tile of the d 256 route, and on its boundary
    (2, 130, 260, 2, 2, 256, True, 40),
    (2, 200, 200, 2, 2, 256, False, 100),
    (2, 260, 260, 2, 2, 256, False, 128),
    (2, 260, 260, 2, 2, 256, True, 192),
    (2, 77, 77, 8, 2, 112, True, None),       # G 4
    (2, 77, 77, 8, 2, 112, False, 50),
    (2, 77, 77, 8, 2, 256, True, None),
    (2, 77, 77, 8, 2, 256, False, 50),
    (1, 2048, 2048, 32, 32, 112, True, None),  # zamba2-7b's prefill
    (1, 2048, 2048, 16, 16, 256, True, None),  # gemma-7b's prefill
])
def test_cuda_flash_attention_wide_heads(cuda_device, dtype, B, sq, skv, H,
                                         KV, d, causal, kv_len):
    """Head dims 112 and 256 against attention_ref, per element. In
    bfloat16 both take the wgmma route: d 112 on d 128's tiles over a
    zero-filled pad of 16 columns (only the 112 true ones stored), d 256
    on 64-key kv tiles; in float32 the FMA route."""
    q, k, v = _qkv(d + sq + KV, [(B, sq, H, d), (B, skv, KV, d),
                                 (B, skv, KV, d)], dtype, cuda_device)
    _check_gqa(q, k, v, causal, kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,skv,H,KV,d", [
    (1, 2048, 1601, 64, 16, 128),    # llama-3.2-vision's cross-attention
    (1, 2048, 2048, 16, 16, 64),     # seamless-m4t's encoder
    (1, 2048, 1000, 16, 16, 64),     # its decoder onto 1000 frames
    (2, 100, 161, 8, 2, 128),        # B 2, a ragged last kv tile
    (2, 100, 161, 8, 2, 64),
    (2, 300, 1601, 8, 2, 128),       # B 2 at the image token count
])
def test_cuda_flash_attention_cross_shapes(cuda_device, dtype, B, sq, skv,
                                           H, KV, d):
    """Without the causal mask, q onto a key sequence of another length
    (the vlm and enc-dec prefills' cross and encoder attention). Skv 1601
    = 12 x 128 + 65 leaves the last kv tile ragged; at B 2 a key read
    past Skv would come from the next batch's keys."""
    q, k, v = _qkv(d + skv + B, [(B, sq, H, d), (B, skv, KV, d),
                                 (B, skv, KV, d)], dtype, cuda_device)
    _check_gqa(q, k, v, False, None)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q = torch.zeros((1, 8, 2, 16), device=cuda_device)
    n = dict(fa.LAUNCHES)
    with pytest.raises(TypeError):
        fa.gqa_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="CUDA"):
        fa.gqa_attention_cuda(q, q.cpu(), q)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 8, 2, 24), device=cuda_device)
        fa.gqa_attention_cuda(z, z, z)
    with pytest.raises(ValueError, match="bad shapes"):
        fa.gqa_attention_cuda(torch.zeros((1, 8, 3, 16), device=cuda_device),
                              q, q)
    with pytest.raises(ValueError, match="aligned"):
        off = torch.zeros(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
        fa.gqa_attention_cuda(off, q, q)
    assert fa.LAUNCHES == n


# ---------------------------------------------------------------------------
# K6: the SSD kernel against its plain version
# ---------------------------------------------------------------------------

def _ssd_args(seed, b, s, h, p, g, n, dtype, device):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = f(rng.standard_normal((b, s, h, p))).to(dtype)
    dt = f(np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    A = f(-np.exp(rng.standard_normal(h) * 0.3))
    B = f(rng.standard_normal((b, s, g, n))).to(dtype)
    C = f(rng.standard_normal((b, s, g, n))).to(dtype)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", [
    (1, 64, 2, 16, 1, 16, 16, torch.float32),
    (2, 96, 4, 32, 2, 8, 32, torch.float32),      # g < h
    (1, 50, 2, 16, 2, 4, 16, torch.float32),      # pad, g == h
    (1, 200, 4, 64, 1, 128, 128, torch.float32),  # pad, the mamba2 widths
    (2, 256, 6, 64, 2, 128, 128, torch.bfloat16),
    (1, 130, 3, 16, 3, 32, 64, torch.bfloat16),
    # the chunk-parallel passes: one chunk (no state passed on), s a
    # multiple of the chunk, chunk 16 over 60 chunks, n 4 and 5 (zero-
    # padded to 16 in shared memory, B/C rows off the 16-byte grid), b 2
    # with g 2 and h 6 at the mamba2 widths with s off the chunk
    (1, 100, 4, 64, 1, 128, 128, torch.bfloat16),
    (1, 100, 4, 64, 1, 128, 128, torch.float32),
    (1, 384, 4, 64, 1, 128, 128, torch.bfloat16),
    (1, 960, 2, 32, 1, 64, 16, torch.bfloat16),
    (1, 960, 2, 32, 1, 64, 16, torch.float32),
    (1, 90, 2, 16, 1, 4, 32, torch.bfloat16),
    (1, 70, 2, 32, 2, 5, 16, torch.bfloat16),
    (2, 300, 6, 64, 2, 128, 128, torch.bfloat16),
    (2, 300, 6, 64, 2, 128, 128, torch.float32),
])
def test_cuda_ssd_vs_plain(cuda_device, b, s, h, p, g, n, chunk, dtype):
    """y and state within relative error 1e-3 (of the largest magnitude) of
    the plain float32 recurrence on the same inputs; a bfloat16 y may also
    sit one bfloat16 step (2^-8 relative) away, the rounding of its
    output."""
    args = _ssd_args(s + h + n, b, s, h, p, g, n, dtype, cuda_device)
    _check_ssd(args, chunk)


def _check_ssd(args, chunk):
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    dtype = args[0].dtype
    k = ssd_mod.LAUNCHES["ssd"]
    y, st = ssd(*args, chunk=chunk)
    assert ssd_mod.LAUNCHES["ssd"] == k + 1
    y_r, st_r = ssd_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == torch.float32
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_r.float(), rtol=rtol,
                               atol=1e-3 * float(y_r.float().abs().max()))
    torch.testing.assert_close(st, st_r, rtol=0,
                               atol=1e-3 * float(st_r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_unaligned_inputs(cuda_device, dtype):
    """x, B and C that start off the 16-byte grid take the kernel's
    element-wise staging and give the same result."""
    x, dt, A, B, C = _ssd_args(7, 1, 200, 4, 64, 1, 128, dtype, cuda_device)
    x, B, C = (_misaligned(t) for t in (x, B, C))
    _check_ssd((x, dt, A, B, C), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_zamba2_heads(cuda_device, dtype):
    """zamba2-7b's SSM shape: 112 heads of p 64, state n 64, one group, s
    off the 128-step chunk."""
    args = _ssd_args(64, 1, 300, 112, 64, 1, 64, dtype, cuda_device)
    _check_ssd(args, 128)


@pytest.mark.cuda
def test_cuda_ssd_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels.ssd import ssd as ssd_mod
    x, dt, A, B, C = _ssd_args(0, 1, 32, 2, 16, 1, 8, torch.float32,
                               cuda_device)
    n = ssd_mod.LAUNCHES["ssd"]
    with pytest.raises(TypeError):
        ssd_mod.ssd_cuda(x, dt.double(), A, B, C)
    with pytest.raises(TypeError):
        ssd_mod.ssd_cuda(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd_cuda(x, dt, A.cpu(), B, C)
    with pytest.raises(ValueError, match="chunk"):
        ssd_mod.ssd_cuda(x, dt, A, B, C, chunk=48)
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_mod.ssd_cuda(x, dt, A[:1], B, C)
    assert ssd_mod.LAUNCHES["ssd"] == n


# ---------------------------------------------------------------------------
# LM training: ssd_trainable, remat and the donated step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n", [(2, 256, 4, 64, 1, 128),
                                         (1, 128, 6, 16, 2, 16)])
def test_cuda_ssd_trainable_vs_the_plain_route(cuda_device, dtype, b, s, h,
                                               p, g, n):
    """ssd_trainable on the card: y through K6 (one launch, within K6's
    limit of ssd_chunked's y), and the gradients of all five inputs within
    1e-6 of each one's largest magnitude of those of ssd_chunked itself
    on the same inputs and cotangent (both differentiate ssd_chunked, so
    they are expected to be the same bits)."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd.ops import ssd_trainable
    from repro_torch.nn.ssm import ssd_chunked
    args = _ssd_args(s + h, b, s, h, p, g, n, dtype, cuda_device)
    gy = torch.randn(args[0].shape, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device).to(dtype)
    live = [a.clone().requires_grad_() for a in args]
    k = ssd_mod.LAUNCHES["ssd"]
    y = ssd_trainable(*live)
    assert ssd_mod.LAUNCHES["ssd"] == k + 1 and y.dtype == dtype
    got = torch.autograd.grad(y, live, gy)
    plain = [a.clone().requires_grad_() for a in args]
    y_p, _ = ssd_chunked(*plain, 128)
    want = torch.autograd.grad(y_p, plain, gy)
    assert ssd_mod.LAUNCHES["ssd"] == k + 1
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol,
                               atol=1e-3 * float(y_p.float().abs().max()))
    for name, a, w in zip("x dt A B C".split(), got, want):
        assert a.dtype == w.dtype, name
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=1e-6 * float(w.float().abs().max()),
                                   msg=name)


def _lm_train_case(arch, compute="float32", **kw):
    """A smoke variant's config, shape (2 x 128), CPU params and 2 batches
    on the card, each with its own seeded img_embed (vlm) or frames
    (enc-dec). MoE's embedding rows are shifted by their standard
    deviation: the shared direction sends most tokens to the same experts,
    so the capacity factor of 1.25 drops choices in every layer."""
    from dataclasses import replace
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStreamConfig, sample_batch
    from repro_torch.models import encdec, lm
    from repro_torch.train.steps import make_batch_specs
    cfg = replace(smoke_variant(get_config(arch)), compute_dtype=compute,
                  **kw)
    shape = ShapeConfig("t", "train", 128, 2)
    init = encdec.init_params if cfg.is_encdec else lm.init_params
    params = init(torch.Generator().manual_seed(0), cfg, "cpu")
    if cfg.n_experts:
        emb = params["embed"]["embedding"]
        emb += emb.std()
    extra = {k: v for k, v in make_batch_specs(cfg, shape).items()
             if k not in ("tokens", "labels")}
    batches = [{k: v.cuda() for k, v in dict(sample_batch(TokenStreamConfig(
        cfg.vocab_size, 128, 2), i), **{k: torch.randn(
            v.shape, generator=torch.Generator().manual_seed(10 + i)).to(
            v.dtype) for k, v in extra.items()}).items()} for i in range(2)]
    return cfg, shape, params, batches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m",
                                  "granite-moe-1b-a400m", "zamba2-7b"])
def test_cuda_remat_gives_the_same_bits(cuda_device, arch):
    """On the card (mamba2 and zamba2 through K6), remat "none", "full"
    and "dots": the same loss and gradients, bit for bit. K6 launches once
    per SSM block under "none", twice under "full" and "dots" (the
    backward pass recomputes the block's, or the hybrid group's, forward
    through the SSD scan)."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.models import lm
    from repro_torch.utils import tree_map, tree_paths
    out, launches = {}, {}
    for remat in ("none", "full", "dots"):
        cfg, _, params, batches = _lm_train_case(arch, remat=remat)
        live = tree_map(lambda t: t.cuda().requires_grad_(), params)
        paths, leaves = zip(*tree_paths(live))
        k = ssd_mod.LAUNCHES["ssd"]
        loss, _ = lm.loss_fn(live, batches[0], cfg)
        grads = torch.autograd.grad(loss, leaves)
        launches[remat] = ssd_mod.LAUNCHES["ssd"] - k
        out[remat] = (loss, dict(zip(paths, grads)))
    if cfg.family in ("ssm", "hybrid"):
        n = cfg.n_layers
        assert launches == {"none": n, "full": 2 * n, "dots": 2 * n}, launches
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for path, g in out["none"][1].items():
            assert torch.equal(out[remat][1][path], g), (remat, path)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m",
                                  "granite-moe-1b-a400m", "zamba2-7b"])
def test_cuda_donated_step_gives_the_same_bits(cuda_device, arch):
    """Two bf16-compute train steps on the card with donate=True (the
    update written into the given tensors) and donate=False: the same
    losses, gradient norms, params and moments, bit for bit."""
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map, tree_paths
    cfg, shape, params, batches = _lm_train_case(arch, "bfloat16")
    out = {}
    for donate in (False, True):
        step, _, opt = build_train_step(cfg, shape, lr=1e-3, donate=donate,
                                        device=cuda_device)
        p = tree_map(lambda t: t.cuda(), params)
        o = opt.init(p)
        ms = []
        for b in batches:
            p, o, m = step(p, o, b)
            ms.append((m["loss"], m["gnorm"]))
        out[donate] = (ms, {"params": p, "opt": o})
    for (l1, g1), (l2, g2) in zip(out[False][0], out[True][0]):
        assert torch.equal(l1, l2) and torch.equal(g1, g2)
    for (path, a), (_, b) in zip(tree_paths(out[False][1]),
                                 tree_paths(out[True][1])):
        assert torch.equal(a, b), path


def _train_on(device, cfg, shape, params, batches, drops=None):
    """Float32 train steps from ``params`` on ``device``: per step (loss,
    gnorm), the final params and moments on the CPU, and the K6 launches;
    ``drops`` (a list) collects each moe_apply call's drop_frac."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.nn import moe
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map
    step, _, opt = build_train_step(cfg, shape, lr=1e-3, device=device)
    p = tree_map(lambda t: t.to(device, copy=True), params)
    o = opt.init(p)
    apply, ms, k = moe.moe_apply, [], ssd_mod.LAUNCHES["ssd"]

    def recording(*a, **kw):
        y, aux = apply(*a, **kw)
        drops.append(float(aux["drop_frac"]))
        return y, aux
    if drops is not None:
        moe.moe_apply = recording
    try:
        for b in batches:
            p, o, m = step(p, o, {n: v.to(device) for n, v in b.items()})
            ms.append((float(m["loss"]), float(m["gnorm"])))
    finally:
        moe.moe_apply = apply
    return (ms, tree_map(lambda t: t.cpu(), {"params": p, "opt": o}),
            ssd_mod.LAUNCHES["ssd"] - k)


def _close_train(got, want):
    """Card against CPU: loss within 1e-4 and gnorm within 1e-3
    (relative), params and AdamW moments within rtol 2e-4, atol 2e-5 (the
    train step's tolerance in tests/test_torch_lm_train.py)."""
    from repro_torch.utils import tree_paths
    for (l1, g1), (l2, g2) in zip(got[0], want[0]):
        assert abs(l1 - l2) <= 1e-4 * abs(l2) and abs(g1 - g2) <= 1e-3 * g2
    ref = dict(tree_paths(want[1]))
    for path, a in tree_paths(got[1]):
        torch.testing.assert_close(a, ref[path], rtol=2e-4, atol=2e-5,
                                   msg=path)


@pytest.mark.cuda
def test_cuda_moe_train_steps_match_cpu(cuda_device):
    """granite-moe's smoke variant, 2 float32 train steps at capacity
    factor 1.25 with choices dropped in every layer (the shifted
    embedding): the card against the CPU (_close_train), with the same
    drop share in every moe_apply call, and no kernel launched."""
    cfg, shape, params, batches = _lm_train_case("granite-moe-1b-a400m")
    drops = {"cuda": [], "cpu": []}
    got, want = (_train_on(d, cfg, shape, params, batches, drops[d])
                 for d in ("cuda", "cpu"))
    assert min(drops["cpu"]) > 0
    np.testing.assert_allclose(drops["cuda"], drops["cpu"], rtol=0, atol=1e-6)
    assert got[2] == 0
    _close_train(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_cuda_hybrid_train_steps_match_cpu(cuda_device, remat):
    """zamba2's smoke variant at 4 SSM blocks in groups of 2 (the shared
    block used twice), 2 float32 train steps: K6 launched once per SSM
    block a forward (n_layers a step under remat "none", twice that under
    "full", which recomputes each group), and the card against the CPU
    (_close_train; the CPU runs the plain scan)."""
    cfg, shape, params, batches = _lm_train_case("zamba2-7b", n_layers=4,
                                                 remat=remat)
    got, want = (_train_on(d, cfg, shape, params, batches)
                 for d in ("cuda", "cpu"))
    per_step = cfg.n_layers * (2 if remat == "full" else 1)
    assert got[2] == per_step * len(batches) and want[2] == 0
    _close_train(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("qwen3-32b", {}), ("gemma-7b", {}),
    ("phi4-mini-3.8b", {"tp_multiple": 8}),
    ("llama-3.2-vision-90b", {"n_layers": 4}),
    ("seamless-m4t-large-v2", {})],
    ids=["qwen3-32b", "gemma-7b", "phi4-mini-3.8b-tp8",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_cuda_train_step_matches_cpu(cuda_device, arch, kw):
    """One float32 train step of each family trained since the dense and
    ssm ones (qk-norm, GeGLU, phi4 with its heads padded 4 -> 8, the vlm
    at two groups with its img_embed, the enc-dec with its frames) on the
    card against the CPU from the same params and batch: loss within 1e-4
    and gnorm within 1e-3 (relative), params and moments by
    tests/adam_close.py (the enc-dec with its exemption, as chip_smoke.py's
    LM_TRAIN_ADAM_EXEMPT: AdamW's ill-conditioned elements, their
    gradients held per element); no K5 or K6 launch on the card (training
    attends through the plain attention_core)."""
    from adam_close import close_state
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.utils import tree_paths
    cfg, shape, params, batches = _lm_train_case(arch, **kw)
    k5 = dict(fa.LAUNCHES)
    got, want = (_train_on(d, cfg, shape, params, batches[:1])
                 for d in ("cuda", "cpu"))
    assert fa.LAUNCHES == k5 and got[2] == want[2] == 0
    (l1, g1), (l2, g2) = got[0][0], want[0][0]
    assert abs(l1 - l2) <= 1e-4 * abs(l2) and abs(g1 - g2) <= 1e-3 * g2
    close_state({k: v.numpy() for k, v in tree_paths(got[1])},
                {k: v.numpy() for k, v in tree_paths(want[1])}, 1, 1e-3, {},
                exempt=cfg.is_encdec)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b", "qwen3-32b",
                                  "granite-moe-1b-a400m", "grok-1-314b",
                                  "zamba2-7b"])
def test_cuda_lm_serving_matches_cpu(cuda_device, arch):
    """A smoke variant served on the card (prefill through K5, and K6 for
    zamba2) and on the CPU from the same weights and prompts, float32
    compute: the same tokens for every request (more requests than lanes,
    prompts of several lengths)."""
    from dataclasses import replace
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import lm
    from repro_torch.serve.steps import serve_config
    from repro_torch.utils import tree_map
    cfg = replace(smoke_variant(get_config(arch)), compute_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(0),
                            serve_config(cfg), "cpu")
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (20 + 37 * i,),
                             generator=gen) for i in range(5)]
    out = {}
    for device in ("cuda", "cpu"):
        server = SlotServer(cfg, 2, 200, device=device)
        server.load(tree_map(lambda t: t.to(device), params))
        reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
        n = dict(fa.LAUNCHES)
        serve(server, reqs)
        out[device] = [r.generated for r in reqs]
        if device == "cuda":
            calls = cfg.n_layers // (cfg.attn_every or 1)
            assert fa.LAUNCHES == {
                **n, "flash_attention": n["flash_attention"] + 5 * calls}
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [("gemma-7b", 256),
                                           ("zamba2-7b", 112)])
def test_cuda_lm_serving_wide_heads_bf16(cuda_device, arch, head_dim,
                                         monkeypatch):
    """The smoke variant at its published head dim, served in bfloat16 on
    the card: every prefill's attention runs K5's bf16 wgmma route (d 256
    on 64-key tiles, d 112 over the zero-filled pad) at the shapes the
    model gives it, prompts off the 128-row tile, and each launch is held
    per element to attention_ref within _fa_limit as it is served."""
    from dataclasses import replace
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import lm
    from repro_torch.serve.steps import serve_config
    from repro_torch.utils import tree_map
    cfg = replace(smoke_variant(get_config(arch)), head_dim=head_dim)
    assert cfg.compute_dtype == "bfloat16"
    params = lm.init_params(torch.Generator().manual_seed(0),
                            serve_config(cfg), "cpu")
    shapes = []

    def checked(q, k, v, *, causal=True, chunk=None):
        shapes.append(tuple(q.shape))
        assert q.dtype == torch.bfloat16 and q.shape[-1] == head_dim
        return _check_gqa(q, k, v, causal, None)

    monkeypatch.setattr(lm, "gqa_attention", checked)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (20 + 37 * i,),
                             generator=gen) for i in range(5)]
    server = SlotServer(cfg, 2, 200, device="cuda")
    server.load(tree_map(lambda t: t.to("cuda"), params))
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    n = dict(fa.LAUNCHES)
    serve(server, reqs)
    calls = cfg.n_layers // (cfg.attn_every or 1)
    assert fa.LAUNCHES == {
        **n, "flash_attention": n["flash_attention"] + 5 * calls}
    assert sorted({s[1] for s in shapes}) == [20, 57, 94, 131, 168]
    for r in reqs:
        assert len(r.generated) == 6
        assert all(0 <= t < cfg.vocab_size for t in r.generated)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_cuda_cross_attention_serving_matches_cpu(cuda_device, arch):
    """The vlm (two groups) and enc-dec smoke variants through the model
    API on the card (every prefill attention through K5: self causal,
    cross and encoder without the mask) and on the CPU from the same
    weights, images or frames and prompts, float32 compute: last logits
    and three greedy decode steps' logits within 1e-4, the same tokens."""
    from dataclasses import replace
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import encdec, lm
    from repro_torch.serve.steps import serve_config
    from repro_torch.utils import tree_map
    cfg = replace(smoke_variant(get_config(arch)), compute_dtype="float32")
    if not cfg.is_encdec:
        cfg = replace(cfg, n_layers=4)
    mod = encdec if cfg.is_encdec else lm
    params = mod.init_params(torch.Generator().manual_seed(0),
                             serve_config(cfg), "cpu")
    gen = torch.Generator().manual_seed(6)
    B, S = 3, 37
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    src = (torch.randn((B, 29, cfg.d_model), generator=gen) if cfg.is_encdec
           else torch.randn((B, cfg.n_image_tokens, cfg.vision_dim),
                            generator=gen))
    out = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        n = dict(fa.LAUNCHES)
        if cfg.is_encdec:
            last, cache = encdec.prefill(p, src.to(device), tokens.to(device),
                                         cfg, max_len=S + 4)
            causal = cfg.n_layers
            cross = cfg.encoder_layers + cfg.n_layers
        else:
            last, cache = lm.prefill(p, tokens.to(device), cfg,
                                     img_embed=src.to(device), max_len=S + 4)
            cross = cfg.n_layers // cfg.cross_every
            causal = cfg.n_layers - cross
        if device == "cuda":
            assert fa.LAUNCHES == {
                "flash_attention": n["flash_attention"] + causal,
                "flash_attention_noncausal":
                    n["flash_attention_noncausal"] + cross}
        logits, toks = [last.cpu()], []
        for i in range(3):
            toks.append(logits[-1].argmax(-1))
            step, cache = mod.decode_step(p, toks[-1][:, None].to(device),
                                          torch.tensor(S + i, device=device),
                                          cache, cfg)
            logits.append(step[:, 0].cpu())
        out[device] = (torch.stack(logits), torch.stack(toks))
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# the co-design sweep and deploying from it
# ---------------------------------------------------------------------------

def _sweep_setup():
    """The fast grid at reduced() with the smallest step counts."""
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign, sweep
    cfg, data = p2m_dvs.reduced()
    grid = sweep.fast_grid()
    scfg = codesign.SweepConfig(t_intg_grid_ms=grid.t_intg_grid_ms,
                                batch_size=2, pretrain_steps=2,
                                finetune_steps=1, eval_batches=1)
    return cfg, data, grid, scfg


def _sweep_run(device, source=None):
    """Both protocols on ``device`` from the seeded init."""
    from repro_torch.core import sweep
    cfg, data, grid, scfg = _sweep_setup()
    return sweep.run_protocols(data if source is None else source, cfg,
                               scfg, grid, device=device, keep_params=True,
                               log=lambda *_: None)


@pytest.mark.cuda
def test_cuda_sweep_matches_cpu(cuda_device):
    """The sweep on the card and on the CPU: accuracy, spikes and labels
    equal; bandwidth, sensor energy and retention within 1e-5; backend
    energies within sweep_parity.COUNTER_RTOL (the backbone's counts,
    which roundoff-trained weights move); trained params as
    tests/sweep_parity.py holds them (within 1e-4 of each leaf's largest
    magnitude, but for the elements whose gradient is as small as its
    roundoff, measured on the CPU runs, within 2·lr a step). A planted
    fault, the card's
    updates all dropped so its params stay as pretrained, must fail that
    params check."""
    import sweep_parity as sp
    _, data, _, scfg = _sweep_setup()
    steps = scfg.pretrain_steps + 1 + scfg.finetune_steps
    cpu, masks = sp.cpu_reference(lambda src: _sweep_run("cpu", src), data,
                                  n_pre=scfg.pretrain_steps,
                                  steps=1 + scfg.finetune_steps, rtol=1e-4)
    card = _sweep_run("cuda")
    for proto in ("frozen", "unfrozen"):
        rc, rp = card[proto], cpu[proto]
        assert rc.labels == rp.labels
        for a, b in zip(rc.records, rp.records):
            for k in ("label", "variant", "accuracy", "layer1_spikes",
                      "input_events"):
                assert a[k] == b[k], (proto, b["label"], k)
            for k, rel in (("bandwidth_ratio", 1e-5),
                           ("sensor_energy_p2m_j", 1e-5),
                           ("retention_err_v", 1e-5),
                           ("backend_energy_conventional_j", sp.COUNTER_RTOL),
                           ("backend_energy_p2m_j", sp.COUNTER_RTOL)):
                np.testing.assert_allclose(a[k], b[k], rtol=rel)
    par = sp.compare_runs(card, cpu, masks, lr=scfg.lr, steps=steps,
                          rtol=1e-4)
    assert not par.failures, par.failures
    with sp.skip_updates(None):
        frozen = _sweep_run("cuda")
    assert sp.compare_runs(frozen, cpu, masks, lr=scfg.lr, steps=steps,
                           rtol=1e-4).failures


@pytest.mark.cuda
def test_cuda_deploy_from_sweep_serves_as_the_plain_fold(cuda_device,
                                                         tmp_path):
    """A checkpoint of the card's sweep, served on the card through each
    fold kernel (K2, K3) and on the CPU through the plain fold: the same
    predictions and logits within 1e-4."""
    from repro_torch.data import sources
    from repro_torch.stream import deploy
    from repro_torch.stream.engine import StreamEngine
    cfg = _sweep_setup()[0]
    res = _sweep_run("cuda")["frozen"]
    rec = deploy.select_record(res.records, t_intg_ms=10.0)
    deploy.deploy_from_sweep(res, cfg, rec, tmp_path / "ckpt")
    src = sources.resolve_dataset("synthetic-gesture",
                                  hw=cfg.backbone.input_hw[0],
                                  duration_ms=1000.0)
    logits = {}
    for device, mode in (("cpu", "deposit"), ("cuda", "deposit"),
                         ("cuda", "mac")):
        dep = deploy.load_deployment(tmp_path / "ckpt", device=device)
        rep = StreamEngine(dep, capacity=2, fold_mode=mode,
                           device=device).serve(src, 3, seed=4)
        logits[(device, mode)] = np.array(
            [r.logits for r in sorted(rep.results,
                                      key=lambda r: r.stream_id)])
    want = logits[("cpu", "deposit")]
    for key in (("cuda", "deposit"), ("cuda", "mac")):
        np.testing.assert_allclose(logits[key], want, rtol=0, atol=1e-4,
                                   err_msg=str(key))


# ---------------------------------------------------------------------------
# registry serving through K2/K3, and adaptation, on the card
# ---------------------------------------------------------------------------

def _awake(params, gain=2.0):
    """Double the BN scales and fc0 weights of a fresh backbone, which
    otherwise goes silent (every logit 0, a vacuous comparison)."""
    bb = params["backbone"]
    for k, v in bb.items():
        if k.startswith("bn"):
            v["scale"].mul_(gain)
    bb["fc0"]["w"].mul_(gain)
    return params


def _circuit_deps(device, coarse_ms=None):
    """reduced() deployments of the three paper circuits (c at mismatch
    0.06), fresh and seeded, on ``device``."""
    import dataclasses
    from repro_torch.configs import p2m_dvs
    from repro_torch.core.leakage import CircuitConfig
    from repro_torch.stream import deploy
    cfg, _ = p2m_dvs.reduced()
    if coarse_ms is not None:
        cfg = dataclasses.replace(cfg, coarse_window_ms=coarse_ms)
    out = {}
    for seed, (name, leak) in enumerate((
            ("a", dict(circuit=CircuitConfig.BASIC)),
            ("b", dict(circuit=CircuitConfig.SWITCH)),
            ("c", dict(circuit=CircuitConfig.NULLIFIED,
                       null_mismatch=0.06)))):
        c = dataclasses.replace(cfg, p2m=dataclasses.replace(
            cfg.p2m, leak=dataclasses.replace(cfg.p2m.leak, **leak)))
        dep = deploy.fresh_deployment(c, seed=seed, device=device)
        _awake(dep.params)
        out[name] = dep
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode, counter", [("deposit", "fold"),
                                           ("mac", "fold_mac")])
def test_cuda_registry_serve_bit_identical_to_singles(cuda_device, mode,
                                                      counter):
    """A mixed-variant serve (three circuits round-robin on 3 lanes)
    through K2 or K3: every stream's logits bit-identical to a
    single-variant serve of its entry on the card, and one launch per
    served entry per chunk (+ the warm-up's)."""
    from repro_torch.data import sources
    from repro_torch.stream.engine import StreamEngine
    from repro_torch.stream.registry import Registry
    deps = _circuit_deps("cuda")
    reg = Registry()
    for name, dep in deps.items():
        reg.register(name, dep)
    src = sources.resolve_dataset("synthetic-gesture", hw=24,
                                  duration_ms=1000.0)
    names = list(deps)
    eng = StreamEngine(reg, capacity=3, fold_mode=mode, device="cuda")
    before = dict(sf.LAUNCHES)
    rep = eng.serve(src, 6, seed=2, variants=[names[i % 3] for i in range(6)])
    torch.cuda.synchronize()
    launched = {k: sf.LAUNCHES[k] - before[k] for k in sf.LAUNCHES}
    windows = {}
    for r in rep.results:
        for w in range(r.admitted_window, r.finished_window):
            windows.setdefault(w, set()).add(r.entry_uid)
    expected = eng.chunks_per_window * sum(map(len, windows.values())) + 1
    assert launched[counter] == expected and \
        sum(launched.values()) == expected, (launched, expected)
    for name, dep in deps.items():
        single = {r.stream_id: r for r in StreamEngine(
            dep, capacity=3, fold_mode=mode, device="cuda").serve(
                src, 6, seed=2).results}
        for r in rep.results:
            if r.entry == name:
                np.testing.assert_array_equal(r.logits,
                                              single[r.stream_id].logits)
    assert np.abs([r.logits for r in rep.results]).max() > 0.05


@pytest.mark.cuda
def test_cuda_adaptation_matches_cpu(cuda_device):
    """Surrogate adaptation (lr 0.5, reduced() with a 100 ms coarse
    window, 4 streams on 2 lanes) on the card and on the CPU: equal update
    counts, deltas within 1e-4 of their largest element, logits within
    1e-4; with lr 0 the card's adapting serve (cuDNN per-lane fold) stays
    within 1e-4 of its frozen K2 serve, predictions equal."""
    from repro_torch.data import sources
    from repro_torch.stream.adapt import AdaptConfig
    from repro_torch.stream.engine import StreamEngine
    src = sources.resolve_dataset("synthetic-gesture", hw=24,
                                  duration_ms=1000.0)
    runs = {}
    for device in ("cuda", "cpu"):
        dep = _circuit_deps(device, coarse_ms=100.0)["c"]
        eng = StreamEngine(dep, capacity=2, device=device,
                           adapt=AdaptConfig(lr_w=0.5, lr_theta=0.01))
        rep = eng.serve(src, 4, seed=3)
        runs[device] = (rep, {k: v.cpu().numpy()
                              for k, v in eng.adapt_state.items()})
    (crep, cst), (prep, pst) = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(cst["n_updates"], pst["n_updates"])
    assert pst["n_updates"].min() > 0
    for key in ("dw", "dtheta"):
        scale = np.abs(pst[key]).max()
        assert scale > 0 and np.abs(cst[key] - pst[key]).max() <= 1e-4 * scale
    by = lambda rep: np.array([r.logits for r in sorted(  # noqa: E731
        rep.results, key=lambda r: r.stream_id)])
    np.testing.assert_allclose(by(crep), by(prep), rtol=0, atol=1e-4)
    dep = _circuit_deps("cuda", coarse_ms=100.0)["c"]
    frozen = StreamEngine(dep, capacity=2, device="cuda").serve(src, 4, seed=3)
    off = StreamEngine(dep, capacity=2, device="cuda",
                       adapt=AdaptConfig(lr_w=0.0)).serve(src, 4, seed=3)
    np.testing.assert_allclose(by(off), by(frozen), rtol=0, atol=1e-4)
    assert [r.prediction for r in off.results] == \
        [r.prediction for r in frozen.results]


# ---------------------------------------------------------------------------
# file-backed data (a DVS128-Gesture fixture the port writes) on the card
# ---------------------------------------------------------------------------

def _file_source(root, hw):
    """A 2-recording DVS128 fixture (2 gesture trials each) under ``root``,
    read at ``hw``."""
    from repro_torch.data import fixtures, sources
    fixtures.make_dvs128_fixture(root, n_recordings=2,
                                 trials_per_recording=2)
    return sources.DVSGestureSource(root, hw=hw, split="all",
                                    cache_root=root / "cache")


@pytest.mark.cuda
def test_cuda_file_batch_kernel_eval_matches_cpu(cuda_device, tmp_path):
    """A file-backed batch at reduced() (4 fixture windows at 24×24,
    T_INTG 10 ms, n_sub 4) evaluated in kernel mode: K1 on the card and
    its plain version on the CPU give equal layer-1 spike counts and
    logits within 1e-4 (the backbone's convolutions sum in another order
    on cuDNN); K1 launched once."""
    import dataclasses
    from repro_torch.configs import p2m_dvs
    from repro_torch.core import codesign
    from repro_torch.kernels.p2m_conv import p2m_conv as pc
    from repro_torch.stream.deploy import tree_to
    cfg, _ = p2m_dvs.reduced()
    cfg = dataclasses.replace(cfg, p2m=dataclasses.replace(cfg.p2m,
                                                           mode="kernel"))
    src = _file_source(tmp_path, cfg.backbone.input_hw[0])
    ev, labels = src._gather([0, 1, 2, 3], cfg.p2m.t_intg_ms, cfg.p2m.n_sub)
    assert ev.shape == (4, 200, 4, 24, 24, 2) and float(ev.sum()) > 0
    out = {}
    for device in ("cuda", "cpu"):
        params, state = codesign.model_init(torch.Generator().manual_seed(0),
                                            cfg)
        params = _awake(tree_to(params, torch.device(device)))
        before = pc.LAUNCHES["p2m_conv"] + pc.LAUNCHES["p2m_conv_fma"]
        metrics, aux = codesign.make_eval_fn(cfg, device=device)(
            params, tree_to(state, torch.device(device)), ev, labels)
        launched = (pc.LAUNCHES["p2m_conv"] + pc.LAUNCHES["p2m_conv_fma"]
                    - before)
        out[device] = (metrics["logits"].cpu().numpy(),
                       float(aux["spikes/p2m"]), launched)
    (lc, sc, nc), (lp, sp_, np_) = out["cuda"], out["cpu"]
    assert (nc, np_) == (1, 0)
    assert sc == sp_ and sc > 0
    assert np.abs(lp).max() > 0.05, "vacuous: the head never spiked"
    np.testing.assert_allclose(lc, lp, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_file_replay_through_k3_matches_cpu(cuda_device, tmp_path):
    """One fixture recording replayed to a fresh reduced() deployment
    (circuit c): served through K3 on the card and through the plain fold
    on the CPU, logits within 1e-4, the same prediction; K3 launched on
    every chunk."""
    from repro_torch.stream.engine import StreamEngine
    dep_cpu = _circuit_deps("cpu")["c"]
    src = _file_source(tmp_path, dep_cpu.model_cfg.backbone.input_hw[0])

    class Pinned:
        def __init__(self):
            for attr in ("name", "height", "width", "n_classes",
                         "duration_ms", "sensor_hw", "n_slots"):
                setattr(self, attr, getattr(src, attr))

        def iter_event_chunks(self, gen, *, chunk_us, slot_us=None):
            return src.iter_event_chunks(gen, chunk_us=chunk_us, index=2)

    reps = {}
    for device, mode, dep in (("cpu", "deposit", dep_cpu),
                              ("cuda", "mac", _circuit_deps("cuda")["c"])):
        before = sf.LAUNCHES["fold_mac"]
        reps[device] = StreamEngine(dep, capacity=1, fold_mode=mode,
                                    device=device).serve(Pinned(), 1, seed=0)
        launched = sf.LAUNCHES["fold_mac"] - before
    (got,), (want,) = reps["cuda"].results, reps["cpu"].results
    assert launched == len(reps["cuda"].fold_s) + 1      # + the warm-up
    assert got.label == want.label == src.samples[2].label
    assert np.abs(want.logits).max() > 0.05, "vacuous: the head never spiked"
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=1e-4)
    assert got.prediction == want.prediction


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m",
                                  "granite-moe-1b-a400m", "zamba2-7b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_cuda_mesh_builders_bit_identical_at_one_rank(cuda_device, arch):
    """The sharding layer's builders on make_host_mesh() = (1, 1) over
    cuda:0 (smoke variant): build_prefill_step (with the vlm's img_embed
    or the enc-dec's frames), two build_serve_step decode steps and two
    build_train_step steps give the unsharded path's bits (logits, every
    cache leaf, loss, gnorm, every param and moment; MoE's lb and drop
    shares, with drops from an embedding shifted by its std) with the same
    K5 / K6 launches."""
    from dataclasses import replace

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd import ssd as sd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import moe
    from repro_torch.serve.steps import (build_prefill_step,
                                         build_serve_step, grow_cache)
    from repro_torch.sharding import rules
    from repro_torch.train.steps import build_train_step, model_of
    from repro_torch.utils import tree_map, tree_paths
    mesh = make_host_mesh(device="cuda")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
    cfg = smoke_variant(get_config(arch))
    mod = model_of(cfg)
    B, S, n = 2, 64, 2
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + n), generator=g
                           ).to(cuda_device)
    pstep, (p_sds, t_sds, *e_sds), scfg = build_prefill_step(
        cfg, ShapeConfig("p", "prefill", S, B), mesh)
    dstep, (_, tok_sds, _, c_sds), _ = build_serve_step(
        cfg, ShapeConfig("d", "decode", S + n, B), mesh)
    extra = [torch.randn(tuple(e.shape), generator=g).to(cuda_device,
                                                         e.dtype)
             for e in e_sds]
    params = mod.init_params(torch.Generator(device="cuda").manual_seed(0),
                             scfg, cuda_device)

    def counts():
        return dict(fa.LAUNCHES, **sd.LAUNCHES)
    c0 = counts()
    if cfg.is_encdec:
        ref, rc = mod.prefill(params, extra[0], tokens[:, :S], scfg,
                              max_len=S + n)
        # the serve step's cross cache holds S + n positions, the grown
        # one zero keys there
        rc["cross"] = tree_map(lambda t: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, n)), rc["cross"])
    else:
        ref, rc = mod.prefill(params, tokens[:, :S], scfg,
                              img_embed=extra[0] if extra else None,
                              max_len=S + n)
    plain = {k: v - c0[k] for k, v in counts().items()}
    c0 = counts()
    dp = rules.place_as(params, p_sds)
    logits, cache = pstep(dp, rules.place_as(tokens[:, :S], t_sds),
                          *(rules.place_as(e, s) for e, s in zip(extra,
                                                                 e_sds)))
    assert {k: v - c0[k] for k, v in counts().items()} == plain
    # one K5 launch per attention call (causal for self-attention, not for
    # cross and encoder attention), one K6 launch per SSM block
    cross = {"vlm": cfg.n_layers // max(cfg.cross_every, 1),
             "audio": cfg.encoder_layers + cfg.n_layers}.get(cfg.family, 0)
    assert plain == {
        "flash_attention": {"ssm": 0,
                            "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                            "vlm": cfg.n_layers - cross
                            }.get(cfg.family, cfg.n_layers),
        "flash_attention_noncausal": cross,
        "ssd": cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0}
    assert torch.equal(logits.to_local(), ref)
    cache = grow_cache(cache, c_sds)
    for i in range(n):
        pos = torch.tensor(S + i, device=cuda_device)
        tok = tokens[:, S + i:S + i + 1]
        lg, cache = dstep(dp, rules.place_as(tok, tok_sds), pos, cache)
        want, rc = mod.decode_step(params, tok, pos, rc, scfg)
        assert torch.equal(lg.to_local(), want), i
    for (path, a), (_, b) in zip(tree_paths(cache), tree_paths(rc)):
        assert torch.equal(a.to_local(), b), path

    cfg = replace(cfg, compute_dtype="float32")
    shape = ShapeConfig("t", "train", S, B)
    step, (p_sds, o_sds, b_sds), _ = build_train_step(cfg, shape, mesh,
                                                      lr=1e-3)
    ustep, specs, uopt = build_train_step(cfg, shape, lr=1e-3,
                                          device="cuda")
    up = mod.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         cuda_device)
    if cfg.n_experts:
        emb = up["embed"]["embedding"]
        emb.add_(emb.std())
    dp = rules.place_as(tree_map(torch.clone, up), p_sds)
    do, uo = rules.zeros(o_sds), uopt.init(up)
    drops, apply = [], moe.moe_apply

    def recording(*a, **kw):
        y, aux = apply(*a, **kw)
        drops.append(rules.local(aux["drop_frac"]).item())
        return y, aux
    moe.moe_apply = recording
    try:
        for i in range(2):
            batch = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                       generator=g)
                         if v.dtype == torch.int64
                         else torch.randn(tuple(v.shape), generator=g)
                         ).to(cuda_device)
                     for k, v in specs.items()}
            c0 = counts()
            drops.clear()
            up, uo, um = ustep(up, uo, batch)
            plain, plain_drops = ({k: v - c0[k] for k, v in
                                   counts().items()}, list(drops))
            c0 = counts()
            drops.clear()
            dp, do, m = step(dp, do, rules.place_as(batch, b_sds))
            assert {k: v - c0[k] for k, v in counts().items()} == plain
            assert drops == plain_drops
            assert set(m) == set(um)
            for k in um:
                assert torch.equal(m[k], um[k]), (i, k)
            if cfg.n_experts:
                assert len(drops) == cfg.n_layers and max(drops) > 0
    finally:
        moe.moe_apply = apply
    for (path, a), (_, b) in zip(tree_paths({"p": dp, "o": do}),
                                 tree_paths({"p": up, "o": uo})):
        assert torch.equal(a.to_local(), b), path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_cuda_mesh_grad_accum_bit_identical_at_one_rank(cuda_device, arch):
    """Two build_train_step steps at grad_accum=2 on the (1, 1) host mesh
    over cuda:0 (smoke variant, float32 compute) give the one-device
    grad_accum=2 step's bits: loss, gnorm, every param and moment."""
    from dataclasses import replace

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import rules
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map, tree_paths
    mesh = make_host_mesh(device="cuda")
    cfg = replace(smoke_variant(get_config(arch)), compute_dtype="float32")
    B, S = 4, 64
    shape = ShapeConfig("t", "train", S, B)
    step, (p_sds, o_sds, b_sds), _ = build_train_step(
        cfg, shape, mesh, lr=1e-3, grad_accum=2)
    ustep, _, uopt = build_train_step(cfg, shape, lr=1e-3, device="cuda",
                                      grad_accum=2)
    up = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        cuda_device)
    dp = rules.place_as(tree_map(torch.clone, up), p_sds)
    do, uo = rules.zeros(o_sds), uopt.init(up)
    g = torch.Generator().manual_seed(4)
    for i in range(2):
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g
                                  ).to(cuda_device)
                 for k in ("tokens", "labels")}
        up, uo, um = ustep(up, uo, batch)
        dp, do, m = step(dp, do, rules.place_as(batch, b_sds))
        assert set(m) == set(um) == {"loss", "gnorm"}
        for k in um:
            assert torch.equal(m[k], um[k]), (i, k)
    for (path, a), (_, b) in zip(tree_paths({"p": dp, "o": do}),
                                 tree_paths({"p": up, "o": uo})):
        assert torch.equal(a.to_local(), b), path


@pytest.mark.cuda
def test_cuda_machine_gloo_mesh_matches_the_unsharded_port(cuda_device,
                                                           tmp_path):
    """tests/sharding_ranks.py under this machine's torch: every family's
    smoke variant (float32 compute) on 4 gloo CPU ranks forming a (2, 2)
    mesh, prefill + 2 decode steps + 2 train steps: internlm2-1.8b,
    mamba2-780m, granite-moe-1b-a400m (EP), grok-1-314b at tp_multiple=8
    (TP), zamba2-7b, the vlm (img_embed) and seamless (frames), held to the
    port's unsharded run of the same inputs (MoE in the same dispatch
    groups, one a data shard): serving within 2e-4 (and 2e-4 of a leaf's
    largest), the steps by tests/adam_close.py (loss and lb rtol 1e-5,
    gnorm 1e-4), MoE's drop shares to 1e-6. The collectives reorder
    float32 sums."""
    import dataclasses
    import os
    import subprocess
    import sys

    from adam_close import close_state
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.train.steps import model_of
    from repro_torch.utils import tree_paths
    sys.path.insert(0, os.path.dirname(__file__))
    from sharding_ranks import parse_key
    keys = ["internlm2-1.8b", "mamba2-780m", "granite-moe-1b-a400m",
            "grok-1-314b+tp8", "zamba2-7b", "llama-3.2-vision-90b",
            "seamless-m4t-large-v2"]
    rng = np.random.default_rng(5)
    inp = {"arch": np.array(keys)}
    for key in keys:
        arch, kw = parse_key(key)
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **kw)
        p = model_of(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                      "cpu")
        for path, t in tree_paths(p):
            inp[f"{key}/serve/{path}"] = t.float().numpy()
            inp[f"{key}/train/{path}"] = t.float().numpy()
        inp[f"{key}/prompt"] = rng.integers(0, cfg.vocab_size, (4, 16))
        inp[f"{key}/decode"] = rng.integers(0, cfg.vocab_size, (2, 4, 1))
        extra = {"img_embed": (4, cfg.n_image_tokens, cfg.vision_dim)
                 if cfg.family == "vlm" else None,
                 "frames": (4, 16, cfg.d_model) if cfg.is_encdec else None}
        for k, shape in extra.items():
            if shape:
                inp[f"{key}/{k}"] = rng.standard_normal(shape).astype(
                    np.float32)
        for i in range(2):
            for k in ("tokens", "labels"):
                inp[f"{key}/batch{i}/{k}"] = rng.integers(
                    0, cfg.vocab_size, (4, 64))
            for k, shape in extra.items():
                if shape:
                    inp[f"{key}/batch{i}/{k}"] = rng.standard_normal(
                        shape[:1] + (64,) + shape[2:] if k == "frames"
                        else shape).astype(np.float32)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inp)
    here = os.path.dirname(__file__)
    r = subprocess.run([sys.executable, os.path.join(here,
                                                     "sharding_ranks.py"),
                        str(src), str(dst), "--plain"], capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    z = dict(np.load(dst))
    for key in keys:
        names = [k[len(f"plain/{key}/"):] for k in z
                 if k.startswith(f"plain/{key}/")]
        assert names
        for k in names:
            if "/" in k and k.split("/")[0].startswith("step"):
                continue
            got, want = z[f"{key}/{k}"], z[f"plain/{key}/{k}"]
            if k.startswith(("loss", "lb")):
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
            elif k.startswith("gnorm"):
                np.testing.assert_allclose(got, want, rtol=1e-4)
            elif k.startswith("drop"):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=2e-4,
                    atol=2e-4 * max(1.0, np.abs(want).max()), err_msg=k)
        carry = {}
        for i in range(2):
            pre = f"step{i}/"
            got = {k[len(f"{key}/{pre}"):]: v for k, v in z.items()
                   if k.startswith(f"{key}/{pre}")}
            want = {k[len(f"plain/{key}/{pre}"):]: v for k, v in z.items()
                    if k.startswith(f"plain/{key}/{pre}")}
            assert got and set(got) == set(want)
            close_state(got, want, i + 1, 1e-3, carry)
