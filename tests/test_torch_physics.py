"""PyTorch port: the physics-mode evaluation path (scan, curvefit and
kernel modes of layer 1, the P²M conv op, the LIF op, the eval step)
against the JAX package on the same numpy inputs.

On the CPU every kernel wrapper runs its plain version, so these checks
pin the arithmetic the CUDA kernels must reproduce (the kernels against
their plain versions on the card are in tests/test_torch_cuda.py).
Tolerances: voltages rtol 1e-5 / atol 1e-6 (float32 in two frameworks,
the conv summed in another order); spikes equal wherever the voltage is
more than 1e-5 from the threshold (exactly equal on these inputs);
logits atol 1e-4 (backbone, as in the serving tests); LIF spikes exactly
equal (the same op sequence, each op correctly rounded)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import p2m_dvs as j_configs
from repro.core import analog as j_analog
from repro.core import codesign as j_codesign
from repro.core import leakage as j_leak
from repro.core import p2m_layer as j_p2m
from repro.core import snn as j_snn
from repro.data import events as j_events
from repro.kernels.lif import ops as j_lif_ops
from repro.kernels.lif import ref as j_lif_ref
from repro.kernels.p2m_conv import ops as j_conv_ops
from repro_torch.configs import p2m_dvs
from repro_torch.core import analog, codesign, leakage, p2m_layer, snn
from repro_torch.data import events
from repro_torch.kernels.lif import lif as lif_mod
from repro_torch.kernels.lif import ops as lif_ops
from repro_torch.kernels.lif.ref import lif_ref
from repro_torch.kernels.p2m_conv import ops as conv_ops
from repro_torch.kernels.p2m_conv import p2m_conv as conv_mod
from repro_torch.stream.deploy import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL, BAND, LOGIT_ATOL = 1e-5, 1e-6, 1e-5, 1e-4
CIRCUITS = ("a", "b", "c", "ideal")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _spikes_equal_off_band(got_s, want_s, v_pre, theta):
    """Spikes equal wherever the voltage is clear of the threshold."""
    clear = np.abs(_np(v_pre) - np.asarray(theta)) > BAND
    np.testing.assert_array_equal(_np(got_s)[clear], _np(want_s)[clear])


def _leak_pair(circuit, **kw):
    return (j_leak.LeakageConfig(circuit=j_leak.CircuitConfig(circuit), **kw),
            leakage.LeakageConfig(circuit=leakage.CircuitConfig(circuit),
                                  **kw))


def _p2m_pair(F=6, n_sub=3, stride=1, cin=2, nonlinear=True, circuit="c"):
    """The same P2MConfig in both packages."""
    jl, tl = _leak_pair(circuit)
    common = dict(in_channels=cin, out_channels=F, stride=stride,
                  t_intg_ms=10.0, n_sub=n_sub)
    jc = j_p2m.P2MConfig(**common, leak=jl, analog=j_analog.AnalogConfig(
        enable_nonlinearity=nonlinear))
    tc = p2m_layer.P2MConfig(**common, leak=tl, analog=analog.AnalogConfig(
        enable_nonlinearity=nonlinear))
    return jc, tc


def _p2m_inputs(seed, cfg, B, T, hw, lam=0.6):
    """Layer-1 params and event counts from numpy: (numpy params, events)."""
    rng = np.random.default_rng(seed)
    F, cin, k = cfg.out_channels, cfg.in_channels, cfg.kernel_size
    params = {
        "w": (rng.standard_normal((k, k, cin, F)) * 0.5).astype(np.float32),
        "pv_gain": (1 + 0.02 * rng.standard_normal(F)).astype(np.float32),
        "pv_offset": (1.5e-3 * rng.standard_normal(F)).astype(np.float32)}
    h, w = hw
    ev = rng.poisson(lam, (B, T, cfg.n_sub, h, w, cin)).astype(np.float32)
    return params, ev


def _both(params, ev):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    return jp, jnp.asarray(ev), tp, torch.from_numpy(ev)


# ---------------------------------------------------------------------------
# leakage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_stacked_leak_params_match_jax(sigma):
    """The three paper circuits plus IDEAL, stacked on the config axis;
    IDEAL's decay is exactly 1 (tau = inf)."""
    rng = np.random.default_rng(11)
    w = (np.round(rng.uniform(-1, 1, (3, 3, 2, 16)) * 8) / 8).astype(np.float32)
    pairs = [_leak_pair(c, sigma=sigma) for c in CIRCUITS]
    want = j_leak.stacked_leak_params(jnp.asarray(w), [p[0] for p in pairs])
    got = leakage.stacked_leak_params(torch.from_numpy(w),
                                      [p[1] for p in pairs])
    assert tuple(got.v_inf.shape) == (4, 16)
    _close(got.v_inf, want.v_inf)
    _close(got.tau_ms, want.tau_ms)
    decay = leakage.decay_factor(got.tau_ms, 2.5)
    _close(decay, j_leak.decay_factor(want.tau_ms, 2.5))
    assert torch.isinf(got.tau_ms[3]).all()
    assert (decay[3] == 1.0).all()


def test_paper_circuits_and_with_mismatch_match_jax():
    got = [c.circuit.value for c in leakage.paper_circuits()]
    assert got == [c.circuit.value for c in j_leak.paper_circuits()]
    assert got == ["a", "b", "c"]
    lc = leakage.with_mismatch(leakage.paper_circuits()[2], 0.2)
    jlc = j_leak.with_mismatch(j_leak.paper_circuits()[2], 0.2)
    assert lc.null_mismatch == jlc.null_mismatch == 0.2
    assert dataclasses.asdict(lc)["circuit"].value == jlc.circuit.value


# ---------------------------------------------------------------------------
# layer-1 forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,hw", [(1, (12, 12)), (2, (12, 12)),
                                       (1, (7, 9))])
def test_forward_scan_matches_jax(stride, hw):
    jc, tc = _p2m_pair(stride=stride)
    params, ev = _p2m_inputs(stride + hw[1], tc, 2, 3, hw)
    jp, jev, tp, tev = _both(params, ev)
    want_s, want_v = j_p2m.p2m_forward_scan(jp, jev, jc)
    got_s, got_v = p2m_layer.p2m_forward_scan(tp, tev, tc)
    assert tuple(got_v.shape) == want_v.shape
    _close(got_v, want_v)
    _spikes_equal_off_band(got_s, want_s, want_v, tc.v_threshold)
    assert 0 < float(got_s.sum()) < got_s.numel()


@pytest.mark.parametrize("mode", ["scan", "curvefit"])
def test_stacked_forwards_match_jax(mode):
    """Both stacked XLA-path forwards over the four circuits, thresholds
    overridden per variant."""
    jc, tc = _p2m_pair(F=4, n_sub=4)
    params, ev = _p2m_inputs(5, tc, 2, 2, (10, 10))
    jp, jev, tp, tev = _both(params, ev)
    pairs = [_leak_pair(c, v_threshold=vt)
             for c, vt in zip(CIRCUITS, (None, 0.01, 0.02, None))]
    jl, tl = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    jfn = {"scan": j_p2m.p2m_forward_scan_stacked,
           "curvefit": j_p2m.p2m_forward_curvefit_stacked}[mode]
    want_s, want_v = jfn(jp, jev, jc, jl)
    got_s, got_v = p2m_layer.p2m_apply_stacked(
        tp, tev, dataclasses.replace(tc, mode=mode), tl)
    assert tuple(got_v.shape) == want_v.shape
    _close(got_v, want_v)
    th = np.asarray(j_p2m.stacked_thetas(jc, jl, want_v.ndim))
    _spikes_equal_off_band(got_s, want_s, want_v, th)


def test_apply_single_modes_match_jax():
    jc, tc = _p2m_pair(F=4, n_sub=2)
    params, ev = _p2m_inputs(9, tc, 1, 2, (8, 8))
    jp, jev, tp, tev = _both(params, ev)
    for mode in ("scan", "curvefit"):
        want_s, want_v = j_p2m.p2m_apply(jp, jev,
                                         dataclasses.replace(jc, mode=mode))
        got_s, got_v = p2m_layer.p2m_apply(tp, tev,
                                           dataclasses.replace(tc, mode=mode))
        _close(got_v, want_v)
        _spikes_equal_off_band(got_s, want_s, want_v, tc.v_threshold)
    with pytest.raises(ValueError, match="unknown mode"):
        p2m_layer.p2m_apply(tp, tev, dataclasses.replace(tc, mode="pallas"))


# ---------------------------------------------------------------------------
# the P²M conv op (K1's plain route on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,stride,n_cfg,nonlinear", [
    ((8, 8), 1, 1, True),
    ((7, 9), 1, 3, True),
    ((12, 12), 2, 3, True),
    ((9, 7), 1, 2, False),
])
def test_p2m_conv_multi_matches_jax_ref_and_pallas(hw, stride, n_cfg,
                                                   nonlinear):
    """The port's op against the JAX op's pure-jnp route and its Pallas
    kernel in interpret mode, with per-variant thresholds."""
    jc, tc = _p2m_pair(F=5, n_sub=3, stride=stride, nonlinear=nonlinear)
    params, ev = _p2m_inputs(hw[0] * 10 + stride, tc, 2, 2, hw)
    jp, jev, tp, tev = _both(params, ev)
    pairs = [_leak_pair(c, v_threshold=vt) for c, vt in
             zip(("a", "b", "c"), (None, 0.005, 0.02))][:n_cfg]
    jl, tl = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    before = dict(conv_mod.LAUNCHES)
    got_s, got_v = conv_ops.p2m_conv_multi(tp, tev, tc, tl)
    assert conv_mod.LAUNCHES == before          # the CPU takes the plain route
    th = np.asarray(j_p2m.stacked_thetas(jc, jl, 6))
    for use_ref in (True, False):
        want_s, want_v = j_conv_ops.p2m_conv_multi(jp, jev, jc, jl,
                                                   use_ref=use_ref)
        assert tuple(got_v.shape) == want_v.shape
        _close(got_v, want_v)
        _spikes_equal_off_band(got_s, want_s, want_v, th)
    assert got_s.dtype == torch.float32


def test_p2m_conv_single_matches_jax_and_port_scan():
    jc, tc = _p2m_pair(F=4, n_sub=4)
    params, ev = _p2m_inputs(3, tc, 2, 2, (9, 9))
    jp, jev, tp, tev = _both(params, ev)
    want_s, want_v = j_conv_ops.p2m_conv(jp, jev, jc, use_ref=True)
    got_s, got_v = conv_ops.p2m_conv(tp, tev, tc)
    _close(got_v, want_v)
    _spikes_equal_off_band(got_s, want_s, want_v, tc.v_threshold)
    scan_s, scan_v = p2m_layer.p2m_forward_scan(tp, tev, tc)
    torch.testing.assert_close(got_v, scan_v, rtol=0, atol=1e-7)
    torch.testing.assert_close(got_s, scan_s, rtol=0, atol=0)


def test_apply_stacked_kernel_matches_per_config_port_scan():
    """The port's kernel mode over the paper circuits against one port
    scan per circuit (the sweep engine's stacked-parity contract)."""
    _, tc = _p2m_pair(F=6, n_sub=3)
    params, ev = _p2m_inputs(1, tc, 2, 2, (12, 12), lam=0.4)
    _, _, tp, tev = _both(params, ev)
    circuits = leakage.paper_circuits()
    s_m, v_m = p2m_layer.p2m_apply_stacked(
        tp, tev, dataclasses.replace(tc, mode="kernel"), circuits)
    assert v_m.shape[0] == len(circuits)
    for i, lc in enumerate(circuits):
        s_i, v_i = p2m_layer.p2m_apply(
            tp, tev, dataclasses.replace(tc, mode="scan", leak=lc))
        torch.testing.assert_close(v_m[i], v_i, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(s_m[i], s_i, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# LIF (K4's plain route on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("soft_reset", [True, False])
@pytest.mark.parametrize("T,N", [(7, 513), (64, 256)])
def test_lif_ref_matches_jax_bit_exact(soft_reset, T, N):
    x = (np.random.default_rng(T * N).standard_normal((T, N)) * 1.5
         ).astype(np.float32)
    want = np.asarray(j_lif_ref.lif_ref(jnp.asarray(x), tau=2.0, v_th=1.0,
                                        soft_reset=soft_reset))
    got = lif_ref(torch.from_numpy(x), tau=2.0, v_th=1.0,
                  soft_reset=soft_reset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_lif_op_matches_snn_lif_over_time():
    """The op is a drop-in for snn.lif_over_time, in both packages."""
    x = np.random.default_rng(2).standard_normal((5, 3, 4, 4, 6)
                                                 ).astype(np.float32) * 2
    cfg = snn.LIFConfig()
    before = dict(lif_mod.LAUNCHES)
    got = lif_ops.lif_over_time(torch.from_numpy(x), cfg)
    assert lif_mod.LAUNCHES == before
    assert got.shape == x.shape
    np.testing.assert_array_equal(
        got.numpy(), snn.lif_over_time(torch.from_numpy(x), cfg).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_snn.lif_over_time(jnp.asarray(x),
                                                    j_snn.LIFConfig())))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_lif_ops.lif_over_time(
            jnp.asarray(x), j_snn.LIFConfig(), use_ref=True)))


def test_lif_ref_bf16_takes_working_type():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 40))
                         .astype(np.float32)).to(torch.bfloat16)
    out = lif_ref(x)
    assert out.dtype == torch.bfloat16
    assert set(out.float().unique().tolist()) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# the eval step
# ---------------------------------------------------------------------------

def _reduced_pair(mode):
    jcfg, _ = j_configs.reduced()
    tcfg, _ = p2m_dvs.reduced()
    return (dataclasses.replace(jcfg, p2m=dataclasses.replace(jcfg.p2m,
                                                             mode=mode)),
            dataclasses.replace(tcfg, p2m=dataclasses.replace(tcfg.p2m,
                                                             mode=mode)))


@pytest.fixture(scope="module")
def reduced_model():
    """JAX-initialised reduced() params with an awakened backbone (BN
    scales and fc0 tripled: at ×2 this draw's head never spikes and every
    logit is 0), and one numpy batch of
    B 2 spanning one coarse frame (T_fine 100)."""
    jcfg, _ = _reduced_pair("scan")
    params, state = j_codesign.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, {"params": params, "bn_state": state})
    for k, v in tree["params"]["backbone"].items():
        if k.startswith("bn"):
            v["scale"] = v["scale"] * 3.0
    tree["params"]["backbone"]["fc0"]["w"] = (
        tree["params"]["backbone"]["fc0"]["w"] * 3.0)
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.08, (2, 100, 4, 24, 24, 2)).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    return tree, ev, labels


@pytest.mark.parametrize("mode", ["scan", "curvefit", "kernel"])
def test_make_eval_fn_matches_jax(reduced_model, mode):
    """JAX kernel mode is held through its oracle, scan mode."""
    tree, ev, labels = reduced_model
    jcfg, _ = _reduced_pair("scan" if mode == "kernel" else mode)
    _, tcfg = _reduced_pair(mode)
    jtree = jax.tree.map(jnp.asarray, tree)
    jm, jaux = j_codesign.make_eval_fn(jcfg)(
        jtree["params"], jtree["bn_state"], jnp.asarray(ev),
        jnp.asarray(labels))
    want_logits, _, _ = j_codesign.model_apply(
        jtree["params"], jtree["bn_state"], jnp.asarray(ev), jcfg,
        train=False)
    params, state = params_from_jax(tree, device="cpu")
    tm, taux = codesign.make_eval_fn(tcfg, device="cpu")(params, state, ev,
                                                         labels)
    assert np.abs(np.asarray(want_logits)).max() > 0.05    # not vacuous
    _close(tm["logits"], want_logits, rtol=0, atol=LOGIT_ATOL)
    assert float(tm["acc"]) == float(jm["acc"])
    _close(tm["loss"], jm["loss"], rtol=1e-5, atol=1e-5)
    for key in ("spikes/p2m", "events/in", "macs/p2m"):
        assert float(taux[key]) == float(jaux[key]), key


def test_model_apply_refuses_training(reduced_model):
    """Training runs through curvefit (tests/test_torch_train.py); layer
    1 in kernel mode has no backward, so under autograd it is refused."""
    tree, ev, _ = reduced_model
    _, tcfg = _reduced_pair("kernel")
    params, state = params_from_jax(tree, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        codesign.model_apply(params, state, torch.from_numpy(ev), tcfg,
                             train=True)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, 6).astype(np.int32)
    labels[:3] = logits[:3].argmax(-1)
    _close(snn.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels)),
           j_snn.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert float(snn.accuracy(torch.from_numpy(logits),
                              torch.from_numpy(labels))) == float(
        j_snn.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# event helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 5])
def test_refine_slots_and_events_to_frames_match_jax(factor):
    ev = np.random.default_rng(factor).poisson(0.5, (2, 10, 3, 5, 6, 2)
                                               ).astype(np.float32)
    got = events.refine_slots(torch.from_numpy(ev), factor)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_events.refine_slots(jnp.asarray(ev),
                                                      factor)))
    np.testing.assert_array_equal(
        events.events_to_frames(got).numpy(),
        np.asarray(j_events.events_to_frames(
            j_events.refine_slots(jnp.asarray(ev), factor))))
    assert float(got.sum()) == float(ev.sum())


def test_refine_slots_rejects_a_ragged_split():
    with pytest.raises(ValueError, match="groups of 3"):
        events.refine_slots(torch.zeros((1, 10, 2, 4, 4, 2)), 3)


def test_sample_batch_shapes_and_seeding():
    _, data = p2m_dvs.reduced(hw=12)
    data = dataclasses.replace(data, duration_ms=200.0)
    ev, labels = events.sample_batch(torch.Generator().manual_seed(3), data,
                                     3, 10.0, n_sub=4)
    assert tuple(ev.shape) == (3, 20, 4, 12, 12, 2)
    assert labels.shape == (3,) and int(labels.max()) < data.n_classes
    assert float(ev.sum()) > 0 and (ev == ev.round()).all()
    again, labels2 = events.sample_batch(torch.Generator().manual_seed(3),
                                         data, 3, 10.0, n_sub=4)
    torch.testing.assert_close(again, ev, rtol=0, atol=0)
    assert torch.equal(labels, labels2)
    ev2, lab2 = events.sample_batch_with_labels(
        torch.Generator().manual_seed(3), data, torch.tensor([1, 2]), 20.0)
    assert tuple(ev2.shape) == (2, 10, 1, 12, 12, 2)
    assert lab2.tolist() == [1, 2]
