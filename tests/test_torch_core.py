"""PyTorch port: the P²M layer-1 physics and the spiking backbone against
the JAX package on the same numpy inputs, within 1e-5 relative (float32
arithmetic in two frameworks; the conv sums in another order)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as j_analog
from repro.core import leakage as j_leak
from repro.core import p2m_layer as j_p2m
from repro.core import snn as j_snn
from repro_torch.core import analog, leakage, p2m_layer, snn
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _tree(tree):
    """A JAX pytree of arrays → the same dict tree of torch tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


@pytest.mark.parametrize("stride,hw", [(1, 12), (2, 12), (2, 13), (1, 7)])
def test_conv_same_padding_matches_jax(stride, hw):
    """XLA's SAME pads 0 before / 1 after for stride 2 on an even size."""
    rng = np.random.default_rng(hw * 10 + stride)
    x = rng.poisson(0.7, (2, hw, hw, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 5)).astype(np.float32)
    want = j_p2m._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = p2m_layer._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_quantize_weights_values_and_straight_through_gradient():
    cfg = analog.AnalogConfig()
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 3, 2, 16)) * 0.6).astype(np.float32)
    w[0, 0, 0, :4] = [0.0625, -0.1875, 1.7, -3.0]     # half-way ties + clips
    want = j_analog.quantize_weights(jnp.asarray(w), j_analog.AnalogConfig())
    wt = torch.from_numpy(w).requires_grad_(True)
    q = analog.quantize_weights(wt, cfg)
    _close(q, want, rtol=0, atol=0)
    q.sum().backward()
    # identity inside the clip range, zero where the clip saturates — the
    # reference's gradient exactly
    want_g = jax.grad(lambda v: j_analog.quantize_weights(
        v, j_analog.AnalogConfig()).sum())(jnp.asarray(w))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(wt.grad.numpy(),
                                  (np.abs(w) <= cfg.w_clip).astype(np.float32))


@pytest.mark.parametrize("circuit", list(leakage.CircuitConfig))
@pytest.mark.parametrize("sigma,v_th", [(0.0, None), (0.3, 0.02)])
def test_leak_params_from_coeffs_matches_jax(circuit, sigma, v_th):
    rng = np.random.default_rng(1)
    w = (np.round(rng.uniform(-1, 1, (3, 3, 2, 16)) * 8) / 8).astype(np.float32)
    jc = j_leak.LeakageConfig(circuit=j_leak.CircuitConfig(circuit.value),
                              sigma=sigma, v_threshold=v_th)
    tc = leakage.LeakageConfig(circuit=circuit, sigma=sigma, v_threshold=v_th)
    want = j_leak.leak_params_from_coeffs(jnp.asarray(w), j_leak.leak_coeffs(jc))
    co = leakage.leak_coeffs(tc)
    got = leakage.leak_params_from_coeffs(torch.from_numpy(w), co)
    _close(got.v_inf, want.v_inf)
    _close(got.tau_ms, want.tau_ms)
    assert co.v_threshold == float(j_leak.leak_coeffs(jc).v_threshold)
    for dt in (0.25, 2.5):
        _close(leakage.decay_factor(got.tau_ms, dt),
               j_leak.decay_factor(want.tau_ms, dt))


def test_tau_sigma_units_is_the_reference_draw():
    np.testing.assert_array_equal(leakage._tau_sigma_units(16),
                                  j_leak._tau_sigma_units(16))


@pytest.mark.parametrize("circuit", [leakage.CircuitConfig.BASIC,
                                     leakage.CircuitConfig.NULLIFIED])
@pytest.mark.parametrize("n_sub,dt", [(4, 2.5), (8, 0.125)])
def test_window_decay_matches_jax(circuit, n_sub, dt):
    rng = np.random.default_rng(2)
    w = (np.round(rng.uniform(-1, 1, (3, 3, 2, 8)) * 8) / 8).astype(np.float32)
    jlk = j_leak.kernel_leak_params(
        jnp.asarray(w), j_leak.LeakageConfig(
            circuit=j_leak.CircuitConfig(circuit.value)))
    tlk = leakage.kernel_leak_params(torch.from_numpy(w),
                                     leakage.LeakageConfig(circuit=circuit))
    jw, jd = j_p2m.window_decay(jlk, n_sub, dt)
    tw, td = p2m_layer.window_decay(tlk, n_sub, dt)
    _close(tw, jw)
    _close(td, jd)


@pytest.mark.parametrize("nonlinear", [True, False])
@pytest.mark.parametrize("with_pv", [True, False])
def test_transfer_curve_matches_jax(nonlinear, with_pv):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.6, 0.6, (4, 5, 5, 8)).astype(np.float32)
    pv = {"gain": (1 + 0.02 * rng.standard_normal(8)).astype(np.float32),
          "offset": (1.5e-3 * rng.standard_normal(8)).astype(np.float32)}
    jcfg = j_analog.AnalogConfig(enable_nonlinearity=nonlinear)
    tcfg = analog.AnalogConfig(enable_nonlinearity=nonlinear)
    want = j_analog.transfer_curve(
        jnp.asarray(x), jcfg,
        {k: jnp.asarray(v) for k, v in pv.items()} if with_pv else None)
    got = analog.transfer_curve(
        torch.from_numpy(x), tcfg, _tree(pv) if with_pv else None)
    _close(got, want)
    _close(analog.step_nonlinearity(torch.from_numpy(x), tcfg),
           j_analog.step_nonlinearity(jnp.asarray(x), jcfg))


def _backbone(channels=(8, 16, 16), hw=16):
    jcfg = j_snn.SpikingCNNConfig(channels=channels, input_hw=(hw, hw),
                                  fc_hidden=32, n_classes=5,
                                  first_layer_external=True)
    tcfg = snn.SpikingCNNConfig(channels=channels, input_hw=(hw, hw),
                                fc_hidden=32, n_classes=5,
                                first_layer_external=True)
    params, state = j_snn.spiking_cnn_init(jax.random.PRNGKey(0), jcfg)
    # non-trivial BN statistics, so eval BN is exercised
    rng = np.random.default_rng(4)
    state = {k: {"mean": rng.uniform(-0.2, 0.2, v["mean"].shape),
                 "var": rng.uniform(0.5, 1.5, v["var"].shape)}
             for k, v in state.items()}
    state = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), state)
    return jcfg, tcfg, params, state


def test_spiking_cnn_stream_step_matches_jax():
    jcfg, tcfg, params, state = _backbone()
    rng = np.random.default_rng(5)
    x_t = rng.poisson(1.5, (3, 8, 8, 8)).astype(np.float32)
    mem = {k: rng.uniform(0, 0.9, (3,) + s).astype(np.float32)
           for k, s in j_snn._stream_shapes(jcfg)[0].items()}
    want_l, want_m = j_snn.spiking_cnn_stream_step(
        params, state, {k: jnp.asarray(v) for k, v in mem.items()},
        jnp.asarray(x_t), jcfg)
    got_l, got_m = snn.spiking_cnn_stream_step(
        _tree(params), _tree(state), _tree(mem), torch.from_numpy(x_t), tcfg)
    _close(got_l, want_l)
    for k in want_m:
        _close(got_m[k], want_m[k])


def test_spiking_cnn_apply_eval_matches_jax():
    jcfg, tcfg, params, state = _backbone()
    x = np.random.default_rng(6).poisson(1.0, (2, 3, 8, 8, 8)
                                         ).astype(np.float32)
    want, _, _ = j_snn.spiking_cnn_apply(params, state, jnp.asarray(x), jcfg,
                                         train=False)
    got, got_state, _ = snn.spiking_cnn_apply(
        _tree(params), _tree(state), torch.from_numpy(x), tcfg, train=False)
    _close(got, want)
    for k in state:                       # eval hands the state back as is
        for leaf in state[k]:
            _close(got_state[k][leaf], state[k][leaf], rtol=0, atol=0)


def test_spike_fn_atan_surrogate_gradient():
    x = torch.tensor([-1.0, -0.1, 0.0, 0.2, 3.0], requires_grad=True)
    snn.spike_fn(x).sum().backward()
    want = jax.grad(lambda v: j_snn.spike_fn(v).sum())(
        jnp.asarray(x.detach().numpy()))
    _close(x.grad, want)
    np.testing.assert_array_equal(snn.spike_fn(x.detach()).numpy(),
                                  [0, 0, 0, 1, 1])


@pytest.mark.parametrize("hw", [8, 9])
def test_max_pool_matches_jax(hw):
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)
                                                  ).astype(np.float32)
    _close(snn.max_pool(torch.from_numpy(x)), j_snn.max_pool(jnp.asarray(x)),
           rtol=0, atol=0)


def test_coarsen_spikes_matches_jax():
    s = np.random.default_rng(8).integers(0, 2, (2, 6, 4, 4, 3)
                                          ).astype(np.float32)
    _close(p2m_layer.coarsen_spikes(torch.from_numpy(s), 3),
           j_p2m.coarsen_spikes(jnp.asarray(s), 3), rtol=0, atol=0)
    with pytest.raises(ValueError):
        p2m_layer.coarsen_spikes(torch.from_numpy(s), 4)
