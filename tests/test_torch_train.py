"""PyTorch port: the P²M training slice — the optimizers, BatchNorm in
training, the backbone's and the model's counters (``aux``), the grouped
curve-fit forward and its gradients, and ``make_train_step`` — against
the JAX package on the same numpy inputs (random draws made by the
reference and fed to both sides).

Tolerances, and why:
- optimizers on given gradients: 1e-6 relative (the same float32 ops in
  two frameworks; ``b ** step`` may differ in its last bit);
- BN, the backbone and the curve-fit forward: rtol 1e-5 / atol 1e-6
  (convolutions summed in another order), spikes and ``aux`` equal;
- gradients of the curve-fit forward: rtol 1e-4 / atol 1e-7 (sums over
  every site, in another order);
- three train steps: loss and gnorm rtol 1e-5; params rtol 1e-5 / atol
  1e-6; per leaf, the BN state within 1e-5 and both moments within 1e-4
  of the leaf's largest magnitude (batch means and per-filter gradients
  are sums whose terms cancel, so an element's own size is no measure of
  its error); gradcheck as the reference's finite-difference test holds
  its seams (rtol 1e-3; tests/test_torch_train_gradcheck.py, a file of
  its own so that its float64 finite differences run beside this file
  on another worker). The conv biases feed
  train-mode BN, which subtracts them again: their exact gradient is 0,
  both frameworks return roundoff (below 1e-6 of the largest gradient),
  and Adam's normalisation turns that noise into steps of up to about
  lr either way. They are held to that: |gradient| ≤ 1e-6 · max, and
  |Δ| ≤ 2·lr per step between the two sides; the BN running means they
  feed are compared after taking out the biases' momentum-weighted
  difference.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import p2m_dvs as j_configs
from repro.core import codesign as j_codesign
from repro.core import leakage as j_leak
from repro.core import p2m_layer as j_p2m
from repro.core import snn as j_snn
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.data import events as j_events
from repro.optim import optimizers as j_opt
from repro_torch.configs import p2m_dvs
from repro_torch.core import codesign, leakage, p2m_layer, snn
from repro_torch.core.analog import AnalogConfig
from repro_torch.kernels.lif import lif as lif_mod
from repro_torch.kernels.p2m_conv import p2m_conv as conv_mod
from repro_torch.kernels.stream_fold import stream_fold as fold_mod
from repro_torch.optim import optimizers as opt
from repro_torch.stream.deploy import opt_state_from_jax, params_from_jax
from repro_torch.utils import tree_map, tree_paths
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _trees_close(got, want, rtol=RTOL, atol=ATOL, skip=lambda p: False):
    want = dict(tree_paths(jax.tree.map(np.asarray, want)))
    got = dict(tree_paths(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if not skip(path):
            _close(got[path], w, rtol, atol, path)


def _trees_close_scaled(got, want, rel, skip=lambda p: False):
    """Per leaf, max |got − want| ≤ rel · max |want|: for sums whose
    elements cancel (a BN batch mean, the gradient of a per-filter offset
    summed over every site), where an element's own magnitude is no
    measure of its error."""
    want = dict(tree_paths(jax.tree.map(np.asarray, want)))
    got = dict(tree_paths(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if not skip(path):
            err = float(np.abs(_np(got[path]) - w).max())
            assert err <= rel * float(np.abs(w).max()), (path, err)


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _grad_tree(seed):
    """A small dict tree of float32 gradients and params, numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"conv": {"w": (3, 3, 2, 4), "b": (4,)},
              "fc": {"w": (8, 3), "b": (3,)}}
    mk = lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return (jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipping active (0.5) and not (100): scaled tree and norm."""
    g, _ = _grad_tree(1)
    want, want_n = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                             max_norm)
    got, got_n = opt.clip_by_global_norm(_torch_tree(g), max_norm)
    _close(got_n, want_n, 1e-6, 0)
    _trees_close(got, want, 1e-6, 0)


def _bias_mask(path: str) -> bool:
    return not path.endswith("/b")


@pytest.mark.parametrize("mask", [None, _bias_mask], ids=["all", "no_bias"])
@pytest.mark.parametrize("lr", [3e-3, "warmup_cosine"])
def test_adamw_matches_jax(mask, lr):
    """Four updates from given gradients: updates, moments and step, with
    and without a weight-decay mask, at a constant and a scheduled lr."""
    p, _ = _grad_tree(2)
    if lr == "warmup_cosine":
        j_o = j_opt.adamw(j_opt.warmup_cosine(3e-3, 2, 6), weight_decay=0.1,
                          mask_fn=mask)
        t_o = opt.adamw(opt.warmup_cosine(3e-3, 2, 6), weight_decay=0.1,
                        mask_fn=mask)
    else:
        j_o = j_opt.adamw(lr, weight_decay=0.1, mask_fn=mask)
        t_o = opt.adamw(lr, weight_decay=0.1, mask_fn=mask)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch_tree(p)
    js, ts = j_o.init(jp), t_o.init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for i in range(4):
        g, _ = _grad_tree(10 + i)
        ju, js = j_o.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = t_o.update(_torch_tree(g), ts, tp)
        _trees_close(tu, ju, 1e-6, 1e-12)
        for k in ("mu", "nu"):
            _trees_close(ts[k], js[k], 1e-6, 0)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        jp = j_opt.apply_updates(jp, ju)
        tp = opt.apply_updates(tp, tu)
        _trees_close(tp, jp, 1e-6, 1e-9)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_jax(nesterov):
    p, _ = _grad_tree(3)
    j_o, t_o = (j_opt.sgd(0.05, nesterov=nesterov),
                opt.sgd(0.05, nesterov=nesterov))
    jp, tp = jax.tree.map(jnp.asarray, p), _torch_tree(p)
    js, ts = j_o.init(jp), t_o.init(tp)
    for i in range(3):
        g, _ = _grad_tree(20 + i)
        ju, js = j_o.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = t_o.update(_torch_tree(g), ts, tp)
        _trees_close(tu, ju, 1e-6, 1e-12)
        _trees_close(ts["mom"], js["mom"], 1e-6, 0)
        assert int(ts["step"]) == int(js["step"]) == i + 1


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (2e-3,)),
    ("cosine_schedule", (2e-3, 10)),
    ("cosine_schedule", (2e-3, 10, 0.0)),
    ("warmup_cosine", (2e-3, 3, 12)),
])
def test_schedules_match_jax(name, args):
    j_fn, t_fn = getattr(j_opt, name)(*args), getattr(opt, name)(*args)
    for step in range(0, 15):
        want = j_fn(jnp.asarray(step, jnp.int32))
        got = t_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32, name
        _close(got, want, 1e-6, 1e-12, f"{name} step {step}")


def test_opt_state_from_jax_resumes_mid_run():
    """A reference AdamW state after two updates, carried into the port,
    gives the same third update on both sides."""
    p, _ = _grad_tree(4)
    j_o, t_o = j_opt.adamw(1e-3), opt.adamw(1e-3)
    jp = jax.tree.map(jnp.asarray, p)
    js = j_o.init(jp)
    for i in range(2):
        g, _ = _grad_tree(30 + i)
        ju, js = j_o.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = j_opt.apply_updates(jp, ju)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 2
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    g, _ = _grad_tree(40)
    ju, js = j_o.update(jax.tree.map(jnp.asarray, g), js, jp)
    tu, ts = t_o.update(_torch_tree(g), ts, tp)
    _trees_close(tu, ju, 1e-6, 1e-12)
    _trees_close(ts["nu"], js["nu"], 1e-6, 0)


# ---------------------------------------------------------------------------
# BatchNorm in training, the backbone, the model's aux
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_bn_apply_matches_jax(train):
    """Batch mean and biased variance in training, running statistics
    moved by momentum·old + (1 − momentum)·batch; eval untouched."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 5, 4, 3)) * 2 + 0.7).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32),
         "bias": rng.uniform(-0.3, 0.3, 3).astype(np.float32)}
    s = {"mean": rng.uniform(-0.2, 0.2, 3).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 3).astype(np.float32)}
    jy, js = j_snn.bn_apply(jax.tree.map(jnp.asarray, p),
                            jax.tree.map(jnp.asarray, s), jnp.asarray(x),
                            train=train)
    ty, ts = snn.bn_apply(_torch_tree(p), _torch_tree(s), torch.from_numpy(x),
                          train=train)
    _close(ty, jy)
    _trees_close(ts, js)
    if train:      # the unbiased variance would differ by 120/119
        want_var = 0.9 * s["var"] + 0.1 * x.reshape(-1, 3).var(0)
        _close(ts["var"], want_var)


def _backbone():
    channels, hw = (8, 16, 16), 16
    kw = dict(channels=channels, input_hw=(hw, hw), fc_hidden=32,
              n_classes=5, first_layer_external=True)
    jcfg, tcfg = j_snn.SpikingCNNConfig(**kw), snn.SpikingCNNConfig(**kw)
    params, state = j_snn.spiking_cnn_init(jax.random.PRNGKey(1), jcfg)
    params = jax.tree.map(np.asarray, params)
    for k in params:                  # awake: spikes reach the head
        if k.startswith("bn"):
            params[k]["scale"] = params[k]["scale"] * 3.0
    params["fc0"]["w"] = params["fc0"]["w"] * 3.0
    return jcfg, tcfg, params, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("train", [True, False])
def test_spiking_cnn_apply_aux_and_state_match_jax(train):
    """Logits, BN state and every ``aux`` counter key for key."""
    jcfg, tcfg, params, state = _backbone()
    x = np.random.default_rng(6).poisson(1.0, (3, 4, 8, 8, 8)
                                         ).astype(np.float32)
    jl, js, jaux = j_snn.spiking_cnn_apply(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(x), jcfg, train=train)
    tl, ts, taux = snn.spiking_cnn_apply(_torch_tree(params),
                                         _torch_tree(state),
                                         torch.from_numpy(x), tcfg,
                                         train=train)
    _close(tl, jl)
    _trees_close(ts, js)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        assert float(taux[k]) == float(jaux[k]), k
    assert float(jaux["spikes/fc0"]) > 0          # not vacuous


def test_max_pool_gradient_goes_to_the_first_max_as_in_jax():
    """On binary spikes (ties everywhere, all-zero windows too) the
    pooled gradient lands on each window's first maximum, as JAX routes
    it; the values equal the eval-path ``amax`` pool."""
    rng = np.random.default_rng(12)
    x = rng.integers(0, 2, (3, 8, 9, 4)).astype(np.float32)
    cot = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = snn.max_pool(xt)
    (g,) = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), xt)
    jg = jax.grad(lambda v: jnp.vdot(j_snn.max_pool(v), cot))(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(_np(y), np.asarray(j_snn.max_pool(x)))
    np.testing.assert_array_equal(snn.max_pool(torch.from_numpy(x)).numpy(),
                                  _np(y))


@pytest.fixture(scope="module")
def reduced_run():
    """reduced(): reference-initialised params (awake, as the physics tests
    make them) and a batch of B 4 drawn by the reference's sampler."""
    jcfg, jdata = j_configs.reduced()
    params, state = j_codesign.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, {"params": params, "bn_state": state})
    ev, labels = j_events.sample_batch(jax.random.PRNGKey(1), jdata, 4,
                                       jcfg.p2m.t_intg_ms,
                                       n_sub=jcfg.p2m.n_sub)
    return jcfg, jdata, tree, np.asarray(ev), np.asarray(labels)


@pytest.mark.parametrize("train", [True, False])
def test_model_apply_aux_matches_jax(reduced_run, train):
    """The model's ``aux`` equals the reference's key for key (the
    backbone's spikes/synops and layer 1's counters), with the logits and
    BN state, in training and evaluation (curvefit layer 1)."""
    jcfg, _, tree, ev, _ = reduced_run
    tcfg = p2m_dvs.reduced()[0]
    jt = jax.tree.map(jnp.asarray, tree)
    jl, js, jaux = j_codesign.model_apply(jt["params"], jt["bn_state"],
                                          jnp.asarray(ev), jcfg, train=train)
    params, state = params_from_jax(tree, device="cpu")
    tl, ts, taux = codesign.model_apply(params, state, torch.from_numpy(ev),
                                        tcfg, train=train)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        assert float(taux[k]) == float(jaux[k]), k
    _close(tl, jl, 0, 1e-4)
    _trees_close(ts, js)
    assert float(jaux["spikes/conv1"]) > 0 and float(jaux["spikes/p2m"]) > 0


# ---------------------------------------------------------------------------
# the grouped curve-fit forward and its gradients
# ---------------------------------------------------------------------------

CIRCUITS = ("a", "b", "c")


def _leak_pairs(**kw):
    return ([j_leak.LeakageConfig(circuit=j_leak.CircuitConfig(c), **kw)
             for c in CIRCUITS],
            [leakage.LeakageConfig(circuit=leakage.CircuitConfig(c), **kw)
             for c in CIRCUITS])


def _grouped_inputs(levels=16):
    kw = dict(out_channels=4, t_intg_ms=10.0, n_sub=3)
    jcfg = j_p2m.P2MConfig(**kw, analog=JAnalogConfig(weight_levels=levels))
    tcfg = p2m_layer.P2MConfig(**kw, analog=AnalogConfig(
        weight_levels=levels))
    rng = np.random.default_rng(9)
    n = len(CIRCUITS)
    params_s = {
        "w": (rng.standard_normal((n, 3, 3, 2, 4)) * 0.5).astype(np.float32),
        "pv_gain": (1 + 0.02 * rng.standard_normal((n, 4))).astype(np.float32),
        "pv_offset": (1.5e-3 * rng.standard_normal((n, 4))).astype(np.float32)}
    ev = rng.poisson(0.4, (2, 2, 3, 8, 8, 2)).astype(np.float32)
    return jcfg, tcfg, params_s, ev


def test_stacked_coeffs_and_grouped_leak_params_match_jax():
    jl, tl = _leak_pairs(sigma=0.2)
    jco, tco = j_leak.stacked_leak_coeffs(jl), leakage.stacked_leak_coeffs(tl)
    for f in dataclasses.fields(leakage.LeakCoeffs):
        _close(getattr(tco, f.name), getattr(jco, f.name), 0, 0, f.name)
    _, _, params_s, _ = _grouped_inputs()
    w = params_s["w"]
    want = j_leak.grouped_leak_params(jnp.asarray(w), jl)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = leakage.grouped_leak_params(wt, tl)
    _close(got.v_inf, want.v_inf)
    _close(got.tau_ms, want.tau_ms)
    # differentiable in w_s: config (a)'s leak depends on its own kernel
    cot = np.random.default_rng(3).standard_normal((3, 4)).astype(np.float32)
    g = torch.autograd.grad((got.v_inf * torch.from_numpy(cot)).sum()
                            + got.tau_ms[0].sum(), wt)[0]
    jg = jax.grad(lambda x: jnp.sum(j_leak.grouped_leak_params(x, jl).v_inf
                                    * cot)
                  + jnp.sum(j_leak.grouped_leak_params(x, jl).tau_ms[0]))(
        jnp.asarray(w))
    _close(g, jg, 1e-4, 1e-7)
    assert float(g[0].abs().max()) > 0 and float(g[1:].abs().max()) == 0
    with pytest.raises(ValueError, match="kernels for"):
        leakage.grouped_leak_params(wt[:2], tl)


def test_curvefit_grouped_and_grads_match_jax():
    """Per-config layer-1 params: spikes and v_pre, and the gradient of a
    v_pre readout w.r.t. every leaf against ``jax.grad``; with every
    config on the same params it equals the stacked forward."""
    jcfg, tcfg, params_s, ev = _grouped_inputs()
    jl, tl = _leak_pairs()
    js, jv = j_p2m.p2m_forward_curvefit_grouped(
        jax.tree.map(jnp.asarray, params_s), jnp.asarray(ev), jcfg, tuple(jl))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params_s.items()}
    ts, tv = p2m_layer.p2m_forward_curvefit_grouped(tp, torch.from_numpy(ev),
                                                    tcfg, tuple(tl))
    assert tuple(tv.shape) == jv.shape == (3, 2, 2, 8, 8, 4)
    _close(tv, jv)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    cot = np.random.default_rng(4).standard_normal(jv.shape).astype(np.float32)
    grads = torch.autograd.grad((tv * torch.from_numpy(cot)).sum(),
                                list(tp.values()))
    jg = jax.grad(lambda p: jnp.vdot(j_p2m.p2m_forward_curvefit_grouped(
        p, jnp.asarray(ev), jcfg, tuple(jl))[1], cot))(
        jax.tree.map(jnp.asarray, params_s))
    for k, g in zip(tp, grads):
        _close(g, jg[k], 1e-4, 1e-7, k)
    # the same params in every config: the stacked forward's result
    one = {k: v[0] for k, v in params_s.items()}
    stacked = p2m_layer.stack_p2m_params(_torch_tree(one), 3)
    assert tuple(stacked["w"].shape) == (3, 3, 3, 2, 4)
    _, v_s = p2m_layer.p2m_forward_curvefit_grouped(
        stacked, torch.from_numpy(ev), tcfg, tuple(tl))
    _, v_st = p2m_layer.p2m_forward_curvefit_stacked(
        _torch_tree(one), torch.from_numpy(ev), tcfg, tuple(tl))
    _close(v_s, v_st, 1e-6, 1e-7)


# ---------------------------------------------------------------------------
# make_train_step: three steps against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("freeze_p2m", [False, True], ids=["unfrozen",
                                                           "frozen"])
def test_make_train_step_matches_jax(reduced_run, freeze_p2m):
    """Three AdamW steps on reduced() from the reference's initial params
    and batches: per step the loss, gnorm, acc, every param, the BN state,
    both moments, the step count and aux; under freeze_p2m layer 1 stays
    bit-identical (its updates are zeroed after its gradients were)."""
    jcfg, jdata, tree, _, _ = reduced_run
    tcfg = p2m_dvs.reduced()[0]
    j_o, t_o = j_opt.adamw(LR), opt.adamw(LR)
    j_step = j_codesign.make_train_step(jcfg, j_o, freeze_p2m=freeze_p2m)
    t_step = codesign.make_train_step(tcfg, t_o, freeze_p2m=freeze_p2m,
                                      device="cpu")
    jt = jax.tree.map(jnp.asarray, tree)
    jp, js = jt["params"], jt["bn_state"]
    jo = j_o.init(jp)
    tp, ts = params_from_jax(tree, device="cpu")
    to = t_o.init(tp)
    p2m0 = {k: v.clone() for k, v in tp["p2m"].items()}
    counts = (dict(lif_mod.LAUNCHES), dict(conv_mod.LAUNCHES),
              dict(fold_mod.LAUNCHES))

    def conv_bias(path):
        return path.startswith("backbone/conv") and path.endswith("/b")

    # what the two sides' conv biases (below) put into the BN running
    # means: momentum-weighted, as the means themselves are
    bias_in_mean = {k: torch.zeros_like(v["mean"]) for k, v in ts.items()}
    for i in range(3):
        ev, labels = j_events.sample_batch(jax.random.PRNGKey(10 + i), jdata,
                                           4, jcfg.p2m.t_intg_ms,
                                           n_sub=jcfg.p2m.n_sub)
        for k in bias_in_mean:
            conv = "conv" + k[2:]
            bias_in_mean[k] = 0.9 * bias_in_mean[k] + 0.1 * (
                tp["backbone"][conv]["b"]
                - torch.from_numpy(np.asarray(jp["backbone"][conv]["b"])))
        jp, jo, js, jm, jaux = j_step(jp, jo, js, ev, labels)
        tp, to, ts, tm, taux = t_step(tp, to, ts, np.asarray(ev),
                                      np.asarray(labels))
        for k in ("loss", "gnorm"):
            _close(tm[k], jm[k], 1e-5, 0, f"step {i} {k}")
        assert float(tm["acc"]) == float(jm["acc"])
        assert sorted(taux) == sorted(jaux)
        for k in jaux:
            assert float(taux[k]) == float(jaux[k]), (i, k)
        _trees_close(tp, jp, skip=conv_bias)
        _trees_close_scaled({k: {"mean": v["mean"] - bias_in_mean[k],
                                 "var": v["var"]} for k, v in ts.items()},
                            js, 1e-5)
        _trees_close_scaled(to["mu"], jo["mu"], 1e-4, skip=conv_bias)
        _trees_close_scaled(to["nu"], jo["nu"], 1e-4, skip=conv_bias)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        # the conv biases: roundoff gradients, Adam-sized steps
        jmu = dict(tree_paths(jax.tree.map(np.asarray, jo["mu"])))
        top = max(np.abs(v).max() for v in jmu.values())
        jpd = dict(tree_paths(jax.tree.map(np.asarray, jp)))
        for path, t in tree_paths(tp):
            if conv_bias(path):
                assert np.abs(jmu[path]).max() <= 1e-6 * top, path
                assert float(to["mu"]["backbone"][path.split("/")[1]]["b"]
                             .abs().max()) <= 1e-6 * top, path
                _close(t, jpd[path], 0, 2 * LR * (i + 1), path)
    if freeze_p2m:
        for k, v in p2m0.items():
            assert torch.equal(tp["p2m"][k], v), k
    else:
        assert not torch.equal(tp["p2m"]["w"], p2m0["w"])
    # training runs no kernel: layer 1 in curvefit, the LIF plain
    assert counts == (dict(lif_mod.LAUNCHES), dict(conv_mod.LAUNCHES),
                      dict(fold_mod.LAUNCHES))


def test_train_step_leaves_its_inputs_and_refuses_kernel_mode(reduced_run):
    """The step is functional (params, optimizer and BN state passed in
    are not modified), and layer 1 in kernel mode, which has no backward,
    is refused."""
    _, _, tree, ev, labels = reduced_run
    tcfg = p2m_dvs.reduced()[0]
    params, state = params_from_jax(tree, device="cpu")
    o = opt.adamw(LR)
    ostate = o.init(params)
    before = [t.clone() for _, t in tree_paths((params, state, ostate))]
    step = codesign.make_train_step(tcfg, o, freeze_p2m=False, device="cpu")
    out = step(params, ostate, state, ev[:2], labels[:2])
    assert np.isfinite(float(out[3]["loss"]))
    after = [t for _, t in tree_paths((params, state, ostate))]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    kcfg = dataclasses.replace(tcfg, p2m=dataclasses.replace(tcfg.p2m,
                                                             mode="kernel"))
    kstep = codesign.make_train_step(kcfg, o, freeze_p2m=True, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        kstep(params, ostate, state, ev[:2], labels[:2])
