"""PyTorch port: ``torch.autograd.gradcheck`` (float64 central
differences) through the smooth seams of the P²M training slice, held as
the reference's finite-difference test holds them (rtol 1e-3 on the
curve-fit forward). It shares ``tests/test_torch_train.py``'s inputs and
sits in a file of its own because it is the suite's longest test: under
``--dist loadfile`` it then runs beside the rest of the training tests
instead of after them on one worker."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codesign, p2m_layer, snn
from repro_torch.utils import tree_map
from test_torch_train import _grouped_inputs, _leak_pairs


def _f64(tree):
    return tree_map(lambda t: t.double(), tree)


def test_gradcheck_float64_train_seams():
    """``torch.autograd.gradcheck`` (float64 central differences) through
    the smooth seams training differentiates: the grouped curve-fit v_pre
    w.r.t. w (at a fine quantizer step, so finite differences see the
    straight-through slope), pv_gain and pv_offset per circuit; BN in
    training w.r.t. its input, scale and bias; and the loss of
    ``model_apply(train=True)`` w.r.t. the head (fc1), downstream of every
    spike. The spike comparator itself is a step whose surrogate gradient
    finite differences must not see (test_torch_core holds it to the
    reference's ATan formula)."""
    _, tcfg, params_s, ev = _grouped_inputs(levels=1 << 22)
    _, tl = _leak_pairs()
    evt = torch.from_numpy(ev).double()

    def v_pre(w, gain, offset):
        return p2m_layer.p2m_forward_curvefit_grouped(
            {"w": w, "pv_gain": gain, "pv_offset": offset}, evt, tcfg,
            tuple(tl))[1]

    args = [torch.from_numpy(params_s[k]).double().requires_grad_(True)
            for k in ("w", "pv_gain", "pv_offset")]
    # eps spans ~2000 quantizer steps, so the staircase averages out
    assert torch.autograd.gradcheck(v_pre, args, eps=1e-3, atol=1e-5,
                                    rtol=1e-3)

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((5, 3, 4))).requires_grad_(True)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 4)).requires_grad_(True)
    bias = torch.from_numpy(rng.uniform(-0.3, 0.3, 4)).requires_grad_(True)
    s = {"mean": torch.zeros(4, dtype=torch.float64),
         "var": torch.ones(4, dtype=torch.float64)}
    assert torch.autograd.gradcheck(
        lambda a, b, c: snn.bn_apply({"scale": b, "bias": c}, s, a,
                                     train=True)[0],
        (x, scale, bias), eps=1e-6, atol=1e-6, rtol=1e-4)

    cfg = codesign.P2MModelConfig(
        p2m=p2m_layer.P2MConfig(out_channels=4, n_sub=2, t_intg_ms=60.0),
        backbone=snn.SpikingCNNConfig(channels=(4, 4, 4), input_hw=(8, 8),
                                      fc_hidden=8, n_classes=3,
                                      first_layer_external=True),
        coarse_window_ms=120.0)
    params, state = codesign.model_init(torch.Generator().manual_seed(0), cfg)
    params, state = _f64(params), _f64(state)
    for k, v in params["backbone"].items():
        if k.startswith("bn"):
            v["scale"] = v["scale"] * 3.0
    params["backbone"]["fc0"]["w"] = params["backbone"]["fc0"]["w"] * 3.0
    ev_m = torch.from_numpy(np.random.default_rng(2).poisson(
        0.5, (2, 4, 2, 8, 8, 2))).double()
    labels = torch.tensor([0, 2])

    def loss(w1, b1):
        bb = {**params["backbone"], "fc1": {"w": w1, "b": b1}}
        logits, _, aux = codesign.model_apply({**params, "backbone": bb},
                                              state, ev_m, cfg, train=True)
        assert float(aux["spikes/fc0"]) > 0       # the head sees spikes
        return snn.cross_entropy(logits, labels)

    fc1 = params["backbone"]["fc1"]
    assert torch.autograd.gradcheck(
        loss, (fc1["w"].clone().requires_grad_(True),
               fc1["b"].clone().requires_grad_(True)),
        eps=1e-6, atol=1e-6, rtol=1e-4)
