"""PyTorch port: the batched co-design sweep (``core/sweep.py``, the
energy and retention models, the variant registry) and deploying from a
sweep (``stream/deploy.py``) against the JAX package.

One module-scoped reference run at ``sweep.paper_setup(fast=True)`` (hw
16, batch 2, 4 pretrain / 2 finetune / 2 eval steps, fast grid: circuits
a, b, c@m=0.06 × T_INTG 10, 1000 ms, both protocols) records every batch
its source draws. The port then runs the same sweep from the reference's
initial params (``codesign.model_init`` patched to return them) on a
source that replays those batches in order, so both sides see the same
numbers; the two RNGs could not agree.

Tolerances, and why:
- ``accuracy``, ``layer1_spikes``, ``input_events``, labels, the grid and
  every ``variant`` dict: equal (counts and argmaxes of the same float32
  values);
- ``retention_err_v`` and ``retention_surface_v``: rtol 1e-6 under the
  frozen protocol (the pretrained kernel; ``exp`` of XLA and of PyTorch
  may differ in the last bit), 1e-5 unfrozen (the learned kernels carry
  the training's rounding too);
- ``bandwidth_*`` and ``sensor_energy_p2m_j``: rtol 1e-5 (ratios of the
  equal counts);
- the backend energies and ``energy_improvement``: rtol 1e-5 where the
  port evaluates the reference's trained params
  (``test_batched_eval_on_reference_params``), 1e-3 in the records of the
  two runs. Some weights have an exact gradient of 0 and train on
  roundoff, which Adam scales to steps of about lr either way
  (``tests/sweep_parity.py``: the conv biases before train-mode BN, the
  centre taps of a conv on an input channel constant over the whole
  map, the BN scales of a constant channel; the constant channels are
  measured on the port's run). On this run that moves 4 of circuit
  (a)'s 4060 conv1 spikes at 10 ms (energies 1.5e-5 and 3.9e-4 apart);
- ``final_params`` as ``tests/test_torch_train.py`` holds trained params:
  rtol 1e-5 per element with atol 3e-6 (its 1e-6 covers 3 Adam steps of
  lr 1e-3; a cell here has taken 7 of lr 2e-3, and Adam's step lr·m̂/√v̂
  carries the relative error of a small gradient whatever the weight's
  size), but the unfrozen layer-1 params within 1e-4 of each leaf's
  largest magnitude (their gradients are sums over every site, held to
  1e-4 in ``tests/test_torch_train.py``, and Adam carries a small
  element's relative error into its step), the roundoff-trained weights
  above within 2·lr a step, the BN running means (which absorb them)
  within 1e-2 and the running variances within 1e-5 of each leaf's
  largest magnitude;
- ``train_time_*`` and ``wall_s``: present and positive only (wall clock).

The reference's red ``test_retention_ordering_in_records`` is not
asserted here: the port is held to the reference's values instead.
"""
from __future__ import annotations

import dataclasses
import json
import random

import jax
import numpy as np
import pytest
import torch

from repro.core import codesign as j_codesign
from repro.core import energy as j_energy
from repro.core import leakage as j_leak
from repro.core import sweep as j_sweep
from repro.core import variant_grid as j_vg
from repro.data import sources as j_sources
from repro.stream import deploy as j_deploy
from repro_torch.core import codesign, energy, leakage, sweep, variant_grid
from repro_torch.data import sources
from repro_torch.stream import deploy
from repro_torch.utils import tree_paths

import sweep_parity as sp
from torch_threads import one_torch_thread  # noqa: F401

RET_RTOL = {"frozen": 1e-6, "unfrozen": 1e-5}
ENERGY_RTOL = 1e-5
RTOL, ATOL = 1e-5, 3e-6
TRACE_ATOL = 6e-8        # two float32 ulps at the 0.4 V swing
EQUAL_KEYS = ("label", "circuit", "null_mismatch", "protocol", "t_intg_ms",
              "n_sub", "variant", "accuracy", "layer1_spikes",
              "input_events")
RTOL_KEYS = ("bandwidth_ratio", "bandwidth_norm", "sensor_energy_p2m_j")
COUNTER_KEYS = ("backend_energy_conventional_j", "backend_energy_p2m_j",
                "energy_improvement")
COUNTER_RTOL = 1e-3
LR, STEPS = 2e-3, 4 + 1 + 2      # paper_setup(fast=True): pretrain, warm-up,
#                                  finetune steps before a cell's final params
WALL_KEYS = ("train_time_s", "train_time_per_step_s", "train_time_norm")


class _Recording(j_sources.SyntheticSource):
    """The reference's synthetic source, logging every batch as numpy."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.batches = []

    def sample_batch(self, key, batch_size, t_intg_ms, n_sub=1):
        ev, lab = super().sample_batch(key, batch_size, t_intg_ms, n_sub)
        self.batches.append((np.asarray(ev), np.asarray(lab)))
        return ev, lab


class _Replay(sources.SyntheticSource):
    """The port's synthetic source returning recorded batches in order
    (the generator is not drawn from)."""

    def __init__(self, cfg, batches):
        super().__init__(cfg)
        self.batches = list(batches)
        self.n = 0

    def sample_batch(self, gen, batch_size, t_intg_ms, n_sub=1):
        ev, lab = self.batches[self.n]
        self.n += 1
        assert ev.shape[0] == batch_size and ev.shape[2] == n_sub
        return torch.from_numpy(ev.copy()), torch.from_numpy(lab.copy())


def _quiet(*_):
    pass


def _pre_cfg(model, sweep_cfg):
    t_long = max(sweep_cfg.t_intg_grid_ms)
    return dataclasses.replace(model, p2m=dataclasses.replace(
        model.p2m, t_intg_ms=t_long, mode="curvefit",
        leak=dataclasses.replace(model.p2m.leak, circuit=type(
            model.p2m.leak.circuit).IDEAL)))


@pytest.fixture(scope="module")
def runs():
    """The reference's run and the port's on the reference's batches and
    initial params: (reference results, port results, both artifacts)."""
    data, model, sweep_cfg, grid = j_sweep.paper_setup(fast=True)
    sweep_cfg = dataclasses.replace(sweep_cfg,
                                    t_intg_grid_ms=grid.t_intg_grid_ms)
    rec = _Recording(data.cfg)
    key = jax.random.PRNGKey(sweep_cfg.seed)
    init = j_codesign.model_init(key, _pre_cfg(model, sweep_cfg))
    init_tree = jax.tree.map(np.asarray, {"params": init[0],
                                          "bn_state": init[1]})
    pre = j_sweep.pretrain_backbone(key, rec, model, sweep_cfg, _quiet)
    j_res = {p: j_sweep.run_grid(rec, model, sweep_cfg, grid, _quiet,
                                 protocol=p, pretrained=pre,
                                 keep_params=True)
             for p in j_sweep.PROTOCOLS}
    j_art = json.loads(json.dumps(j_sweep.protocols_artifact(j_res),
                                  default=float))

    t_data, t_model, t_sweep, t_grid = sweep.paper_setup(fast=True)
    t_sweep = dataclasses.replace(t_sweep,
                                  t_intg_grid_ms=t_grid.t_intg_grid_ms)
    replay = _Replay(t_data.cfg, rec.batches)
    with pytest.MonkeyPatch.context() as mp, \
            sp.record_constant_channels() as log:
        mp.setattr(codesign, "model_init", lambda gen, cfg:
                   deploy.params_from_jax(init_tree, device="cpu"))
        t_pre = sweep.pretrain_backbone(torch.Generator().manual_seed(0),
                                        replay, t_model, t_sweep, _quiet,
                                        device="cpu")
        t_res = {p: sweep.run_grid(replay, t_model, t_sweep, t_grid, _quiet,
                                   protocol=p, pretrained=t_pre,
                                   keep_params=True, device="cpu")
                 for p in sweep.PROTOCOLS}
    assert replay.n == len(rec.batches)
    masks = sp.roundoff_masks(
        log, {p: r.final_params for p, r in t_res.items()},
        n_pre=t_sweep.pretrain_steps, steps=1 + t_sweep.finetune_steps)
    t_art = sweep.protocols_artifact(t_res)
    return j_res, t_res, j_art, t_art, (model, t_model, grid, t_grid, masks)


def test_artifact_structure_matches_reference(runs):
    """Keys, grid block, labels, protocols, record order and variant
    dicts equal the reference's; the port's artifact dumps as JSON with
    no ``default=``."""
    _, _, j_art, t_art, _ = runs
    t_art = json.loads(json.dumps(t_art))
    assert list(t_art) == list(j_art)
    assert t_art["schema"] == j_art["schema"] == sweep.SCHEMA_V3
    assert t_art["protocols"] == j_art["protocols"] == ["frozen", "unfrozen"]
    assert t_art["grid"] == j_art["grid"]
    assert t_art["grid"]["labels"] == ["a", "b", "c@m=0.06"]
    assert len(t_art["records"]) == len(j_art["records"]) == 12
    for t, j in zip(t_art["records"], j_art["records"]):
        assert list(t) == list(j)
        assert [t[k] for k in ("protocol", "label", "t_intg_ms")] == \
            [j[k] for k in ("protocol", "label", "t_intg_ms")]
        assert t["variant"] == j["variant"]
    assert t_art["retention"]["t_grid_ms"] == j_art["retention"]["t_grid_ms"]
    assert t_art["retention"]["v0"] == j_art["retention"]["v0"]
    assert list(t_art["retention"]["mean_abs_error_v"]) == \
        list(j_art["retention"]["mean_abs_error_v"])
    for lab, row in j_art["retention"]["mean_abs_error_v"].items():
        np.testing.assert_allclose(t_art["retention"]["mean_abs_error_v"][lab],
                                   row, rtol=RET_RTOL["frozen"], atol=0)


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_records_match_reference(runs, protocol):
    """Per record: counts and accuracy equal, energies and bandwidth
    within ENERGY_RTOL, retention within RET_RTOL, wall times positive."""
    j_res, t_res, _, _, _ = runs
    for t, j in zip(t_res[protocol].records, j_res[protocol].records):
        what = (protocol, j["label"], j["t_intg_ms"])
        for k in EQUAL_KEYS:
            assert t[k] == j[k], (what, k, t[k], j[k])
        for k in RTOL_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=ENERGY_RTOL, atol=0,
                                       err_msg=f"{what} {k}")
        for k in COUNTER_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=COUNTER_RTOL, atol=0,
                                       err_msg=f"{what} {k}")
        np.testing.assert_allclose(t["retention_err_v"], j["retention_err_v"],
                                   rtol=RET_RTOL[protocol], atol=0)
        np.testing.assert_allclose(t["retention_surface_v"],
                                   j["retention_surface_v"],
                                   rtol=RET_RTOL[protocol], atol=0)
        for k in WALL_KEYS:
            assert isinstance(t[k], float) and t[k] > 0, (what, k)
        assert all(type(v) in (str, float, int, dict, list)
                   for v in t.values()), what


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_final_params_match_reference(runs, protocol):
    """Each cell's trained weights in the reference's layout (stacked on
    [n_cfg], but for the frozen protocol's shared layer 1)."""
    j_res, t_res, _, _, (*_, masks) = runs
    jf, tf = j_res[protocol].final_params, t_res[protocol].final_params
    assert list(tf) == list(jf)
    for cell in jf:
        want = dict(tree_paths(jax.tree.map(np.asarray, jf[cell])))
        got = dict(tree_paths(tf[cell]))
        assert sorted(got) == sorted(want)
        assert want["p2m/w"].ndim == (5 if protocol == "unfrozen" else 4)
        for path, w in want.items():
            g = got[path].numpy()
            assert g.shape == w.shape, path
            if path.startswith("state/") or (protocol == "unfrozen"
                                              and path.startswith("p2m/")):
                rel = (1e-4 if path.startswith("p2m/") else
                       1e-2 if path.endswith("/mean") else 1e-5)
                err = float(np.abs(g - w).max())
                assert err <= rel * float(np.abs(w).max()), (cell, path, err)
                continue
            free = masks[protocol][cell][path].numpy()
            np.testing.assert_allclose(g[free], w[free], rtol=0,
                                       atol=2 * LR * STEPS, err_msg=path)
            np.testing.assert_allclose(g[~free], w[~free], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{cell} {path}")


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_batched_eval_on_reference_params(runs, protocol):
    """The port's batched eval on the reference's trained params and a
    batch of the reference's sampler: accuracy, layer-1 counters and the
    backbone's aux equal, and the energies from them within 1e-5."""
    j_res, _, _, _, (j_model, t_model, grid, t_grid, _) = runs
    cell = (10.0, 2)
    fp = jax.tree.map(np.asarray, j_res[protocol].final_params[cell])
    j_cfg = dataclasses.replace(j_model, p2m=dataclasses.replace(
        j_model.p2m, t_intg_ms=cell[0], n_sub=cell[1]))
    t_cfg = dataclasses.replace(t_model, p2m=dataclasses.replace(
        t_model.p2m, t_intg_ms=cell[0], n_sub=cell[1]))
    j_lcs = j_sweep.expand_leak_configs(grid, j_model.p2m.leak)
    t_lcs = sweep.expand_leak_configs(t_grid, t_model.p2m.leak)
    data = j_sweep.paper_setup(fast=True)[0]
    ev, lab = data.sample_batch(jax.random.PRNGKey(7), 4, cell[0],
                                n_sub=cell[1])
    jm, jaux, jl1 = j_sweep.make_batched_eval(j_cfg, j_lcs, protocol)(
        fp["p2m"], fp["backbone"], fp["state"], ev, lab)
    tp = {k: deploy.tree_to(v, torch.device("cpu")) for k, v in fp.items()}
    tm, taux, tl1 = sweep.make_batched_eval(t_cfg, t_lcs, protocol,
                                            device="cpu")(
        tp["p2m"], tp["backbone"], tp["state"], np.array(ev), np.array(lab))
    assert tm["acc"].tolist() == np.asarray(jm["acc"]).tolist()
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        assert taux[k].tolist() == np.asarray(jaux[k]).tolist(), k
    for k in jl1:
        assert np.asarray(tl1[k]).tolist() == np.asarray(jl1[k]).tolist(), k
    macs = float(jl1["macs/p2m"])
    for g in range(len(j_lcs)):
        ja = {k: float(v[g]) for k, v in jaux.items()}
        ta = {k: float(taux[k][g]) for k in sorted(taux)}
        spikes = float(jl1["spikes/p2m"][g])
        np.testing.assert_allclose(
            energy.backend_energy_conventional(ta, macs),
            j_energy.backend_energy_conventional(ja, macs), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(
            energy.backend_energy_p2m(ta, spikes, macs),
            j_energy.backend_energy_p2m(ja, spikes, macs), rtol=ENERGY_RTOL)
    assert float(np.asarray(jl1["spikes/p2m"]).max()) > 0
    assert float(np.asarray(jaux["spikes/conv1"]).max()) > 0


# ---------------------------------------------------------------------------
# units: energy, retention, the variant registry, the sources, selection
# ---------------------------------------------------------------------------

def test_energy_models_match_reference():
    """Every function of core/energy on the same aux dict: equal floats."""
    rng = np.random.default_rng(3)
    aux = {k: float(v) for k, v in zip(
        ("synops/conv0", "synops/conv1", "synops/fc0", "spikes/conv1",
         "synops/fc1"), rng.uniform(0, 1e6, 5).astype(np.float32))}
    spikes, macs = 12345.0, float(np.float32(1.9e9))
    em = energy.EnergyModel(e_ac_pj=0.7)
    jem = j_energy.EnergyModel(e_ac_pj=0.7)
    assert energy.bandwidth_ratio(spikes, 7.0) == \
        j_energy.bandwidth_ratio(spikes, 7.0)
    assert energy.bandwidth_ratio(3.0, 0.0) == \
        j_energy.bandwidth_ratio(3.0, 0.0)
    for e, je in ((energy.EnergyModel(), j_energy.EnergyModel()), (em, jem)):
        assert energy.backend_energy_conventional(aux, macs, e) == \
            j_energy.backend_energy_conventional(aux, macs, je)
        assert energy.backend_energy_p2m(aux, spikes, macs, e) == \
            j_energy.backend_energy_p2m(aux, spikes, macs, je)
        assert energy.sensor_energy_p2m(macs, e) == \
            j_energy.sensor_energy_p2m(macs, je)
        assert energy.improvement(aux, spikes, macs, e) == \
            j_energy.improvement(aux, spikes, macs, je)


def _leak_pairs(**kw):
    return ([j_leak.LeakageConfig(circuit=j_leak.CircuitConfig(c), **kw)
             for c in ("a", "b", "c")],
            [leakage.LeakageConfig(circuit=leakage.CircuitConfig(c), **kw)
             for c in ("a", "b", "c")])


@pytest.mark.parametrize("kw", [{}, {"sigma": 0.1, "null_mismatch": 0.02}])
def test_retention_surface_and_traces_match_reference(kw):
    """retention_traces [n_cfg, n_t, F] and retention_surface [n_cfg, n_t]
    on one quantized kernel within 1e-6 (traces also within TRACE_ATOL:
    V(t) = V_inf + (V0 − V_inf)·a sums terms near 0.4 V, so one ulp of
    ``exp`` shows at that scale); retention_error on grouped params
    within the unfrozen protocol's 1e-5."""
    rng = np.random.default_rng(4)
    w = (np.round(rng.uniform(-1, 1, (3, 3, 2, 8)) * 8) / 8).astype(np.float32)
    jl, tl = _leak_pairs(**kw)
    ts = (1.0, 10.0, 100.0, 1000.0)
    jt = np.asarray(j_leak.retention_traces(jax.numpy.asarray(w), jl,
                                            jax.numpy.asarray(ts)))
    tt = leakage.retention_traces(torch.from_numpy(w), tl, ts).numpy()
    assert tt.shape == jt.shape == (3, 4, 8)
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=TRACE_ATOL)
    js = np.asarray(j_leak.retention_surface(jax.numpy.asarray(w), jl, ts))
    tsurf = leakage.retention_surface(torch.from_numpy(w), tl, ts).numpy()
    np.testing.assert_allclose(tsurf, js, rtol=1e-6, atol=0)
    ws = np.stack([w, w * 0.5, -w]).astype(np.float32)
    jlk = j_leak.grouped_leak_params(jax.numpy.asarray(ws), jl)
    tlk = leakage.grouped_leak_params(torch.from_numpy(ws), tl)
    for t in ts:
        np.testing.assert_allclose(
            leakage.retention_error(tlk, 0.2, t).numpy(),
            np.asarray(j_leak.retention_error(jlk, 0.2, t)), rtol=1e-5,
            atol=1e-9)


def _grids():
    """Grids over every registered axis, alone and together, for both
    packages."""
    combos = [{}, {"null_mismatch": (0.02, 0.06, 0.2)},
              {"v_threshold": (0.01, 0.02)}, {"sigma": (0.0, 0.1)},
              {"n_sub": (2, 4)},
              {"null_mismatch": (0.02, 0.2), "v_threshold": (0.01,),
               "sigma": (0.0, 0.1), "n_sub": (1, 3)},
              {"circuits": ("a", "c"), "null_mismatch": ()}]
    out = []
    for c in combos:
        circ = c.get("circuits", ("a", "b", "c"))
        kw = {k: v for k, v in c.items() if k != "circuits"}
        out.append((
            j_sweep.SweepGrid(circuits=tuple(j_leak.CircuitConfig(x)
                                             for x in circ), **kw),
            sweep.SweepGrid(circuits=tuple(leakage.CircuitConfig(x)
                                           for x in circ), **kw)))
    return out


@pytest.mark.parametrize("i", range(7))
def test_variant_grid_matches_reference(i):
    """expand_variants, variant_label, variant_dict, outer_cells,
    active_axes and grid_axis_values over every registered axis."""
    jg, tg = _grids()[i]
    jv = j_vg.expand_variants(jg, j_leak.LeakageConfig())
    tv = variant_grid.expand_variants(tg, leakage.LeakageConfig())
    assert len(jv) == len(tv) > 0
    for a, b in zip(jv, tv):
        assert variant_grid.variant_label(b) == j_vg.variant_label(a)
        for ns in (1, 4):
            assert variant_grid.variant_dict(
                b, v_threshold_default=0.015, n_sub=ns) == \
                j_vg.variant_dict(a, v_threshold_default=0.015, n_sub=ns)
    assert variant_grid.outer_cells(tg, 4) == j_vg.outer_cells(jg, 4)
    assert variant_grid.active_axes(tg) == j_vg.active_axes(jg)
    assert variant_grid.grid_axis_values(tg) == j_vg.grid_axis_values(jg)
    assert [a.name for a in variant_grid.AXES] == [a.name for a in j_vg.AXES]
    for a in j_vg.AXES:
        assert variant_grid.axis(a.cli).cli_defaults == a.cli_defaults
        assert variant_grid.check_values(a.name, a.cli_defaults) == \
            j_vg.check_values(a.name, a.cli_defaults)
    with pytest.raises(KeyError):
        variant_grid.axis("nope")


def test_synthetic_source_batch_api():
    """sample_batch / sample_batch_with_labels: shapes and dtypes of the
    reference's contract, drawn on the CPU, reproducible from a seed;
    as_source and resolve_eval_dataset as the reference's."""
    src = sources.resolve_dataset("synthetic-gesture", hw=8,
                                  duration_ms=200.0)
    ev, lab = src.sample_batch(torch.Generator().manual_seed(1), 3, 50.0,
                               n_sub=2)
    assert ev.shape == (3, 4, 2, 8, 8, 2) and ev.dtype == torch.float32
    assert lab.shape == (3,) and ev.device.type == "cpu"
    ev2, lab2 = src.sample_batch(torch.Generator().manual_seed(1), 3, 50.0,
                                 n_sub=2)
    assert torch.equal(ev, ev2) and torch.equal(lab, lab2)
    ev3, lab3 = src.sample_batch_with_labels(
        torch.Generator().manual_seed(2), torch.tensor([4, 5]), 100.0)
    assert ev3.shape == (2, 2, 1, 8, 8, 2) and lab3.tolist() == [4, 5]
    assert sources.as_source(src) is src
    assert isinstance(sources.as_source(src.cfg), sources.SyntheticSource)
    with pytest.raises(TypeError):
        sources.as_source(3)
    for name in ("synthetic-gesture", "synthetic-nmnist"):
        assert sources.resolve_eval_dataset(name, hw=8) == \
            j_sources.resolve_eval_dataset(name, hw=8) == (None, None)
    assert sources.DATASET_DURATIONS_MS == j_sources.DATASET_DURATIONS_MS
    # the file-backed datasets: a root is required, and one without
    # recordings raises, as in the reference
    for mod in (sources, j_sources):
        with pytest.raises(ValueError, match="file-backed"):
            mod.resolve_dataset("dvs128", split="val")
        with pytest.raises(ValueError, match="no samples found"):
            mod.resolve_dataset("nmnist", data_root="x", split="val")


def test_select_record_total_order_matches_reference(runs):
    """select_record over shuffled records and after a JSON round trip
    picks what the reference picks, for every filter."""
    _, _, j_art, _, _ = runs
    recs = j_art["records"]
    rng = random.Random(0)
    tie = dict(recs[0], accuracy=1.0)
    pools = [recs, recs + [tie, dict(tie, label="z")]]
    for pool in pools:
        for _ in range(3):
            shuffled = json.loads(json.dumps(rng.sample(pool, len(pool))))
            for kw in ({}, {"protocol": "unfrozen"}, {"t_intg_ms": 1000.0},
                       {"label": "b"}, {"protocol": "frozen",
                                        "t_intg_ms": 10.0}):
                assert deploy.select_record(shuffled, **kw) == \
                    j_deploy.select_record(shuffled, **kw), kw
    assert deploy.select_from_artifact(j_art, protocol="frozen") == \
        j_deploy.select_from_artifact(j_art, protocol="frozen")
    with pytest.raises(ValueError, match="no sweep record"):
        deploy.select_record(recs, label="nope")
    with pytest.raises(ValueError, match="not a co-design"):
        deploy.select_from_artifact({"schema": "x", "records": recs})


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_deploy_from_sweep_both_directions(runs, protocol, tmp_path):
    """The port's checkpoint of a record loads in the reference (and
    against the reference's artifact) with the same config and weights;
    the reference's loads in the port, and the port's load_deployment
    refuses an artifact that lacks the record."""
    j_res, t_res, j_art, t_art, (j_model, t_model, *_) = runs
    rec = deploy.select_record(t_res[protocol].records, t_intg_ms=10.0)
    jrec = j_deploy.select_record(j_res[protocol].records, t_intg_ms=10.0)
    assert (rec["label"], rec["t_intg_ms"]) == (jrec["label"],
                                                jrec["t_intg_ms"])
    deploy.deploy_from_sweep(t_res[protocol], t_model, rec, tmp_path / "t",
                             meta={"dataset": "synthetic-gesture"})
    j_deploy.deploy_from_sweep(j_res[protocol], j_model, jrec,
                               tmp_path / "j")
    jd = j_deploy.load_deployment(tmp_path / "t", t_art)
    td = deploy.load_deployment(tmp_path / "t", device="cpu",
                                artifact=t_art)
    assert j_deploy.model_config_to_dict(jd.model_cfg) == \
        deploy.model_config_to_dict(td.model_cfg)
    assert td.protocol == jd.protocol == protocol
    assert td.record == jd.record and td.meta == {"dataset":
                                                  "synthetic-gesture"}
    g = list(t_res[protocol].labels).index(rec["label"])
    want = t_res[protocol].final_params[(10.0, 2)]["backbone"]["fc0"]["w"][g]
    assert torch.equal(td.params["backbone"]["fc0"]["w"], want)
    np.testing.assert_array_equal(np.asarray(jd.params["p2m"]["w"]),
                                  td.params["p2m"]["w"].numpy())
    back = deploy.load_deployment(tmp_path / "j", device="cpu",
                                  artifact=j_art)
    jback = j_deploy.load_deployment(tmp_path / "j", j_art)
    assert deploy.model_config_to_dict(back.model_cfg) == \
        j_deploy.model_config_to_dict(jback.model_cfg)
    for path, leaf in tree_paths(jax.tree.map(np.asarray, jback.params)):
        np.testing.assert_array_equal(
            dict(tree_paths(back.params))[path].numpy(), leaf, err_msg=path)
    assert back.model_cfg.p2m.leak == deploy.leak_config_from_variant(
        jrec["variant"], t_model.p2m.leak)
    with pytest.raises(ValueError, match="not found in the sweep"):
        deploy.load_deployment(tmp_path / "t", device="cpu",
                               artifact={"records": []})


@pytest.mark.parametrize("mode", ["curvefit", "scan"])
def test_layer1_coarse_matches_reference(runs, mode):
    """The stacked physics-validator path (any mode) → pool → coarsen on
    the reference's pretrained layer 1: coarse counts and layer-1
    statistics equal."""
    j_res, _, _, _, (j_model, t_model, grid, t_grid, _) = runs
    p2m = jax.tree.map(np.asarray, j_res["frozen"].final_params[(10.0, 2)]
                       ["p2m"])
    j_cfg = dataclasses.replace(j_model, p2m=dataclasses.replace(
        j_model.p2m, t_intg_ms=10.0, mode=mode))
    t_cfg = dataclasses.replace(t_model, p2m=dataclasses.replace(
        t_model.p2m, t_intg_ms=10.0, mode=mode))
    data = j_sweep.paper_setup(fast=True)[0]
    ev, _ = data.sample_batch(jax.random.PRNGKey(9), 2, 10.0, n_sub=2)
    jc, jl1 = j_sweep._layer1_coarse(
        p2m, ev, j_cfg, j_sweep.expand_leak_configs(grid, j_model.p2m.leak))
    tc, tl1 = sweep._layer1_coarse(
        deploy.tree_to(p2m, torch.device("cpu")), torch.from_numpy(
            np.array(ev)), t_cfg,
        sweep.expand_leak_configs(t_grid, t_model.p2m.leak))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for k in jl1:
        assert np.asarray(tl1[k]).tolist() == np.asarray(jl1[k]).tolist(), k
    assert float(np.asarray(jc).sum()) > 0
