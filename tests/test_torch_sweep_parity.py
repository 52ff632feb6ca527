"""The check that holds two runs of the port's co-design sweep against
each other (``tests/sweep_parity.py``, used by ``chip_smoke.py``'s
``[sweep parity]`` and ``tests/test_torch_cuda.py``), on the CPU, at
reduced() with the fast grid, from fresh seeded weights as
``chip_smoke.py`` draws them (BN scales and fc0 doubled, so spikes reach
the head) and as drawn.

The reference run's masks come from its constant channels and two twin
runs (batches reversed; one thread). A held-out sound run, batches
reversed on one thread, changes only the roundoff once more: it must
pass with those masks, and the masks must be few. Runs with the same
batches but some updates dropped are the faults the check must catch:
its params check fails and their backend energies read above
``COUNTER_RTOL``, which the sound run's stay below.
"""
from __future__ import annotations

import pytest
import torch

import sweep_parity as sp
from repro_torch.configs import p2m_dvs
from repro_torch.core import codesign, sweep

CFG, DATA = p2m_dvs.reduced()
GRID = sweep.fast_grid()
SCFG = codesign.SweepConfig(t_intg_grid_ms=GRID.t_intg_grid_ms, batch_size=2,
                            pretrain_steps=2, finetune_steps=2,
                            eval_batches=1)
STEPS = SCFG.pretrain_steps + 1 + SCFG.finetune_steps


def _awake(init):
    def woken(gen, cfg):
        params, state = init(gen, cfg)
        bb = params["backbone"]
        for k, v in bb.items():
            if k.startswith("bn"):
                v["scale"].mul_(2.0)
        bb["fc0"]["w"].mul_(2.0)
        return params, state
    return woken


def _run(source=DATA):
    return sweep.run_protocols(source, CFG, SCFG, GRID, device="cpu",
                               keep_params=True, log=lambda *_: None)


@pytest.fixture(scope="module", params=["as_drawn", "awake"])
def base(request):
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "awake":
            mp.setattr(codesign, "model_init", _awake(codesign.model_init))
        res, masks = sp.cpu_reference(_run, DATA, n_pre=SCFG.pretrain_steps,
                                      steps=1 + SCFG.finetune_steps,
                                      rtol=1e-4)
        yield res, masks, mp


def test_a_held_out_sound_run_passes(base):
    """Batches reversed on one thread: params within 1e-4 of each leaf's
    largest magnitude but for the masked elements, which stay within 2·lr
    a step and under MAX_MASKED_SHARE; records' energies within
    COUNTER_RTOL, counts equal."""
    res, masks, _ = base
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        other = _run(sp.ReversedBatches(DATA))
    finally:
        torch.set_num_threads(threads)
    par = sp.compare_runs(other, res, masks, lr=SCFG.lr, steps=STEPS,
                          rtol=1e-4)
    assert not par.failures, par.failures
    assert 0 < par.share() <= sp.MAX_MASKED_SHARE
    assert max(sp.energy_reading(other, res).values()) <= sp.COUNTER_RTOL
    for p in res:
        for a, b in zip(other[p].records, res[p].records):
            assert (a["accuracy"], a["layer1_spikes"]) == \
                (b["accuracy"], b["layer1_spikes"])


@pytest.mark.parametrize("calls", [None, [0], [SCFG.finetune_steps]],
                         ids=["every_update", "warm_up", "last_finetune"])
def test_dropped_updates_fail(base, calls):
    """The planted faults: the params check fails, and in both protocols
    the backend energies read above COUNTER_RTOL."""
    res, masks, _ = base
    with sp.skip_updates(calls):
        bad = _run()
    par = sp.compare_runs(bad, res, masks, lr=SCFG.lr, steps=STEPS,
                          rtol=1e-4)
    assert par.failures
    assert min(sp.energy_reading(bad, res).values()) > sp.COUNTER_RTOL


def test_masks_follow_the_constant_channels():
    """Every conv bias is masked; circuit (b) never fires at 1000 ms, so
    its backbone's BN1 input is one value per channel and all its BN1
    scales are masked, circuit (a)'s are not; no fc or BN bias is."""
    with sp.record_constant_channels() as log:
        res = _run()
    masks = sp.roundoff_masks(log, {p: r.final_params for p, r in res.items()},
                              n_pre=SCFG.pretrain_steps,
                              steps=1 + SCFG.finetune_steps)
    labels = list(res["frozen"].labels)
    b, a = labels.index("b"), labels.index("a")
    m = masks["frozen"][(1000.0, CFG.p2m.n_sub)]
    assert m["backbone/bn1/scale"][b].all()
    assert not m["backbone/bn1/scale"][a].any()
    for path, mask in m.items():
        if path.endswith("/b") and "/conv" in path:
            assert mask.all(), path
        elif "/fc" in path or path.endswith("/bias"):
            assert not mask.any(), path
    with pytest.raises(AssertionError, match="order of work"):
        sp.roundoff_masks(log[:-1], {p: r.final_params
                                     for p, r in res.items()},
                          n_pre=SCFG.pretrain_steps,
                          steps=1 + SCFG.finetune_steps)
