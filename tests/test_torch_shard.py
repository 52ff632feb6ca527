"""PyTorch port: the sweep's variant axis and the serving lane axis over
several devices (``core/sweep_exec.py``, ``stream/shard.py``), on the CPU.

The entry points run on the CPU here, so the ``n`` shards are all ``cpu``
(the counterpart of the reference's forced host devices); every shard
still holds its block of the axis as tensors of its own and runs its own
steps. Held to the reference's contracts (``tests/test_sweep_shard.py``,
``tests/test_stream_shard.py``):

- the executor policy: padding repeats the last variant, ``places=``,
  eager ``ValueError`` past the visible cards, no fallback to another
  device;
- the sweep at ``devices=3`` (n_cfg 4 padded to 6), both protocols,
  record for record equal to ``devices=1``, timing fields apart, with
  ``final_params`` unpadded and bit-identical;
- single, registry and adaptive serving at devices 2 and 4 (capacity 4)
  and capacity 3 over 2, plus paced, inline-binning and four-worker
  serves: every stream's label, prediction, logits and counters, and the
  run's ledger, bit-identical to ``devices=1``, one lane a shard
  (``c4_d4``) included;
- the ``sharding`` block equal to the reference engine's for the same run
  (``c4_d2``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import sweep as engine
from repro_torch.core.codesign import P2MModelConfig, SweepConfig
from repro_torch.core.leakage import CircuitConfig, LeakageConfig
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import SpikingCNNConfig
from repro_torch.core.sweep_exec import (AXIS, Blocks, MeshExecutor,
                                         SweepExecutor, make_executor)
from repro_torch.data import events as ev_mod
from repro_torch.data import sources
from repro_torch.stream import deploy
from repro_torch.stream.adapt import AdaptConfig
from repro_torch.stream.engine import StreamEngine
from repro_torch.stream.registry import Registry
from repro_torch.stream.shard import LANE_AXIS, LaneExecutor, make_lane_executor
from repro_torch.utils import tree_paths
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
N_CARDS = torch.cuda.device_count()


# ---------------------------------------------------------------------------
# executor policy
# ---------------------------------------------------------------------------

def test_default_is_one_device():
    for ex in (make_executor(None), make_lane_executor(None)):
        assert ex.devices == 1 and not ex.is_sharded
        assert ex.bind("cpu") == (CPU,)
    assert make_lane_executor(1).axis == LANE_AXIS
    assert issubclass(LaneExecutor, MeshExecutor)
    assert issubclass(SweepExecutor, MeshExecutor)


@pytest.mark.parametrize("make", [make_executor, make_lane_executor])
def test_validates_devices_eagerly(make):
    """A --devices past the visible cards fails at construction, before
    any compute; on the CPU the same count runs that many host shards."""
    n = max(2, N_CARDS + 1)
    with pytest.raises(ValueError, match="visible"):
        make(n, device="cuda")
    with pytest.raises(ValueError, match="visible"):
        LaneExecutor(devices=2, places=("cuda:0", f"cuda:{N_CARDS}"))
    assert make(n, device="cpu").bind("cpu") == (CPU,) * n
    with pytest.raises(ValueError, match=">= 1"):
        make(-1)


def test_no_fallback_to_another_device():
    """An executor runs exactly its shards on the device family it was
    given: bound by an entry point on another device, it raises."""
    with pytest.raises(ValueError, match="never falls back"):
        SweepExecutor(devices=2, device="cpu").bind("cuda")
    with pytest.raises(ValueError, match="never falls back"):
        LaneExecutor(devices=2, places=("cpu", "cpu")).bind("cuda")
    with pytest.raises(ValueError, match="one device per shard"):
        LaneExecutor(devices=3, places=("cpu", "cpu"))
    ex = LaneExecutor(devices=3, places=("cpu",) * 3)
    assert ex.bind("cpu") == (CPU,) * 3
    # an unbound executor takes the entry point's device family
    assert make_executor(2).bind("cpu") == (CPU, CPU)


@pytest.mark.parametrize("n,devices,padded", [
    (3, 1, 3), (3, 8, 8), (4, 8, 8), (9, 8, 16), (8, 8, 8), (4, 3, 6)])
def test_padded_size(n, devices, padded):
    assert SweepExecutor(devices=devices).padded_size(n) == padded
    assert LaneExecutor(devices=devices).padded_size(n) == padded


def test_pad_stacked_repeats_the_last_variant():
    ex = SweepExecutor(devices=4)
    tree = {"a": torch.arange(3.0), "b": torch.ones((3, 2))}
    padded = ex.pad_stacked(tree, 3)
    assert padded["a"].shape == (4,) and padded["b"].shape == (4, 2)
    assert padded["a"].tolist() == [0.0, 1.0, 2.0, 2.0]
    assert ex.pad_stacked(["x", "y", "z"], 3) == ["x", "y", "z", "z"]
    x = torch.arange(4.0)
    assert SweepExecutor(devices=2).pad_stacked({"x": x}, 4)["x"] is x


def test_one_device_shard_is_the_identity():
    fn = lambda x: x + 1  # noqa: E731
    assert SweepExecutor().shard([fn], (AXIS,), (CPU,)) is fn
    tree = {"w": torch.ones(3)}
    assert SweepExecutor().split(tree, (CPU,)) is tree


def test_blocks_own_their_rows():
    """split gives each shard its rows as a tensor of its own (no view
    into the stacked tensor); global rows read and write through, gather
    unpads in shard order, and shard runs each body on its block."""
    ex = SweepExecutor(devices=3)
    x = torch.arange(12.0).reshape(6, 2)
    b = ex.split({"x": x}, (CPU,) * 3)["x"]
    assert isinstance(b, Blocks) and len(b.blocks) == 3
    assert all(blk.shape == (2, 2) and blk.is_contiguous()
               and blk.untyped_storage().data_ptr()
               != x.untyped_storage().data_ptr() for blk in b.blocks)
    assert b[3].tolist() == [6.0, 7.0]
    b[3] = 0
    assert b.blocks[1][1].tolist() == [0.0, 0.0] and x[3, 0] == 6.0
    assert ex.gather(b, 5).tolist() == b.cpu()[:5].tolist()
    seen = []

    def body(k):
        def run(rows, shared):
            seen.append((k, rows.tolist(), shared))
            return {"y": rows * 2}
        return run

    out = ex.shard([body(k) for k in range(3)], (AXIS, "rep"),
                   (CPU,) * 3)(torch.arange(6.0), 7)
    assert [s[1] for s in seen] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    assert ex.gather(out)["y"].tolist() == [0.0, 2.0, 4.0, 6.0, 8.0, 10.0]


# ---------------------------------------------------------------------------
# the sweep's variant axis (the reference's test_sweep_shard script)
# ---------------------------------------------------------------------------

TIMING = {"train_time_s", "train_time_per_step_s", "train_time_norm"}


@pytest.fixture(scope="module")
def sweep_setup():
    model = P2MModelConfig(
        p2m=P2MConfig(out_channels=8, n_sub=2, t_intg_ms=120.0),
        backbone=SpikingCNNConfig(channels=(8, 8, 8, 8), input_hw=(16, 16),
                                  fc_hidden=16, n_classes=5,
                                  first_layer_external=True),
        coarse_window_ms=120.0)
    data = ev_mod.EventStreamConfig(name="gesture", height=16, width=16,
                                    n_classes=5, duration_ms=240.0)
    # 3 circuits, mismatch expands only (c): n_cfg 4, padded to 6 over 3
    grid = engine.SweepGrid(t_intg_grid_ms=(30.0, 120.0),
                            null_mismatch=(0.02, 0.06))
    scfg = SweepConfig(batch_size=2, pretrain_steps=2, finetune_steps=2,
                       eval_batches=1, lr_p2m=5e-4,
                       t_intg_grid_ms=grid.t_intg_grid_ms)
    pre = engine.pretrain_backbone(torch.Generator().manual_seed(scfg.seed),
                                   data, model, scfg, lambda *_: None,
                                   device="cpu")
    return data, model, scfg, grid, pre


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_sharded_sweep_records_equal_one_device(sweep_setup, protocol):
    data, model, scfg, grid, pre = sweep_setup

    def run(executor):
        return engine.run_grid(data, model, scfg, grid, lambda *_: None,
                               protocol=protocol, pretrained=pre,
                               executor=executor, keep_params=True,
                               device="cpu")

    base, sh = run(None), run(make_executor(3))
    assert [r["label"] for r in base.records[:4]] == [
        "a", "b", "c@m=0.02", "c@m=0.06"]
    assert len(sh.records) == len(base.records) == 8
    for a, b in zip(base.records, sh.records):
        assert list(a) == list(b)
        for k in a:
            if k in TIMING:
                assert b[k] > 0.0
                continue
            assert a[k] == b[k], (protocol, k, a["label"], a[k], b[k])
    assert sh.retention == base.retention
    assert list(sh.final_params) == list(base.final_params)
    for cell, fp in base.final_params.items():
        got = tree_paths(sh.final_params[cell])
        want = tree_paths(fp)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.shape == w.shape, path       # unpadded: [4, ...]
            assert torch.equal(g, w), (cell, path)
        assert fp["backbone"]["fc0"]["w"].shape[0] == 4


# ---------------------------------------------------------------------------
# the serving lane axis (the reference's test_stream_shard _PARITY_SCRIPT)
# ---------------------------------------------------------------------------

HW = 16


def _model(circuit=CircuitConfig.BASIC):
    return P2MModelConfig(
        p2m=P2MConfig(out_channels=8, n_sub=2, t_intg_ms=100.0,
                      leak=LeakageConfig(circuit=circuit,
                                         null_mismatch=0.06)),
        backbone=SpikingCNNConfig(channels=(8, 16), input_hw=(HW, HW),
                                  fc_hidden=32, n_classes=11,
                                  first_layer_external=True),
        coarse_window_ms=200.0)


def _awake(dep, gain=3.0):
    """A fresh backbone goes silent (every logit 0, which would make the
    logit checks vacuous); scaling its BN scales and fc0 keeps it firing."""
    bb = dep.params["backbone"]
    for k, v in bb.items():
        if k.startswith("bn"):
            v["scale"].mul_(gain)
    bb["fc0"]["w"].mul_(gain)
    return dep


@pytest.fixture(scope="module")
def serving():
    src = sources.resolve_dataset("synthetic-gesture", hw=HW,
                                  duration_ms=400.0)
    deps = {name: _awake(deploy.fresh_deployment(_model(c), seed=s,
                                                 device="cpu"))
            for s, (name, c) in enumerate((("a", CircuitConfig.BASIC),
                                           ("c", CircuitConfig.NULLIFIED)))}
    return src, deps


def _engine(serving, mode, capacity, devices, **kw):
    src, deps = serving
    if mode == "registry":
        target = Registry()
        for name, d in deps.items():
            target.register(name, d)
    else:
        target = deps["a"]
    if mode == "adapt":
        kw["adapt"] = AdaptConfig(lr_w=0.5, lr_theta=0.01)
    return StreamEngine(target, capacity=capacity, device="cpu",
                        executor=make_lane_executor(devices), **kw)


def _serve(serving, mode, capacity, devices, *, paced=False, **kw):
    src = serving[0]
    variants = ["a", "c", "c"] * 2 if mode == "registry" else None
    return _engine(serving, mode, capacity, devices, **kw).serve(
        src, 6, seed=0, paced=paced, variants=variants)


def assert_same(want, got, tag):
    """Every stream and the run's ledger bit-identical."""
    key = lambda r: r.stream_id  # noqa: E731
    assert len(want.results) == len(got.results) == 6, tag
    for a, b in zip(sorted(want.results, key=key),
                    sorted(got.results, key=key)):
        for f in ("label", "prediction", "n_events", "n_readouts",
                  "n_coarse_frames", "offered_window", "admitted_window",
                  "finished_window", "entry", "entry_uid"):
            assert getattr(a, f) == getattr(b, f), (tag, a.stream_id, f)
        np.testing.assert_array_equal(np.asarray(a.logits),
                                      np.asarray(b.logits), err_msg=tag)
    for k in ("n_offered", "n_admitted", "n_shed", "n_rejected",
              "n_deferred", "total_events", "total_readouts",
              "total_layer1_spikes", "entry_rows", "adaptation"):
        assert getattr(want, k) == getattr(got, k), (tag, k)
    assert max(np.abs(r.logits).max() for r in want.results) > 0.05, \
        f"{tag}: the head never spiked, the comparison would be vacuous"


@pytest.mark.parametrize("mode", ["single", "registry", "adapt"])
def test_sharded_serving_equals_one_device(serving, mode):
    """capacity 4 over 2 and 4 shards (one lane each) and capacity 3 over
    2 (padded to 4) give every stream the bits of devices=1, adaptation's
    per-lane deltas (the ``adaptation`` block's rows) too. One lane a
    shard holds because the backbone steps lane by lane
    (``accumulator.backbone_lanes``): batched, the CPU's fc0 product
    rounds differently at batch 1, as the reference's c4_d4 does."""
    base4 = _serve(serving, mode, 4, None)
    if mode == "adapt":
        assert base4.adaptation["n_updates"] > 0
    assert_same(base4, _serve(serving, mode, 4, 2), f"{mode} c4_d2")
    assert_same(base4, _serve(serving, mode, 4, 4), f"{mode} c4_d4")
    assert_same(_serve(serving, mode, 3, None),
                _serve(serving, mode, 3, 2), f"{mode} c3_d2_padded")


def test_sharded_serving_paced_inline_and_four_workers(serving):
    base4 = _serve(serving, "single", 4, None)
    assert_same(_serve(serving, "single", 4, None, paced=True),
                _serve(serving, "single", 4, 2, paced=True), "c4_d2_paced")
    assert_same(base4, _serve(serving, "single", 4, 2, prefetch=False),
                "c4_d2_noprefetch")
    assert_same(base4, _serve(serving, "single", 4, 2, bin_workers=4),
                "c4_d2_w4")


def test_sharded_state_lives_in_blocks(serving):
    """Each shard's lane state is its own allocation: the engine's state
    and adaptation state are trees of Blocks, one block of
    lanes_per_shard rows per shard, and harvest reads a global lane."""
    eng = _engine(serving, "adapt", 3, 2)
    eng.serve(serving[0], 6, seed=0)
    state = eng.fns.init_state()
    for _, leaf in tree_paths(state) + tree_paths(eng.adapt_state):
        assert isinstance(leaf, Blocks) and len(leaf.blocks) == 2
        assert all(b.shape[0] == 2 for b in leaf.blocks)
    ptrs = [b.data_ptr() for b in state["x"].blocks]
    assert len(set(ptrs)) == 2
    h = eng.harvest(2)
    assert h["dw"].shape == eng.adapt_state["dw"].blocks[1][0].shape
    np.testing.assert_array_equal(h["dw"],
                                  eng.adapt_state["dw"].blocks[1][0].numpy())


def test_sharding_block_equals_the_reference(serving):
    """The artifact's ``sharding`` block for 6 streams at capacity 4 over
    2 shards equals the reference engine's for the same run. The reference
    is driven with its own engine, slots and padding over a lane executor
    whose mesh is the identity (this process has one JAX device; every
    lane's numerics are independent, so the unsharded jit serves the
    padded axis)."""
    from repro.core.codesign import P2MModelConfig as JModel
    from repro.core.leakage import CircuitConfig as JCircuit
    from repro.core.leakage import LeakageConfig as JLeak
    from repro.core.p2m_layer import P2MConfig as JP2M
    from repro.core.snn import SpikingCNNConfig as JCNN
    from repro.data import sources as j_sources
    from repro.stream import deploy as j_deploy
    from repro.stream.engine import StreamEngine as JaxEngine
    from repro.stream.shard import LaneExecutor as JLaneExecutor

    class OneMeshLanes(JLaneExecutor):
        def shard(self, fn, in_specs, out_specs):
            return fn

    j_model = JModel(
        p2m=JP2M(out_channels=8, n_sub=2, t_intg_ms=100.0,
                 leak=JLeak(circuit=JCircuit.BASIC)),
        backbone=JCNN(channels=(8, 16), input_hw=(HW, HW), fc_hidden=32,
                      n_classes=11, first_layer_external=True),
        coarse_window_ms=200.0)
    j_src = j_sources.resolve_dataset("synthetic-gesture", hw=HW,
                                      duration_ms=400.0)
    j_eng = JaxEngine(j_deploy.fresh_deployment(j_model, seed=0),
                      capacity=4, executor=OneMeshLanes(devices=2))
    want = j_eng.serve(j_src, 6, seed=0).to_artifact()
    got = _serve(serving, "single", 4, 2).to_artifact()
    assert got["sharding"] == want["sharding"] == {
        "devices": 2, "bin_workers": 2, "padded_capacity": 4,
        "lanes_per_shard": 2, "per_shard_admitted": [4, 2]}
    thr = got["throughput"]
    assert thr["events_per_s_per_device"] * 2 == \
        pytest.approx(thr["events_per_s"])
    assert got["n_streams"] == want["n_streams"] == 6


def test_stream_fns_refuse_an_unpadded_capacity(serving):
    from repro_torch.stream.accumulator import make_stream_fns
    with pytest.raises(ValueError, match="must be a multiple of"):
        make_stream_fns(serving[1]["a"], capacity=3, chunk_slots=1,
                        device="cpu", executor=make_lane_executor(2))
    fns = make_stream_fns(serving[1]["a"], capacity=4, chunk_slots=1,
                          device="cpu", executor=dataclasses.replace(
                              make_lane_executor(2), places=("cpu",) * 2))
    assert isinstance(fns.init_state()["x"], Blocks)
