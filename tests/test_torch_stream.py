"""PyTorch port: the serving slice against the JAX package.

A deployment the JAX package wrote (``reduced()`` P²M config, fresh
seeded weights) is loaded by the port and served on the CPU on the same
numpy events. Held to: charge ``x`` ≤ 1e-5 abs, layer-1 spikes equal
except where ``|v_pre − theta| < 1e-5`` (a comparator sitting on its
threshold may flip under float32 reordering; the count is reported),
final logits ≤ 1e-4 abs, and equal predictions wherever the top-two
logit gap exceeds 1e-3.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import p2m_dvs as j_configs
from repro.stream import accumulator as j_acc
from repro.stream import deploy as j_deploy
from repro.stream.engine import StreamEngine as JaxEngine
from repro_torch.core import analog
from repro_torch.data.binning import frames_to_events
from repro_torch.data.sources import rechunk_events
from repro_torch.stream import accumulator, deploy
from repro_torch.stream.engine import StreamEngine
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
X_ATOL, LOGIT_ATOL, NEAR, GAP = 1e-5, 1e-4, 1e-5, 1e-3
N_SUB = 4


def _awake(params, gain=2.0):
    """Fresh He-init backbones go silent by their third layer on these
    inputs (every logit exactly 0, which would make the logit checks
    vacuous); doubling the BN scales and the fc0 weights keeps spikes
    flowing to the head."""
    bb = dict(params["backbone"])
    for k, v in bb.items():
        if k.startswith("bn"):
            bb[k] = {**v, "scale": v["scale"] * gain}
    bb["fc0"] = {**bb["fc0"], "w": bb["fc0"]["w"] * gain}
    return {**params, "backbone": bb}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A reduced() deployment written by the JAX package."""
    cfg, _ = j_configs.reduced()
    dep = j_deploy.fresh_deployment(cfg, seed=3)
    dep = dataclasses.replace(dep, params=_awake(dep.params))
    path = tmp_path_factory.mktemp("jax_deploy")
    j_deploy.save_deployment(path, dep)
    return dep, path


@pytest.fixture(scope="module")
def port_dep(jax_ckpt):
    return deploy.load_deployment(jax_ckpt[1], device="cpu")


def _events(seed, B, T, hw):
    rng = np.random.default_rng(seed)
    return rng.poisson(0.25, (B, T, N_SUB, hw, hw, 2)).astype(np.float32)


def _assert_spikes_match(got, want, v_pre, theta, what):
    near = np.abs(v_pre - theta) < NEAR
    bad = (got != want) & ~near
    print(f"{what}: {int(near.sum())} of {near.size} comparator inputs "
          f"within {NEAR:g} V of theta")
    assert not bad.any(), f"{what}: {int(bad.sum())} spikes differ"


def _assert_logits_match(got, want):
    assert np.abs(want).max() > 0.05, "vacuous: the head never spiked"
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def test_checkpoint_and_in_memory_params_agree(jax_ckpt, port_dep):
    """load_deployment (disk) and params_from_jax (memory) give the same
    tensors, equal to the JAX package's arrays; the config round-trips."""
    jdep, _ = jax_ckpt
    params, bn = deploy.params_from_jax(
        {"params": jax.device_get(jdep.params),
         "bn_state": jax.device_get(jdep.bn_state)}, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(jdep.params)
    for path, leaf in flat:
        keys = [p.key for p in path]
        a, b = params, port_dep.params
        for k in keys:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf))
        np.testing.assert_array_equal(b.numpy(), np.asarray(leaf))
    assert set(bn) == set(jdep.bn_state)
    assert (deploy.model_config_to_dict(port_dep.model_cfg)
            == j_deploy.model_config_to_dict(jdep.model_cfg))
    assert port_dep.record == json.loads(json.dumps(jdep.record))


def test_offline_forward_matches_jax(jax_ckpt, port_dep):
    jdep, _ = jax_ckpt
    ev = _events(0, 2, 200, 24)
    want = j_deploy.offline_forward(jdep, jnp.asarray(ev))
    got = deploy.offline_forward(port_dep, torch.from_numpy(ev))
    np.testing.assert_allclose(got["v_pre"].numpy(), np.asarray(want["v_pre"]),
                               rtol=0, atol=X_ATOL)
    _assert_spikes_match(got["spikes"].numpy(), np.asarray(want["spikes"]),
                         got["v_pre"].numpy(), port_dep.coeffs.v_threshold,
                         "offline layer 1")
    _assert_logits_match(got["logits"].numpy(), np.asarray(want["logits"]))


def test_stream_fns_window_by_window_match_jax(jax_ckpt, port_dep):
    """Fold one sub-slot chunk at a time, read out at every T_INTG window,
    on both packages; then the port's stream against its own offline
    forward."""
    jdep, _ = jax_ckpt
    B, T, hw = 2, 200, 24
    ev = _events(1, B, T, hw)
    jf = j_acc.make_stream_fns(jdep, capacity=B, chunk_slots=1)
    tf = accumulator.make_stream_fns(port_dep, capacity=B, chunk_slots=1,
                                     device="cpu")
    js, ts = jf.init_state(), tf.init_state()
    active = np.ones(B, bool)
    group = port_dep.model_cfg.coarsen_group()
    nb = accumulator.entry_numerics(port_dep)
    n_near = 0
    for t in range(T):
        for k in range(N_SUB):
            fr = ev[:, t, k:k + 1]
            js = jf.fold(js, jnp.asarray(fr), jnp.asarray(active))
            ts = tf.fold(ts, torch.from_numpy(fr), active)
        np.testing.assert_allclose(ts["x"].numpy(), np.asarray(js["x"]),
                                   rtol=0, atol=X_ATOL)
        v_pre = analog.transfer_curve(ts["x"] + nb["drift"],
                                      port_dep.model_cfg.p2m.analog,
                                      nb["pv"]).numpy()
        cm = np.full(B, (t + 1) % group == 0)
        js, jo = jf.readout(js, jnp.asarray(active), jnp.asarray(cm))
        ts, to = tf.readout(ts, active, cm)
        near = np.abs(v_pre - nb["theta"]) < NEAR
        n_near += int(near.sum())
        bad = (to["spikes"].numpy() != np.asarray(jo["spikes"])) & ~near
        assert not bad.any(), f"window {t}: {int(bad.sum())} spikes differ"
    print(f"stream layer 1: {n_near} comparator inputs within {NEAR:g} V "
          f"of theta")
    got = (ts["logits"] / ts["n_coarse"][:, None]).numpy()
    want = np.asarray(js["logits"] / js["n_coarse"][:, None])
    _assert_logits_match(got, want)
    offline = deploy.offline_forward(port_dep, torch.from_numpy(ev))
    _assert_logits_match(got, offline["logits"].numpy())


class _Replay:
    """Feeds the same pre-drawn event records to either package's engine:
    stream ``i`` (admission order = stream order) replays record ``i``."""

    def __init__(self, records, labels, hw, duration_ms, n_classes):
        self.records, self.labels = records, labels
        self.name = "replay"
        self.height = self.width = hw
        self.sensor_hw = (hw, hw)
        self.n_classes = n_classes
        self.duration_ms = duration_ms
        self._opened = 0

    def n_slots(self, t_intg_ms):
        return int(round(self.duration_ms / t_intg_ms))

    def iter_event_chunks(self, key, *, chunk_us, slot_us=None):
        i = self._opened
        self._opened += 1
        n = int(round(self.duration_ms * 1000 / chunk_us))
        return self.labels[i], rechunk_events(self.records[i], chunk_us, n)


def _replay(n_streams, hw, duration_ms, slot_us, n_classes):
    rng = np.random.default_rng(11)
    n_total = int(duration_ms * 1000 // slot_us)
    records = [frames_to_events(rng.poisson(0.25, (n_total, hw, hw, 2))
                                .astype(np.float32), slot_us)
               for _ in range(n_streams)]
    labels = [int(v) for v in rng.integers(0, n_classes, n_streams)]
    return lambda: _Replay(records, labels, hw, duration_ms, n_classes)


def test_stream_engine_serve_matches_jax(jax_ckpt, port_dep):
    """The whole serve loop (admission into 2 lanes for 3 streams, lane
    recycling, host binning, fold, readout, finalisation) on both."""
    jdep, _ = jax_ckpt
    make = _replay(3, 24, 1000.0, 2500, 11)
    jrep = JaxEngine(jdep, capacity=2).serve(make(), 3, seed=0)
    trep = StreamEngine(port_dep, capacity=2, device="cpu").serve(
        make(), 3, seed=0)
    jres = sorted(jrep.results, key=lambda r: r.stream_id)
    tres = sorted(trep.results, key=lambda r: r.stream_id)
    for fld in ("stream_id", "label", "n_events", "n_readouts",
                "n_coarse_frames", "offered_window", "admitted_window",
                "finished_window"):
        assert [getattr(r, fld) for r in tres] == \
            [getattr(r, fld) for r in jres], fld
    _assert_logits_match(np.array([r.logits for r in tres]),
                         np.array([r.logits for r in jres]))
    jart, tart = jrep.to_artifact(), trep.to_artifact()
    assert tart["registry"]["compat"] == jart["registry"]["compat"]
    assert tart["admission"] == jart["admission"]
    assert tart["deployed"] == json.loads(json.dumps(jart["deployed"]))


def test_launcher_artifact_passes_stats_gate(tmp_path):
    """The port's CLI on the CPU emits a v5 artifact the gate accepts."""
    out = tmp_path / "out"
    env_path = str(ROOT / "src")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--device", "cpu",
         "--config", "reduced", "--duration-ms", "1000", "--streams", "3",
         "--capacity", "2", "--max-pending", "0", "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    art = out / "stream_serving_synthetic-gesture.json"
    gate = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_stream_stats.py"), str(art)],
        capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stderr
    data = json.loads(art.read_text())
    assert data["device"] == "cpu"
    assert data["admission"]["n_shed"] == 1      # 3 offers, 2 lanes, 0 pending


def test_fold_modes_serve_the_same_predictions(port_dep):
    """fold_mode="mac" serves what "deposit" serves (≤ 1e-4 logits)."""
    make = _replay(2, 24, 2000.0, 2500, 11)
    reps = [StreamEngine(port_dep, capacity=2, fold_mode=m, device="cpu")
            .serve(make(), 2) for m in ("deposit", "mac")]
    _assert_logits_match(np.array([r.logits for r in reps[1].results]),
                         np.array([r.logits for r in reps[0].results]))
