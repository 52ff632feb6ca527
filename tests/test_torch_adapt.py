"""PyTorch port: per-lane online adaptation and its delta checkpoints
against the JAX package, on the CPU at ``reduced()``.

Deployments written by the JAX package (circuits a and c, fresh seeded
weights, backbone awake) are served by both packages from the same
numpy-seeded event records. ``reduced()`` keeps its widths; its coarse
window is cut from 1000 to 100 ms, so a 1000 ms stream crosses 10 labeled
coarse boundaries (10 updates) instead of 1. Held to:

- one readout's per-lane gradients ``(g_w, g_theta)`` within 1e-5 of the
  largest element of the reference's ``vgrad``;
- a served run under each rule: ``n_updates`` equal, ``dw``/``dtheta``
  within 1e-5 of their largest element (2.8e-7–5.4e-7 measured), logits
  within 1e-4, predictions equal;
- inside the port: lr 0 and unlabeled streams bit-identical to frozen
  serving, lane isolation, delta checkpoints crossing the packages in both
  directions with equal ``deployment_digest``.
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
from repro.stream import adapt as j_adapt
from repro.stream import deploy as j_deploy
from repro.stream.engine import StreamEngine as JaxEngine
from repro_torch.checkpoint import store
from repro_torch.core import p2m_layer
from repro_torch.stream import deploy
from repro_torch.stream.adapt import AdaptConfig, make_adapt_fns
from repro_torch.stream.engine import StreamEngine
from repro_torch.stream.registry import Registry, compat_key
from stream_replay import (assert_logits_close, by_stream, jax_deployment,
                           replay_factory)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
HW, N_CLASSES, SLOT_US, DURATION = 24, 11, 2500, 1000.0
GRAD_RTOL = 1e-5       # per-lane gradients, of the largest element
DELTA_RTOL = 1e-5      # served dw / dtheta, of the largest element
CIRCUITS = {"a": dict(circuit=j_deploy.CircuitConfig.BASIC),
            "c": dict(circuit=j_deploy.CircuitConfig.NULLIFIED)}


def _cfg():
    cfg, _ = j_configs.reduced()
    return dataclasses.replace(cfg, coarse_window_ms=100.0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{circuit: (JAX deployment, the port's load of its checkpoint)}."""
    out = {}
    for seed, (name, leak) in enumerate(CIRCUITS.items()):
        jd = jax_deployment(j_deploy, _cfg(), 3 + seed, **leak)
        path = tmp_path_factory.mktemp(f"jax_{name}")
        j_deploy.save_deployment(path, jd)
        out[name] = (jd, deploy.load_deployment(path, device="cpu"))
    return out


@pytest.fixture(scope="module")
def make_src():
    return replay_factory(6, HW, DURATION, SLOT_US, N_CLASSES)


def _state(eng):
    return {k: v.numpy() for k, v in eng.adapt_state.items()}


def _close(got, want, rtol, what):
    scale = float(np.abs(want).max())
    assert scale > 0, f"{what}: vacuous, all zero"
    diff = float(np.abs(got - want).max())
    assert diff <= rtol * scale, f"{what}: {diff} > {rtol} x {scale}"


# ---------------------------------------------------------------------------
# config and kernel guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    ({"rule": "hebbian-ish"}, "rule"),
    ({"lr_w": -1e-3}, "learning rates"),
    ({"lr_theta": -1.0}, "learning rates"),
    ({"clip_w": 0.0}, "clips"),
    ({"clip_theta": -1.0}, "clips"),
])
def test_adapt_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        AdaptConfig(**kw)


@pytest.mark.parametrize("mode", ["deposit", "mac"])
def test_kernel_fold_modes_refuse_adaptation(pair, mode):
    """Adaptation runs its own per-lane fold: asking for K2 or K3 with it
    raises at construction; without adapt the kernel modes serve."""
    dep = pair["c"][1]
    with pytest.raises(ValueError, match="fold_mode"):
        make_adapt_fns(dep, capacity=2, chunk_slots=1, adapt=AdaptConfig(),
                       fold_mode=mode, device="cpu")
    with pytest.raises(ValueError, match="fold_mode"):
        StreamEngine(dep, capacity=2, fold_mode=mode, adapt=AdaptConfig(),
                     device="cpu")
    assert StreamEngine(dep, capacity=2, fold_mode=mode,
                        device="cpu").adapt is None
    assert StreamEngine(dep, capacity=2, adapt=AdaptConfig(),
                        device="cpu").fold_mode is None


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("rule", ["surrogate", "reward"])
def test_readout_gradients_match_the_reference(pair, circuit, rule):
    """Three windows folded one sub-slot at a time into both packages'
    adapting steps, the third read out at a labeled coarse boundary with
    lr 1 and no clip, so each lane's new deltas are minus its gradients."""
    jdep, dep = pair[circuit]
    cap = 4
    kw = dict(rule=rule, lr_w=1.0, lr_theta=1.0, clip_w=1e9, clip_theta=1e9)
    jf = j_adapt.make_adapt_fns(jdep, capacity=cap, chunk_slots=1,
                                adapt=j_adapt.AdaptConfig(**kw))
    tf = make_adapt_fns(dep, capacity=cap, chunk_slots=1,
                        adapt=AdaptConfig(**kw), device="cpu")
    rng = np.random.default_rng(0)
    js, jas = jf.init_state(), jf.init_adapt()
    ts, tas = tf.init_state(), tf.init_adapt()
    act = np.ones(cap, bool)
    labels = rng.integers(0, N_CLASSES, cap).astype(np.int32)
    for window in range(3):
        for _ in range(dep.model_cfg.p2m.n_sub):
            fr = rng.poisson(0.3, (cap, 1, HW, HW, 2)).astype(np.float32)
            js, jas = jf.fold(js, jas, jnp.asarray(fr), jnp.asarray(act))
            ts, tas = tf.fold(ts, tas, torch.from_numpy(fr), act)
        np.testing.assert_allclose(tas["ev"].numpy(), np.asarray(jas["ev"]),
                                   rtol=0, atol=1e-6)
        lab = labels if window == 2 else np.full(cap, -1, np.int32)
        js, jas, _ = jf.readout(js, jas, jnp.asarray(act), jnp.asarray(act),
                                jnp.asarray(lab))
        ts, tas, _ = tf.readout(ts, tas, act, act, lab)
    assert (tas["n_updates"].numpy() == np.asarray(jas["n_updates"])).all()
    _close(-tas["dw"].numpy(), -np.asarray(jas["dw"]), GRAD_RTOL, "g_w")
    _close(-tas["dtheta"].numpy(), -np.asarray(jas["dtheta"]), GRAD_RTOL,
           "g_theta")
    if rule == "reward":
        _close(tas["elig_w"].numpy(), np.asarray(jas["elig_w"]), GRAD_RTOL,
               "elig_w")


@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("rule", ["surrogate", "reward"])
def test_served_run_matches_the_reference(pair, make_src, circuit, rule):
    """6 labeled streams on 3 lanes (lanes recycle, so deltas carry across
    streams), each package's engine: equal update counts, deltas within
    DELTA_RTOL, logits within 1e-4, predictions equal."""
    jdep, dep = pair[circuit]
    kw = dict(rule=rule, lr_w=0.5, lr_theta=0.01)
    jeng = JaxEngine(jdep, capacity=3, adapt=j_adapt.AdaptConfig(**kw))
    jrep = jeng.serve(make_src(), 6)
    teng = StreamEngine(dep, capacity=3, adapt=AdaptConfig(**kw),
                        device="cpu")
    trep = teng.serve(make_src(), 6)
    jst, tst = jax.device_get(jeng.adapt_state), _state(teng)
    np.testing.assert_array_equal(tst["n_updates"], jst["n_updates"])
    assert tst["n_updates"].min() > 0
    _close(tst["dw"], np.asarray(jst["dw"]), DELTA_RTOL, "dw")
    _close(tst["dtheta"], np.asarray(jst["dtheta"]), DELTA_RTOL, "dtheta")
    got, want = by_stream(trep), by_stream(jrep)
    assert [got[s].prediction for s in sorted(want)] == \
        [want[s].prediction for s in sorted(want)]
    assert_logits_close([got[s].logits for s in sorted(want)],
                        [want[s].logits for s in sorted(want)])
    ad, jad = trep.to_artifact()["adaptation"], jrep.to_artifact()[
        "adaptation"]
    assert ad["n_updates"] == jad["n_updates"]
    assert [r["lane"] for r in ad["lanes"]] == [r["lane"]
                                                for r in jad["lanes"]]


# ---------------------------------------------------------------------------
# inside the port: adaptation-off parity and lane isolation
# ---------------------------------------------------------------------------

def _assert_bitexact(ref, got):
    a, b = by_stream(ref), by_stream(got)
    assert sorted(a) == sorted(b)
    for sid in a:
        assert a[sid].prediction == b[sid].prediction
        assert a[sid].n_events == b[sid].n_events
        np.testing.assert_array_equal(a[sid].logits, b[sid].logits)
    assert ref.total_layer1_spikes == got.total_layer1_spikes


@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("kw, labeled", [
    (dict(lr_w=0.0, lr_theta=0.0), None),      # updates fire, deltas stay 0
    (dict(lr_w=0.5, lr_theta=1e-3), ()),       # no label, no update
])
def test_adaptation_off_is_bit_identical_to_frozen(pair, make_src, circuit,
                                                   kw, labeled):
    dep = pair[circuit][1]
    frozen = StreamEngine(dep, capacity=3, device="cpu").serve(
        make_src(labeled), 6)
    eng = StreamEngine(dep, capacity=3, adapt=AdaptConfig(**kw),
                       device="cpu")
    _assert_bitexact(frozen, eng.serve(make_src(labeled), 6))
    st = _state(eng)
    np.testing.assert_array_equal(st["dw"], 0.0)
    np.testing.assert_array_equal(st["dtheta"], 0.0)
    assert (st["n_updates"].sum() > 0) == (labeled is None)


@pytest.mark.parametrize("rule, labeled", [("surrogate", (0, 2)),
                                           ("reward", (1,))])
def test_updates_never_perturb_other_lanes(pair, make_src, rule, labeled):
    """4 streams on 4 lanes (stream i on lane i), labels only on some: the
    other lanes keep exactly-zero deltas and their logits stay bit-equal to
    the frozen serve while their neighbours learn."""
    dep = pair["c"][1]
    frozen = by_stream(StreamEngine(dep, capacity=4, device="cpu").serve(
        make_src(labeled), 4))
    eng = StreamEngine(dep, capacity=4, device="cpu",
                       adapt=AdaptConfig(rule=rule, lr_w=0.5))
    rep = by_stream(eng.serve(make_src(labeled), 4))
    st = _state(eng)
    for lane in range(4):
        if lane in labeled:
            assert st["n_updates"][lane] > 0
            assert np.linalg.norm(st["dw"][lane]) > 0
        else:
            assert st["n_updates"][lane] == 0
            np.testing.assert_array_equal(st["dw"][lane], 0.0)
            np.testing.assert_array_equal(rep[lane].logits,
                                          frozen[lane].logits)


def test_rebind_resets_deltas_and_turnover_keeps_them(pair, make_src):
    """On a registry engine a lane keeps its deltas across streams of one
    entry (transient reset) and loses them when it rebinds to another."""
    dep = pair["c"][1]
    reg = Registry()
    reg.register("c", dep)
    reg.register("c2", dataclasses.replace(dep, record={
        **dep.record, "label": "c2"}))
    eng = StreamEngine(reg, capacity=1, adapt=AdaptConfig(lr_w=0.5),
                       device="cpu")
    eng.serve(make_src(), 2, variants=["c", "c"])
    assert int(eng.adapt_state["n_updates"][0]) == 20
    eng.serve(make_src(), 1, variants=["c"])
    assert int(eng.adapt_state["n_updates"][0]) == 30
    eng.serve(make_src(), 1, variants=["c2"])
    assert int(eng.adapt_state["n_updates"][0]) == 10
    assert eng.harvest(0)["base_name"] == "c2"


# ---------------------------------------------------------------------------
# delta checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adapted(pair, make_src):
    """Both packages' adapted engines on the same streams (circuit c)."""
    jdep, dep = pair["c"]
    kw = dict(rule="surrogate", lr_w=0.5, lr_theta=0.01)
    jeng = JaxEngine(jdep, capacity=2, adapt=j_adapt.AdaptConfig(**kw))
    jeng.serve(make_src(), 4)
    teng = StreamEngine(dep, capacity=2, adapt=AdaptConfig(**kw),
                        device="cpu")
    teng.serve(make_src(), 4)
    return jeng, teng


def test_digest_equals_the_reference(pair):
    for jdep, dep in pair.values():
        assert deploy.deployment_digest(dep) == \
            j_deploy.deployment_digest(jdep)


@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_delta_crosses_the_packages(pair, adapted, make_src, tmp_path,
                                    saved_by):
    """harvest → save in one package → load, apply and serve in the other;
    the applied deployments' weights and thresholds equal in both, their
    serves within 1e-4."""
    jdep, dep = pair["c"]
    jeng, teng = adapted
    if saved_by == "jax":
        h = jeng.harvest(0)
        j_deploy.save_adapt_delta(tmp_path, h["base"], dw=h["dw"],
                                  dtheta=h["dtheta"], lane=0,
                                  n_updates=h["n_updates"],
                                  meta={"why": "test"})
    else:
        h = teng.harvest(0)
        deploy.save_adapt_delta(tmp_path, h["base"], dw=h["dw"],
                                dtheta=h["dtheta"], lane=0,
                                n_updates=h["n_updates"],
                                meta={"why": "test"})
    assert h["n_updates"] > 0 and np.linalg.norm(h["dw"]) > 0
    tdelta = deploy.load_adapt_delta(tmp_path, dep, expect_uid=0)
    jdelta = j_deploy.load_adapt_delta(tmp_path, jdep, expect_uid=0)
    assert tdelta["meta"] == jdelta["meta"] == {"why": "test"}
    np.testing.assert_array_equal(tdelta["dw"], jdelta["dw"])
    tnew = deploy.apply_adapt_delta(dep, tdelta)
    jnew = j_deploy.apply_adapt_delta(jdep, jdelta)
    np.testing.assert_array_equal(tnew.params["p2m"]["w"].numpy(),
                                  np.asarray(jnew.params["p2m"]["w"]))
    assert tnew.coeffs.v_threshold == jnew.coeffs.v_threshold
    assert tnew.record == json.loads(json.dumps(jnew.record, default=float))
    assert deploy.deployment_digest(tnew) == j_deploy.deployment_digest(jnew)
    # the quantized weights the adapted lane served
    np.testing.assert_array_equal(
        p2m_layer.effective_weights(tnew.params["p2m"],
                                    tnew.model_cfg.p2m).numpy(),
        p2m_layer.effective_weights(
            {"w": torch.from_numpy(deploy.host_effective_weights(dep)
                                   + h["dw"])}, dep.model_cfg.p2m).numpy())
    assert compat_key(tnew) == compat_key(dep)
    reg = Registry()
    reg.register("base", dep)
    entry = reg.register("base+adapt", tnew)
    rep = StreamEngine(reg, capacity=2, default_entry="base+adapt",
                       device="cpu").serve(make_src(), 2)
    assert all(r.entry == "base+adapt" and r.entry_uid == entry.uid
               for r in rep.results)
    jrep = JaxEngine(jnew, capacity=2).serve(make_src(), 2)
    assert_logits_close([r.logits for r in rep.results],
                        [r.logits for r in jrep.results])


def test_zero_delta_is_identity(pair, tmp_path):
    dep = pair["c"][1]
    w = deploy.host_effective_weights(dep)
    deploy.save_adapt_delta(tmp_path, dep, dw=np.zeros_like(w), dtheta=0.0)
    same = deploy.apply_adapt_delta(dep, deploy.load_adapt_delta(tmp_path,
                                                                 dep))
    np.testing.assert_array_equal(
        p2m_layer.effective_weights(same.params["p2m"],
                                    same.model_cfg.p2m).numpy(), w)
    assert same.coeffs.v_threshold == dep.coeffs.v_threshold


@pytest.mark.parametrize("case, match", [
    ("wrong_base", "digests to"),
    ("stale_uid", "hot-swapped"),
    ("no_digest", "corrupt"),
    ("schema", "not an adaptation delta"),
    ("plain_ckpt", "not an adaptation delta"),
    ("dw_shape_save", "shape"),
    ("dw_shape_load", "shape"),
])
def test_delta_rejections(pair, tmp_path, case, match):
    """The digest, uid, stamp, schema and shape guards."""
    dep, other = pair["c"][1], pair["a"][1]
    w = deploy.host_effective_weights(dep)
    if case == "dw_shape_save":
        with pytest.raises(ValueError, match=match):
            deploy.save_adapt_delta(tmp_path, dep, dw=np.zeros((2, 2)),
                                    dtheta=0.0)
        return
    if case == "plain_ckpt":
        store.save_checkpoint(tmp_path, 0, {"dw": np.zeros(3)},
                              {"schema": "something-else"})
    else:
        ckpt = deploy.save_adapt_delta(tmp_path, dep, dw=np.zeros_like(w),
                                       dtheta=0.0, base_uid=3)
        assert deploy.load_adapt_delta(tmp_path, dep,
                                       expect_uid=3)["base_uid"] == 3
        index = ckpt / "index.json"
        meta = json.loads(index.read_text())
        if case == "no_digest":
            del meta["extra"]["base"]["digest"]
        elif case == "schema":
            meta["extra"]["delta_schema"] = "p2m-deploy/v1"
        elif case == "dw_shape_load":
            # a stamp valid for dep on a dw of the wrong shape
            store.save_checkpoint(tmp_path, 0, {"dw": np.zeros((2, 2)),
                                                "dtheta": np.float32(0)},
                                  meta["extra"])
            meta = json.loads(index.read_text())
        index.write_text(json.dumps(meta))
    base = other if case == "wrong_base" else dep
    with pytest.raises(ValueError, match=match):
        deploy.load_adapt_delta(tmp_path, base,
                                expect_uid=7 if case == "stale_uid" else None)


def test_harvest_validation(pair, adapted):
    dep = pair["c"][1]
    eng = StreamEngine(dep, capacity=2, device="cpu")
    with pytest.raises(ValueError, match="without adapt"):
        eng.harvest(0)
    with pytest.raises(ValueError, match="out of range"):
        adapted[1].harvest(99)
    fresh = StreamEngine(dep, capacity=2, adapt=AdaptConfig(), device="cpu")
    with pytest.raises(ValueError, match="never served"):
        fresh.harvest(0)


# ---------------------------------------------------------------------------
# the launcher's artifacts through the stats gate
# ---------------------------------------------------------------------------

def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.stream",
                           "--device", "cpu"] + args, capture_output=True,
                          text=True, cwd=cwd, timeout=600,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})


def _gate(path, *extra):
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_stream_stats.py"),
         str(path), *extra], capture_output=True, text=True, timeout=60)


def test_launcher_adapt_export_and_registry(pair, tmp_path):
    """``--adapt --adapt-export`` serves, exports each adapted lane as a
    delta checkpoint that loads against its base, and ``--registry`` serves
    the base and a second checkpoint; both artifacts pass the gate."""
    ckpts = []
    for name in CIRCUITS:
        ckpts.append(tmp_path / f"ckpt_{name}")
        deploy.save_deployment(ckpts[-1], pair[name][1])
    out, exp = tmp_path / "adapt", tmp_path / "deltas"
    run = _run(["--checkpoint", str(ckpts[1]), "--duration-ms", "1000",
                "--streams", "2", "--capacity", "2", "--adapt",
                "--adapt-lr", "0.5", "--adapt-export", str(exp),
                "--out", str(out)], ROOT)
    assert run.returncode == 0, run.stderr
    art = out / "stream_serving_synthetic-gesture.json"
    gate = _gate(art, "--streams", "2")
    assert gate.returncode == 0, gate.stdout + gate.stderr
    assert "adapting (surrogate)" in gate.stdout
    ad = json.loads(art.read_text())["adaptation"]
    assert ad["enabled"] and ad["n_updates"] > 0
    for row in ad["lanes"]:
        delta = deploy.load_adapt_delta(exp / f"lane{row['lane']}",
                                        pair["c"][1])
        assert delta["n_updates"] == row["n_updates"]

    out = tmp_path / "registry"
    run = _run(["--registry", *map(str, ckpts), "--variants", "ckpt_c",
                "circuit=a", "nope", "--duration-ms", "1000", "--streams",
                "3", "--capacity", "2", "--out", str(out)], ROOT)
    assert run.returncode == 0, run.stderr
    art = out / "stream_serving_synthetic-gesture.json"
    gate = _gate(art)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    data = json.loads(art.read_text())
    assert data["admission"]["n_rejected"] == 1
    assert {r["name"] for r in data["registry"]["entries"]} == {"ckpt_a",
                                                                "ckpt_c"}


@pytest.mark.parametrize("argv, match", [
    (["--registry", "x", "--checkpoint", "y"], "mutually exclusive"),
    (["--variants", "a"], "requires --registry"),
    (["--adapt-export", "d"], "requires --adapt"),
    (["--adapt", "--fold-mode", "mac"], "fold_mode"),
])
def test_launcher_refusals(argv, match, tmp_path, capsys):
    """Flag misuse exits 2 with the reference's messages before anything
    is built; a kernel fold mode with --adapt exits 2 on the engine's
    guard (``error:``), as the reference's launcher does on a
    ValueError."""
    from repro_torch.launch import stream as launcher
    args = ["--device", "cpu", "--config", "reduced", "--out",
            str(tmp_path)] + argv
    assert launcher.main(args) == 2
    assert match in capsys.readouterr().err
