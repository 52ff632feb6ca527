"""PyTorch port: package boundaries, device policy, checkpoints, and the
host-side serving pieces (own copies of the JAX package's jax-free
modules)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import binning as j_binning
from repro.stream import deploy as j_deploy
from repro_torch.configs import p2m_dvs
from repro_torch.data import binning, sources
from repro_torch.serve.slots import ShardedSlots
from repro_torch.stream import accumulator, deploy
from repro_torch.stream.engine import StreamEngine, stream_generator

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(" ".join(names))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port loads without jax or the JAX package, the
    LM training slice's among them."""
    run = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stdout + run.stderr
    names = set(run.stdout.splitlines()[0].split())
    assert len(names) >= 20
    assert {f"repro_torch.{m}" for m in (
        "train.steps", "train.loop", "data.tokens", "ft.monitor",
        "checkpoint.store", "launch.train")} <= names


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro"), line


def test_kernel_library_digest_covers_shared_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header, as to the source itself, names a new
    library, so a stale build is never reused; an unrelated file does not."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    assert first.name.startswith("libk-") and first.suffix == ".so"
    (tmp_path / "notes.txt").write_text("not a header")
    assert _build.lib_path("k") == first
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _build.lib_path("k")
    assert second != first
    (tmp_path / "extra.cuh").write_text("// new header\n")
    assert _build.lib_path("k") not in (first, second)
    (tmp_path / "extra.cuh").unlink()
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n// edited\n')
    assert _build.lib_path("k") not in (first, second)
    assert _build.sources() == ["k"]


def _small_dep(device="cpu", seed=0):
    cfg, _ = p2m_dvs.reduced(hw=8, channels=(4, 8), fc=16)
    return deploy.fresh_deployment(cfg, seed=seed, device=device)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "resolve_device", "fresh_deployment", "load_deployment",
    "params_from_jax", "make_stream_fns", "StreamEngine", "launcher",
    "make_eval_fn"])
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(entry, no_gpu,
                                                          tmp_path):
    """Without a GPU every entry point raises unless given device="cpu"."""
    from repro_torch.core import codesign
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch import stream as launcher
    dep = _small_dep()
    deploy.save_deployment(tmp_path / "ckpt", dep)
    tree = {"params": dep.params, "bn_state": dep.bn_state}
    calls = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "fresh_deployment": lambda **kw: deploy.fresh_deployment(
            dep.model_cfg, **kw),
        "load_deployment": lambda **kw: deploy.load_deployment(
            tmp_path / "ckpt", **kw),
        "params_from_jax": lambda **kw: deploy.params_from_jax(tree, **kw),
        "make_stream_fns": lambda **kw: accumulator.make_stream_fns(
            dep, capacity=1, chunk_slots=1, **kw),
        "StreamEngine": lambda **kw: StreamEngine(dep, capacity=1, **kw),
        "launcher": lambda **kw: launcher.main(
            ["--config", "reduced", "--streams", "1", "--capacity", "1",
             "--out", str(tmp_path / "out")]
            + (["--device", kw["device"]] if kw else [])
            + ["--duration-ms", "1000"]),
        "make_eval_fn": lambda **kw: codesign.make_eval_fn(dep.model_cfg,
                                                           **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    if entry != "launcher":      # the CPU route is exercised end to end
        calls[entry](device="cpu")  # in test_torch_stream.py


@pytest.mark.parametrize("kwargs,what", [
    ({"adapt": "surrogate", "fold_mode": "mac"}, "adaptation"),
    ({"executor": 2}, "sharding"),
])
def test_engine_refuses_later_slices(kwargs, what):
    """Registry, adaptation and the lane executor are ported; what stays
    refused (ValueError): a lane mesh on cards the engine does not run on
    (an executor never falls back to another device), and adaptation
    through a streaming-fold kernel, which cannot adapt."""
    from repro_torch.stream.adapt import AdaptConfig
    from repro_torch.stream.shard import LaneExecutor
    with pytest.raises(ValueError, match=what):
        kw = {"executor": LaneExecutor(devices=kwargs["executor"],
                                       device="cuda")} \
            if "executor" in kwargs else \
            {"adapt": AdaptConfig(rule=kwargs["adapt"]),
             "fold_mode": kwargs["fold_mode"]}
        StreamEngine(_small_dep(), capacity=1, device="cpu", **kw)


def test_engine_refuses_a_registry():
    """An empty registry cannot anchor an engine."""
    from repro_torch.stream.registry import Registry
    with pytest.raises(ValueError, match="registry is empty"):
        StreamEngine(Registry(), capacity=1, device="cpu")


@pytest.mark.parametrize("argv", [["--registry", "a", "--checkpoint", "b"],
                                  ["--adapt-export", "d"],
                                  ["--devices", "2"], ["--smoke"],
                                  ["--dataset", "dvs128"]])
def test_launcher_refuses_later_slices(argv, tmp_path, capsys):
    """Misuse of the registry and adaptation flags, a file-backed dataset
    with no --data-root outside --smoke, and more --devices than there are
    visible cards exit 2 with ``error:`` before anything is built;
    ``--smoke`` (with --config reduced, which --smoke overrides as in the
    reference) trains on its dvs128 fixture and serves."""
    from repro_torch.launch import stream as launcher
    args = ["--device", "cpu", "--config", "reduced",
            "--out", str(tmp_path)] + argv
    if argv[0] == "--devices":
        more = str(torch.cuda.device_count() + int(argv[1]))
        assert launcher.main(args[:-1] + [more, "--device", "cuda"]) == 2
        assert capsys.readouterr().err.startswith("error: sharding")
        assert not list(tmp_path.iterdir())
        return
    if argv[0] in ("--registry", "--adapt-export", "--dataset"):
        assert launcher.main(args) == 2
        err = capsys.readouterr().err
        assert "error:" in err
        if argv[0] == "--dataset":
            assert "file-backed" in err and not list(tmp_path.iterdir())
        return
    if argv == ["--smoke"]:
        assert launcher.main(args + ["--streams", "2",
                                     "--capacity", "2"]) == 0
        art = json.loads((tmp_path / "stream_serving_dvs128.json")
                         .read_text())
        assert art["n_streams"] == 2 and art["data"]["dataset"] == "dvs128"


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """The port writes the reference's format: the JAX package loads a
    port-written deployment with the same config and weights."""
    dep = _small_dep(seed=5)
    deploy.save_deployment(tmp_path, dep)
    jdep = j_deploy.load_deployment(tmp_path)
    assert (j_deploy.model_config_to_dict(jdep.model_cfg)
            == deploy.model_config_to_dict(dep.model_cfg))
    np.testing.assert_array_equal(np.asarray(jdep.params["p2m"]["w"]),
                                  dep.params["p2m"]["w"].numpy())
    back = deploy.load_deployment(tmp_path, device="cpu")
    for k in ("w", "pv_gain", "pv_offset"):
        torch.testing.assert_close(back.params["p2m"][k], dep.params["p2m"][k],
                                   rtol=0, atol=0)
    assert back.record == dep.record


def test_fresh_deployment_record_matches_reference_labels():
    """The record of a fresh deployment carries the reference's label and
    variant dict for the same config."""
    from repro.configs import p2m_dvs as j_configs
    jdep = j_deploy.fresh_deployment(j_configs.CONFIG, seed=0)
    dep = deploy.fresh_deployment(p2m_dvs.CONFIG, seed=0, device="cpu")
    assert dep.record == jdep.record
    from repro.stream import registry as j_registry
    from repro_torch.stream.registry import compat_digest, compat_key
    assert compat_digest(compat_key(dep)) == \
        j_registry.compat_digest(j_registry.compat_key(jdep))


def test_load_deployment_rejects_foreign_checkpoints(tmp_path):
    from repro_torch.checkpoint import store
    store.save_checkpoint(tmp_path, 0, {"w": np.zeros(3)}, {"other": 1})
    with pytest.raises(ValueError, match="not a streaming deployment"):
        deploy.load_deployment(tmp_path, device="cpu")


def test_binning_copies_match_the_reference():
    rng = np.random.default_rng(0)
    frames = rng.poisson(0.8, (6, 10, 10, 2)).astype(np.float32)
    ev = binning.frames_to_events(frames, 2500)
    jev = j_binning.frames_to_events(frames, 2500)
    for f in ("t", "x", "y", "p"):
        np.testing.assert_array_equal(getattr(ev, f), getattr(jev, f))
    kw = dict(n_total=6, slot_us=2500, sensor_hw=(10, 10), out_hw=(5, 5))
    np.testing.assert_array_equal(binning.bin_chunks([ev], **kw),
                                  j_binning.bin_chunks([jev], **kw))
    assert binning.slot_us_for(10.0, 4) == j_binning.slot_us_for(10.0, 4)


def test_synthetic_replay_rebins_to_its_frames():
    """A synthetic stream replays whole: events spread over the full
    duration, one chunk per sub-slot, deterministic per (seed, stream)."""
    src = sources.resolve_dataset("synthetic-gesture", hw=16,
                                  duration_ms=200.0)
    label, chunks = src.iter_event_chunks(stream_generator(0, 3),
                                          chunk_us=2500, slot_us=2500)
    chunks = list(chunks)
    assert len(chunks) == 80 and 0 <= label < src.n_classes
    assert sum(len(c) for c in chunks) > 0
    label2, again = src.iter_event_chunks(stream_generator(0, 3),
                                          chunk_us=2500, slot_us=2500)
    assert label2 == label
    assert [len(c) for c in again] == [len(c) for c in chunks]
    for i, c in enumerate(chunks):
        assert ((c.t >= i * 2500) & (c.t < (i + 1) * 2500)).all()


def test_sharded_slots_admit_release_order():
    slots = ShardedSlots(3)
    assert [slots.admit(x) for x in "abc"] == [0, 1, 2]
    assert slots.admit("d") is None and slots.is_full()
    assert slots.release(1) == "b"
    assert slots.admit("e") == 1
    assert slots.active_mask() == [True, True, True]
    assert [i for i, _ in slots.occupied()] == [0, 1, 2]
    with pytest.raises(ValueError):
        slots.release(5)


class _Failing:
    """A source whose every stream raises on its third chunk."""

    def __init__(self):
        self.name, self.height, self.width = "failing", 8, 8
        self.sensor_hw, self.n_classes, self.duration_ms = (8, 8), 11, 1000.0

    def n_slots(self, t_intg_ms):
        return int(round(self.duration_ms / t_intg_ms))

    def iter_event_chunks(self, gen, *, chunk_us, slot_us=None):
        from repro_torch.data.formats import concat_chunks

        def chunks():
            for i in range(2):
                yield concat_chunks([])
            raise OSError("sensor link lost")
        return 0, chunks()


@pytest.mark.parametrize("prefetch", [True, False])
def test_serve_failure_joins_bin_workers(prefetch):
    """A failing replay surfaces at serve() and leaves no worker thread."""
    import threading
    engine = StreamEngine(_small_dep(), capacity=2, bin_workers=2,
                          prefetch=prefetch, device="cpu")
    with pytest.raises(OSError, match="sensor link lost"):
        engine.serve(_Failing(), 3)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("stream-bin-worker")]
