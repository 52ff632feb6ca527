"""PyTorch port: the sweep and stream launchers end to end on the CPU —
``launch/sweep.py`` writes the reference CLI's artifact layout, and
``launch/stream.py --smoke`` trains, deploys and serves a checkpoint of
the port's own sweep, which the stats gate passes — and the sweep's
device policy and refusals."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import codesign, sweep
from repro_torch.core.sweep_exec import SweepExecutor, make_executor
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu"}


def _run(args, timeout=600):
    return subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          text=True, cwd=ROOT, timeout=timeout, env=ENV)


def _shape(art: dict) -> dict:
    """The parts of a sweep artifact that are not measured: keys, grid,
    labels, record order and each record's keys and variant."""
    return {"keys": list(art), "grid": art["grid"],
            "protocols": art["protocols"],
            "records": [(list(r), r["protocol"], r["label"], r["t_intg_ms"],
                         r["variant"]) for r in art["records"]],
            "sweep": art["sweep"], "data": art["data"],
            "devices": art["devices"]}


def test_sweep_cli_artifact_matches_reference_cli(tmp_path):
    """``--grid fast --protocol frozen``: the port's artifact has the
    reference CLI's keys, grid, labels, record order and variants."""
    port = _run(["repro_torch.launch.sweep", "--grid", "fast", "--protocol",
                 "frozen", "--device", "cpu", "--out", str(tmp_path / "t")])
    assert port.returncode == 0, port.stderr
    ref = _run(["repro.launch.sweep", "--grid", "fast", "--protocol",
                "frozen", "--out", str(tmp_path / "j")])
    assert ref.returncode == 0, ref.stderr
    t = json.loads((tmp_path / "t" / "codesign_grid_fast.json").read_text())
    j = json.loads((tmp_path / "j" / "codesign_grid_fast.json").read_text())
    assert _shape(t) == _shape(j)
    assert t["grid"]["labels"] == ["a", "b", "c@m=0.06"]
    assert t["schema"] == sweep.SCHEMA_V3 and t["wall_s"] > 0
    assert "[sweep frozen t=10.0ms] sample_batch host" in port.stdout


@pytest.mark.parametrize("argv", [["--t-intg", "3"],
                                  ["--t-intg", "10", "7"]])
def test_sweep_cli_rejects_t_intg_off_the_coarse_window(argv):
    run = _run(["repro_torch.launch.sweep", "--grid", "fast", "--device",
                "cpu"] + argv, timeout=120)
    assert run.returncode == 2
    assert "must divide the backbone coarse window" in run.stderr


def test_stream_cli_smoke_serves_its_own_sweep(tmp_path):
    """``--smoke --dataset synthetic-gesture``: a smoke-scale sweep trains
    and deploys a checkpoint at 100 ms, which is served; the stats gate
    passes the artifact."""
    out = tmp_path / "st"
    run = _run(["repro_torch.launch.stream", "--smoke", "--dataset",
                "synthetic-gesture", "--device", "cpu", "--streams", "2",
                "--capacity", "2", "--out", str(out)])
    assert run.returncode == 0, run.stderr
    art_path = out / "stream_serving_synthetic-gesture.json"
    gate = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_stream_stats.py"),
         "--streams", "2", str(art_path)],
        capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    art = json.loads(art_path.read_text())
    assert art["deployed"]["protocol"] == "frozen"
    assert art["deployed"]["t_intg_ms"] == 100.0
    assert art["n_streams"] == 2 and art["device"] == "cpu"
    sweep_art = json.loads((out / "deploy" / "codesign_grid_deploy.json")
                           .read_text())
    assert sweep_art["schema"] == sweep.SCHEMA_V3
    assert sweep_art["grid"]["t_intg_grid_ms"] == [100.0, 1000.0]
    assert (out / "deploy" / "ckpt_frozen").is_dir()


def test_stream_cli_serves_a_checkpoint_against_its_artifact(tmp_path,
                                                           capsys):
    """--checkpoint with --artifact: the handshake loads and serves; an
    artifact without the record is refused as the reference's launcher
    refuses it: ``error:`` and the reference loader's message, exit 2."""
    from repro_torch.launch import stream as launcher
    from repro_torch.stream import deploy

    bundle = deploy.train_and_deploy(tmp_path / "d", smoke=True,
                                     t_intg_grid_ms=(1000.0,),
                                     circuits=(sweep.CircuitConfig.SWITCH,),
                                     log=lambda *_: None, device="cpu")
    ckpt = str(bundle["checkpoints"]["frozen"])
    assert launcher.main(["--device", "cpu", "--checkpoint", ckpt,
                          "--artifact", str(bundle["artifact"]),
                          "--streams", "1", "--capacity", "1",
                          "--out", str(tmp_path / "o")]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": sweep.SCHEMA_V3, "records": []}))
    capsys.readouterr()
    assert launcher.main(["--device", "cpu", "--checkpoint", ckpt,
                          "--artifact", str(bad),
                          "--out", str(tmp_path / "o")]) == 2
    from repro.stream import deploy as j_deploy
    with pytest.raises(ValueError) as want:
        j_deploy.load_deployment(ckpt, str(bad))
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert err == f"error: {want.value}"
    assert "not found in the sweep" in err


@pytest.mark.parametrize("argv,what", [
    (["--smoke"], None),
    (["--smoke", "--dataset", "nmnist"],
     "T_INTG values [1000.0] do not divide"),
])
def test_stream_cli_smoke_fixture_is_a_later_slice(argv, what, tmp_path,
                                                   monkeypatch, capsys):
    """``--smoke`` on a file-backed dataset writes its fixture to a
    temporary directory and removes it after. dvs128 (the default) trains,
    deploys and serves it, and the stats gate passes the artifact; nmnist's
    300 ms recordings do not hold the smoke grid's 1000 ms point, which the
    launcher refuses as the reference's does: it prints ``error:`` and the
    message and exits 2."""
    from repro_torch.launch import stream as launcher
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr("tempfile.tempdir", str(tmp))
    args = ["--device", "cpu", "--streams", "2", "--capacity", "2",
            "--out", str(tmp_path / "st")] + argv
    if what is not None:
        assert launcher.main(args) == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        assert err.startswith(f"error: {what}")
        assert list(tmp.iterdir()) == []
        return
    assert launcher.main(args) == 0
    assert list(tmp.iterdir()) == []
    art_path = tmp_path / "st" / "stream_serving_dvs128.json"
    gate = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_stream_stats.py"),
         "--streams", "2", str(art_path)],
        capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    art = json.loads(art_path.read_text())
    assert art["data"]["dataset"] == "dvs128"
    assert art["data"]["data_root"].startswith(str(tmp))
    assert (art["data"]["hw"], art["data"]["n_classes"],
            art["data"]["duration_ms"]) == (16, 11, 2000.0)
    assert art["deployed"]["t_intg_ms"] == 100.0
    sweep_art = json.loads((tmp_path / "st" / "deploy" /
                            "codesign_grid_deploy.json").read_text())
    assert sweep_art["data"]["dataset"] == "dvs128"
    assert sweep_art["data"]["eval_split"] == "train"   # 2 recordings


def test_sweep_refuses_what_one_card_cannot_run(tmp_path, capsys):
    """More cards than are visible raise before any compute (the launcher
    prints ``error:`` and exits 2); the dry-run cell sweep names queue 1
    item 2c; the one-device executor names its count, and run_sweep
    refuses more cards before any compute."""
    from repro_torch.launch import sweep as launcher
    more = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match="visible"):
        make_executor(more, device="cuda")
    assert launcher.main(["--grid", "fast", "--devices", str(more),
                          "--device", "cuda", "--out", str(tmp_path)]) == 2
    assert capsys.readouterr().err.startswith("error: sharding")
    assert not list(tmp_path.iterdir())
    with pytest.raises(NotImplementedError, match="queue 1 item 2c"):
        launcher.main(["--dryrun-cells"])
    ex = make_executor(None)
    assert ex == SweepExecutor() == make_executor(1) and ex.devices == 1
    with pytest.raises(ValueError, match=">= 1"):
        make_executor(-1)
    with pytest.raises(ValueError, match="visible"):
        codesign.run_sweep(devices=more, device="cuda")


def test_sweep_entry_points_need_a_gpu_unless_asked(monkeypatch):
    """run_grid, run_protocols and run_sweep resolve to cuda and raise
    without a GPU unless given device="cpu"."""
    from repro_torch.core import codesign
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, model, cfg, grid = sweep.paper_setup(fast=True)
    for fn in (lambda: sweep.run_grid(data, model, cfg, grid),
               lambda: sweep.run_protocols(data, model, cfg, grid),
               lambda: codesign.run_sweep(data, model, cfg),
               lambda: sweep.make_batched_eval(model, (model.p2m.leak,))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_run_sweep_single_circuit_on_cpu():
    """codesign.run_sweep: one record per T_INTG for one circuit, the
    nullified default, with the artifact's record keys."""
    from repro_torch.core import codesign
    data, model, cfg, _ = sweep.paper_setup(fast=True)
    cfg = codesign.SweepConfig(t_intg_grid_ms=(100.0, 1000.0), batch_size=1,
                               pretrain_steps=1, finetune_steps=1,
                               eval_batches=1)
    recs = codesign.run_sweep(data, model, cfg, log=lambda *_: None,
                              device="cpu")
    assert [(r["label"], r["t_intg_ms"]) for r in recs] == \
        [("c@m=0.06", 100.0), ("c@m=0.06", 1000.0)]
    assert recs[1]["bandwidth_norm"] == 1.0
