"""PyTorch port, LM training slice around the step: the token stream, the
checkpoint manager (its contract, and checkpoints crossing between the
packages), the fault-tolerance monitors, the restartable loop and
``launch/train.py``, on the CPU. The contracts are the reference's
``tests/test_runtime.py`` cases; the reference's own loop is not run
(its step rejects its own outputs from the second call on this JAX), so
the loop's restart is held within the port."""
from __future__ import annotations

import dataclasses
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import lm as j_lm
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import (TokenLoader, TokenStreamConfig,
                                     host_slice, sample_batch)
from repro_torch.ft import HeartbeatTracker, PreemptionGuard, StragglerMonitor
from repro_torch.launch import train as launcher
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import loop as loop_mod
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.steps import build_train_step
from repro_torch.utils import tree_paths
from torch_threads import one_torch_thread  # noqa: F401



# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------

def _tcfg():
    return TokenStreamConfig(vocab_size=128, seq_len=32, global_batch=4)


def test_tokens_are_deterministic_in_the_step():
    cfg = _tcfg()
    b1, b2, b3 = (sample_batch(cfg, s) for s in (5, 5, 6))
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].dtype == torch.int64 and b1["tokens"].device.type \
        == "cpu"
    assert 0 <= int(b1["tokens"].min()) and int(b1["tokens"].max()) < 128
    other = sample_batch(dataclasses.replace(cfg, seed=1), 5)
    assert not torch.equal(b1["tokens"], other["tokens"])


def test_labels_are_the_shifted_tokens():
    b = sample_batch(_tcfg(), 0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])


def test_seek_skips_ahead():
    cfg = _tcfg()
    l1 = TokenLoader(cfg)
    for _ in range(3):
        next(l1)
    s1, b1 = next(l1)
    l2 = TokenLoader(cfg)
    l2.seek(3)
    s2, b2 = next(l2)
    assert s1 == s2 == 3 and l2.step == 4
    assert torch.equal(b1["tokens"], b2["tokens"])


def test_the_stream_has_learnable_structure():
    """The reference's statistic: H(next | prev) < H(next) − 0.05 bits."""
    cfg = TokenStreamConfig(vocab_size=16, seq_len=512, global_batch=8,
                            markov_temp=0.4, n_states=8)
    toks = sample_batch(cfg, 0)["tokens"].numpy()
    uni = np.bincount(toks.reshape(-1), minlength=16).astype(float) + 1e-9
    p_uni = uni / uni.sum()
    h_uni = -(p_uni * np.log2(p_uni)).sum()
    big = np.zeros((16, 16)) + 1e-9
    for row in toks:
        np.add.at(big, (row[:-1], row[1:]), 1.0)
    p_j = big / big.sum()
    p_prev = p_j.sum(1, keepdims=True)
    h_cond = -(p_j * np.log2(p_j / p_prev)).sum()
    assert h_cond < h_uni - 0.05


def test_host_slice():
    b = sample_batch(_tcfg(), 0)
    s0, s1 = host_slice(b, 0, 2), host_slice(b, 1, 2)
    assert s0["tokens"].shape[0] == 2
    assert torch.equal(torch.cat([s0["tokens"], s1["tokens"]]), b["tokens"])
    assert host_slice(b, 0, 1) is b


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(scale=1.0):
    return {"a": {"w": torch.full((4, 4), scale), "b": torch.arange(3.0)},
            "step_arr": torch.ones(2) * scale}


def test_checkpoint_roundtrip(tmp_path):
    save_checkpoint(tmp_path, 7, _tree(2.0), extra={"step": 7})
    got, extra = load_checkpoint(tmp_path)
    assert extra["step"] == 7
    np.testing.assert_array_equal(got["a"]["w"], _tree(2.0)["a"]["w"])


def test_atomic_commit_ignores_uncommitted(tmp_path):
    save_checkpoint(tmp_path, 5, _tree())
    bad = tmp_path / "step_000000009"
    bad.mkdir()
    (bad / "index.json").write_text("{}")
    assert latest_step(tmp_path) == 5


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, every_steps=1, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003", "step_000000004"]
    assert latest_step(tmp_path) == 4 and mgr.last_saved == 4
    assert [mgr.should_save(s) for s in (0, 1)] == [False, True]


def test_async_save_snapshots_before_returning(tmp_path):
    """An async save copies the tree to the host before it returns: a
    donated step may write the same tensors in place at once."""
    mgr = CheckpointManager(tmp_path, every_steps=1, keep=5)
    tree = _tree(1.0)
    mgr.save(1, tree, blocking=False)
    tree["step_arr"].fill_(9.0)
    tree["a"]["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore()
    np.testing.assert_array_equal(got["step_arr"], [1.0, 1.0])
    np.testing.assert_array_equal(got["a"]["w"], np.ones((4, 4)))


def test_async_writer_error_surfaces(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    mgr = CheckpointManager(tmp_path / "file" / "ck")
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                       # reported once


def test_restore_onto_a_device(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(3.0))
    got, _ = mgr.restore(device="cpu")
    assert isinstance(got["a"]["w"], torch.Tensor)
    assert got["a"]["w"].device.type == "cpu"
    assert torch.equal(got["a"]["w"], _tree(3.0)["a"]["w"])


def test_missing_returns_none(tmp_path):
    assert CheckpointManager(tmp_path / "nope").restore() is None


def _reference_lm_state(arch):
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)),
                               compute_dtype="float32")
    jp = jax.jit(j_lm.init_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                     jcfg)
    jo = j_adamw(1e-3).init(jp)
    jo["step"] = jnp.asarray(5, jnp.int32)
    jo["mu"] = jax.tree.map(lambda p: p * 0.5, jp)
    return {"params": jp, "opt": jo}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m"])
def test_lm_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A reference CheckpointManager checkpoint of an LM {"params", "opt"}
    tree restores in the port, and the port's in the reference, leaf for
    leaf equal (dtypes too), with the data cursor."""
    jtree = _reference_lm_state(arch)
    JCheckpointManager(tmp_path / "ref").save(5, jtree, extra={"step": 5})
    got, extra = CheckpointManager(tmp_path / "ref").restore(device="cpu")
    assert extra == {"step": 5}
    want = dict(tree_paths(jax.tree.map(np.asarray, jtree)))
    flat = dict(tree_paths(got))
    assert set(flat) == set(want)
    for path, t in flat.items():
        assert t.dtype == torch.from_numpy(want[path]).dtype, path
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
    # the port's state as the loop holds it, written by the port
    cfg = smoke_variant(get_config(arch))
    p = lm.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    ptree = {"params": p, "opt": adamw(1e-3).init(p)}
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(2, ptree, extra={"step": 2}, blocking=False)
    mgr.wait()
    back, jextra = JCheckpointManager(tmp_path / "port").restore()
    assert jextra == {"step": 2}
    jflat = dict(tree_paths(back))
    assert set(jflat) == {path for path, _ in tree_paths(ptree)}
    for path, t in tree_paths(ptree):
        assert jflat[path].dtype == t.numpy().dtype, path
        np.testing.assert_array_equal(jflat[path], t.numpy(), err_msg=path)


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------

def test_straggler_flags_an_outlier_after_warmup():
    m = StragglerMonitor(warmup_steps=4, k_sigma=4.0)
    flagged = [m.observe(i, 1.0 + 0.01 * ((i * 2654435761) % 7 - 3) / 3.0)
               for i in range(30)]
    assert not any(flagged)
    assert m.observe(30, 3.0)
    assert abs(m.mean_s - 1.0) < 0.05


def test_straggler_consecutive_flags():
    m = StragglerMonitor(warmup_steps=2, k_sigma=3.0)
    for i in range(10):
        m.observe(i, 1.0)
    for i in range(10, 13):
        m.observe(i, 5.0)
    assert m.consecutive_flags(3)


def test_heartbeat_dead_detection_on_a_simulated_clock():
    now = [0.0]
    hb = HeartbeatTracker(n_workers=4, timeout_s=10.0, clock=lambda: now[0])
    now[0] = 5.0
    hb.beat(0)
    hb.beat(1)
    hb.beat(2)
    now[0] = 12.0
    assert hb.dead() == [3]
    assert hb.alive() == [0, 1, 2]


def test_preemption_guard_trigger_and_poll():
    with PreemptionGuard() as g:
        assert not g.preempted
        g.trigger()
        assert g.preempted


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

SHAPE = ShapeConfig("t", "train", 32, 2)


def _loop(tmp, total, **kw):
    return LoopConfig(total_steps=total, ckpt_every=3, log_every=100,
                      ckpt_dir=str(tmp), lr=1e-3, **kw)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m"])
def test_a_restarted_run_replays_the_same_bits(arch, tmp_path):
    """6 steps in one run, and a run cut at step 3 then restarted from its
    (async) checkpoint: the same losses and the same final params and
    optimizer state, bit for bit; and the loop's losses are those of
    calling the port's step on the loader's batches, from the loop's
    initial state."""
    cfg = smoke_variant(get_config(arch))
    whole = run(cfg, SHAPE, _loop(tmp_path / "a", 6), log=lambda _: None,
                device="cpu")
    assert whole.final_step == 6 and whole.restored_from is None
    assert len(whole.gnorms) == len(whole.step_s) == 6
    cut = run(cfg, SHAPE, _loop(tmp_path / "b", 3), log=lambda _: None,
              device="cpu")
    logs = []
    rest = run(cfg, SHAPE, _loop(tmp_path / "b", 6), log=logs.append,
               device="cpu")
    assert rest.restored_from == 3 and "[loop] restored from step 3" in logs
    assert cut.losses + rest.losses == whole.losses
    assert cut.gnorms + rest.gnorms == whole.gnorms
    a, _ = load_checkpoint(tmp_path / "a", 6)
    b, _ = load_checkpoint(tmp_path / "b", 6)
    for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        np.testing.assert_array_equal(x, y, err_msg=path)

    step, _, opt = build_train_step(cfg, SHAPE, lr=1e-3, device="cpu")
    params, state = loop_mod.init_train_state(cfg, opt, torch.device("cpu"))
    loader = TokenLoader(TokenStreamConfig(cfg.vocab_size, SHAPE.seq_len,
                                           SHAPE.global_batch))
    for want in whole.losses:
        _, batch = next(loader)
        params, state, m = step(params, state, batch)
        assert float(m["loss"]) == want
    for path, x in tree_paths({"params": params, "opt": state}):
        np.testing.assert_array_equal(x.numpy(), dict(tree_paths(a))[path],
                                      err_msg=path)


def test_preemption_drains_with_a_final_checkpoint(tmp_path):
    """SIGTERM during step 1 (the guard turns it into a flag): the loop
    finishes that step, writes a blocking checkpoint at step 2 and
    returns preempted."""
    cfg = smoke_variant(get_config("mamba2-780m"))
    calls = []

    def sigterm_at_step_1(batch):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch

    logs = []
    handler = signal.getsignal(signal.SIGTERM)
    res = run(cfg, SHAPE, _loop(tmp_path, 10), log=logs.append,
              extra_batch_fn=sigterm_at_step_1, device="cpu")
    assert res.preempted and res.final_step == 2 and len(res.losses) == 2
    assert latest_step(tmp_path) == 2
    assert any("preempted at step 1" in line for line in logs)
    assert signal.getsignal(signal.SIGTERM) == handler


# ---------------------------------------------------------------------------
# the launcher and the device policy
# ---------------------------------------------------------------------------

def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "128", "--ckpt-dir", str(tmp_path)]
    assert launcher.main(args) == 0
    assert "[train] done at step 4" in capsys.readouterr().out
    assert latest_step(tmp_path) == 4
    assert launcher.main(args[:4] + ["6"] + args[5:]) == 0
    out = capsys.readouterr().out
    assert "[loop] restored from step 4" in out
    assert "[train] done at step 6" in out


@pytest.mark.parametrize("argv,what", [
    (["--production-mesh"], "needs 256 ranks"),
    (["--multi-pod"], "needs 512 ranks"),
    (["--arch", "seamless-m4t-large-v2", "--production-mesh"],
     "needs 256 ranks"),
    (["--arch", "llama-3.2-vision-90b", "--multi-pod"], "needs 512 ranks"),
    (["--arch", "no-such-arch"], "unknown arch"),
])
def test_launcher_refuses_what_is_not_ported(argv, what, tmp_path, capsys):
    """A production mesh on a one-rank job (it needs 256 or 512 ranks)
    and an unknown arch: exit 2, nothing written."""
    assert launcher.main(argv + ["--smoke", "--ckpt-dir",
                                 str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and what in err
    assert not list(tmp_path.iterdir())


def test_training_entry_points_need_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_variant(get_config("mamba2-780m"))
    for call in (lambda: build_train_step(cfg, SHAPE),
                 lambda: run(cfg, SHAPE, _loop(tmp_path, 1)),
                 lambda: launcher.main(["--smoke", "--ckpt-dir",
                                        str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not list(tmp_path.iterdir())


def test_no_thread_is_left_behind(tmp_path):
    """An async save's writer is joined by the loop's final wait."""
    cfg = smoke_variant(get_config("internlm2-1.8b"))
    run(cfg, SHAPE, _loop(tmp_path, 3), log=lambda _: None, device="cpu")
    assert latest_step(tmp_path) == 3
    assert not [t for t in threading.enumerate()
                if t is not threading.main_thread() and t.daemon
                and t.name.startswith("Thread")]
