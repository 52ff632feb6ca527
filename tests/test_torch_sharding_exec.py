"""PyTorch port, sharded execution on the CPU: internlm2-1.8b's and
mamba2-780m's smoke variants (float32 compute) on 4 spawned ``gloo``
ranks forming a ``(2, 2)`` ("data", "model") mesh, through
``build_prefill_step``, two ``build_serve_step`` decode steps and two
``build_train_step`` steps (tests/sharding_ranks.py), held to the JAX
package's builders on the same numpy inputs and the reference's weights;
and the launcher's meshes.

Tolerances. Serving: 2e-4 (tests/test_torch_lm.py, the reference's
tests/test_models.py) relative, and absolute 2e-4 of the leaf's largest
element: mamba2's smoke logits reach ~60. Steps: tests/lm_train_oracle.close_steps (loss rtol 1e-5,
gnorm 1e-4, params and moments by tests/adam_close.py). The collectives
reorder float32 sums (a matmul's partial products summed across the
"model" shards, the gradients across the "data" shards), which moves
results by a few ulps, well inside those."""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lm_train_oracle as oracle
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.serve import steps as j_serve
from repro_torch.utils import tree_paths
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["internlm2-1.8b", "mamba2-780m"]
B, P, N_DEC, S_TRAIN, N_STEPS = 4, 16, 2, 64, 2
ATOL = 2e-4
HERE = os.path.dirname(__file__)


def _inputs(arch: str) -> tuple[dict, dict]:
    """(numpy inputs for tests/sharding_ranks.py under ``arch/``, the
    reference's results): prefill of a [B, P] prompt, N_DEC decode steps
    on its cache padded to P + N_DEC, N_STEPS train steps."""
    jcfg, cfg, jp, tree = oracle.params(arch)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    dec = rng.integers(0, cfg.vocab_size, (N_DEC, B, 1))
    batches = oracle.step_batches(cfg, B, S_TRAIN, N_STEPS)
    inp = {"prompt": prompt, "decode": dec}
    for path, a in tree_paths(tree):
        inp[f"serve/{path}"] = a
        inp[f"train/{path}"] = a
    for i, b in enumerate(batches):
        for k, v in b.items():
            inp[f"batch{i}/{k}"] = v

    want = {}
    with j_host_mesh() as mesh:
        pstep, (p_sds, _), _ = j_serve.build_prefill_step(
            jcfg, JShapeConfig("p", "prefill", P, B), mesh)
        # the serving params in the dtypes the reference allocates them
        jsp = jax.tree.map(lambda a, sds: jnp.asarray(a, sds.dtype), jp,
                           p_sds)
        logits, cache = pstep(jsp, jnp.asarray(prompt, jnp.int32))
        want["prefill"] = np.asarray(logits, np.float32)
        cache = jax.tree.map(np.asarray, cache)
        for path, a in tree_paths(cache):
            want[f"prefill_cache/{path}"] = np.asarray(a, np.float32)
        dstep, _, _ = j_serve.build_serve_step(
            jcfg, JShapeConfig("d", "decode", P + N_DEC, B), mesh,
            donate=False)
        # the decode step's cache holds P + N_DEC positions (dense and ssm
        # caches are flat dicts; only k and v have a position axis)
        cache = {k: jnp.asarray(np.pad(v, [(0, 0), (0, 0), (0, N_DEC),
                                           (0, 0), (0, 0)])
                                if k in ("k", "v") else v)
                 for k, v in cache.items()}
        for i in range(N_DEC):
            lg, cache = dstep(jsp, jnp.asarray(dec[i], jnp.int32),
                              jnp.asarray(P + i, jnp.int32), cache)
            cache = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), cache)
            want[f"decode{i}"] = np.asarray(lg, np.float32)
        for path, a in tree_paths(cache):
            want[f"cache/{path}"] = np.asarray(a, np.float32)
    want["steps"] = oracle.reference_steps(jcfg, jp, B, S_TRAIN, batches,
                                           1e-3)
    return {f"{arch}/{k}": v for k, v in inp.items()}, want


def _run(tmp: str):
    """Both archs through tests/sharding_ranks.py once: (got, wants)."""
    inp, wants = {"arch": np.array(ARCHS)}, {}
    for arch in ARCHS:
        i, w = _inputs(arch)
        inp.update(i)
        wants[arch] = w
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(src, **inp)
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "sharding_ranks.py"),
                        src, dst], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(dst) as z:
        got = {k: z[k] for k in z.files}
    return got, wants


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _run(str(tmp_path_factory.mktemp("ranks")))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=ATOL,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_a_2x2_mesh_matches_reference(arch, results):
    """Last logits and every cache leaf of the sharded prefill (K5 / K6's
    plain versions on each rank's head shards) within 2e-4 of the
    reference's build_prefill_step."""
    got, wants = results
    want = wants[arch]
    _close(got[f"{arch}/prefill"], want["prefill"], "logits")
    keys = [k for k in want if k.startswith("prefill_cache/")]
    assert keys
    for k in keys:
        _close(got[f"{arch}/{k}"], want[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_2x2_mesh_matches_reference(arch, results):
    """Two decode steps of build_serve_step on the prefill's cache (grown
    to P + 2 positions): logits and the cache after, within 2e-4."""
    got, wants = results
    want = wants[arch]
    for i in range(N_DEC):
        _close(got[f"{arch}/decode{i}"], want[f"decode{i}"], f"decode{i}")
    keys = [k for k in want if k.startswith("cache/")]
    assert keys
    for k in keys:
        _close(got[f"{arch}/{k}"], want[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_on_a_2x2_mesh_match_reference(arch, results):
    """Two build_train_step steps on the mesh (batch over "data", weights
    over "model", gradients reduced over "data" before clipping): loss,
    gnorm, params and AdamW moments after each, by close_steps."""
    got, wants = results
    steps = []
    for i in range(N_STEPS):
        state = {}
        pre = f"{arch}/step{i}/"
        for k, v in got.items():
            if k.startswith(pre):
                state[k[len(pre):]] = v
        steps.append((got[f"{arch}/loss{i}"], got[f"{arch}/gnorm{i}"],
                      _unflatten(state)))
    oracle.close_steps(steps, wants[arch]["steps"], 1e-3)


def _unflatten(flat: dict) -> dict:
    from repro_torch.utils import unflatten_dict
    return unflatten_dict(flat)


def test_launcher_meshes_on_a_small_job(tmp_path, capsys):
    """--production-mesh and --multi-pod exit 2 on a one-rank job, naming
    the 256 and 512 ranks they need; without either flag --smoke trains on
    the host mesh ((1, 1) here) and a rerun resumes."""
    from repro_torch.launch import train as launcher
    for flag, need in (("--production-mesh", 256), ("--multi-pod", 512)):
        assert launcher.main(["--smoke", flag, "--device", "cpu",
                              "--ckpt-dir", str(tmp_path / "m")]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error:") and f"needs {need} ranks" in err
    assert not (tmp_path / "m").exists()
    argv = ["--device", "cpu", "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ck")]
    assert launcher.main(argv + ["--steps", "2"]) == 0
    assert "[train] done at step 2" in capsys.readouterr().out
    assert launcher.main(argv + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[loop] restored from step 2" in out
    assert "[train] done at step 3" in out
