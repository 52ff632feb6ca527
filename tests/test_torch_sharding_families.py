"""PyTorch port, sharded execution of every remaining family on the CPU:
granite-moe-1b-a400m (MoE, experts over "model": EP), grok-1-314b at
``tp_multiple=8`` (MoE, d_ff over "model": TP), zamba2-7b (hybrid, 4 SSM
blocks in 2 groups, so its shared block runs twice), llama-3.2-vision-90b
(vlm, ``img_embed``) and seamless-m4t-large-v2 (enc-dec, ``frames``), smoke
variants at float32 compute, on 4 spawned ``gloo`` ranks forming a (2, 2)
("data", "model") mesh: ``build_prefill_step``, two ``build_serve_step``
decode steps and two ``build_train_step`` steps at capacity 1.25; then
two steps at ``grad_accum=2`` for internlm2-1.8b and granite; all in one
spawned run (tests/sharding_ranks.py). Held to the JAX package on the
same numpy inputs and the reference's weights; and the elastic planner
(``ft/elastic.plan_remesh``) against the reference's.

The MoE oracle. The reference's ``moe_apply`` raises inside its host mesh
on this JAX (ROADMAP.md queue 3), so its MoE steps are built on the host
mesh and called outside it, with ``repro.nn.moe._batch_groups`` patched in
the test to the port's data-shard count (2): the reference then dispatches
in the groups the sharded port dispatches in (one a batch shard) and drops
the same tokens. Every MoE embedding row is shifted by the embedding's
standard deviation, so that capacity 1.25 drops choices in every layer
(tests/test_torch_lm_train_families.py); the step's ``lb`` and every
layer's drop share are held to the reference's.

Tolerances, as tests/test_torch_sharding_exec.py: serving 2e-4 relative
and 2e-4 of the leaf's largest element absolute; steps by
tests/lm_train_oracle.close_steps (loss rtol 1e-5, gnorm 1e-4, params and
moments by tests/adam_close.py); ``lb`` rtol 1e-5, drop shares equal to
1e-6 (the same count of dropped choices)."""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import lm_train_oracle as oracle
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import lm as j_lm
from repro.nn import moe as j_moe
from repro.serve import steps as j_serve
from repro_torch.utils import tree_paths, unflatten_dict
from sharding_ranks import parse_key
from torch_threads import one_torch_thread  # noqa: F401

SERVED = ["granite-moe-1b-a400m", "grok-1-314b+tp8", "zamba2-7b+L4",
          "llama-3.2-vision-90b", "seamless-m4t-large-v2"]
ACCUM = ["internlm2-1.8b+accum2", "granite-moe-1b-a400m+accum2"]
B, P, N_DEC, S_TRAIN, N_STEPS = 4, 16, 2, 64, 2
ATOL = 2e-4
DATA_SHARDS = 2
HERE = os.path.dirname(__file__)


def _kw(key: str) -> tuple[str, dict, int]:
    """(arch, config fields, grad_accum) of a case key."""
    arch, kw = parse_key(key)
    return arch, kw, kw.pop("grad_accum", 1)


@contextlib.contextmanager
def _groups_of_the_port(moe: bool):
    """The reference's MoE dispatch groups set to the port's data shards
    (and its calls made outside its host mesh, where they run)."""
    if not moe:
        yield
        return
    orig = j_moe._batch_groups
    j_moe._batch_groups = (lambda T: DATA_SHARDS if T % DATA_SHARDS == 0
                           else 1)
    try:
        yield
    finally:
        j_moe._batch_groups = orig


def _reference_serving(jcfg, jp, prompt, dec, extra, moe: bool) -> dict:
    """The reference's build_prefill_step and N_DEC build_serve_step steps
    on the prefill's cache padded to the serve step's structs."""
    want = {}
    mesh = j_host_mesh()
    with mesh if not moe else contextlib.nullcontext():
        pstep, (p_sds, *_), _ = j_serve.build_prefill_step(
            jcfg, JShapeConfig("p", "prefill", P, B), mesh)
        jsp = jax.tree.map(lambda a, sds: jnp.asarray(a, sds.dtype), jp,
                           p_sds)
        logits, cache = pstep(jsp, jnp.asarray(prompt, jnp.int32),
                              *(jnp.asarray(e) for e in extra))
        want["prefill"] = np.asarray(logits, np.float32)
        cache = jax.tree.map(np.asarray, cache)
        for path, a in tree_paths(cache):
            want[f"prefill_cache/{path}"] = np.asarray(a, np.float32)
        dstep, (*_, c_sds), _ = j_serve.build_serve_step(
            jcfg, JShapeConfig("d", "decode", P + N_DEC, B), mesh,
            donate=False)
        # the prefill's cache inside the serve step's: attention leaves
        # (and the enc-dec's cross cache) grow on the position axis
        cache = jax.tree.map(lambda a, s: jnp.asarray(
            a if a.shape == s.shape else np.pad(
                a, [(0, n - m) for m, n in zip(a.shape, s.shape)])),
            cache, c_sds)
        for i in range(N_DEC):
            lg, cache = dstep(jsp, jnp.asarray(dec[i], jnp.int32),
                              jnp.asarray(P + i, jnp.int32), cache)
            cache = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), cache)
            want[f"decode{i}"] = np.asarray(lg, np.float32)
        for path, a in tree_paths(cache):
            want[f"cache/{path}"] = np.asarray(a, np.float32)
    return want


def _reference_drops(jcfg, jp, tokens) -> np.ndarray:
    """Each MoE layer's drop share in the reference's forward pass over
    ``tokens`` (a callback from inside its scanned layers)."""
    seen, apply = [], j_moe.moe_apply

    def recording(p, x, cfg, groups=None):
        y, aux = apply(p, x, cfg, groups)
        jax.debug.callback(lambda d: seen.append(float(d)),
                           aux["drop_frac"], ordered=True)
        return y, aux
    j_moe.moe_apply = recording
    try:
        # a function of its own: a cached trace would call an older list
        jax.block_until_ready(jax.jit(lambda p, t: j_lm.forward(p, t, jcfg))(
            jp, jnp.asarray(tokens)))
        jax.effects_barrier()
    finally:
        j_moe.moe_apply = apply
    return np.array(seen, np.float32)


def _case(key: str) -> tuple[dict, dict]:
    """(numpy inputs for tests/sharding_ranks.py under ``key/``, the
    reference's results)."""
    arch, kw, accum = _kw(key)
    jcfg, cfg, jp, tree = oracle.params(arch, **kw)
    moe = bool(cfg.n_experts)
    if moe:
        emb = tree["embed"]["embedding"]
        tree["embed"]["embedding"] = emb + emb.std()
        jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    inp, want = {}, {}
    for path, a in tree_paths(tree):
        inp[f"serve/{path}"] = a
        inp[f"train/{path}"] = a
    batches = oracle.step_batches(cfg, B, S_TRAIN, N_STEPS)
    for i, b in enumerate(batches):
        for k, v in b.items():
            inp[f"batch{i}/{k}"] = v
    with _groups_of_the_port(moe):
        if accum == 1:
            prompt = rng.integers(0, cfg.vocab_size, (B, P))
            dec = rng.integers(0, cfg.vocab_size, (N_DEC, B, 1))
            extra = oracle.extras(cfg, B, P, seed=3)
            inp.update(prompt=prompt, decode=dec, **extra)
            want.update(_reference_serving(jcfg, jp, prompt, dec,
                                           list(extra.values()), moe))
        metrics = []
        want["steps"] = oracle.reference_steps(
            jcfg, jp, B, S_TRAIN, batches, 1e-3, grad_accum=accum,
            in_mesh=not moe, metrics=metrics)
        if moe and accum == 1:
            want["lb"] = [m["lb"] for m in metrics]
            starts = [jp] + [jax.tree.map(jnp.asarray, s[2])
                             for s in want["steps"][:-1]]
            want["drops"] = [_reference_drops(jcfg, p, b["tokens"])
                             for p, b in zip(starts, batches)]
    return {f"{key}/{k}": v for k, v in inp.items()}, want


def _run(tmp: str):
    """Every case through tests/sharding_ranks.py once: (got, wants)."""
    keys = SERVED + ACCUM
    inp, wants = {"arch": np.array(keys)}, {}
    for key in keys:
        i, w = _case(key)
        inp.update(i)
        wants[key] = w
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(src, **inp)
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "sharding_ranks.py"),
                        src, dst], capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(dst) as z:
        got = {k: z[k] for k in z.files}
    return {k: _select(got, k) for k in keys}, wants


def _select(got: dict, key: str) -> dict:
    return {k[len(key) + 1:]: v for k, v in got.items()
            if k.startswith(key + "/")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _run(str(tmp_path_factory.mktemp("ranks")))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=ATOL,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("key", SERVED)
def test_prefill_on_a_2x2_mesh_matches_reference(key, results):
    """Last logits and every cache leaf of the sharded prefill (the vlm's
    cross cache onto img_embed, the enc-dec's onto the encoded frames,
    the hybrid's SSM states with batch on axis 2) within 2e-4 of the
    reference's build_prefill_step."""
    got, wants = results
    got, want = got[key], wants[key]
    _close(got["prefill"], want["prefill"], "logits")
    keys = [k for k in want if k.startswith("prefill_cache/")]
    assert keys and set(keys) == {k for k in got
                                  if k.startswith("prefill_cache/")}
    for k in keys:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("key", SERVED)
def test_decode_on_a_2x2_mesh_matches_reference(key, results):
    """Two decode steps of build_serve_step on the prefill's cache grown
    by grow_cache: logits and every cache leaf after, within 2e-4."""
    got, wants = results
    got, want = got[key], wants[key]
    for i in range(N_DEC):
        _close(got[f"decode{i}"], want[f"decode{i}"], f"decode{i}")
    keys = [k for k in want if k.startswith("cache/")]
    assert keys and set(keys) == {k for k in got if k.startswith("cache/")}
    for k in keys:
        _close(got[k], want[k], k)


def _steps(got: dict) -> list:
    steps = []
    for i in range(N_STEPS):
        pre = f"step{i}/"
        state = {k[len(pre):]: v for k, v in got.items()
                 if k.startswith(pre)}
        steps.append((got[f"loss{i}"], got[f"gnorm{i}"],
                      unflatten_dict(state)))
    return steps


@pytest.mark.parametrize("key", SERVED)
def test_train_steps_on_a_2x2_mesh_match_reference(key, results):
    """Two build_train_step steps (capacity 1.25, batch over "data",
    weights over "model"; MoE's gradients of the router and the experts
    summed over the shards they were replicated on): loss, gnorm, params
    and AdamW moments after each, by close_steps; for MoE the step's lb
    and each layer's drop share, every layer dropping."""
    got, wants = results
    got, want = got[key], wants[key]
    oracle.close_steps(_steps(got), want["steps"], 1e-3)
    if "lb" in want:
        for i in range(N_STEPS):
            np.testing.assert_allclose(got[f"lb{i}"], want["lb"][i],
                                       rtol=1e-5, err_msg=f"lb{i}")
            d = want["drops"][i]
            assert len(d) == 2 and d.min() > 0, d
            np.testing.assert_allclose(got[f"drop{i}"], d, rtol=0,
                                       atol=1e-6, err_msg=f"drop{i}")


@pytest.mark.parametrize("key", ACCUM)
def test_grad_accum_on_a_2x2_mesh_matches_reference(key, results):
    """Two steps at grad_accum=2 (microbatch i the global rows [2i, 2i+2),
    each pinned to the batch placement; gradients summed in float32 and
    halved) against the reference's build_train_step(grad_accum=2)."""
    got, wants = results
    oracle.close_steps(_steps(got[key]), wants[key]["steps"], 1e-3)
    assert not any(k.startswith("lb") for k in got[key])


# ---------------------------------------------------------------------------
# the elastic planner
# ---------------------------------------------------------------------------

def _plans(chips: int, tp: int, batch: int):
    from repro.ft import plan_remesh as j_plan
    from repro_torch.ft import plan_remesh
    got, want = (f(chips, tp=tp, global_batch=batch)
                 for f in (plan_remesh, j_plan))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.chips == want.chips
    return got


@pytest.mark.parametrize("chips,tp,batch", [(480, 16, 256), (256, 16, 256),
                                            (8, 16, 64), (512, 16, 256)])
def test_plan_remesh_matches_reference(chips, tp, batch):
    """The reference's four cases (tests/test_runtime.py), field for
    field, and what those tests assert of them."""
    plan = _plans(chips, tp, batch)
    if chips == 480:
        assert plan.mesh_shape == (30, 16) and plan.grad_accum > 1
        # the reference's quirk, kept: ceil(256 / 30) = 9 does not divide
        # the batch, which build_train_step refuses
        assert plan.grad_accum == 9 and batch % plan.grad_accum
    if chips == 8:
        assert plan.mesh_shape[1] <= 8 and plan.chips <= 8


@settings(max_examples=50, deadline=None)
@given(chips=st.integers(1, 512), tp=st.sampled_from([1, 2, 4, 8, 16]),
       batch=st.sampled_from([32, 256, 1024]))
def test_plan_remesh_sweep_matches_reference(chips, tp, batch):
    """The reference's property sweep (tests/test_property.py): every
    plan equal to the reference's, field for field."""
    plan = _plans(chips, tp, batch)
    data, model = plan.mesh_shape
    assert data * model <= chips and plan.dropped_chips >= 0


def test_plan_remesh_accum_that_divides_trains_on_a_mesh():
    """A plan whose grad_accum divides the batch builds a mesh step; one
    whose ceil(B / data) does not raises ValueError, as the reference's
    step asserts."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.ft import plan_remesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.steps import build_train_step
    cfg = smoke_variant(get_config("internlm2-1.8b"))
    mesh = make_host_mesh(device="cpu")
    ok = plan_remesh(3, tp=1, global_batch=4)
    assert ok.mesh_shape == (3, 1) and ok.grad_accum == 2
    build_train_step(cfg, ShapeConfig("t", "train", 8, 4), mesh,
                     grad_accum=ok.grad_accum)
    bad = plan_remesh(480, tp=16, global_batch=256)
    with pytest.raises(ValueError, match="does not divide"):
        build_train_step(cfg, ShapeConfig("t", "train", 8, 256), mesh,
                         grad_accum=bad.grad_accum)


@pytest.mark.parametrize("mesh,tokens,groups", [
    (((1, 1), ("data", "model")), 64, 1),
    (((2, 2), ("data", "model")), 64, 2),
    (((2, 2), ("data", "model")), 63, 1),
    (((16, 16), ("data", "model")), 4096, 16),
    (((2, 16, 16), ("pod", "data", "model")), 4096, 32)])
def test_batch_groups_and_moe_placements(mesh, tokens, groups):
    """rules.batch_groups gives the reference's _batch_groups count (the
    pod x data shards where they divide the tokens, else 1); on the (2, 2)
    mesh granite's smoke variant splits its experts over "model" (EP) and
    grok's at tp_multiple=8 its d_ff (TP), each leaving y a Partial sum
    there, the router's gradient a Partial sum over both axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.sharding import rules
    m = rules.MeshShape(*mesh)
    assert rules.batch_groups(m, tokens) == groups
    assert rules.batch_groups(None, tokens) == 1
    if m.shape != (2, 2):
        return
    for arch, kw, mode, dim in (("granite-moe-1b-a400m", {}, "EP", 0),
                                ("grok-1-314b", {"tp_multiple": 8}, "TP",
                                 2)):
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **kw)
        pl = rules.moe_placements(cfg, m, (4, 16, cfg.d_model))
        assert (pl.mode, pl.split, pl.row_shards) == (mode, True, 2)
        assert pl.x == (Shard(0), Replicate())
        assert pl.y == (Shard(0), Partial())
        assert pl.weights["wg"] == (Replicate(), Shard(dim))
        assert pl.grads["wg"] == (Partial(), Shard(dim))
        assert pl.grads["router"] == (Partial(), Partial())
        # a batch of 3 rows stays whole on every data rank
        pl3 = rules.moe_placements(cfg, m, (3, 16, cfg.d_model))
        assert pl3.row_shards == 1 and pl3.x == (Replicate(), Replicate())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_grad_accum_at_one_rank_is_bit_identical(arch):
    """On the (1, 1) host mesh every placement replicates: two steps at
    grad_accum=2 give the one-device grad_accum=2 step's bits (loss,
    gnorm, every param and moment), the property chip_smoke.py's [mesh]
    holds on the card."""
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import rules
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map
    mesh = make_host_mesh(device="cpu")
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              compute_dtype="float32")
    shape = ShapeConfig("t", "train", 32, 4)
    step, (p_sds, o_sds, b_sds), _ = build_train_step(
        cfg, shape, mesh, lr=1e-3, grad_accum=2)
    ustep, _, uopt = build_train_step(cfg, shape, lr=1e-3, device="cpu",
                                      grad_accum=2)
    up = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    dp = rules.place_as(tree_map(torch.clone, up), p_sds)
    do, uo = rules.zeros(o_sds), uopt.init(up)
    g = torch.Generator().manual_seed(4)
    for i in range(2):
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
                 for k in ("tokens", "labels")}
        up, uo, um = ustep(up, uo, batch)
        dp, do, m = step(dp, do, rules.place_as(batch, b_sds))
        assert set(m) == set(um) == {"loss", "gnorm"}
        for k in um:
            assert torch.equal(m[k], um[k]), (i, k)
    for (path, a), (_, b) in zip(tree_paths({"p": dp, "o": do}),
                                 tree_paths({"p": up, "o": uo})):
        assert torch.equal(a.full_tensor(), b), path
