"""PyTorch port, LM training for the moe and hybrid families: ``moe_apply``
and its VJP at the training capacity (1.25, with drops), ``loss_fn``'s
loss, ``ce``, ``lb`` and every gradient, remat, and 3 train steps, against
the JAX package on the same numpy inputs and the reference's weights
(``lm.params_from_jax``). Smoke variants: granite-moe-1b-a400m and
grok-1-314b with 4 experts top 2, zamba2-7b at 4 SSM blocks in groups of
2, so that its shared block runs twice. The reference's ``moe_apply``
raises inside its host mesh on this JAX, so its MoE oracles run outside
any mesh."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.tokens import TokenStreamConfig as JTokenStreamConfig
from repro.data.tokens import sample_batch as j_sample_batch
from repro.launch.mesh import make_host_mesh
from repro.models import lm as j_lm
from repro.nn import moe as j_moe
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim.optimizers import apply_updates as j_apply_updates
from repro.train.steps import build_train_step as j_build_train_step
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.train.steps import build_train_step, make_batch_specs
from repro_torch.utils import tree_map, tree_paths
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["granite-moe-1b-a400m", "grok-1-314b", "zamba2-7b"]
MOE = ARCHS[:2]
# zamba2's smoke variant has one group; two make the shared block's
# gradient the sum of two uses
DEPTH = {"zamba2-7b": dict(n_layers=4)}
# the reference's own test_grad_accum_matches_single_shot
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _cfgs(arch, compute="float32", **kw):
    kw = dict(DEPTH.get(arch, {}), compute_dtype=compute, **kw)
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


_j_init = jax.jit(j_lm.init_params, static_argnums=1)
_j_loss_and_grad = jax.jit(jax.value_and_grad(j_lm.loss_fn, has_aux=True),
                           static_argnums=2)
_j_forward = jax.jit(j_lm.forward, static_argnums=2)


def _params(arch, shift=True, **kw):
    """The reference's smoke weights (numpy ``tree`` and JAX ``jp``). For
    MoE, unless ``shift`` is false, every embedding row is shifted by the
    embedding's standard deviation: the shared direction sends most tokens
    to the same experts, so that the capacity factor of 1.25 drops choices
    in every layer (unshifted, the smoke routing keeps every choice)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = _j_init(jax.random.PRNGKey(0),
                 dataclasses.replace(jcfg, compute_dtype="float32"))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    if cfg.n_experts and shift:
        emb = tree["embed"]["embedding"]
        tree["embed"]["embedding"] = emb + emb.std()
        jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, cfg, jp, tree


@pytest.fixture
def drops(monkeypatch):
    """Every port ``moe_apply`` call's drop_frac, as floats."""
    seen, apply = [], moe.moe_apply

    def recording(*a, **kw):
        y, aux = apply(*a, **kw)
        seen.append(float(aux["drop_frac"]))
        return y, aux
    monkeypatch.setattr(moe, "moe_apply", recording)
    return seen


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S))
            for k in ("tokens", "labels")}


def _port_grads(params, batch, cfg):
    """(loss, aux, {path: grad}) of the port's loss_fn."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    paths, leaves = zip(*tree_paths(live))
    loss, aux = lm.loss_fn(live, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg)
    return loss, aux, dict(zip(paths, torch.autograd.grad(loss, leaves)))


def test_moe_and_hybrid_are_trainable():
    """check_trainable admits both families; the batch specs are the
    tokens and labels alone, as for dense."""
    from repro_torch.train.steps import check_trainable
    for arch in ARCHS:
        cfg = _cfgs(arch)[1]
        check_trainable(cfg)
        specs = make_batch_specs(cfg, ShapeConfig("t", "train", 8, 2))
        assert {k: tuple(v.shape) for k, v in specs.items()} == {
            "tokens": (2, 8), "labels": (2, 8)}


# ---------------------------------------------------------------------------
# moe_apply at the training capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_and_its_vjp_match_the_reference(arch):
    """Capacity factor 1.25 on tokens skewed toward expert 0, so both sides
    drop as many (token, choice) pairs (drop_frac > 0, the same count): y
    within 1e-5, lb_loss within 1e-6 (relative), and the VJP of (y,
    lb_loss) for x, router, wg, wu and wd within rtol 1e-4 and an atol of
    1e-6 times each gradient's largest magnitude. The reference multiplies
    a dropped choice's contribution by 0, so a gradient that reached one
    would show here."""
    jcfg, cfg = _cfgs(arch)
    assert cfg.capacity_factor == jcfg.capacity_factor == 1.25
    jp = j_moe.moe_init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    w0 = np.asarray(jp["router"])[:, 0]
    x += 3.0 * w0 / np.linalg.norm(w0)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    g_lb = np.float32(0.7)

    def j_fn(p, x):
        y, aux = j_moe.moe_apply(p, x, jcfg)
        return (y, aux["lb_loss"]), aux["drop_frac"]
    (jy, jlb), vjp, jdrop = jax.vjp(jax.jit(j_fn), jp, jnp.asarray(x),
                                    has_aux=True)
    jp_g, jx_g = vjp((jnp.asarray(gy), jnp.asarray(g_lb)))

    p = {k: _t(v).requires_grad_() for k, v in jp.items()}
    xt = _t(x).requires_grad_()
    y, aux = moe.moe_apply(p, xt, cfg)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(aux["lb_loss"]), _np(jlb), rtol=1e-6)
    n = cfg.top_k * x.shape[0] * x.shape[1]      # (token, choice) pairs
    assert round(float(aux["drop_frac"]) * n) == round(float(jdrop) * n) > 0
    grads = torch.autograd.grad((y, aux["lb_loss"]), [xt] + list(p.values()),
                                (_t(gy), torch.tensor(g_lb)))
    want = [jx_g] + [jp_g[k] for k in p]
    for name, g, w in zip(["x"] + list(p), grads, want):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_its_gradients_match_the_reference(arch, drops):
    """loss_fn's loss, ce, lb and the gradient of every leaf against
    jax.value_and_grad(lm.loss_fn) from the same weights and batch (2 x
    64 tokens), at tests/test_torch_lm_train.py's tolerances.
    float32 compute: loss, ce and lb rtol 1e-5, gradients rtol 1e-4 and
    atol 1e-6, forward's logits rtol and atol 1e-5; lb > 0 for MoE (the
    sum of its layers' load-balance losses), here with choices dropped in
    every layer, and 0 for the hybrid.
    bfloat16 compute: loss, ce and lb within 2^-6 relative; every gradient
    element within 2^-6 of the largest element from the float32 gradient
    of the same weights; and each leaf's bf16 gradient no further (L2)
    from the port's float32 one than 1.5 times the reference's bf16
    gradient lies from its float32 one. The element bound is held against
    the float32 gradient, not the reference's bf16 one: over zamba2's 4
    SSM blocks each package's bf16 gradient of out_proj alone lies close
    to 2^-6 of the largest element from its float32 one, so two bf16 runs
    can differ by more than 2^-6 without a fault. MoE is held in bf16 on
    the reference's weights unshifted: with the shift, bf16 rounding
    flips a few tokens' top-2 choices in either package against float32,
    and a flip moves the capacity boundary of its expert (which later
    choice is dropped), a step in the gradient that no noise bound
    describes."""
    runs = [("float32", True), ("bfloat16", False)]
    if arch in MOE:
        runs.append(("float32", False))       # the bf16 run's exact one
    out = {}
    for compute, shift in runs:
        jcfg, cfg, jp, tree = _params(arch, compute=compute, shift=shift)
        batch = _batch(cfg, 2, 64)
        (want, want_aux), jgrads = _j_loss_and_grad(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        params = lm.params_from_jax(tree, cfg, "cpu")
        loss, aux, got = _port_grads(params, batch, cfg)
        aux = {k: v.detach() for k, v in aux.items()}
        want_g = {k: _np(v) for k, v in tree_paths(jgrads)}
        assert set(got) == set(want_g)
        assert aux["lb"].dtype == torch.float32
        if not cfg.n_experts:
            assert float(aux["lb"]) == float(want_aux["lb"]) == 0.0
        elif shift:
            assert float(aux["lb"]) > 0 and float(want_aux["lb"]) > 0
            assert len(drops) == cfg.n_layers and min(drops) > 0
        drops.clear()
        out[compute, shift] = ({k: float(v) for k, v in
                                dict(aux, loss=loss.detach()).items()},
                               {k: float(v) for k, v in
                                dict(want_aux, loss=want).items()},
                               {k: _np(v) for k, v in got.items()}, want_g)
        if (compute, shift) == ("float32", True):  # forward's logits and lb
            logits, lb = lm.forward(params, torch.from_numpy(
                batch["tokens"]), cfg)
            j_logits, j_lb = _j_forward(jp, jnp.asarray(batch["tokens"]),
                                        jcfg)
            np.testing.assert_allclose(_np(logits), _np(j_logits),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(_np(lb), _np(j_lb), rtol=1e-5)
    for key in out:
        if key[0] != "float32":
            continue
        got_s, want_s, got, want_g = out[key]
        for k in ("loss", "ce", "lb"):
            np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5,
                                       err_msg=k)
        for path, g in got.items():
            np.testing.assert_allclose(g, want_g[path], rtol=1e-4, atol=1e-6,
                                       err_msg=path)
    got_s, want_s, got, want_g = out["bfloat16", False]
    for k in ("loss", "ce", "lb"):
        assert abs(got_s[k] - want_s[k]) <= 2.0 ** -6 * abs(want_s[k]), k
    _, _, got32, exact = out["float32", arch not in MOE]
    top = max(np.abs(w).max() for w in exact.values())
    for path, g in got.items():
        assert np.abs(g - exact[path]).max() <= 2.0 ** -6 * top, path
        noise = np.linalg.norm(want_g[path] - exact[path])
        assert np.linalg.norm(g - got32[path]) <= 1.5 * noise, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(arch):
    """remat "none", "full" and "dots": the same loss, lb and gradients,
    bit for bit (MoE recomputes its routing and drops; the hybrid remats
    each group with its shared block under one wrapper)."""
    _, _, _, tree = _params(arch)
    batch = _batch(_cfgs(arch)[1], 2, 64, seed=1)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = _cfgs(arch, remat=remat)[1]
        out[remat] = _port_grads(lm.params_from_jax(tree, cfg, "cpu"), batch,
                                 cfg)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][1]["lb"], out["none"][1]["lb"]), remat
        for path, g in out["none"][2].items():
            assert torch.equal(out[remat][2][path], g), (remat, path)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _reference_steps(jcfg, jp, shape, batches, lr, grad_accum=1):
    """The reference's train step over ``batches``: per step (loss, gnorm,
    params, opt state) as numpy. The hybrid runs the reference's own
    ``build_train_step`` in its host mesh (params and opt state through
    numpy between calls: its outputs' shardings are rejected by its next
    call). MoE raises inside that mesh, so its step is the same body built
    outside any mesh from the reference's ``loss_fn``,
    ``clip_by_global_norm``, ``adamw`` and ``apply_updates``."""
    out = []
    if not jcfg.n_experts:
        with make_host_mesh() as mesh:
            step, _, opt = j_build_train_step(jcfg, shape, mesh, lr=lr,
                                              donate=False,
                                              grad_accum=grad_accum)
            jo = opt.init(jp)
            for b in batches:
                jp, jo, m = step(jp, jo, {k: jnp.asarray(v)
                                          for k, v in b.items()})
                jp, jo = (jax.tree.map(np.asarray, t) for t in (jp, jo))
                out.append((float(m["loss"]), float(m["gnorm"]), jp, jo))
                jp, jo = (jax.tree.map(jnp.asarray, t) for t in (jp, jo))
        return out
    opt = j_adamw(lr)
    grads_of = jax.value_and_grad(j_lm.loss_fn, has_aux=True)

    @jax.jit
    def step(params, opt_state, batch):
        if grad_accum > 1:
            B = shape.global_batch
            micro = jax.tree.map(lambda x: x.reshape(
                (grad_accum, B // grad_accum) + x.shape[1:]), batch)

            def acc_body(carry, mb):
                g_sum, loss_sum = carry
                (loss, _), g = grads_of(params, mb, jcfg)
                return (jax.tree.map(jnp.add, g_sum, g), loss_sum + loss), None
            g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                              params)
            (g_sum, loss_sum), _ = jax.lax.scan(
                acc_body, (g0, jnp.zeros((), jnp.float32)), micro)
            grads = jax.tree.map(lambda g: g / grad_accum, g_sum)
            loss = loss_sum / grad_accum
        else:
            (loss, _), grads = grads_of(params, batch, jcfg)
        grads, gnorm = j_clip(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        return j_apply_updates(params, updates), opt_state, loss, gnorm

    jo = opt.init(jp)
    for b in batches:
        jp, jo, loss, gnorm = step(jp, jo, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        out.append((float(loss), float(gnorm),
                    *(jax.tree.map(np.asarray, t) for t in (jp, jo))))
    return out


def _port_steps(cfg, tree, shape, batches, lr, **kw):
    step, _, opt = build_train_step(cfg, shape, lr=lr, device="cpu", **kw)
    p = lm.params_from_jax(tree, cfg, device="cpu")
    o = opt.init(p)
    out = []
    for b in batches:
        p, o, m = step(p, o, {k: torch.from_numpy(np.array(v, np.int64))
                              for k, v in b.items()})
        out.append((m["loss"], m["gnorm"],
                    tree_map(torch.clone, {"params": p, "opt": o})))
    return out


def _close_steps(got, want):
    """Per step: loss within rtol 1e-5, gnorm within 1e-4, params and
    AdamW moments within rtol 2e-4, atol 2e-5."""
    for (loss, gnorm, state), (j_loss, j_gnorm, j_p, j_o) in zip(got, want):
        np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
        np.testing.assert_allclose(float(gnorm), j_gnorm, rtol=1e-4)
        ref = dict(tree_paths({"params": j_p, "opt": j_o}))
        for path, a in tree_paths(state):
            np.testing.assert_allclose(_np(a), _np(ref[path]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(arch):
    """3 steps (lr 1e-3, float32 compute, batch 4 x 64) from the
    reference's weights on the reference's token-stream batches, held to
    the reference's steps (_close_steps). MoE's capacity and lb are per
    microbatch, so its grad_accum=2 is held to the reference's
    grad_accum=2 (not to grad_accum=1, which routes the whole batch at
    once); the hybrid's grad_accum=2 to its grad_accum=1 at the same
    tolerance."""
    jcfg, cfg, jp, tree = _params(arch)
    B, S = 4, 64
    batches = [jax.tree.map(np.asarray, j_sample_batch(
        JTokenStreamConfig(jcfg.vocab_size, S, B), jnp.asarray(i)))
        for i in range(3)]
    jshape, shape = JShapeConfig("t", "train", S, B), ShapeConfig(
        "t", "train", S, B)
    got = _port_steps(cfg, tree, shape, batches, 1e-3)
    _close_steps(got, _reference_steps(jcfg, jp, jshape, batches, 1e-3))
    accum = _port_steps(cfg, tree, shape, batches, 1e-3, grad_accum=2)
    if cfg.n_experts:
        _close_steps(accum, _reference_steps(jcfg, jp, jshape, batches,
                                             1e-3, grad_accum=2))
    else:
        _close_steps(accum, [(float(loss), float(gnorm), s["params"],
                              s["opt"]) for loss, gnorm, s in got])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_smoke_variant(arch, tmp_path, capsys):
    """launch/train.py --smoke on the CPU trains both families (exit 0)
    on the host mesh; --production-mesh exits 2 on this one-rank job,
    naming the 256 ranks it needs."""
    from repro_torch.launch import train as launcher
    assert launcher.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--steps", "2", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", str(tmp_path / "ck")]) == 0
    assert "[train] done at step 2" in capsys.readouterr().out
    assert launcher.main(["--arch", arch, "--production-mesh",
                          "--ckpt-dir", str(tmp_path / "mesh")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "needs 256 ranks" in err
    assert not (tmp_path / "mesh").exists()
