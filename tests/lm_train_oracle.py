"""The reference's LM training oracles and the checks that hold the port
to them (not collected: no ``test_`` prefix), shared by
tests/test_torch_lm_train_dense.py and tests/test_torch_lm_train_cross.py
at tests/test_torch_lm_train_families.py's tolerances. Weights are the
reference's smoke weights carried across by ``params_from_jax``; the
batches are numpy draws fed to both sides: tokens and labels, and the
vlm's ``img_embed`` or the enc-dec's ``frames`` (standard normal,
float32; each side casts them to its compute dtype)."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.tokens import TokenStreamConfig as JTokenStreamConfig
from repro.data.tokens import sample_batch as j_sample_batch
from repro.launch.mesh import make_host_mesh
from repro.models import encdec as j_encdec
from repro.models import lm as j_lm
from repro.train.steps import build_train_step as j_build_train_step
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.train.steps import _loss_for, build_train_step
from repro_torch.utils import tree_map, tree_paths

from adam_close import close_state

# float32 gradients: rtol 1e-4, atol GRAD_ATOL; bf16: elements within
# BF16_REL of the largest float32 gradient element
GRAD_ATOL = 1e-6
BF16_REL = 2.0 ** -6


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def cfgs(arch: str, compute: str = "float32", **kw):
    """(JAX config, port config) of ``arch``'s smoke variant, ``kw``
    replaced in both."""
    kw = dict(kw, compute_dtype=compute)
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


def _j_mod(cfg):
    return j_encdec if cfg.is_encdec else j_lm


def _mod(cfg):
    return encdec if cfg.is_encdec else lm


# the reference's functions compiled whole, one per model module
_j_init = {m: jax.jit(m.init_params, static_argnums=1)
           for m in (j_lm, j_encdec)}
_j_loss_and_grad = {m: jax.jit(jax.value_and_grad(m.loss_fn, has_aux=True),
                               static_argnums=2) for m in (j_lm, j_encdec)}


def params(arch: str, compute: str = "float32", **kw):
    """(jcfg, cfg, JAX params, numpy tree): the reference's smoke weights,
    drawn at float32 compute (the params do not depend on it)."""
    jcfg, cfg = cfgs(arch, compute, **kw)
    jp = _j_init[_j_mod(jcfg)](jax.random.PRNGKey(0),
                               dataclasses.replace(jcfg,
                                                   compute_dtype="float32"))
    return jcfg, cfg, jp, jax.tree.map(
        lambda a: np.asarray(a, dtype=np.float32), jp)


def extras(cfg, B: int, S: int, seed: int) -> dict:
    """The batch keys beyond tokens and labels, numpy float32."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["img_embed"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return out


def batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (B, S))
           for k in ("tokens", "labels")}
    return dict(out, **extras(cfg, B, S, seed + 100))


def to_port(b: dict) -> dict:
    """A numpy batch as the port's tensors: int64 tokens, float32 rest."""
    return {k: torch.from_numpy(np.array(
        v, np.int64 if k in ("tokens", "labels") else np.float32))
        for k, v in b.items()}


def port_grads(p, b: dict, cfg):
    """(loss, aux, {path: grad}) of the port's loss for ``cfg``."""
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    paths, leaves = zip(*tree_paths(live))
    loss, aux = _loss_for(cfg)(live, to_port(b), cfg)
    return loss, aux, dict(zip(paths, torch.autograd.grad(loss, leaves)))


def port_forward(p, b: dict, cfg) -> torch.Tensor:
    t = to_port(b)
    if cfg.is_encdec:
        return encdec.forward(p, t["frames"], t["tokens"], cfg)
    return lm.forward(p, t["tokens"], cfg, img_embed=t.get("img_embed"))[0]


def reference_forward(jp, b: dict, jcfg):
    if jcfg.is_encdec:
        return j_encdec.forward(jp, jnp.asarray(b["frames"]),
                                jnp.asarray(b["tokens"]), jcfg)
    img = b.get("img_embed")
    return j_lm.forward(jp, jnp.asarray(b["tokens"]), jcfg,
                        img_embed=None if img is None else jnp.asarray(img)
                        )[0]


@functools.cache
def reference_grads(arch: str, compute: str, kw: tuple, B: int, S: int):
    """The reference's (loss, {aux}, {path: grad}) as floats and numpy, at
    ``batch(cfg, B, S)``; one value_and_grad a config and compute dtype."""
    jcfg, _, jp, _ = params(arch, compute, **dict(kw))
    (loss, aux), g = _j_loss_and_grad[_j_mod(jcfg)](
        jp, {k: jnp.asarray(v) for k, v in batch(jcfg, B, S).items()}, jcfg)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            {k: np32(v) for k, v in tree_paths(g)})


def check_loss_and_grads(arch: str, **kw) -> None:
    """loss_fn's loss, its parts and the gradient of every leaf against
    jax.value_and_grad of the reference's loss_fn (2 x 64 tokens).
    float32 compute: loss and parts rtol 1e-5, gradients rtol 1e-4 and
    atol 1e-6, forward's logits rtol and atol 1e-5. bfloat16: loss and
    parts within 2^-6 relative, every gradient element within 2^-6 of the
    largest element from the reference's float32 gradient, and each leaf's
    bf16 gradient no further (L2) from the port's float32 one than 1.5
    times the reference's bf16 gradient lies from its float32 one."""
    B, S = 2, 64
    got = {}
    for compute in ("float32", "bfloat16"):
        jcfg, cfg, jp, tree = params(arch, compute, **kw)
        p = _mod(cfg).params_from_jax(tree, cfg, "cpu")
        loss, aux, g = port_grads(p, batch(cfg, B, S), cfg)
        want_loss, want_aux, want_g = reference_grads(
            arch, compute, tuple(sorted(kw.items())), B, S)
        assert set(g) == set(want_g)
        assert set(aux) == set(want_aux)
        got[compute] = (loss.item(), {k: v.item() for k, v in aux.items()},
                        {k: np32(v) for k, v in g.items()})
        if compute == "float32":
            np.testing.assert_allclose(got[compute][0], want_loss, rtol=1e-5)
            for k, v in want_aux.items():
                np.testing.assert_allclose(got[compute][1][k], v, rtol=1e-5,
                                           err_msg=k)
            for path, a in got[compute][2].items():
                np.testing.assert_allclose(a, want_g[path], rtol=1e-4,
                                           atol=GRAD_ATOL, err_msg=path)
            b = batch(cfg, B, S)
            np.testing.assert_allclose(
                np32(port_forward(p, b, cfg)),
                np32(reference_forward(jp, b, jcfg)), rtol=1e-5, atol=1e-5)
    loss16, aux16, g16 = got["bfloat16"]
    want_loss, want_aux, want16 = reference_grads(
        arch, "bfloat16", tuple(sorted(kw.items())), B, S)
    assert abs(loss16 - want_loss) <= BF16_REL * abs(want_loss)
    for k, v in want_aux.items():
        assert abs(aux16[k] - v) <= BF16_REL * abs(v), k
    exact = reference_grads(arch, "float32", tuple(sorted(kw.items())),
                            B, S)[2]
    top = max(np.abs(w).max() for w in exact.values())
    for path, a in g16.items():
        assert np.abs(a - exact[path]).max() <= BF16_REL * top, path
        noise = np.linalg.norm(want16[path] - exact[path])
        assert np.linalg.norm(a - got["float32"][2][path]) <= 1.5 * noise, \
            path


def check_remat_bits(arch: str, **kw) -> None:
    """remat "none", "full" and "dots": the same loss, parts and gradients,
    bit for bit."""
    tree = params(arch, **kw)[3]
    b = batch(cfgs(arch, **kw)[1], 2, 64, seed=1)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = cfgs(arch, remat=remat, **kw)[1]
        out[remat] = port_grads(_mod(cfg).params_from_jax(tree, cfg, "cpu"),
                                b, cfg)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for k, v in out["none"][1].items():
            assert torch.equal(out[remat][1][k], v), (remat, k)
        for path, g in out["none"][2].items():
            assert torch.equal(out[remat][2][path], g), (remat, path)


def step_batches(cfg, B: int, S: int, n: int = 3) -> list[dict]:
    """The reference's token-stream batches, each with its own extras."""
    return [dict(jax.tree.map(np.asarray, j_sample_batch(
        JTokenStreamConfig(cfg.vocab_size, S, B), jnp.asarray(i))),
        **extras(cfg, B, S, seed=10 + i)) for i in range(n)]


def reference_steps(jcfg, jp, B: int, S: int, batches, lr: float,
                    grad_accum: int = 1):
    """The reference's build_train_step in its host mesh: per step (loss,
    gnorm, params, opt state) as numpy; params and opt state go through
    numpy between calls (its outputs' shardings are rejected by its next
    call)."""
    out = []
    with make_host_mesh() as mesh:
        step, _, opt = j_build_train_step(jcfg, JShapeConfig("t", "train",
                                                             S, B),
                                          mesh, lr=lr, donate=False,
                                          grad_accum=grad_accum)
        jo = opt.init(jp)
        for b in batches:
            jp, jo, m = step(jp, jo, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            jp, jo = (jax.tree.map(np.asarray, t) for t in (jp, jo))
            out.append((float(m["loss"]), float(m["gnorm"]), jp, jo))
            jp, jo = (jax.tree.map(jnp.asarray, t) for t in (jp, jo))
    return out


def port_steps(cfg, tree, B: int, S: int, batches, lr: float, **kw):
    """The port's build_train_step from the reference's weights: per step
    (loss, gnorm, a copy of {"params", "opt"})."""
    step, _, opt = build_train_step(cfg, ShapeConfig("t", "train", S, B),
                                    lr=lr, device="cpu", **kw)
    p = _mod(cfg).params_from_jax(tree, cfg, device="cpu")
    o = opt.init(p)
    out = []
    for b in batches:
        p, o, m = step(p, o, to_port(b))
        out.append((m["loss"], m["gnorm"],
                    tree_map(torch.clone, {"params": p, "opt": o})))
    return out


def close_steps(got, want, lr: float, exempt: bool = False) -> None:
    """Per step: loss within rtol 1e-5, gnorm within 1e-4, params and
    AdamW moments by tests/adam_close.py (rtol 2e-4, atol 2e-5; with
    ``exempt``, save AdamW's ill-conditioned elements, whose gradients are
    held to rtol 1e-4, atol 1e-6)."""
    assert len(got) == len(want)
    carry = {}
    for t, ((loss, gnorm, state), (j_loss, j_gnorm, j_p, j_o)) in enumerate(
            zip(got, want), 1):
        np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
        np.testing.assert_allclose(float(gnorm), j_gnorm, rtol=1e-4)
        ref = {k: np32(v) for k, v in tree_paths({"params": j_p,
                                                  "opt": j_o})}
        close_state({k: np32(v) for k, v in tree_paths(state)}, ref, t, lr,
                    carry, exempt)


def check_train_steps(arch: str, exempt: bool = False, **kw) -> None:
    """3 steps (lr 1e-3, float32 compute, batch 4 x 64) from the
    reference's weights, held to the reference's build_train_step; then
    grad_accum=2 (every batch key sliced into 2 microbatches) held to the
    reference's grad_accum=2. ``exempt``: see close_steps."""
    jcfg, cfg, jp, tree = params(arch, **kw)
    B, S = 4, 64
    batches = step_batches(cfg, B, S)
    for accum in (1, 2):
        close_steps(port_steps(cfg, tree, B, S, batches, 1e-3,
                               grad_accum=accum),
                    reference_steps(jcfg, jp, B, S, batches, 1e-3,
                                    grad_accum=accum), 1e-3, exempt)
