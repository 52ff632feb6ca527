"""PyTorch port, LM training slice: the differentiable SSD scan
(``_segsum``, ``ssd_chunked`` and its VJP), ``ssd_trainable`` on the CPU,
the chunked cross-entropy, ``loss_fn`` and its gradients for both
architectures, remat, and the train step (3 steps, ``grad_accum``,
``donate``), against the JAX package on the same numpy inputs and the
reference's weights (``lm.params_from_jax``), at the smoke variants."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import shape_applicable as j_shape_applicable
from repro.data.tokens import TokenStreamConfig as JTokenStreamConfig
from repro.data.tokens import sample_batch as j_sample_batch
from repro.kernels.ssd.ops import ssd_trainable as j_ssd_trainable
from repro.launch.mesh import make_host_mesh
from repro.models import lm as j_lm
from repro.nn import layers as j_layers
from repro.nn import ssm as j_ssm
from repro.train.steps import build_train_step as j_build_train_step
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.kernels.ssd import ssd as sd
from repro_torch.kernels.ssd.ops import ssd_trainable
from repro_torch.models import lm
from repro_torch.nn import layers, ssm
from repro_torch.train.steps import build_train_step, make_batch_specs
from repro_torch.utils import tree_map, tree_paths
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["internlm2-1.8b", "mamba2-780m"]
# the reference's own test_grad_accum_matches_single_shot
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5



def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _cfgs(arch, compute="float32", **kw):
    kw = dict(compute_dtype=compute, **kw)
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


# the reference's functions compiled whole: eager dispatch compiles each
# primitive on its own, which costs more than the tests' arithmetic
_j_init = jax.jit(j_lm.init_params, static_argnums=1)
_j_loss_and_grad = jax.jit(jax.value_and_grad(j_lm.loss_fn, has_aux=True),
                           static_argnums=2)


def _params(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    # the params do not depend on the compute dtype: one compile serves both
    jp = _j_init(jax.random.PRNGKey(0),
                 dataclasses.replace(jcfg, compute_dtype="float32"))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    return jcfg, cfg, jp, tree


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


def _close_grad(got, want, what):
    """rtol 1e-4, atol 1e-6 of the gradient's largest magnitude."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_remat_match_the_reference(arch):
    """SHAPES and shape_applicable equal the reference's; remat defaults to
    "full" and is "none" in the smoke variant, as there."""
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    for shape in SHAPES:
        assert shape_applicable(get_config(arch), shape) == \
            j_shape_applicable(j_get_config(arch), shape)
    assert get_config(arch).remat == j_get_config(arch).remat == "full"
    assert smoke_variant(get_config(arch)).remat == "none"


# ---------------------------------------------------------------------------
# the differentiable SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,init", [(64, 16, False), (64, 16, True),
                                          (48, 48, False), (48, 64, True)])
def test_ssd_chunked_and_its_vjp_match_the_reference(s, chunk, init):
    """y and the final state within rtol 1e-5, atol 1e-6 of the
    reference's ssd_chunked, with and without an initial state, at a chunk
    that divides s and at one equal to (or past) s; the VJP of both
    outputs for all six inputs within rtol 1e-4 and an atol of 1e-6 times
    each gradient's largest magnitude (dt's reach ~30 and cancel, so an
    element's roundoff is that of its largest terms)."""
    b, h, p, g, n = 2, 4, 8, 2, 8
    args = list(_ssd_inputs(s + chunk, b, s, h, p, g, n))
    rng = np.random.default_rng(s)
    args.append(rng.standard_normal((b, h, p, n)).astype(np.float32) if init
                else None)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)
    names = ["x", "dt", "A", "B", "C", "initial_state"][:5 + init]

    want_out, vjp = jax.vjp(
        jax.jit(lambda *a: j_ssm.ssd_chunked(*a[:5], chunk, *a[5:])),
        *map(jnp.asarray, args[:5 + init]))
    want_grads = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    live = [_t(a).requires_grad_() for a in args[:5 + init]]
    y, st = ssm.ssd_chunked(*live[:5], chunk, *live[5:])
    np.testing.assert_allclose(_np(y), _np(want_out[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(st), _np(want_out[1]), rtol=1e-5,
                               atol=1e-6)
    got = torch.autograd.grad((y, st), live, (_t(gy), _t(gs)))
    for name, a, w in zip(names, got, want_grads):
        _close_grad(a, w, name)
    a = rng.standard_normal((3, 2, 7)).astype(np.float32)
    np.testing.assert_array_equal(_np(ssm._segsum(_t(a))),
                                  _np(j_ssm._segsum(jnp.asarray(a))))


def test_ssd_chunked_refuses_a_ragged_sequence():
    args = map(_t, _ssd_inputs(0, 1, 200, 2, 8, 1, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(*args, 128)


def test_ssd_trainable_on_the_cpu_matches_the_reference():
    """tests/test_kernels.py's ssd_trainable inputs (b 1, s 32, h 2, p 8,
    g 1, n 4): y within relative error 1e-3 (K6's limit against ssd_ref;
    the CPU forward is the plain recurrence, the reference's the Pallas
    kernel in interpret mode); the gradients of sum(y²) for all five
    inputs within rtol 1e-4 and an atol of 1e-6 of each one's largest
    magnitude, as in the ssd_chunked test, since both sides differentiate
    ssd_chunked. No kernel launches on the CPU."""
    k = jax.random.split(jax.random.PRNGKey(11), 5)
    b, s, h, p, g, n = 1, 32, 2, 8, 1, 4
    args = (jax.random.normal(k[0], (b, s, h, p)),
            jax.nn.softplus(jax.random.normal(k[1], (b, s, h))),
            -jnp.exp(jax.random.normal(k[2], (h,)) * 0.3),
            jax.random.normal(k[3], (b, s, g, n)),
            jax.random.normal(k[4], (b, s, g, n)))
    y_ref, vjp = jax.vjp(jax.jit(j_ssd_trainable), *args)
    want_grads = vjp(2.0 * y_ref)                 # d sum(y²) / dy = 2y
    live = [_t(a).requires_grad_() for a in args]
    before = dict(sd.LAUNCHES)
    y = ssd_trainable(*live)
    assert sd.LAUNCHES == before and y.dtype == torch.float32
    assert np.abs(_np(y) - _np(y_ref)).max() <= 1e-3 * np.abs(_np(y_ref)).max()
    got = torch.autograd.grad(torch.sum(y ** 2), live)
    for name, a, w in zip("x dt A B C".split(), got, want_grads):
        _close_grad(a, w, name)


# ---------------------------------------------------------------------------
# cross-entropy and the loss
# ---------------------------------------------------------------------------

def test_chunked_cross_entropy_equals_the_full_one():
    """Padded vocab (250 of 256, the pad rows −inf): the chunked CE equals
    the mean of softmax_cross_entropy over the full logits (rtol 1e-6),
    which equals the reference's; its gradient to h is finite."""
    _, cfg = _cfgs("internlm2-1.8b", vocab_size=250)
    assert cfg.phys_vocab == 256
    jcfg, _, jp, tree = _params("internlm2-1.8b", vocab_size=250)
    p = lm.params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 96, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, 250, (2, 96))
    full = layers.softmax_cross_entropy(
        layers.unembed_apply(p["embed"], _t(h), cfg), torch.from_numpy(labels))
    want = j_layers.softmax_cross_entropy(
        j_layers.unembed_apply(jp["embed"], jnp.asarray(h), jcfg),
        jnp.asarray(labels))
    np.testing.assert_allclose(_np(full), _np(want), rtol=1e-6, atol=1e-6)
    hs = _t(h).requires_grad_()
    got = layers.chunked_cross_entropy(p["embed"], hs,
                                       torch.from_numpy(labels), cfg,
                                       seq_chunk=32)
    np.testing.assert_allclose(float(got), float(full.mean()), rtol=1e-6)
    got.backward()
    assert torch.isfinite(hs.grad).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_its_gradients_match_the_reference(arch):
    """loss_fn's loss, aux and gradient of every leaf against
    jax.value_and_grad(lm.loss_fn) from the same weights and batch.
    float32 compute: loss rtol 1e-5, gradients rtol 1e-4, atol 1e-6, and
    forward's logits rtol and atol 1e-5.
    bfloat16 compute, held as tests/test_torch_lm.py holds bf16 prefill
    logits (within 2^-6 of the largest magnitude): the loss within 2^-6
    relative, and every gradient element within 2^-6 of the tree's largest
    gradient element. A leaf small beside the largest is held by its
    noise instead: its bf16 gradient lies no further (L2) from the port's
    float32 gradient than 1.5 times the reference's bf16 gradient lies
    from the reference's float32 one (measured: at most 1.21 times)."""
    out = {}
    for compute in ("float32", "bfloat16"):
        jcfg, cfg, jp, tree = _params(arch, compute=compute)
        batch = _batch(cfg, 2, 64)
        (want, want_aux), jgrads = _j_loss_and_grad(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        params = lm.params_from_jax(tree, cfg, "cpu")
        loss, aux, got = _port_grads(params, batch, cfg)
        if compute == "float32":      # the logits of forward, too
            logits, lb = lm.forward(params, torch.from_numpy(
                batch["tokens"]), cfg)
            j_logits, _ = j_lm.forward(jp, jnp.asarray(batch["tokens"]),
                                       jcfg)
            np.testing.assert_allclose(_np(logits), _np(j_logits),
                                       rtol=1e-5, atol=1e-5)
            assert float(lb) == 0.0
        want_g = {k: _np(v) for k, v in tree_paths(jgrads)}
        assert set(got) == set(want_g)
        assert float(aux["lb"]) == float(want_aux["lb"]) == 0.0
        out[compute] = (float(loss), float(want),
                        {k: _np(v) for k, v in got.items()}, want_g)
    loss, want, got, want_g = out["float32"]
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    for path, g in got.items():
        np.testing.assert_allclose(g, want_g[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)
    loss, want, got, want_g = out["bfloat16"]
    assert abs(loss - want) <= 2.0 ** -6 * abs(want)
    top = max(np.abs(w).max() for w in want_g.values())
    for path, g in got.items():
        assert np.abs(g - want_g[path]).max() <= 2.0 ** -6 * top, path
        noise = np.linalg.norm(want_g[path] - out["float32"][3][path])
        assert (np.linalg.norm(g - out["float32"][2][path])
                <= 1.5 * noise), path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(arch):
    """remat "none", "full" and "dots": the same loss and gradients, bit
    for bit."""
    _, _, _, tree = _params(arch)
    batch = _batch(smoke_variant(get_config(arch)), 2, 64, seed=1)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = _cfgs(arch, remat=remat)[1]
        out[remat] = _port_grads(lm.params_from_jax(tree, cfg, "cpu"), batch,
                                 cfg)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for path, g in out["none"][2].items():
            assert torch.equal(out[remat][2][path], g), (remat, path)


def test_other_families_are_refused():
    """Every family trains now: all ten configs pass the trainability
    check and get batch specs (the vlm's with img_embed, the enc-dec's
    with frames). What stays refused is lm.loss_fn for an enc-dec config,
    which names encdec.loss_fn, and encdec.loss_fn for a decoder-only
    one."""
    from repro_torch.configs import list_archs
    from repro_torch.models import encdec
    from repro_torch.train.steps import check_trainable
    extra = {}
    for arch in list_archs():
        cfg = smoke_variant(get_config(arch))
        check_trainable(cfg)
        extra[arch] = set(make_batch_specs(
            cfg, ShapeConfig("t", "train", 8, 2))) - {"tokens", "labels"}
    assert len(extra) == 10
    assert extra.pop("llama-3.2-vision-90b") == {"img_embed"}
    assert extra.pop("seamless-m4t-large-v2") == {"frames"}
    assert not any(extra.values())
    with pytest.raises(NotImplementedError, match="encdec.loss_fn"):
        lm.loss_fn({}, {}, smoke_variant(get_config("seamless-m4t-large-v2")))
    with pytest.raises(NotImplementedError, match="models/lm.py"):
        encdec.loss_fn({}, {}, smoke_variant(get_config("qwen3-32b")))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _reference_steps(jcfg, jp, shape, batches, lr):
    """The reference's train step over ``batches``: per step (loss, gnorm,
    params, opt state) as numpy. Its outputs carry NamedShardings that its
    own embedding gather rejects on the next call, so params and opt state
    go through numpy between calls."""
    out = []
    with make_host_mesh() as mesh:
        step, _, opt = j_build_train_step(jcfg, shape, mesh, lr=lr,
                                          donate=False)
        jo = opt.init(jp)
        for b in batches:
            jp, jo, m = step(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
            jp, jo = (jax.tree.map(np.asarray, t) for t in (jp, jo))
            out.append((float(m["loss"]), float(m["gnorm"]), jp, jo))
            jp, jo = (jax.tree.map(jnp.asarray, t) for t in (jp, jo))
    return out


def _port_steps(cfg, tree, shape, batches, lr, **kw):
    step, specs, opt = build_train_step(cfg, shape, lr=lr, device="cpu", **kw)
    p = lm.params_from_jax(tree, cfg, device="cpu")
    o = opt.init(p)
    out = []
    for b in batches:
        p, o, m = step(p, o, {k: torch.from_numpy(np.array(v, np.int64))
                              for k, v in b.items()})
        out.append((m["loss"], m["gnorm"],
                    tree_map(torch.clone, {"params": p, "opt": o})))
    return out, specs


def _close_state(got, want):
    want = dict(tree_paths(want))
    for path, a in tree_paths(got):
        np.testing.assert_allclose(_np(a), _np(want[path]), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(arch):
    """3 steps (lr 1e-3, float32 compute) from the reference's weights on
    the reference's token-stream batches: per step loss within rtol 1e-5,
    gnorm within 1e-4, params and AdamW moments within rtol 2e-4, atol
    2e-5 (the reference's own grad-accumulation tolerance). grad_accum=2
    holds to grad_accum=1 at that tolerance, and donate=True (the update
    written in place) gives the same bits as donate=False."""
    jcfg, cfg, jp, tree = _params(arch)
    B, S = 4, 64
    batches = [jax.tree.map(np.asarray, j_sample_batch(
        JTokenStreamConfig(jcfg.vocab_size, S, B), jnp.asarray(i)))
        for i in range(3)]
    want = _reference_steps(jcfg, jp, JShapeConfig("t", "train", S, B),
                            batches, 1e-3)
    shape = ShapeConfig("t", "train", S, B)
    got, specs = _port_steps(cfg, tree, shape, batches, 1e-3, donate=False)
    assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == {
        k: ((B, S), torch.int64) for k in ("tokens", "labels")}
    for (loss, gnorm, state), (j_loss, j_gnorm, j_p, j_o) in zip(got, want):
        np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
        np.testing.assert_allclose(float(gnorm), j_gnorm, rtol=1e-4)
        _close_state(state, {"params": j_p, "opt": j_o})
    donated, _ = _port_steps(cfg, tree, shape, batches, 1e-3, donate=True)
    for (l1, g1, s1), (l2, g2, s2) in zip(got, donated):
        assert torch.equal(l1, l2) and torch.equal(g1, g2)
        for (path, a), (_, b) in zip(tree_paths(s1), tree_paths(s2)):
            assert torch.equal(a, b), path
    accum, _ = _port_steps(cfg, tree, shape, batches, 1e-3, grad_accum=2)
    for (l1, g1, s1), (l2, g2, s2) in zip(got, accum):
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
        _close_state(s2, s1)


def test_donated_step_updates_its_inputs_in_place():
    """donate=True returns the tensors it was given, updated; donate=False
    leaves them as they were. A batch of the wrong shape is refused."""
    cfg = _cfgs("mamba2-780m")[1]
    shape = ShapeConfig("t", "train", 32, 2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 32).items()}
    for donate in (False, True):
        step, _, opt = build_train_step(cfg, shape, lr=1e-3, donate=donate,
                                        device="cpu")
        p = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        o = opt.init(p)
        before = tree_map(torch.clone, p)
        p2, o2, _ = step(p, o, batch)
        w, w0 = p["embed"]["embedding"], before["embed"]["embedding"]
        assert (p2["embed"]["embedding"] is w) == donate
        assert torch.equal(w, w0) != donate
        assert int(o["step"]) == int(donate) and int(o2["step"]) == 1
    with pytest.raises(ValueError, match="the step takes"):
        step(p, o, {k: v[:, :16] for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases_over_steps(arch):
    """The contract of the reference's tests/test_train_step.py (red
    there on this JAX: its step rejects its own outputs): 5 steps on one
    batch at lr 1e-3 in float32 compute, the loss falls."""
    cfg = _cfgs(arch)[1]
    step, _, opt = build_train_step(cfg, ShapeConfig("t", "train", 32, 4),
                                    lr=1e-3, device="cpu")
    p = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = opt.init(p)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 32).items()}
    losses = []
    for _ in range(5):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
