"""PyTorch port, the served LM families beyond dense and ssm: qk-norm
(qwen3), GeGLU with head dim 256 (gemma), padded heads (phi4), MoE
(granite, grok) and hybrid (zamba2), against the JAX package on the same
numpy inputs: the layers, ``moe_apply``, prefill and decode, the slot
server, and K5's plain version at head dims 112 and 256. Float32 compute
unless a test says otherwise; the reference's smoke weights carried across
by ``params_from_jax``. Training moe and hybrid is held in
tests/test_torch_lm_train_families.py, GeGLU, qk-norm and padded heads in
tests/test_torch_lm_train_dense.py."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import lm as j_lm
from repro.nn import layers as j_layers
from repro.nn import moe as j_moe
from repro.serve.slots import SlotManager as JSlotManager
from repro.serve.steps import serve_config as j_serve_config
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import lm
from repro_torch.nn import layers, moe
from repro_torch.serve.steps import serve_config
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ["phi4-mini-3.8b", "gemma-7b", "qwen3-32b", "granite-moe-1b-a400m",
            "grok-1-314b", "zamba2-7b"]
ATOL = 2e-4            # prefill/decode vs the reference (tests/test_models.py)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=atol, atol=atol,
                               err_msg=what)


def _cfgs(arch: str, compute: str = "float32", param: str = "float32", **kw):
    """(JAX config, port config) of the smoke variant, same numerics."""
    kw.update(compute_dtype=compute, param_dtype=param)
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


def _params(arch: str, **kw):
    """JAX-initialised smoke params and the port's copy of them."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = j_lm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, _port_params(jp, cfg)


def _port_params(jp, cfg):
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    return lm.params_from_jax(tree, cfg, device="cpu")


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close_trees(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path in got:
        _close(got[path], want[path], atol, path)


# ---------------------------------------------------------------------------
# layers: qk-norm, GeGLU
# ---------------------------------------------------------------------------

def test_project_qkv_with_qk_norm():
    """qwen3's q and k normalised per head before rope (scales off 1, so a
    norm applied after rope, or not at all, would show)."""
    jcfg, cfg = _cfgs("qwen3-32b")
    jp = j_lm.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    for name in ("q_norm", "k_norm"):
        scale = rng.uniform(0.5, 1.5, jp["blocks"]["attn"][name].shape)
        jp["blocks"]["attn"][name] = jnp.asarray(scale, jnp.float32)
    p = _port_params(jp, cfg)
    assert p["blocks"]["attn"]["q_norm"].shape == (2, 16)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.arange(9)[None, :]
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    want = j_layers.project_qkv(jattn, jnp.asarray(x), jnp.asarray(x), jcfg,
                                jnp.asarray(pos), jnp.asarray(pos))
    got = layers.project_qkv(lm._layer(p["blocks"], 0)["attn"], _t(x), _t(x),
                             cfg, torch.from_numpy(pos), torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_gelu_is_the_tanh_form_and_geglu_matches():
    """``_act("gelu")`` is jax.nn.gelu's default tanh approximation (the
    exact erf form differs by up to ~5e-4 over this range), and gemma's
    GeGLU mlp_apply equals the reference's."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    _close(layers._act(_t(x), "gelu"), want, 1e-6)
    erf = torch.nn.functional.gelu(_t(x))
    assert np.abs(_np(erf) - want).max() > 1e-4
    jcfg, cfg, jp, p = _params("gemma-7b")
    xm = np.random.default_rng(3).standard_normal((2, 7, 64)).astype(
        np.float32)
    jmlp = jax.tree.map(lambda a: a[1], jp["blocks"]["mlp"])
    _close(layers.mlp_apply(lm._layer(p["blocks"], 1)["mlp"], _t(xm), cfg),
           j_layers.mlp_apply(jmlp, jnp.asarray(xm), jcfg), 1e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["drops", "dropless", "groups2"])
def test_moe_apply_matches_reference(case):
    """moe_apply against the reference's on granite's smoke variant (4
    experts, top 2): y, lb_loss and drop_frac. ``drops``: capacity factor
    1.25 on tokens skewed toward one expert, so both sides drop the same
    (token, choice) pairs; ``dropless``: the serving capacity E / K;
    ``groups2``: two dispatch groups, each with its own capacity."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    if case == "dropless":
        jcfg, cfg = (dataclasses.replace(c, capacity_factor=2.0)
                     for c in (jcfg, cfg))
    jp = j_moe.moe_init(jax.random.PRNGKey(4), jcfg)
    p = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    if case == "drops":
        w0 = np.asarray(jp["router"])[:, 0]
        x += 3.0 * w0 / np.linalg.norm(w0)
    groups = 2 if case == "groups2" else 1
    y, aux = moe.moe_apply(p, _t(x), cfg, groups=groups)
    jy, jaux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg, groups=groups)
    _close(y, jy, 1e-5)
    _close(aux["lb_loss"], jaux["lb_loss"], 1e-6)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    if case == "drops":
        assert float(aux["drop_frac"]) > 0
    else:
        assert case == "groups2" or float(aux["drop_frac"]) == 0


def test_serving_moe_is_dropless():
    cfg = serve_config(get_config("granite-moe-1b-a400m"))
    jcfg = j_serve_config(j_get_config("granite-moe-1b-a400m"))
    assert cfg.capacity_factor == jcfg.capacity_factor == 32 / 8
    assert moe.capacity(2048, cfg) == j_moe.capacity(2048, jcfg) == 2048


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [(a, {}) for a in FAMILIES]
                         + [("phi4-mini-3.8b", {"tp_multiple": 8})],
                         ids=FAMILIES + ["phi4-mini-3.8b-tp8"])
def test_prefill_then_decode_matches_reference(arch, kw):
    """Prefill S tokens, then decode token S: last logits and every cache
    leaf within 2e-4 of the reference's, and the decode equal to the last
    logits of a prefill of S + 1 tokens. ``tp8``: phi4 with heads padded
    (4 → 8 query heads, 2 → 8 kv heads)."""
    jcfg, cfg, jp, p = _params(arch, **kw)
    if kw:
        assert cfg.phys_heads == 8 > cfg.n_heads
    B, S, max_len = 2, 12, 16
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 1))
    last, cache = lm.prefill(p, torch.from_numpy(tokens[:, :S]), cfg,
                             max_len=max_len)
    j_last, j_cache = j_lm.prefill(jp, jnp.asarray(tokens[:, :S]), jcfg,
                                   max_len=max_len)
    _close(last, j_last, ATOL)
    _close_trees(cache, j_cache, ATOL)
    dec, cache = lm.decode_step(p, torch.from_numpy(tokens[:, S:]),
                                torch.tensor(S), cache, cfg)
    j_dec, j_cache = j_lm.decode_step(jp, jnp.asarray(tokens[:, S:]),
                                      jnp.asarray(S, jnp.int32), j_cache,
                                      jcfg)
    _close(dec, j_dec, ATOL)
    _close_trees(cache, j_cache, ATOL)
    longer, _ = lm.prefill(p, torch.from_numpy(tokens), cfg)
    _close(dec[:, 0], longer, ATOL)


def _place(big, small, slot, axis):
    """numpy: ``small``'s batch row into ``big`` at ``slot`` on ``axis``."""
    big = np.array(big)
    idx = [slice(None)] * big.ndim
    idx[axis] = slice(slot, slot + 1)
    big[tuple(idx)] = np.asarray(small)
    return big


def _batch_axis(path: str) -> int:
    """The reference's cache layout: a hybrid SSM leaf is [n_groups, k, B,
    ...], every other leaf [n, B, ...]."""
    return 2 if path.startswith("/ssm/") else 1


def _place_tree(big, small, slot):
    flat = {path: _place(b, dict(_leaves(small))[path], slot,
                         _batch_axis(path))
            for path, b in _leaves(big)}
    out: dict = {}
    for path, v in flat.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_per_row_decode_matches_reference(arch):
    """Rows decoding at different positions in one batch: each prompt
    prefilled alone and placed into a batch-3 cache on each leaf's batch
    axis (numpy, on the reference's side), then one per-row decode step in
    each package."""
    jcfg, cfg, jp, p = _params(arch)
    assert lm.cache_batch_axes(cfg) == (
        {"ssm": {"conv_x": 2, "conv_bc": 2, "state": 2},
         "attn": {"k": 1, "v": 1}} if cfg.family == "hybrid"
        else {"k": 1, "v": 1})
    Bn, max_len, lens = 3, 24, [5, 9, 14]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    cache = lm.init_cache(cfg, Bn, max_len, device="cpu")
    j_cache = j_lm.init_cache(jcfg, Bn, max_len)
    toks = []
    for i, pr in enumerate(prompts):
        logits_i, c1 = lm.prefill(p, torch.from_numpy(pr), cfg,
                                  max_len=max_len)
        for (_, big), (path, small) in zip(_leaves(cache), _leaves(c1)):
            big.narrow(_batch_axis(path), i, 1).copy_(small)
        _, jc1 = j_lm.prefill(jp, jnp.asarray(pr), jcfg, max_len=max_len)
        j_cache = _place_tree(j_cache, jc1, i)
        toks.append(int(torch.argmax(logits_i[0])))
    tok = np.array(toks)[:, None]
    got, _ = lm.decode_step(p, torch.from_numpy(tok), torch.tensor(lens),
                            cache, cfg)
    want, _ = j_lm.decode_step(jp, jnp.asarray(tok),
                               jnp.asarray(lens, jnp.int32), j_cache, jcfg)
    _close(got, want, ATOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_prefill_then_decode_bf16_matches_reference(arch):
    """Serving numerics (bf16 compute) on the CPU: prefill, then three
    greedy decode steps in both packages from the same weights and
    prompt. Every last-logit row agrees within 2^-6 of its largest
    magnitude and the greedy tokens are equal."""
    jcfg, cfg, jp, p = _params(arch, compute="bfloat16")
    B, S, n_dec = 2, 12, 3
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    last, cache = lm.prefill(p, torch.from_numpy(tokens), cfg,
                             max_len=S + n_dec)
    j_last, j_cache = j_lm.prefill(jp, jnp.asarray(tokens), jcfg,
                                   max_len=S + n_dec)
    got, want = [], []
    for i in range(n_dec + 1):
        a, b = _np(last), _np(j_last)
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max(), i
        got.append(a.argmax(-1))
        want.append(b.argmax(-1))
        if i == n_dec:
            break
        last, cache = lm.decode_step(p, torch.from_numpy(got[-1][:, None]),
                                     torch.tensor(S + i), cache, cfg)
        j_last, j_cache = j_lm.decode_step(
            jp, jnp.asarray(want[-1][:, None]), jnp.asarray(S + i, jnp.int32),
            j_cache, jcfg)
        last, j_last = last[:, 0], j_last[:, 0]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


# ---------------------------------------------------------------------------
# the slot server
# ---------------------------------------------------------------------------

def _prompts(vocab: int, n: int = 5):
    rng = np.random.default_rng(9)
    return [rng.integers(0, vocab, 6 + 2 * (i % 2)) for i in range(n)]


def _port_serve(cfg, jp, prompts):
    from repro_torch.launch.serve import Request, SlotServer, serve
    server = SlotServer(cfg, batch=2, max_len=32, device="cpu")
    server.load(_port_params(jp, server.cfg))
    assert server.params["embed"]["embedding"].dtype == torch.bfloat16
    reqs = [Request(i, torch.from_numpy(pr), max_new=4)
            for i, pr in enumerate(prompts)]
    done, _ = serve(server, reqs)
    assert len(done) == len(prompts) > server.batch
    assert server.slots.is_empty()
    return [r.rid for r in done], [r.generated for r in reqs]


def test_slot_server_generates_the_reference_tokens_moe():
    """granite's smoke variant: the reference's SlotServer and the port's,
    float32 compute over the same bf16 serving weights and prompts, give
    the same tokens, lanes recycled. The reference's server runs outside
    its host mesh: inside it, its moe_apply pins the expert buffer to the
    mesh's "model" axis with with_sharding_constraint, which this JAX
    refuses on the mesh's Explicit axes (src/repro/nn/moe.py:134)."""
    from repro.launch.serve import Request as JRequest
    from repro.launch.serve import SlotServer as JSlotServer
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    prompts = _prompts(cfg.vocab_size)
    jserver = JSlotServer(jcfg, None, batch=2, max_len=32)
    jp = j_lm.init_params(jax.random.PRNGKey(0), jserver.cfg)
    jserver.load(jp)
    jreqs = [JRequest(i, jnp.asarray(pr, jnp.int32), max_new=4)
             for i, pr in enumerate(prompts)]
    queue, jdone = list(jreqs), []
    while len(jdone) < len(jreqs):
        while queue and jserver.admit(queue[0]):
            queue.pop(0)
        jdone.extend(jserver.step())
    order, tokens = _port_serve(cfg, jp, prompts)
    assert order == [r.rid for r in jdone]
    assert tokens == [r.generated for r in jreqs]


def _oracle_serve(jcfg, jp, prompts, batch=2, max_len=32, max_new=4):
    """The reference's functions driven as a slot server: each prompt
    prefilled alone by ``lm.prefill``, its cache placed into the batch
    cache with numpy on each leaf's batch axis (the reference's own
    SlotServer.admit places every leaf on axis 1, which a hybrid SSM leaf
    [n_groups, k, B, ...] does not have as its batch axis), then
    ``lm.decode_step`` at per-row positions."""
    cache = j_lm.init_cache(jcfg, batch, max_len)
    decode = jax.jit(lambda p, t, pos, c: j_lm.decode_step(p, t, pos, c,
                                                           jcfg))
    slots = JSlotManager(batch)
    pos = np.zeros(batch, np.int32)
    gen = {i: [] for i in range(len(prompts))}
    queue, done = list(range(len(prompts))), []
    while len(done) < len(prompts):
        while queue:
            slot = slots.admit(queue[0])
            if slot is None:
                break
            rid = queue.pop(0)
            logits, c1 = j_lm.prefill(jp, jnp.asarray(prompts[rid])[None],
                                      jcfg, max_len=max_len)
            cache = _place_tree(cache, c1, slot)
            gen[rid].append(int(jnp.argmax(logits[0])))
            pos[slot] = len(prompts[rid])
        tok = np.array([[gen[slots.get(i)][-1] if slots.get(i) is not None
                         else 0] for i in range(batch)], np.int32)
        logits, cache = decode(jp, jnp.asarray(tok), jnp.asarray(pos), cache)
        nxt = np.asarray(jnp.argmax(logits[:, 0], axis=-1))
        for i, rid in list(slots.occupied()):
            gen[rid].append(int(nxt[i]))
            pos[i] += 1
            if len(gen[rid]) >= max_new:
                done.append(rid)
                slots.release(i)
    return done, [gen[i] for i in range(len(prompts))]


def test_slot_server_generates_the_oracle_tokens_hybrid():
    """zamba2's smoke variant: the port's SlotServer (admit on each leaf's
    own batch axis) and the in-test oracle over the reference's prefill
    and decode generate the same tokens in the same order."""
    jcfg, cfg = _cfgs("zamba2-7b")
    jscfg = j_serve_config(jcfg)
    jp = j_lm.init_params(jax.random.PRNGKey(0), jscfg)
    prompts = _prompts(cfg.vocab_size)
    want_order, want = _oracle_serve(jscfg, jp, prompts)
    order, tokens = _port_serve(cfg, jp, prompts)
    assert order == want_order
    assert tokens == want


@pytest.mark.parametrize("arch", ["zamba2-7b", "grok-1-314b"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3"]) == 0
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# K5's plain version at the new head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [112, 256])
@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 50)])
def test_flash_attention_plain_wide_heads(d, causal, kv_len):
    """K5's plain version at zamba2's and gemma's head dims against the
    reference's attention_ref (1e-5)."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 70, d)).astype(np.float32)
               for _ in range(3))
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, kv_len=kv_len)
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, kv_len=kv_len)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b"])
def test_training_launcher_refuses_moe(arch, tmp_path, capsys):
    """MoE trains (tests/test_torch_lm_train_families.py); the launcher's
    production mesh needs 256 ranks, so a one-rank job exits 2, writing
    nothing."""
    from repro_torch.launch import train as launcher
    assert launcher.main(["--arch", arch, "--smoke", "--production-mesh",
                          "--ckpt-dir", str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "needs 256 ranks" in err
    assert not list(tmp_path.iterdir())


def test_moe_and_hybrid_training_are_refused(tmp_path, capsys):
    """Training refuses no family now: each of the ten configs at full
    width passes the trainability check (moe, hybrid, GeGLU, qk-norm,
    padded heads, vlm, enc-dec). The launcher exits 2 for each with
    --multi-pod on a one-rank job (it needs 512 ranks), writing
    nothing."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import train as launcher
    from repro_torch.train.steps import check_trainable
    for arch in list_archs():
        check_trainable(get_config(arch))
        assert launcher.main(["--arch", arch, "--multi-pod", "--ckpt-dir",
                              str(tmp_path)]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error:") and "needs 512 ranks" in err
    assert not list(tmp_path.iterdir())
