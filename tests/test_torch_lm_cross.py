"""PyTorch port, the cross-attention families: vlm (llama-3.2-vision) and
enc-dec (seamless-m4t), against the JAX package on the same numpy inputs:
``project_qkv`` without rope, ``project_q``, ``cross_attention``, K5's
plain version without the causal mask at Sq != Skv, the vlm prefill and
decode (one and two groups, per-row positions), the enc-dec encoder,
prefill and decode, bf16 serving numerics for both, and what stays
refused (training both on a sharded mesh, ``SlotServer`` and the serve
launcher for both).
Float32 compute unless a test says otherwise; the reference's smoke
weights carried across by ``params_from_jax``."""
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
from repro.models import encdec as j_encdec
from repro.models import lm as j_lm
from repro.nn import layers as j_layers
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.models import encdec, lm
from repro_torch.nn import layers
from torch_threads import one_torch_thread  # noqa: F401

VLM, ENCDEC = "llama-3.2-vision-90b", "seamless-m4t-large-v2"
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


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close_trees(got, want, atol):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), path
        _close(g, w, atol, path)


def _cfgs(arch: str, compute: str = "float32", **kw):
    """(JAX config, port config) of the smoke variant, same numerics."""
    kw.update(compute_dtype=compute, param_dtype="float32")
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


def _params(arch: str, **kw):
    """JAX-initialised smoke params and the port's copy of them."""
    jcfg, cfg = _cfgs(arch, **kw)
    jmod, mod = (j_encdec, encdec) if cfg.is_encdec else (j_lm, lm)
    jp = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    return jcfg, cfg, jp, mod.params_from_jax(tree, cfg, device="cpu")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_cross_projections_and_attention():
    """A vlm cross block's projections (K/V from vision_dim 32 rows, not
    d_model 64), without rope, and the plain cross_attention."""
    jcfg, cfg, jp, p = _params(VLM)
    assert cfg.vision_dim != cfg.d_model
    jx = jax.tree.map(lambda a: a[0], jp["cross_blocks"]["xattn"])
    px = lm._layer(p["cross_blocks"], 0)["xattn"]
    assert px["wk"].shape == (cfg.vision_dim, cfg.phys_kv_heads * 16)
    x, mem = _normal(1, (2, 9, 64)), _normal(2, (2, 8, 32))
    want = j_layers.project_qkv(jx, jnp.asarray(x), jnp.asarray(mem), jcfg,
                                None, None, use_rope=False)
    got = layers.project_qkv(px, _t(x), _t(mem), cfg, None, None,
                             use_rope=False)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    _close(layers.project_q(px, _t(x), cfg),
           j_layers.project_q(jx, jnp.asarray(x), jcfg), 1e-5)
    _close(layers.cross_attention(px, _t(x), _t(mem), cfg),
           j_layers.cross_attention(jx, jnp.asarray(x), jnp.asarray(mem),
                                    jcfg), 1e-5)
    # positions None means arange, with rope
    sa = lm._layer(p["blocks"], (0, 0))["attn"]
    jsa = jax.tree.map(lambda a: a[0, 0], jp["blocks"]["attn"])
    for g, w in zip(layers.project_qkv(sa, _t(x), _t(x), cfg, None, None),
                    j_layers.project_qkv(jsa, jnp.asarray(x), jnp.asarray(x),
                                         jcfg, None, None)):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("sq,skv,G,kv_len", [
    (7, 21, 2, None),     # Sq != Skv, Skv off the chunk
    (12, 161, 4, None),   # vlm's G, a ragged Skv past one 128-key chunk
    (5, 40, 1, 33),       # kv_len masks the tail
])
def test_gqa_attention_non_causal_cross_shapes(sq, skv, G, kv_len):
    """K5's plain version without the causal mask, q onto a longer (or
    shorter) key sequence at B 2, against the reference's attention_ref."""
    B, KV, d = 2, 2, 16
    q, k, v = (_normal(sq + i, s) for i, s in enumerate(
        ((B, sq, KV * G, d), (B, skv, KV, d), (B, skv, KV, d))))
    got = gqa_attention(_t(q), _t(k), _t(v), causal=False, kv_len=kv_len)

    def bh(a):
        a = np.repeat(a, (KV * G) // a.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], d))
    want = j_attention_ref(bh(q), bh(k), bh(v), causal=False, kv_len=kv_len)
    want = np.asarray(want).reshape(B, KV * G, sq, d).transpose(0, 2, 1, 3)
    _close(got, want, 1e-5)


def test_attention_core_at_the_image_token_count():
    """The plain attention_core (vlm decode's cross-attention) at Skv 1601
    with chunk 1024: the ragged second chunk is padded and masked."""
    B, H, KV, d = 2, 4, 1, 16
    q, k, v = _normal(3, (B, 1, H, d)), _normal(4, (B, 1601, KV, d)), \
        _normal(5, (B, 1601, KV, d))
    got = layers.attention_core(_t(q), _t(k), _t(v), causal=False,
                                chunk=1024)
    want = j_layers.attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, chunk=1024)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# vlm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [2, 4])
def test_vlm_prefill_then_decode_matches_reference(n_layers):
    """One and two groups of (1 self, 1 cross) blocks: prefill S tokens
    with image embeddings, then decode token S; last logits and every
    cache leaf within 2e-4 of the reference's, the cross cache unchanged
    by decode, and the decode equal to a prefill of S + 1."""
    jcfg, cfg, jp, p = _params(VLM, n_layers=n_layers)
    assert p["blocks"]["attn"]["wq"].shape[:2] == (n_layers // 2, 1)
    assert p["cross_blocks"]["xattn"]["wk"].shape[0] == n_layers // 2
    B, S, max_len = 2, 12, 16
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 1))
    img = _normal(8, (B, cfg.n_image_tokens, cfg.vision_dim))
    last, cache = lm.prefill(p, torch.from_numpy(tokens[:, :S]), cfg,
                             img_embed=_t(img), max_len=max_len)
    j_last, j_cache = j_lm.prefill(jp, jnp.asarray(tokens[:, :S]), jcfg,
                                   img_embed=jnp.asarray(img),
                                   max_len=max_len)
    _close(last, j_last, ATOL)
    _close_trees(cache, j_cache, ATOL)
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    dec, cache = lm.decode_step(p, torch.from_numpy(tokens[:, S:]),
                                torch.tensor(S), cache, cfg)
    j_dec, j_cache = j_lm.decode_step(jp, jnp.asarray(tokens[:, S:]),
                                      jnp.asarray(S, jnp.int32), j_cache,
                                      jcfg)
    _close(dec, j_dec, ATOL)
    _close_trees(cache, j_cache, ATOL)
    for k, v in cross.items():
        assert torch.equal(cache["cross"][k], v), k
    longer, _ = lm.prefill(p, torch.from_numpy(tokens), cfg,
                           img_embed=_t(img))
    _close(dec[:, 0], longer, ATOL)


def test_vlm_per_row_decode_matches_reference():
    """Each prompt (with its own image) prefilled alone and placed on its
    cache row, on each leaf's batch axis (cache_batch_axes: 2 for the
    self-attention leaves, 1 for the cross ones); then one decode step at
    per-row positions, against the reference doing the same."""
    jcfg, cfg, jp, p = _params(VLM, n_layers=4)
    axes = lm.cache_batch_axes(cfg)
    assert axes == {"self": {"k": 2, "v": 2}, "cross": {"k": 1, "v": 1}}
    Bn, max_len, lens = 3, 20, [5, 9, 14]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    imgs = [_normal(20 + i, (1, cfg.n_image_tokens, cfg.vision_dim))
            for i in range(Bn)]
    cache = lm.init_cache(cfg, Bn, max_len, device="cpu")
    j_cache = jax.tree.map(np.array, j_lm.init_cache(jcfg, Bn, max_len))
    toks = []
    for i, (pr, im) in enumerate(zip(prompts, imgs)):
        logits_i, c1 = lm.prefill(p, torch.from_numpy(pr), cfg,
                                  img_embed=_t(im), max_len=max_len)
        _, jc1 = j_lm.prefill(jp, jnp.asarray(pr), jcfg,
                              img_embed=jnp.asarray(im), max_len=max_len)
        for part in ("self", "cross"):
            for k in ("k", "v"):
                ax = axes[part][k]
                cache[part][k].narrow(ax, i, 1).copy_(c1[part][k])
                idx = [slice(None)] * j_cache[part][k].ndim
                idx[ax] = slice(i, i + 1)
                j_cache[part][k][tuple(idx)] = np.asarray(jc1[part][k])
        toks.append(int(torch.argmax(logits_i[0])))
    tok = np.array(toks)[:, None]
    got, cache = lm.decode_step(p, torch.from_numpy(tok), torch.tensor(lens),
                                cache, cfg)
    want, j_cache = j_lm.decode_step(
        jp, jnp.asarray(tok), jnp.asarray(lens, jnp.int32),
        jax.tree.map(jnp.asarray, j_cache), jcfg)
    _close(got, want, ATOL)
    _close_trees(cache, j_cache, ATOL)


def test_vlm_prefill_needs_images():
    _, cfg = _cfgs(VLM)
    p = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="img_embed"):
        lm.prefill(p, torch.zeros((1, 4), dtype=torch.long), cfg)


# ---------------------------------------------------------------------------
# enc-dec
# ---------------------------------------------------------------------------

def test_encdec_matches_reference():
    """encode, prefill (S_enc 10 frames, 7 prompt tokens) and one decode
    step: encoder states, last logits and every cache leaf within 2e-4
    of the reference's; the cross cache unchanged by decode; the decode
    equal to a prefill of S + 1."""
    jcfg, cfg, jp, p = _params(ENCDEC)
    B, S_enc, S, max_len = 2, 10, 7, 12
    frames = _normal(11, (B, S_enc, cfg.d_model))
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    _close(encdec.encode(p, _t(frames), cfg),
           j_encdec.encode(jp, jnp.asarray(frames), jcfg), ATOL)
    last, cache = encdec.prefill(p, _t(frames),
                                 torch.from_numpy(tokens[:, :S]), cfg,
                                 max_len=max_len)
    j_last, j_cache = j_encdec.prefill(jp, jnp.asarray(frames),
                                       jnp.asarray(tokens[:, :S]), jcfg,
                                       max_len=max_len)
    _close(last, j_last, ATOL)
    _close_trees(cache, j_cache, ATOL)
    assert cache["cross"]["k"].shape[2] == S_enc
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    dec, cache = encdec.decode_step(p, torch.from_numpy(tokens[:, S:]),
                                    torch.tensor(S), cache, cfg)
    j_dec, j_cache = j_encdec.decode_step(jp, jnp.asarray(tokens[:, S:]),
                                          jnp.asarray(S, jnp.int32),
                                          j_cache, jcfg)
    _close(dec, j_dec, ATOL)
    _close_trees(cache, j_cache, ATOL)
    for k, v in cross.items():
        assert torch.equal(cache["cross"][k], v), k
    longer, _ = encdec.prefill(p, _t(frames), torch.from_numpy(tokens), cfg)
    _close(dec[:, 0], longer, ATOL)


# ---------------------------------------------------------------------------
# bf16 serving numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_bf16_prefill_then_decode_matches_reference(arch):
    """bf16 compute on the CPU: prefill, then two greedy decode steps, in
    the reference and in the port from the same weights and inputs. Every
    last-logit row agrees within 2^-6 of its largest magnitude (both round
    each op's output to bf16, in other summation orders), and the greedy
    tokens are equal."""
    jcfg, cfg, jp, p = _params(arch, compute="bfloat16")
    B, S, n_dec = 2, 12, 2
    tokens = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, S))
    if cfg.is_encdec:
        src = _normal(14, (B, 9, cfg.d_model))
        mod, jmod = encdec, j_encdec
        last, cache = encdec.prefill(p, _t(src), torch.from_numpy(tokens),
                                     cfg, max_len=S + n_dec)
        j_last, j_cache = j_encdec.prefill(jp, jnp.asarray(src),
                                           jnp.asarray(tokens), jcfg,
                                           max_len=S + n_dec)
    else:
        src = _normal(14, (B, cfg.n_image_tokens, cfg.vision_dim))
        mod, jmod = lm, j_lm
        last, cache = lm.prefill(p, torch.from_numpy(tokens), cfg,
                                 img_embed=_t(src), max_len=S + n_dec)
        j_last, j_cache = j_lm.prefill(jp, jnp.asarray(tokens), jcfg,
                                       img_embed=jnp.asarray(src),
                                       max_len=S + n_dec)
    got, want = [], []
    for i in range(n_dec + 1):
        a, b = _np(last), _np(j_last)
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max(), i
        got.append(a.argmax(-1))
        want.append(b.argmax(-1))
        if i == n_dec:
            break
        last, cache = mod.decode_step(p, torch.from_numpy(got[-1][:, None]),
                                      torch.tensor(S + i), cache, cfg)
        j_last, j_cache = jmod.decode_step(
            jp, jnp.asarray(want[-1][:, None]), jnp.asarray(S + i, jnp.int32),
            j_cache, jcfg)
        last, j_last = last[:, 0], j_last[:, 0]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_training_both_families_is_refused(tmp_path, capsys):
    """Both families train (tests/test_torch_lm_train_cross.py); the
    training launcher refuses the production meshes on a one-rank job
    (--production-mesh needs 256 ranks, --multi-pod 512: exit 2, nothing
    written), and the serve launcher still refuses both (SlotServer takes
    token prompts alone)."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as launcher
    for arch in (VLM, ENCDEC):
        for flag, need in (("--production-mesh", 256), ("--multi-pod", 512)):
            ck = tmp_path / f"{arch}{flag}"
            assert launcher.main(["--arch", arch, "--smoke", flag,
                                  "--ckpt-dir", str(ck)]) == 2
            err = capsys.readouterr().err
            assert err.startswith("error:") and f"needs {need} ranks" in err
            assert not ck.exists()
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 2
        assert "SlotServer" in capsys.readouterr().err


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_serve_launcher_refuses_cross_attention(arch, capsys):
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "SlotServer" in err
