"""PyTorch port, LM serving slice: the port's layers, the plain versions of
the flash-attention (K5) and SSD (K6) kernels, the dense and SSM models
and the slot server, against the JAX package on the same numpy inputs
(float32 compute; Pallas kernels in interpret mode, as the JAX package's
own tests run them on the CPU)."""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.kernels.ssd.ssd import ssd_pallas
from repro.models import lm as j_lm
from repro.nn import layers as j_layers
from repro.nn import ssm as j_ssm
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.models import lm
from repro_torch.nn import layers, ssm
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["internlm2-1.8b", "mamba2-780m"]
# every architecture the port carries (tests/test_torch_lm_families.py
# holds the other six's models to the reference)
PORTED = ARCHS + ["phi4-mini-3.8b", "gemma-7b", "qwen3-32b", "zamba2-7b",
                  "granite-moe-1b-a400m", "grok-1-314b"]
ATOL = 2e-4            # prefill/decode vs the reference (tests/test_models.py)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _cfgs(arch: str, compute: str = "float32", param: str = "float32"):
    """(JAX config, port config) of the smoke variant, same numerics."""
    kw = dict(compute_dtype=compute, param_dtype=param)
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


def _params(arch: str, **kw):
    """JAX-initialised smoke params and the port's copy of them."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = j_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    return jcfg, cfg, jp, lm.params_from_jax(tree, cfg, device="cpu")


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=atol, atol=atol,
                               err_msg=what)


def _rel_err(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_the_reference(arch):
    """Logical and TP-padded shapes equal the reference's, full and smoke;
    the port's config has every field of the reference's but the sharding
    knobs and ``moe_impl`` (which the reference's moe_apply never reads)."""
    unread = {"weight_sharding", "zero1", "moe_impl"}
    port_fields = {f.name for f in dataclasses.fields(get_config(arch))}
    ref_fields = {f.name for f in dataclasses.fields(j_get_config(arch))}
    assert port_fields == ref_fields - unread
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (smoke_variant(get_config(arch)),
                       j_smoke(j_get_config(arch)))):
        for name in port_fields:
            assert getattr(port, name) == getattr(ref, name), name
        for prop in ("phys_vocab", "phys_heads", "phys_kv_heads", "q_per_kv",
                     "ssm_inner", "ssm_nheads"):
            assert getattr(port, prop) == getattr(ref, prop), prop


def test_other_architectures_are_refused():
    """The two cross-attention architectures (vlm, enc-dec) are the next
    slice: get_config, init_params and SlotServer refuse them."""
    from repro_torch.configs import list_archs
    from repro.configs import list_archs as j_list_archs
    assert list_archs() == j_list_archs()
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    vlm = dataclasses.replace(smoke_variant(get_config("internlm2-1.8b")),
                              family="vlm", cross_every=2)
    with pytest.raises(NotImplementedError, match="family 'vlm'"):
        lm.init_params(torch.Generator(), vlm, device="cpu")
    from repro_torch.launch.serve import SlotServer
    with pytest.raises(NotImplementedError, match="next slice"):
        SlotServer(vlm, batch=2, max_len=16, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["prefill", "per_row"])
def test_apply_rope(case):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4, 16)).astype(np.float32)
    if case == "prefill":
        pos = np.arange(7)[None, :]
    else:                                           # decode: one pos per row
        x = x[:, :1]
        pos = np.array([5, 900, 2047])[:, None]
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), 1e6)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(got, want, 1e-5)


def test_rmsnorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(layers.rmsnorm(_t(x), _t(scale), 1e-5),
           j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)


def test_project_qkv():
    jcfg, cfg, jp, p = _params("internlm2-1.8b")
    x = np.random.default_rng(2).standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.arange(9)[None, :]
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    want = j_layers.project_qkv(jattn, jnp.asarray(x), jnp.asarray(x), jcfg,
                                jnp.asarray(pos), jnp.asarray(pos))
    got = layers.project_qkv(lm._layer(p["blocks"], 0)["attn"], _t(x), _t(x),
                             cfg, torch.from_numpy(pos), torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("case", ["causal", "per_row_decode", "kv_len_pad",
                                  "causal_pad"])
def test_attention_core(case):
    """The plain online softmax with per-row q_offset/kv_len, against the
    reference's."""
    rng = np.random.default_rng(3)
    B, H, KV, hd, chunk = 3, 4, 2, 16, 8
    Sq, Skv = {"causal": (16, 16), "per_row_decode": (1, 24),
               "kv_len_pad": (5, 21), "causal_pad": (13, 13)}[case]
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    kw = {"causal": case.startswith("causal")}
    if case == "per_row_decode":
        pos = np.array([3, 11, 23])
        jkw = dict(q_offset=jnp.asarray(pos), kv_len=jnp.asarray(pos + 1))
        tkw = dict(q_offset=torch.from_numpy(pos),
                   kv_len=torch.from_numpy(pos + 1))
    elif case == "kv_len_pad":
        jkw = tkw = dict(kv_len=17)
    else:
        jkw = tkw = {}
    want = j_layers.attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), chunk=chunk, **kw, **jkw)
    got = layers.attention_core(_t(q), _t(k), _t(v), chunk=chunk, **kw, **tkw)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# K5: flash attention's plain version and the GQA op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,d,causal,kv_len", [
    (64, 64, 16, True, None),
    (32, 128, 32, False, None),
    (100, 100, 16, True, None),     # non-multiple of the block: pad path
    (1, 96, 16, False, None),       # decode-like
    (1, 64, 16, False, 40),         # kv_len masks the cache tail
])
def test_flash_attention_plain_vs_reference(sq, skv, d, causal, kv_len):
    """K5's plain version against attention_ref (1e-5) and against the
    Pallas kernel in interpret mode (2e-3, tests/test_kernels.py)."""
    rng = np.random.default_rng(sq + skv + d)
    q = rng.standard_normal((2, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, skv, d)).astype(np.float32)
    v = rng.standard_normal((2, skv, d)).astype(np.float32)
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, kv_len=kv_len)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, j_attention_ref(*jargs, causal=causal, kv_len=kv_len), 1e-5)
    pallas = flash_attention_pallas(*jargs, causal=causal, kv_len=kv_len,
                                    block_q=32, block_k=32, interpret=True)
    _close(got, pallas, 2e-3)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 9)])
def test_gqa_attention_groups(causal, kv_len):
    """gqa_attention with G = 2 query heads per kv head."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    got = gqa_attention(_t(q), _t(k), _t(v), causal=causal, kv_len=kv_len)
    want = j_fa_ops.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  kv_len=kv_len, use_ref=True)
    _close(got, want, 1e-5)


def _wgmma_route_emulation(q, k, v, *, causal, kv_len=None, drop_tile=None):
    """float32 emulation of the order of work of the bf16 wgmma route of
    csrc/flash_attention.cu, on q [S, H, d] and k/v [Skv, H, d] (kv head
    already repeated to each query head): blocks of 128 query rows as two
    warpgroups of 64, kv tiles of 128 keys up to the causal limit of the
    block's last row, the mask applied only on tiles that cross the
    diagonal or kv_len, p = 2^(s scale log2(e) - m) with m in that log2
    domain, P rounded to bf16 before PV while l sums the unrounded p, out =
    acc / max(l, 1e-20) rounded to bf16. ``drop_tile`` skips one kv tile."""
    S, H, d = q.shape
    Skv = k.shape[0]
    kv_len = Skv if kv_len is None else kv_len
    bq = bk = 128
    neg = -1e30
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(d),
                              dtype=torch.float32)
    qh, kh, vh = (t.transpose(0, 1).float() for t in (q, k, v))
    out = torch.zeros((H, S, d))
    for q0 in range(0, S, bq):
        kv_hi = min(kv_len, min(q0 + bq, S)) if causal else kv_len
        for r_min in (q0, q0 + 64):                 # the two warpgroups
            rows = torch.arange(r_min, r_min + 64)
            qr = qh[:, r_min:r_min + 64]
            if qr.shape[1] == 0:
                continue
            rows = rows[:qr.shape[1]]
            m = torch.full((H, len(rows)), neg)
            l = torch.zeros((H, len(rows)))
            acc = torch.zeros((H, len(rows), d))
            for t, k0 in enumerate(range(0, kv_hi, bk)):
                if t == drop_tile:
                    continue
                keys = torch.arange(k0, k0 + bk)
                kt = torch.zeros((H, bk, d))
                vt = torch.zeros((H, bk, d))
                kt[:, :min(bk, Skv - k0)] = kh[:, k0:k0 + bk]
                vt[:, :min(bk, Skv - k0)] = vh[:, k0:k0 + bk]
                s = qr @ kt.transpose(1, 2)
                masked = (causal and k0 + bk - 1 > r_min) or k0 + bk > kv_len
                if masked:
                    bad = keys[None, :] >= kv_len
                    if causal:
                        bad = bad | (keys[None, :] > rows[:, None])
                    s = s.masked_fill(bad, neg)
                m_new = torch.maximum(m, s.amax(-1) * scale_log2)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s * scale_log2 - m_new[..., None])
                if masked:
                    p = p.masked_fill(bad, 0.0)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + p.bfloat16().float() @ vt
                m = m_new
            out[:, rows] = acc / l.clamp_min(1e-20)[..., None]
    return out.bfloat16().float()


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 700)])
def test_wgmma_route_arithmetic_within_the_card_limit(G, causal, kv_len):
    """The bf16 wgmma route's arithmetic (see the emulation) at S 1024, H 2,
    d 128 against attention_ref on the same bf16 values, per element within
    chip_smoke.fa_limit's 2^-8 (|o| + attention of |v|) + 1e-5; with one kv
    tile dropped the same check fails, so the limit sees a missing tile."""
    S, H, d = 1024, 2, 128
    rng = np.random.default_rng(G)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16().float()
               for shape in ((S, H, d), (S, H // G, d), (S, H // G, d)))
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    bh = [t.transpose(0, 1) for t in (q, k, v)]
    want = attention_ref(*bh, causal=causal, kv_len=kv_len)
    abs_attn = attention_ref(bh[0], bh[1], bh[2].abs(), causal=causal,
                             kv_len=kv_len)
    u = 2.0 ** -8
    limit = u * want.abs() + u * (1 + 2.0 ** -6) * abs_attn + 1e-5
    got = _wgmma_route_emulation(q, k, v, causal=causal, kv_len=kv_len)
    share = float(((got - want).abs() / limit).max())
    assert share <= 1.0, f"{share:.3g} of the limit"
    dropped = _wgmma_route_emulation(q, k, v, causal=causal, kv_len=kv_len,
                                     drop_tile=1)
    assert float(((dropped - want).abs() / limit).max()) > 4.0


# ---------------------------------------------------------------------------
# K6: the SSD scan's plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 64, 2, 8, 1, 8, 16),
    (2, 96, 4, 16, 2, 8, 32),       # g < h
    (1, 50, 2, 8, 2, 4, 16),        # pad path
])
def test_ssd_plain_vs_reference(b, s, h, p, g, n, chunk):
    """K6's plain version against ssd_ref (1e-5) and against the Pallas
    kernel in interpret mode (relative error 1e-3, the ROADMAP contract)."""
    args = _ssd_inputs(s + h, b, s, h, p, g, n)
    y, st = ssd(*map(_t, args), chunk=chunk)
    jargs = tuple(map(jnp.asarray, args))
    y_r, st_r = j_ssd_ref(*jargs)
    _close(y, y_r, 1e-5)
    _close(st, st_r, 1e-5)
    y_k, st_k = ssd_pallas(*jargs, chunk=chunk, interpret=True)
    assert _rel_err(y, y_k) <= 1e-3
    assert _rel_err(st, st_k) <= 1e-3
    assert torch.equal(ssd_ref(*map(_t, args))[0], y)


def _split(v, terms=2):
    """A float32 operand as the kernel hands it to bf16 products: the sum
    of ``terms`` bf16 values, each the rounding of what the earlier ones
    left (1: one bf16 rounding)."""
    out, rest = torch.zeros_like(v), v
    for _ in range(terms):
        part = rest.bfloat16().float()
        out, rest = out + part, rest - part
    return out


def _ssd_chunked_emulation(x, dt, A, B, C, chunk, *, single=(),
                           drop_state=None):
    """float32 emulation of the bf16 route of csrc/ssd.cu on x [s, h, p],
    dt [s, h], A [h] and B/C [s, n] (one group), in its three passes:
    (1) per chunk a_cs, the contribution U = (x * w)^T B with x * w split
    into hi + lo and the decay exp(a_cs[L-1]); (2) the state entering each
    chunk, walking the chunks; (3) y = W x + exp(a_cs) (C state^T) with W
    split into hi + mid + lo and the incoming state into hi + lo, y rounded
    to bf16. ``single`` names operands rounded once instead ("xw", "w",
    "state"); ``drop_state`` is a chunk whose incoming state is taken as
    zero."""
    s, h, p = x.shape
    n = B.shape[1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xp, dtp, Bp, Cp = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                       for t in (x, dt, B, C))
    xc = xp.view(nc, chunk, h, p)
    Bc, Cc = Bp.view(nc, chunk, n), Cp.view(nc, chunk, n)
    acs = (dtp * A).view(nc, chunk, h).cumsum(1)            # [nc, L, h]
    dtc = dtp.view(nc, chunk, h)
    # pass 1
    w = dtc * torch.exp(acs[:, -1:] - acs)                  # [nc, L, h]
    xw = _split(xc * w[..., None], 1 if "xw" in single else 2)
    U = torch.einsum("clhp,cln->chpn", xw, Bc)              # [nc, h, p, n]
    dec = torch.exp(acs[:, -1])                             # [nc, h]
    # pass 2
    run = torch.zeros((h, p, n))
    s_in = torch.empty_like(U)
    for c in range(nc):
        s_in[c] = run
        run = dec[c][:, None, None] * run + U[c]
    if drop_state is not None:
        s_in[drop_state] = 0.0
    # pass 3
    G = torch.einsum("cin,cjn->cij", Cc, Bc)                # [nc, L, L]
    seg = acs[:, :, None, :] - acs[:, None, :, :]           # [nc, i, j, h]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    decay = torch.where(mask[None, :, :, None], torch.exp(seg),
                        torch.zeros(()))
    W = _split(G[..., None] * decay * dtc[:, None, :, :],
               1 if "w" in single else 3)
    y = torch.einsum("cijh,cjhp->cihp", W, xc)
    y_inter = torch.einsum("cin,chpn->cihp", Cc,
                           _split(s_in, 1 if "state" in single else 2))
    y = y + torch.exp(acs)[..., None] * y_inter
    return y.reshape(nc * chunk, h, p)[:s].bfloat16().float(), run


@pytest.mark.parametrize("variant", ["kernel", "dropped_state",
                                     "single_rounding"])
def test_ssd_chunked_route_within_the_card_limit(variant):
    """The bf16 route's arithmetic (see the emulation) at s 1024, 4 heads,
    p 64, n 128, chunk 128, on chip_smoke.py's input distribution rounded to
    bf16, against ssd_ref: y within 1e-3 of max |y| plus 2^-8 |y| per
    element and the final state within relative error 1e-3 (chip_smoke's
    SSD_RTOL and per-element limit). Negative controls: with one chunk's
    incoming state dropped y fails the same limit; with the state and
    x * dt * decay_end (the kernel weights x, not B) rounded once to bf16
    the state's relative error exceeds 1e-3."""
    s, h, p, n, chunk = 1024, 4, 64, 128, 128
    rng = np.random.default_rng(15)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float()  # noqa: E731
    x = bf(rng.standard_normal((s, h, p)))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((s, h))))
                          .astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(h) * 0.3))
                         .astype(np.float32))
    B, C = bf(rng.standard_normal((s, n))), bf(rng.standard_normal((s, n)))
    y_r, st_r = ssd_ref(x[None], dt[None], A, B[None, :, None],
                        C[None, :, None])
    y_r, st_r = y_r[0], st_r[0]
    kw = {"dropped_state": {"drop_state": 3},
          "single_rounding": {"single": ("state", "xw")}}.get(variant, {})
    y, st = _ssd_chunked_emulation(x, dt, A, B, C, chunk, **kw)
    limit = 1e-3 * y_r.abs().max() + 2.0 ** -8 * y_r.abs()
    y_share = float(((y - y_r).abs() / limit).max())
    st_err = float((st - st_r).abs().max() / st_r.abs().max())
    if variant == "kernel":
        assert y_share <= 1.0 and st_err <= 1e-3, (y_share, st_err)
    elif variant == "dropped_state":
        assert y_share > 1.0
    else:
        assert st_err > 1e-3


def test_ssm_block_full_and_decode():
    """_ssm_block_full (through the SSD op) and one ssm_block_decode step
    against the reference's, with the same weights."""
    jcfg, cfg, jp, p = _params("mamba2-780m")
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    tb = lm._layer(p["blocks"], 0)["ssm"]
    x = np.random.default_rng(5).standard_normal((2, 11, 64)).astype(
        np.float32)
    out, state, tails = ssm._ssm_block_full(tb, _t(x), cfg)
    j_out, j_state, j_tails = j_ssm._ssm_block_full(jb, jnp.asarray(x), jcfg)
    _close(out, j_out, 1e-5)
    _close(state, j_state, 1e-5)
    for k in ("x", "bc"):
        _close(tails[k], j_tails[k], 1e-5)
    cache = {"conv_x": tails["x"], "conv_bc": tails["bc"], "state": state}
    jcache = {"conv_x": j_tails["x"], "conv_bc": j_tails["bc"],
              "state": j_state}
    x1 = np.random.default_rng(6).standard_normal((2, 1, 64)).astype(
        np.float32)
    y, new = ssm.ssm_block_decode(tb, _t(x1), cache, cfg)
    j_y, j_new = j_ssm.ssm_block_decode(jb, jnp.asarray(x1), jcache, jcfg)
    _close(y, j_y, 1e-5)
    for k in new:
        _close(new[k], j_new[k], 1e-5, k)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill S tokens, then decode token S: last logits and caches
    within 2e-4 of the reference's (tests/test_models.py), and the decode
    equal to the last logits of a prefill of S + 1 tokens."""
    jcfg, cfg, jp, p = _params(arch)
    B, S, max_len = 2, 12, 16
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 1))
    last, cache = lm.prefill(p, torch.from_numpy(tokens[:, :S]), cfg,
                             max_len=max_len)
    j_last, j_cache = j_lm.prefill(jp, jnp.asarray(tokens[:, :S]), jcfg,
                                   max_len=max_len)
    _close(last, j_last, ATOL)
    for k in cache:
        _close(cache[k], j_cache[k], ATOL, k)
    dec, cache = lm.decode_step(p, torch.from_numpy(tokens[:, S:]),
                                torch.tensor(S), cache, cfg)
    j_dec, j_cache = j_lm.decode_step(jp, jnp.asarray(tokens[:, S:]),
                                      jnp.asarray(S, jnp.int32), j_cache,
                                      jcfg)
    _close(dec, j_dec, ATOL)
    for k in cache:
        _close(cache[k], j_cache[k], ATOL, k)
    longer, _ = lm.prefill(p, torch.from_numpy(tokens), cfg)
    _close(dec[:, 0], longer, ATOL)


def test_prefill_then_decode_bf16_matches_reference():
    """Serving numerics (bf16 compute) on the CPU: prefill, then four greedy
    decode steps, in the reference and in the port from the same weights
    and prompt. Every last-logit row agrees within 2^-6 of its largest
    magnitude (four bf16 steps: both sides round each op's output to bf16,
    in other summation orders), and the greedy tokens are equal."""
    jcfg, cfg, jp, p = _params("internlm2-1.8b", compute="bfloat16")
    B, S, n_dec = 2, 12, 4
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


@pytest.mark.parametrize("S,chunk", [(40, 64), (100, 64), (200, 64)])
def test_prefill_attention_bf16_rounds_p_like_the_reference(S, chunk):
    """The port's prefill attention on the CPU (gqa_attention with the
    config's attn_chunk) against the reference prefill's attention_core on
    the same bf16 q, k, v: every output within one bf16 step (2^-7
    relative) of the reference's. Both round each KV chunk's unnormalised
    P to bf16 before PV; a float32 softmax with P never rounded does not
    hold to this."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * scale).bfloat16()
               for shape, scale in (((2, S, 4, 16), 2.0), ((2, S, 2, 16), 2.0),
                                    ((2, S, 2, 16), 1.0)))
    got = gqa_attention(q, k, v, causal=True, chunk=chunk)
    assert got.dtype == torch.bfloat16
    want = j_layers.attention_core(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), causal=True, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_row_decode_matches_reference(arch):
    """Rows decoding at different positions in one batch
    (tests/test_serving.py): the port's per-row step equals the
    reference's, and each row equals its own scalar-position decode."""
    jcfg, cfg, jp, p = _params(arch)
    Bn, max_len, lens = 3, 24, [5, 9, 14]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    cache = lm.init_cache(cfg, Bn, max_len, device="cpu")
    j_cache = j_lm.init_cache(jcfg, Bn, max_len)
    toks = []
    for i, pr in enumerate(prompts):
        logits_i, c1 = lm.prefill(p, torch.from_numpy(pr), cfg,
                                  max_len=max_len)
        for k in cache:
            cache[k][:, i:i + 1] = c1[k]
        _, jc1 = j_lm.prefill(jp, jnp.asarray(pr), jcfg, max_len=max_len)
        j_cache = jax.tree.map(lambda big, small, i=i:
                               big.at[:, i:i + 1].set(small), j_cache, jc1)
        toks.append(int(torch.argmax(logits_i[0])))
    tok = np.array(toks)[:, None]
    got, _ = lm.decode_step(p, torch.from_numpy(tok), torch.tensor(lens),
                            cache, cfg)
    want, _ = j_lm.decode_step(jp, jnp.asarray(tok),
                               jnp.asarray(lens, jnp.int32), j_cache, jcfg)
    _close(got, want, ATOL)
    for i, pr in enumerate(prompts):
        _, ci = lm.prefill(p, torch.from_numpy(pr), cfg, max_len=max_len)
        li, _ = lm.decode_step(p, torch.from_numpy(tok[i:i + 1]),
                               torch.tensor(lens[i]), ci, cfg)
        _close(got[i], li[0], 3e-4, f"row {i}")


def test_params_from_jax_checks_the_tree():
    _, cfg, jp, p = _params("internlm2-1.8b")
    assert p["blocks"]["attn"]["wq"].shape == (2, 64, 64)
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    del tree["blocks"]["mlp"]
    with pytest.raises(ValueError, match="keys"):
        lm.params_from_jax(tree, cfg, device="cpu")
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    tree["final_norm"] = tree["final_norm"][:3]
    with pytest.raises(ValueError, match="shape"):
        lm.params_from_jax(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the slot server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_slot_server_generates_the_reference_tokens(arch):
    """The reference's SlotServer and the port's, float32 compute over the
    same bf16 serving weights and prompts, generate the same tokens for
    every request; lanes are recycled (more requests than batch)."""
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serve import Request as JRequest
    from repro.launch.serve import SlotServer as JSlotServer
    from repro_torch.launch.serve import Request, SlotServer, serve
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + 2 * i) for i in range(5)]
    with make_host_mesh() as mesh:
        jserver = JSlotServer(jcfg, mesh, batch=2, max_len=32)
        jp = j_lm.init_params(jax.random.PRNGKey(0), jserver.cfg)
        jserver.load(jp)
        jreqs = [JRequest(i, jnp.asarray(pr, jnp.int32), max_new=4)
                 for i, pr in enumerate(prompts)]
        queue, jdone = list(jreqs), []
        while len(jdone) < len(jreqs):
            while queue and jserver.admit(queue[0]):
                queue.pop(0)
            jdone.extend(jserver.step())
    server = SlotServer(cfg, batch=2, max_len=32, device="cpu")
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jp)
    server.load(lm.params_from_jax(tree, server.cfg, device="cpu"))
    assert server.params["embed"]["embedding"].dtype == torch.bfloat16
    reqs = [Request(i, torch.from_numpy(pr), max_new=4)
            for i, pr in enumerate(prompts)]
    done, steps = serve(server, reqs)
    assert len(done) == 5 > server.batch
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(reqs, jreqs):
        assert r.generated == jr.generated, r.rid
    assert server.slots.is_empty()
    assert len(server.timings["prefill"]) == 5
    assert len(server.timings["decode"]) == steps


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3"]) == 0
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out


def test_lm_entry_points_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.serve import SlotServer
    cfg = smoke_variant(get_config("mamba2-780m"))
    for call in (lambda: lm.init_params(torch.Generator(), cfg),
                 lambda: lm.init_cache(cfg, 1, 8),
                 lambda: SlotServer(cfg, 1, 8),
                 lambda: launcher.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
