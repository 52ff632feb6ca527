"""Transformer building blocks (the port's ``repro.nn.layers``): RMSNorm,
RoPE, GQA attention as an online softmax over KV chunks (differentiable,
the training path's attention), GLU MLPs, embeddings and the chunked
cross-entropy.

Params are plain dicts of tensors; every apply casts to the config's
compute dtype and keeps softmax and norm statistics in float32. Init
functions take a ``torch.Generator`` and draw on its device; with
``gen=None`` they return tensors on the ``meta`` device, which give the
shapes and dtypes of a parameter tree without allocating it. ``lead``
prepends stacking dims (``(n_layers,)``), the reference's vmapped init.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig

Params = dict
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdt(cfg: LMConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdt(cfg: LMConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _device(gen: torch.Generator | None) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def _normal(gen, shape, stddev, dtype) -> torch.Tensor:
    """Normal(0, stddev) drawn in float32, then cast (as the reference).
    A stacked leaf (more than 2 dims) of a narrower type is drawn one
    matrix at a time into its stack: drawn whole in float32 it would need
    twice its own bytes again as a transient (33.5 GB for qwen3-32b's
    ``[64, 5120, 25600]`` MLP stacks beside 61 GiB of weights)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    if dtype == torch.float32 or len(shape) <= 2:
        x = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return x.mul_(stddev).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(_normal(gen, shape[-2:], stddev, dtype))
    return out


def _full(gen, shape, value, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=_device(gen))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(gen, d: int, dtype, lead: tuple = ()) -> torch.Tensor:
    return _full(gen, lead + (d,), 1.0, dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate-half, not interleaved; float32)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), ex)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x [..., S, n_heads, head_dim]; positions broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: LMConfig, lead: tuple = ()) -> Params:
    D, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.phys_heads, cfg.phys_kv_heads
    s = 1.0 / math.sqrt(D)
    dt = pdt(cfg)
    p = {
        "wq": _normal(gen, lead + (D, H * hd), s, dt),
        "wk": _normal(gen, lead + (D, KV * hd), s, dt),
        "wv": _normal(gen, lead + (D, KV * hd), s, dt),
        "wo": _normal(gen, lead + (H * hd, D), s / math.sqrt(2 * cfg.n_layers),
                      dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(gen, hd, dt, lead)
        p["k_norm"] = rmsnorm_init(gen, hd, dt, lead)
    return p


def project_qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor,
                cfg: LMConfig, positions: torch.Tensor,
                kv_positions: torch.Tensor):
    """Project, normalise q and k per head (qk-norm configs) and rotate.
    Returns q [B,S,H,hd], k/v [B,Skv,KV,hd]."""
    H, KV, hd = cfg.phys_heads, cfg.phys_kv_heads, cfg.head_dim
    dt = cdt(cfg)
    B, S = x.shape[0], x.shape[1]
    Skv = kv_src.shape[1]
    q = (x.to(dt) @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (kv_src.to(dt) @ p["wk"].to(dt)).reshape(B, Skv, KV, hd)
    v = (kv_src.to(dt) @ p["wv"].to(dt)).reshape(B, Skv, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, kv_positions, cfg.rope_theta), v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, chunk: int,
                   q_offset: torch.Tensor | int = 0,
                   kv_len: torch.Tensor | int | None = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (plain PyTorch, any device).

    q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd] with H % KV == 0 (GQA).
    ``q_offset``: absolute position of q[0], an int or per-row ``[B]``.
    ``kv_len``: number of valid kv positions (masks the cache tail), an
    int or per-row ``[B]``. Returns [B, Sq, H, hd]; statistics in float32.
    Scores take float32 products of the inputs; P is rounded to q's type
    before PV, as the reference's (flash/MXU practice).
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    chunk = min(chunk, Skv)
    if Skv % chunk:        # pad KV to a chunk multiple; mask the tail
        pad = chunk - Skv % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = Skv
        Skv += pad
    off = torch.as_tensor(q_offset, device=dev)
    # [Sq] for scalar offsets, [B, Sq] for per-row offsets
    q_pos = (off[..., None] if off.dim() else off) + torch.arange(Sq,
                                                                  device=dev)
    kl = None
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev)
        kl = kl[:, None, None] if kl.dim() == 1 else kl
    m = torch.full((B, Sq, KV, G), -math.inf, device=dev)
    l = torch.zeros((B, Sq, KV, G), device=dev)
    acc = torch.zeros((B, Sq, KV, G, hd), device=dev)
    for idx in range(Skv // chunk):
        kb = k[:, idx * chunk:(idx + 1) * chunk].float()
        vb = v[:, idx * chunk:(idx + 1) * chunk].to(q.dtype).float()
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, kb) * scale
        kv_pos = idx * chunk + torch.arange(chunk, device=dev)
        # mask [B or 1, Sq, chunk]
        mask = torch.ones((1, Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = q_pos[..., :, None] >= kv_pos
            if mask.dim() == 2:
                mask = mask[None]
        if kl is not None:
            mask = mask & (kv_pos[None, None, :] < kl)
        s = s.masked_fill(~mask[:, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # fully-masked rows (m_new = -inf) contribute nothing
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bqkgc,bckh->bqkgh", p.to(q.dtype).float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attn_out(p: Params, o: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    B, S = o.shape[0], o.shape[1]
    dt = cdt(cfg)
    return o.reshape(B, S, -1) @ p["wo"].to(dt)


def self_attention(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                   causal: bool = True,
                   positions: torch.Tensor | None = None) -> torch.Tensor:
    """Training-path self-attention through the plain ``attention_core``
    (the reference trains through it too; K5 is forward-only)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = project_qkv(p, x, x, cfg, positions, positions)
    o = attention_core(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return attn_out(p, o, cfg)


# --- decode-path attention over a cache --------------------------------

def decode_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor, cfg: LMConfig
                     ) -> torch.Tensor:
    """One-token attention: x [B,1,D]; cache_k/v [B, Smax, KV, hd], written
    in place at ``pos`` (positions > pos mask out). Scalar pos = lockstep
    batch; ``[B]`` pos = continuous batching (rope, cache write and the kv
    mask are all per row)."""
    per_row = pos.dim() == 1
    rope_pos = pos[:, None] if per_row else pos[None, None]
    q, k, v = project_qkv(p, x, x, cfg, rope_pos, rope_pos)
    _cache_write(cache_k, k, pos)
    _cache_write(cache_v, v, pos)
    o = attention_core(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                       causal=False, chunk=cfg.attn_chunk, q_offset=pos,
                       kv_len=pos + 1)
    return attn_out(p, o, cfg)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
                 ) -> None:
    """cache [B, Smax, KV, hd] ← new [B, 1, KV, hd] at position pos
    (scalar, or [B] for per-row slots), in place."""
    new = new[:, 0].to(cache.dtype)
    if pos.dim() == 1:
        cache[torch.arange(cache.shape[0], device=cache.device),
              pos.long()] = new
    else:
        cache[:, int(pos)] = new


# ---------------------------------------------------------------------------
# MLP (GLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: LMConfig, lead: tuple = ()) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    dt = pdt(cfg)
    return {
        "wg": _normal(gen, lead + (D, Fd), s, dt),
        "wu": _normal(gen, lead + (D, Fd), s, dt),
        "wd": _normal(gen, lead + (Fd, D),
                      (1.0 / math.sqrt(Fd)) / math.sqrt(2 * cfg.n_layers), dt),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The GLU gate's activation: ``silu`` (SwiGLU) or ``gelu`` (GeGLU).
    ``jax.nn.gelu``, the reference's, is the tanh approximation by
    default, so GeGLU here is too (not the exact erf form)."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp_apply(p: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """SwiGLU or GeGLU, by ``cfg.act``."""
    dt = cdt(cfg)
    x = x.to(dt)
    h = _act(x @ p["wg"].to(dt), cfg.act) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: LMConfig) -> Params:
    V, D = cfg.phys_vocab, cfg.d_model
    p = {"embedding": _normal(gen, (V, D), 1.0, pdt(cfg))}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (D, V), 1.0 / math.sqrt(D), pdt(cfg))
    return p


def embed_apply(p: Params, tokens: torch.Tensor, cfg: LMConfig
                ) -> torch.Tensor:
    return p["embedding"][tokens.long()].to(cdt(cfg))


def unembed_apply(p: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Logits over the physical vocab; padded entries are −inf."""
    dt = cdt(cfg)
    w = p["embedding"].t() if cfg.tie_embeddings else p["unembed"]
    logits = x.to(dt) @ w.to(dt)
    if cfg.phys_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -math.inf
    return logits


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """logits [..., V] (may hold the −inf pad mask), labels [...] → the
    per-position loss, in float32. −inf becomes −1e30, as the reference
    has it, so a padded entry adds exp(−1e30 − max) = 0 to the sum and
    its gradient is 0, not NaN."""
    lf = logits.float()
    lf = torch.where(torch.isinf(lf), -1e30, lf)
    lse = torch.logsumexp(lf, -1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def chunked_cross_entropy(p_embed: Params, h: torch.Tensor,
                          labels: torch.Tensor, cfg: LMConfig,
                          seq_chunk: int = 256) -> torch.Tensor:
    """Mean CE without keeping [B, S, V] logits: each chunk of
    ``seq_chunk`` positions computes its logits, reduces them to
    (lse − gold) summed, and drops them. Each chunk runs under
    ``torch.utils.checkpoint`` (recomputed in the backward pass), so one
    chunk's logits is the most that is alive at a time, as in the
    reference's scan."""
    B, S, _ = h.shape
    seq_chunk = min(seq_chunk, S)
    if S % seq_chunk:
        raise ValueError(f"sequence {S} is not a multiple of the CE chunk "
                         f"{seq_chunk}")

    def chunk_sum(hb, lb):
        return softmax_cross_entropy(unembed_apply(p_embed, hb, cfg),
                                     lb).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, seq_chunk):
        tot = tot + checkpoint(chunk_sum, h[:, i:i + seq_chunk],
                               labels[:, i:i + seq_chunk],
                               use_reentrant=False)
    return tot / (B * S)
