"""Decoder LM (the port's ``repro.models.lm``):

  dense  — phi4-mini (padded heads), gemma-7b (GeGLU, head dim 256),
           qwen3-32b (qk-norm), internlm2 (GQA attention + GLU MLP)
  moe    — granite-moe, grok-1 (the dense stack with ``nn/moe`` MLPs)
  ssm    — mamba2 (attention-free Mamba-2 blocks)
  hybrid — zamba2 (groups of Mamba-2 blocks, one *shared* attention+MLP
           block after each group)
  vlm    — llama-3.2-vision (groups of k - 1 dense blocks and one
           cross-attention block onto the image embeddings)

All five are served (``init_params``, ``params_from_jax``,
``init_cache``, ``prefill``, ``decode_step``) and trained (``forward``,
``backbone``, ``loss_fn``; the vlm's batch carries ``img_embed``). The
encoder-decoder family is ``models/encdec.py``'s (it reuses these
blocks); here it raises ``NotImplementedError``.

Params keep the reference's tree: ``embed``, ``final_norm`` and
``blocks`` with every leaf stacked ``[n_layers, ...]`` (hybrid:
``[n_groups, k, ...]`` plus one unstacked ``shared`` block; vlm:
``[n_groups, k - 1, ...]`` plus ``cross_blocks`` ``[n_groups, ...]``);
layers run in a Python loop over views of the stacks. Training
(``forward``, ``loss_fn``) runs each block under ``cfg.remat``
(``_maybe_remat``; a hybrid group of ``attn_every`` SSM blocks and the
shared block after it, and a vlm group of ``cross_every - 1`` dense
blocks and its cross-attention block, each run under one wrapper, as the
reference remats its scanned group), every attention, the vlm's
cross-attention onto ``img_embed`` included, through the plain
``attention_core`` (K5 is forward-only), MoE
layers through ``nn/moe.moe_apply`` at the config's capacity (drops and
all; their load-balance losses summed in float32 into ``lb``) and the SSD
scan through ``nn/ssm.ssm_block_apply`` (K6's forward on the card).
Prefill's causal self-attention and the vlm prefill's non-causal
attention onto the image tokens go through
``kernels/flash_attention/ops.gqa_attention`` and the SSM prefill's scan through ``kernels/ssd/ops.ssd`` (the CUDA
kernels on the card); decode stays on the plain ``attention_core`` and
SSM step, as in the reference. Decode updates the self-attention and SSM
caches in place and only reads the cross-attention cache.

API:
  init_params(gen, cfg, device)              → params
  params_from_jax(tree, cfg, device)         → params (reference weights)
  forward(params, tokens, cfg, img_embed=)   → (logits, moe aux loss)
  loss_fn(params, batch, cfg)                → (loss, {"ce", "lb"})
  init_cache(cfg, batch, max_len, device=)   → cache
  cache_batch_axes(cfg)                      → each cache leaf's batch axis
  prefill(params, tokens, cfg, img_embed=, max_len=)
                                             → (last_logits, cache)
  decode_step(params, token, pos, cache, cfg)→ (logits, cache)
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import ssm as ssm_mod
from repro_torch.sharding.rules import replicated_like, shard_batch
from repro_torch.utils import tree_map

Params = dict
SERVED = ("dense", "ssm", "moe", "hybrid", "vlm")


def check_servable(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` for a config this module cannot
    serve or train: an encoder-decoder (``models/encdec.py`` serves and
    trains it) or an unknown family."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder config is served and trained "
            f"by models/encdec.py (encdec.prefill, encdec.decode_step, "
            f"encdec.loss_fn), not by models/lm.py")
    if cfg.family not in SERVED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder family "
            f"of models/lm.py (it serves {SERVED})")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_block_init(gen, cfg: LMConfig, lead: tuple) -> Params:
    pd = L.pdt(cfg)
    p = {"ln1": L.rmsnorm_init(gen, cfg.d_model, pd, lead),
         "attn": L.attn_init(gen, cfg, lead),
         "ln2": L.rmsnorm_init(gen, cfg.d_model, pd, lead)}
    if cfg.n_experts:
        p["moe"] = moe_mod.moe_init(gen, cfg, lead)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, lead)
    return p


def _ssm_block_init(gen, cfg: LMConfig, lead: tuple) -> Params:
    return {"ln": L.rmsnorm_init(gen, cfg.d_model, L.pdt(cfg), lead),
            "ssm": ssm_mod.ssm_init(gen, cfg, lead)}


def _cross_block_init(gen, cfg: LMConfig, lead: tuple) -> Params:
    pd = L.pdt(cfg)
    return {"ln1": L.rmsnorm_init(gen, cfg.d_model, pd, lead),
            "xattn": L.attn_init(gen, cfg, lead, cross=True),
            "ln2": L.rmsnorm_init(gen, cfg.d_model, pd, lead),
            "mlp": L.mlp_init(gen, cfg, lead)}


def _groups(cfg: LMConfig) -> tuple[int, int]:
    """hybrid: (groups, SSM blocks a group); vlm: (groups, dense blocks a
    group), each group ending in its cross-attention block."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_every, cfg.cross_every - 1
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


def _init(gen: torch.Generator | None, cfg: LMConfig) -> Params:
    """The parameter tree drawn on ``gen``'s device, or on ``meta`` (shapes
    and dtypes only) when ``gen`` is None."""
    check_servable(cfg)
    params: Params = {"embed": L.embed_init(gen, cfg),
                      "final_norm": L.rmsnorm_init(gen, cfg.d_model,
                                                   L.pdt(cfg))}
    if cfg.family in ("dense", "moe"):
        params["blocks"] = _dense_block_init(gen, cfg, (cfg.n_layers,))
    elif cfg.family == "ssm":
        params["blocks"] = _ssm_block_init(gen, cfg, (cfg.n_layers,))
    elif cfg.family == "hybrid":
        params["blocks"] = _ssm_block_init(gen, cfg, _groups(cfg))
        params["shared"] = _dense_block_init(gen, cfg, ())
    else:
        params["blocks"] = _dense_block_init(gen, cfg, _groups(cfg))
        params["cross_blocks"] = _cross_block_init(gen, cfg,
                                                   _groups(cfg)[:1])
    return params


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: str | torch.device | None = None) -> Params:
    """Seeded weights, drawn on ``gen``'s device (a CUDA generator draws on
    the card) and placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return _tree_map(lambda t: t.to(dev), _init(gen, cfg))


def params_from_jax(tree: dict, cfg: LMConfig,
                    device: str | torch.device | None = None) -> Params:
    """The reference's ``lm.init_params`` tree (numpy leaves; bfloat16
    given as float32 values) as the port's tree: same names, same stacked
    layout, each leaf in the dtype the port allocates for it."""
    return tree_like(tree, _init(None, cfg), device)


def tree_like(tree: dict, skeleton: Params,
              device: str | torch.device | None = None) -> Params:
    """``tree`` (numpy leaves) as tensors on ``device`` with the names,
    shapes and dtypes of ``skeleton`` (a ``meta`` tree); raises on a key
    or shape that differs."""
    dev = resolve_device(device)

    def convert(ref, path):
        if isinstance(ref, dict):
            if not isinstance(tree_at(path), dict) or \
                    set(ref) != set(tree_at(path)):
                raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                                 f"{sorted(tree_at(path))} != {sorted(ref)}")
            return {k: convert(v, path + (k,)) for k, v in ref.items()}
        arr = np.array(tree_at(path), dtype=np.float32)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        return torch.from_numpy(arr).to(device=dev, dtype=ref.dtype)

    def tree_at(path):
        node = tree
        for k in path:
            node = node[k]
        return node

    return convert(skeleton, ())


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def attn_cache(cfg: LMConfig, lead: tuple, batch: int, length: int, dtype,
               dev: torch.device) -> dict:
    """``{"k", "v"}`` zeros ``lead + [batch, length, KV, hd]``."""
    shape = lead + (batch, length, cfg.phys_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _cache(cfg: LMConfig, batch: int, max_len: int, dtype,
           dev: torch.device) -> dict:
    if cfg.family in ("dense", "moe"):
        return attn_cache(cfg, (cfg.n_layers,), batch, max_len, dtype, dev)
    if cfg.family == "ssm":
        return ssm_mod.ssm_init_cache(cfg, batch, dtype, dev, (cfg.n_layers,))
    n_groups, k_blocks = _groups(cfg)
    if cfg.family == "vlm":
        return {"self": attn_cache(cfg, (n_groups, k_blocks), batch, max_len,
                                   dtype, dev),
                "cross": attn_cache(cfg, (n_groups,), batch,
                                    cfg.n_image_tokens, dtype, dev)}
    return {"ssm": ssm_mod.ssm_init_cache(cfg, batch, dtype, dev,
                                          (n_groups, k_blocks)),
            "attn": attn_cache(cfg, (n_groups,), batch, max_len, dtype, dev)}


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device: str | torch.device | None = None) -> dict:
    """dense/moe: ``{"k", "v"}`` ``[n_layers, B, max_len, KV, hd]``; ssm:
    ``{"conv_x", "conv_bc", "state"}`` ``[n_layers, B, ...]``; hybrid:
    ``{"ssm": {...} [n_groups, k, B, ...], "attn": {"k", "v"} [n_groups,
    B, max_len, KV, hd]}``; vlm: ``{"self": {"k", "v"} [n_groups, k - 1,
    B, max_len, KV, hd], "cross": {"k", "v"} [n_groups, B,
    n_image_tokens, KV, hd]}``. ``device="meta"`` gives shapes and dtypes
    only."""
    check_servable(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    return _cache(cfg, batch, max_len, dtype or L.cdt(cfg), dev)


def cache_batch_axes(cfg: LMConfig) -> dict:
    """The cache's tree with each leaf's batch axis (1, or 2 for a hybrid
    SSM leaf and a vlm self-attention leaf), read off the shapes
    ``init_cache`` gives at batch 1 and 2."""
    check_servable(cfg)
    one, two = (_cache(cfg, b, 1, L.cdt(cfg), torch.device("meta"))
                for b in (1, 2))
    return tree_map(lambda a, b: next(
        i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n),
        one, two)


def _layer(blocks: Params, i) -> Params:
    """Layer ``i`` (an int, or a (group, block) pair) as views of the
    stacks."""
    return _tree_map(lambda t: t[i], blocks)


def _layers(blocks: Params, n: int) -> list[Params]:
    """Every layer's params as views of the stacks, by one ``unbind`` a
    leaf: its backward stacks the layers' gradients once, where indexing
    layer by layer would add a zero-padded stack-sized gradient a layer."""
    out = [{} for _ in range(n)]

    def split(node, dsts):
        for k, v in node.items():
            if isinstance(v, dict):
                split(v, [d.setdefault(k, {}) for d in dsts])
            else:
                for d, t in zip(dsts, torch.unbind(v, 0)):
                    d[k] = t
    split(blocks, out)
    return out


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of matmuls without batch dims, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: LMConfig):
    """``cfg.remat``: "none" keeps every activation; "full" keeps a
    block's inputs and recomputes the rest in the backward pass; "dots"
    also keeps the outputs of its non-batched matmuls. The gradients are
    the same bits in all three."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r} (expected none, dots or full)")


def _dense_block_fwd(h: torch.Tensor, bp: Params, cfg: LMConfig,
                     positions: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (h, moe aux loss): the MoE layer's load-balance loss, or 0
    for an MLP block."""
    h = h + L.self_attention(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                   cfg.norm_eps),
                             cfg, causal=True, positions=positions)
    x = L.rmsnorm(h, bp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_mod.moe_apply(bp["moe"], x, cfg)
        return h + y, aux["lb_loss"]
    y = L.mlp_apply(bp["mlp"], x, cfg)
    return h + y, replicated_like(torch.zeros((), dtype=torch.float32,
                                              device=h.device), h)


def _ssm_block_fwd(h: torch.Tensor, bp: Params, cfg: LMConfig
                   ) -> torch.Tensor:
    return h + ssm_mod.ssm_block_apply(
        bp["ssm"], L.rmsnorm(h, bp["ln"], cfg.norm_eps), cfg)


def _cross_block_fwd(h: torch.Tensor, bp: Params, memory: torch.Tensor,
                     cfg: LMConfig) -> torch.Tensor:
    """A cross-attention block onto ``memory`` (the image embeddings)
    through the plain ``attention_core``, then its MLP."""
    h = h + L.cross_attention(bp["xattn"], L.rmsnorm(h, bp["ln1"],
                                                     cfg.norm_eps),
                              memory, cfg)
    return h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps),
                           cfg)


def backbone(params: Params, h: torch.Tensor, cfg: LMConfig,
             positions: torch.Tensor | None = None,
             img_embed: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the layer stack. Returns (hidden, total moe aux loss): the sum
    of the MoE layers' load-balance losses in float32, 0 without MoE (as
    in the reference, a hybrid's shared block adds none). The vlm needs
    ``img_embed`` [B, n_image_tokens, vision_dim]."""
    check_servable(cfg)
    lb = replicated_like(torch.zeros((), dtype=torch.float32, device=h.device),
                         h)
    if cfg.family in ("dense", "moe"):
        def body(h, lb, bp):
            h, lb_i = _dense_block_fwd(shard_batch(h), bp, cfg, positions)
            return shard_batch(h), lb + lb_i
        body = _maybe_remat(body, cfg)
        for bp in _layers(params["blocks"], cfg.n_layers):
            h, lb = body(h, lb, bp)
        return h, lb
    if cfg.family == "hybrid":
        n_groups, k_blocks = _groups(cfg)

        def group(h, gp, shared):
            h = shard_batch(h)
            for bp in _layers(gp, k_blocks):
                h = shard_batch(_ssm_block_fwd(h, bp, cfg))
            return shard_batch(_dense_block_fwd(h, shared, cfg, positions)[0])
        group = _maybe_remat(group, cfg)
        for gp in _layers(params["blocks"], n_groups):
            h = group(h, gp, params["shared"])
        return h, lb
    if cfg.family == "vlm":
        if img_embed is None:
            raise ValueError(f"{cfg.name}: a vlm batch needs img_embed")
        n_groups, k_blocks = _groups(cfg)

        def group(h, gp, xp, memory):
            h = shard_batch(h)
            for bp in _layers(gp, k_blocks):
                h = shard_batch(_dense_block_fwd(h, bp, cfg, positions)[0])
            return shard_batch(_cross_block_fwd(h, xp, memory, cfg))
        group = _maybe_remat(group, cfg)
        for gp, xp in zip(_layers(params["blocks"], n_groups),
                          _layers(params["cross_blocks"], n_groups)):
            h = group(h, gp, xp, img_embed)
        return h, lb
    body = _maybe_remat(lambda h, bp: shard_batch(_ssm_block_fwd(
        shard_batch(h), bp, cfg)), cfg)
    for bp in _layers(params["blocks"], cfg.n_layers):
        h = body(h, bp)
    return h, lb


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            img_embed: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (and the vlm's ``img_embed``) → (logits [B, S, Vp],
    moe aux loss)."""
    check_servable(cfg)
    h = L.embed_apply(params["embed"], tokens, cfg)
    h, lb = backbone(params, h, cfg, img_embed=img_embed)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg), lb


def loss_fn(params: Params, batch: dict, cfg: LMConfig,
            lb_coef: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Training loss through the chunked CE (no [B, S, V] logits kept).
    The vlm reads ``batch["img_embed"]``. Returns (loss, {"ce", "lb"})."""
    check_servable(cfg)
    h = L.embed_apply(params["embed"], batch["tokens"], cfg)
    h, lb = backbone(params, h, cfg, img_embed=batch.get("img_embed"))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    ce = L.chunked_cross_entropy(params["embed"], h, batch["labels"], cfg)
    return ce + lb_coef * lb, {"ce": ce, "lb": lb}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _ffn(bp: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """The block's MLP, or its MoE layer (aux loss dropped, as in the
    reference's serving path)."""
    if cfg.n_experts:
        return moe_mod.moe_apply(bp["moe"], x, cfg)[0]
    return L.mlp_apply(bp["mlp"], x, cfg)


def _attn_block_decode(bp: Params, h: torch.Tensor, ck: torch.Tensor,
                       cv: torch.Tensor, pos: torch.Tensor, cfg: LMConfig
                       ) -> torch.Tensor:
    h = h + L.decode_attention(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                     cfg.norm_eps),
                               ck, cv, pos, cfg)
    return h + _ffn(bp, L.rmsnorm(h, bp["ln2"], cfg.norm_eps), cfg)


def _cross_block_decode(bp: Params, h: torch.Tensor, ck: torch.Tensor,
                        cv: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """A cross-attention block's step over its cache (filled at prefill,
    only read here): the query alone through the plain ``attention_core``
    onto every cached key."""
    h = h + L.cached_cross_attention(
        bp["xattn"], L.rmsnorm(h, bp["ln1"], cfg.norm_eps), ck, cv, cfg)
    return h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps),
                           cfg)


def _ssm_block_decode(bp: Params, h: torch.Tensor, c: dict, cfg: LMConfig
                      ) -> torch.Tensor:
    """One SSM block's step; ``c`` holds views of its cache, written."""
    y, new = ssm_mod.ssm_block_decode(
        bp["ssm"], L.rmsnorm(h, bp["ln"], cfg.norm_eps), c, cfg)
    for k, v in new.items():
        c[k].copy_(v)
    return h + y


def decode_step(params: Params, token: torch.Tensor, pos: torch.Tensor,
                cache: dict, cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """token [B, 1] → (logits [B, 1, Vp], cache updated in place). ``pos``
    is a scalar or per-row ``[B]`` tensor of write positions."""
    check_servable(cfg)
    h = L.embed_apply(params["embed"], token, cfg)
    blocks = params["blocks"]
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            h = shard_batch(_attn_block_decode(_layer(blocks, i),
                                               shard_batch(h), cache["k"][i],
                                               cache["v"][i], pos, cfg))
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = shard_batch(_ssm_block_decode(
                _layer(blocks, i), shard_batch(h),
                {k: v[i] for k, v in cache.items()}, cfg))
    elif cfg.family == "hybrid":
        n_groups, k_blocks = _groups(cfg)
        for g in range(n_groups):
            for j in range(k_blocks):
                h = _ssm_block_decode(
                    _layer(blocks, (g, j)), h,
                    {k: v[g, j] for k, v in cache["ssm"].items()}, cfg)
            h = _attn_block_decode(params["shared"], h,
                                   cache["attn"]["k"][g],
                                   cache["attn"]["v"][g], pos, cfg)
    else:
        n_groups, k_blocks = _groups(cfg)
        sc, xc = cache["self"], cache["cross"]
        for g in range(n_groups):
            for j in range(k_blocks):
                h = _attn_block_decode(_layer(blocks, (g, j)), h,
                                       sc["k"][g, j], sc["v"][g, j], pos, cfg)
            h = _cross_block_decode(_layer(params["cross_blocks"], g), h,
                                    xc["k"][g], xc["v"][g], cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg), cache


# ---------------------------------------------------------------------------
# prefill — build the cache for a prompt, return last-token logits
# ---------------------------------------------------------------------------

def self_attn_prefill(p: Params, x: torch.Tensor, cfg: LMConfig,
                      positions: torch.Tensor, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention of the normed x through K5: (output, k, v), k and v
    for the cache."""
    q, k, v = L.project_qkv(p, x, x, cfg, positions, positions)
    o = gqa_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return L.attn_out(p, o, cfg), k, v


def cross_attn_prefill(p: Params, x: torch.Tensor, memory: torch.Tensor,
                       cfg: LMConfig
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention of the normed x onto ``memory`` (image embeddings or
    encoder states) through K5 without the causal mask or rope: (output,
    k, v), k and v for the cross cache."""
    q, k, v = L.project_qkv(p, x, memory, cfg, None, None, use_rope=False)
    o = gqa_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return L.attn_out(p, o, cfg), k, v


def _attn_block_prefill(bp: Params, h: torch.Tensor, cfg: LMConfig,
                        positions: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A self-attention block through K5 that also returns its k and v
    for the cache."""
    a, k, v = self_attn_prefill(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                      cfg.norm_eps),
                                cfg, positions)
    h = h + a
    # pin the cache rows to their layout ([B@batch, S, KV@model, hd])
    k = shard_batch(k, None, "model", None)
    v = shard_batch(v, None, "model", None)
    return h + _ffn(bp, L.rmsnorm(h, bp["ln2"], cfg.norm_eps), cfg), k, v


def _cross_block_prefill(bp: Params, h: torch.Tensor, memory: torch.Tensor,
                         cfg: LMConfig
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A vlm cross-attention block onto the image embeddings; returns its
    k and v for the cross cache."""
    a, k, v = cross_attn_prefill(bp["xattn"], L.rmsnorm(h, bp["ln1"],
                                                        cfg.norm_eps),
                                 memory, cfg)
    h = h + a
    y = L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps), cfg)
    return h + y, k, v


def _ssm_block_prefill(bp: Params, h: torch.Tensor, c: dict, cfg: LMConfig
                       ) -> torch.Tensor:
    """An SSM block through K6; ``c`` holds views of its cache, written."""
    y, st, tails = ssm_mod._ssm_block_full(
        bp["ssm"], L.rmsnorm(h, bp["ln"], cfg.norm_eps), cfg)
    c["state"].copy_(st)
    c["conv_x"].copy_(tails["x"])
    c["conv_bc"].copy_(tails["bc"])
    return h + y


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            img_embed: torch.Tensor | None = None,
            max_len: int | None = None, cache: dict | None = None
            ) -> tuple[torch.Tensor, dict]:
    """tokens [B, S] → (last logits [B, Vp], cache with S entries of
    ``max_len`` positions). vlm needs ``img_embed`` [B, n_image_tokens,
    vision_dim], whose k and v fill the cross cache. ``cache``: the zero
    cache to fill (``serve/steps.build_prefill_step`` passes one placed
    on its mesh); by default a new one on the tokens' device."""
    check_servable(cfg)
    if cfg.family == "vlm" and img_embed is None:
        raise ValueError(f"{cfg.name}: vlm prefill needs img_embed")
    B, S = tokens.shape
    max_len = max_len or S
    h = L.embed_apply(params["embed"], tokens, cfg)
    blocks = params["blocks"]
    if cache is None:
        cache = init_cache(cfg, B, max_len, device=tokens.device)
    positions = torch.arange(S, device=tokens.device)[None, :]
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            h, k, v = _attn_block_prefill(_layer(blocks, i), shard_batch(h),
                                          cfg, positions)
            h = shard_batch(h)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = shard_batch(_ssm_block_prefill(
                _layer(blocks, i), shard_batch(h),
                {k: v[i] for k, v in cache.items()}, cfg))
    elif cfg.family == "hybrid":
        n_groups, k_blocks = _groups(cfg)
        for g in range(n_groups):
            for j in range(k_blocks):
                h = _ssm_block_prefill(
                    _layer(blocks, (g, j)), h,
                    {k: v[g, j] for k, v in cache["ssm"].items()}, cfg)
            h, k, v = _attn_block_prefill(params["shared"], h, cfg,
                                          positions)
            cache["attn"]["k"][g, :, :S] = k
            cache["attn"]["v"][g, :, :S] = v
    else:
        n_groups, k_blocks = _groups(cfg)
        sc, xc = cache["self"], cache["cross"]
        for g in range(n_groups):
            for j in range(k_blocks):
                h, k, v = _attn_block_prefill(_layer(blocks, (g, j)), h, cfg,
                                              positions)
                sc["k"][g, j, :, :S] = k
                sc["v"][g, j, :, :S] = v
            h, k, v = _cross_block_prefill(_layer(params["cross_blocks"], g),
                                           h, img_embed, cfg)
            xc["k"][g] = k
            xc["v"][g] = v
    h = L.rmsnorm(h[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg)[:, 0], cache
