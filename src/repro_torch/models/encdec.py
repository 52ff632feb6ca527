"""Encoder-decoder transformer (the port's ``repro.models.encdec``, the
seamless-m4t-large-v2 backbone), served and trained.

The audio/text front end is a stub, as in the reference: the encoder
consumes precomputed frame embeddings [B, S_enc, d_model]. Encoder =
bidirectional self-attention blocks (``models/lm``'s dense block);
decoder block = causal self-attention + cross-attention onto the encoder
output + GLU MLP. Params keep the reference's tree: ``embed``,
``enc_blocks`` ``[encoder_layers, ...]``, ``enc_norm``, ``dec_blocks``
``[n_layers, ...]`` and ``final_norm``.

Every prefill attention goes through
``kernels/flash_attention/ops.gqa_attention`` (the CUDA kernel on the
card): the encoder's and the decoder's cross-attention without the
causal mask, the decoder's self-attention with it. Decode runs the plain
``attention_core`` over both caches, writes the self-attention cache in
place and only reads the cross-attention cache, filled at prefill.
Training (``forward``, ``loss_fn``) runs its own encoder,
``encode_trainable``: every attention of both stacks through the plain,
differentiable ``attention_core`` (K5 is forward-only), each block under
``cfg.remat`` (``lm._maybe_remat``), as the reference's scanned stacks.

API:
  init_params(gen, cfg, device)                   → params
  params_from_jax(tree, cfg, device)              → params (reference weights)
  init_cache(cfg, batch, max_len, enc_len, device=) → cache
  encode(params, frames, cfg)                     → encoder states (K5)
  encode_trainable(params, frames, cfg)           → encoder states (plain)
  forward(params, frames, tokens, cfg)            → logits
  loss_fn(params, batch, cfg)                     → (ce, {"ce"})
  prefill(params, frames, tokens, cfg, max_len=)  → (last_logits, cache)
  decode_step(params, token, pos, cache, cfg)     → (logits, cache)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.lm import (_dense_block_init, _layer, _layers,
                                   _maybe_remat, _tree_map, attn_cache,
                                   cross_attn_prefill, self_attn_prefill,
                                   tree_like)
from repro_torch.nn import layers as L
from repro_torch.sharding.rules import shard_batch

Params = dict


def check_encdec(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` for a config without an encoder
    (``models/lm.py`` serves those)."""
    if not cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: models/encdec.py serves encoder-decoder configs "
            f"(encoder_layers > 0); family {cfg.family!r} is served by "
            f"models/lm.py")


def _dec_block_init(gen, cfg: LMConfig, lead: tuple) -> Params:
    pd = L.pdt(cfg)
    return {"ln1": L.rmsnorm_init(gen, cfg.d_model, pd, lead),
            "attn": L.attn_init(gen, cfg, lead),
            "lnx": L.rmsnorm_init(gen, cfg.d_model, pd, lead),
            "xattn": L.attn_init(gen, cfg, lead, cross=True),
            "ln2": L.rmsnorm_init(gen, cfg.d_model, pd, lead),
            "mlp": L.mlp_init(gen, cfg, lead)}


def _init(gen: torch.Generator | None, cfg: LMConfig) -> Params:
    """The parameter tree drawn on ``gen``'s device, or on ``meta`` when
    ``gen`` is None."""
    check_encdec(cfg)
    pd = L.pdt(cfg)
    return {"embed": L.embed_init(gen, cfg),
            "enc_blocks": _dense_block_init(gen, cfg, (cfg.encoder_layers,)),
            "enc_norm": L.rmsnorm_init(gen, cfg.d_model, pd),
            "dec_blocks": _dec_block_init(gen, cfg, (cfg.n_layers,)),
            "final_norm": L.rmsnorm_init(gen, cfg.d_model, pd)}


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: str | torch.device | None = None) -> Params:
    """Seeded weights, drawn on ``gen``'s device and placed on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    return _tree_map(lambda t: t.to(dev), _init(gen, cfg))


def params_from_jax(tree: dict, cfg: LMConfig,
                    device: str | torch.device | None = None) -> Params:
    """The reference's ``encdec.init_params`` tree (numpy leaves) as the
    port's tree, each leaf in the dtype the port allocates for it."""
    return tree_like(tree, _init(None, cfg), device)


def init_cache(cfg: LMConfig, batch: int, max_len: int, enc_len: int,
               dtype=None, device: str | torch.device | None = None) -> dict:
    """``{"self": {"k", "v"} [n_layers, B, max_len, KV, hd], "cross":
    {"k", "v"} [n_layers, B, enc_len, KV, hd]}``; batch is axis 1 of every
    leaf. ``device="meta"`` gives shapes and dtypes only."""
    check_encdec(cfg)
    dtype = dtype or L.cdt(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    lead = (cfg.n_layers,)
    return {"self": attn_cache(cfg, lead, batch, max_len, dtype, dev),
            "cross": attn_cache(cfg, lead, batch, enc_len, dtype, dev)}


def encode(params: Params, frames: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    """frames [B, S_enc, D] (stub front-end embeddings) → encoder states,
    each block's attention through K5 without the causal mask."""
    check_encdec(cfg)
    h = frames.to(L.cdt(cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for i in range(cfg.encoder_layers):
        bp = _layer(params["enc_blocks"], i)
        h = shard_batch(h)
        h = h + self_attn_prefill(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                        cfg.norm_eps),
                                  cfg, positions, causal=False)[0]
        h = shard_batch(h + L.mlp_apply(
            bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps), cfg))
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def prefill(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: LMConfig, max_len: int | None = None,
            cache: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Encode ``frames``, then run the decoder over the prompt ``tokens``
    [B, S]: (last logits [B, Vp], cache with S self entries of
    ``max_len`` positions and the encoder length of cross entries).
    ``cache``: the zero cache to fill, as in ``lm.prefill``."""
    memory = encode(params, frames, cfg)
    B, S = tokens.shape
    max_len = max_len or S
    h = L.embed_apply(params["embed"], tokens, cfg)
    if cache is None:
        cache = init_cache(cfg, B, max_len, memory.shape[1],
                           device=tokens.device)
    sc, xc = cache["self"], cache["cross"]
    positions = torch.arange(S, device=tokens.device)[None, :]
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = shard_batch(h)
        a, k, v = self_attn_prefill(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                          cfg.norm_eps),
                                    cfg, positions)
        h = h + a
        sc["k"][i, :, :S] = k
        sc["v"][i, :, :S] = v
        a, k, v = cross_attn_prefill(bp["xattn"], L.rmsnorm(h, bp["lnx"],
                                                            cfg.norm_eps),
                                     memory, cfg)
        h = h + a
        xc["k"][i] = k
        xc["v"][i] = v
        h = shard_batch(h + L.mlp_apply(
            bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps), cfg))
    h = L.rmsnorm(h[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg)[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, pos: torch.Tensor,
                cache: dict, cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """token [B, 1] → (logits [B, 1, Vp], cache with the self entries
    written in place at ``pos``, a scalar or per-row ``[B]``). The cross
    query is ``project_q``'s: the reference projects k and v of the
    decoder state too and drops them; q is the same product."""
    check_encdec(cfg)
    h = L.embed_apply(params["embed"], token, cfg)
    sc, xc = cache["self"], cache["cross"]
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = h + L.decode_attention(bp["attn"],
                                   L.rmsnorm(h, bp["ln1"], cfg.norm_eps),
                                   sc["k"][i], sc["v"][i], pos, cfg)
        h = h + L.cached_cross_attention(
            bp["xattn"], L.rmsnorm(h, bp["lnx"], cfg.norm_eps), xc["k"][i],
            xc["v"][i], cfg)
        h = h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps),
                            cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg), cache


# ---------------------------------------------------------------------------
# training: every attention through the plain attention_core
# ---------------------------------------------------------------------------

def _enc_block_fwd(h: torch.Tensor, bp: Params, cfg: LMConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    h = h + L.self_attention(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                   cfg.norm_eps),
                             cfg, causal=False, positions=positions)
    return h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps),
                           cfg)


def _dec_block_fwd(h: torch.Tensor, bp: Params, memory: torch.Tensor,
                   cfg: LMConfig, positions: torch.Tensor) -> torch.Tensor:
    h = h + L.self_attention(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                   cfg.norm_eps),
                             cfg, causal=True, positions=positions)
    h = h + L.cross_attention(bp["xattn"], L.rmsnorm(h, bp["lnx"],
                                                     cfg.norm_eps),
                              memory, cfg)
    return h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps),
                           cfg)


def encode_trainable(params: Params, frames: torch.Tensor, cfg: LMConfig
                     ) -> torch.Tensor:
    """frames [B, S_enc, D] → encoder states, differentiable: ``encode``'s
    arithmetic with each block's attention through the plain
    ``attention_core`` instead of K5, each block under ``cfg.remat``."""
    check_encdec(cfg)
    h = frames.to(L.cdt(cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    body = _maybe_remat(lambda h, bp: shard_batch(_enc_block_fwd(
        shard_batch(h), bp, cfg, positions)), cfg)
    for bp in _layers(params["enc_blocks"], cfg.encoder_layers):
        h = body(h, bp)
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _decoder(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
             cfg: LMConfig) -> torch.Tensor:
    """The decoder's final normed states over ``tokens`` [B, S_dec],
    attending to the encoded ``frames``."""
    memory = encode_trainable(params, frames, cfg)
    h = L.embed_apply(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    body = _maybe_remat(lambda h, bp, memory: shard_batch(_dec_block_fwd(
        shard_batch(h), bp, memory, cfg, positions)), cfg)
    for bp in _layers(params["dec_blocks"], cfg.n_layers):
        h = body(h, bp, memory)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def forward(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: LMConfig) -> torch.Tensor:
    """(frames [B, S_enc, D], tokens [B, S_dec]) → logits [B, S_dec, Vp]."""
    return L.unembed_apply(params["embed"],
                           _decoder(params, frames, tokens, cfg), cfg)


def loss_fn(params: Params, batch: dict, cfg: LMConfig
            ) -> tuple[torch.Tensor, dict]:
    """Training loss over ``batch`` (``frames``, ``tokens``, ``labels``)
    through the chunked CE: (ce, {"ce": ce}), no load-balance term, as in
    the reference."""
    check_encdec(cfg)
    h = _decoder(params, batch["frames"], batch["tokens"], cfg)
    ce = L.chunked_cross_entropy(params["embed"], h, batch["labels"], cfg)
    return ce, {"ce": ce}
