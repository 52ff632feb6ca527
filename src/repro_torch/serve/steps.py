"""Serving-step builders (the port's ``repro.serve.steps``):
``build_prefill_step`` (prompt → last logits + cache) and
``build_serve_step`` (one decode token against a KV/SSM cache) on a mesh.

Serving runs bf16 params (``serve_config`` rewrites the config on entry).
Each builder returns ``(step, argument structs, cfg)``: the structs are
``sharding/rules.Struct`` trees (a ``meta`` tensor and its spec a leaf;
the reference's ``ShapeDtypeStruct``s with ``NamedSharding``s), and the
step takes DTensors placed by them (``rules.place``). The model body runs
under DTensor's op-by-op sharding propagation with the reference's pins
(``rules.shard_batch``); K5 and K6 run on each rank's local shards
(``local_map`` in their ``ops``). The cache is a fresh set of zero
DTensors placed by ``rules.cache_pspecs`` (:func:`cache_structs`), which
prefill fills and decode updates in place (the reference donates it).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any

import torch

from repro_torch.configs.base import LMConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.sharding import rules
from repro_torch.train.steps import param_structs
from repro_torch.utils import tree_map

PyTree = Any


def serve_config(cfg: LMConfig) -> LMConfig:
    """Serving numerics: bf16 params, no remat, dropless MoE.

    ``capacity_factor = E / K`` makes an expert's capacity cover the worst
    routing (every token to one expert), so serving never drops a token and
    a request's output does not depend on what shares its batch."""
    kw = dict(param_dtype="bfloat16", remat="none")
    if cfg.n_experts:
        kw["capacity_factor"] = cfg.n_experts / max(cfg.top_k, 1)
    return replace(cfg, **kw)


def cache_structs(cfg: LMConfig, mesh, batch: int, max_len: int,
                  enc_len: int | None = None) -> PyTree:
    """``rules.Struct`` tree of the cache for ``batch`` rows of
    ``max_len`` positions (enc-dec: ``enc_len`` cross positions, default
    ``max_len``), specs by ``rules.cache_pspecs``."""
    if cfg.is_encdec:
        shapes = encdec.init_cache(cfg, batch, max_len, enc_len or max_len,
                                   device="meta")
    else:
        shapes = lm.init_cache(cfg, batch, max_len, device="meta")
    return rules.structs(shapes, rules.cache_pspecs(shapes, cfg, mesh, batch),
                         mesh)


def _input_structs(cfg: LMConfig, shape: ShapeConfig, mesh, seq: int
                   ) -> dict:
    """``rules.Struct``s of tokens [B, seq] and, for the vlm and enc-dec,
    ``img_embed`` / ``frames`` in the compute dtype."""
    B, S = shape.global_batch, shape.seq_len
    specs = rules.input_pspecs(cfg, shape, mesh)
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.compute_dtype]
    metas = {"tokens": torch.empty((B, seq), dtype=torch.int64,
                                   device="meta")}
    if cfg.family == "vlm":
        metas["img_embed"] = torch.empty(
            (B, cfg.n_image_tokens, cfg.vision_dim), dtype=cdt, device="meta")
    if cfg.is_encdec:
        metas["frames"] = torch.empty((B, S, cfg.d_model), dtype=cdt,
                                      device="meta")
    return rules.structs(metas, {k: specs[k] for k in metas}, mesh)


def build_serve_step(cfg: LMConfig, shape: ShapeConfig, mesh,
                     donate: bool = True):
    """One-token decode step on ``mesh``. Returns (step, (params, token,
    pos, cache structs), cfg); ``step(params, token, pos, cache) →
    (logits [B, 1, Vp], cache)``, ``pos`` a plain 0-dim tensor. With
    ``donate`` the cache is updated in place and returned; without, a copy
    is."""
    cfg = serve_config(cfg)
    B, S = shape.global_batch, shape.seq_len
    p_sds, _ = param_structs(cfg, mesh)
    c_sds = cache_structs(cfg, mesh, B, S, enc_len=S if cfg.is_encdec
                          else None)
    tok_sds = _input_structs(cfg, shape, mesh, 1)["tokens"]
    pos_sds = torch.empty((), dtype=torch.int64, device="meta")
    decode = encdec.decode_step if cfg.is_encdec else lm.decode_step

    def step(params, token, pos, cache):
        rules.check_placed("token", token, tok_sds)
        if not donate:
            cache = tree_map(torch.clone, cache)
        with rules.use_mesh(mesh):
            return decode(params, token, pos, cache, cfg)

    return step, (p_sds, tok_sds, pos_sds, c_sds), cfg


def build_prefill_step(cfg: LMConfig, shape: ShapeConfig, mesh):
    """Prompt prefill on ``mesh``: tokens [B, S] (and the vlm's
    ``img_embed`` or the enc-dec's ``frames``) → (last logits [B, Vp],
    cache of S positions). Returns (step, arg structs, cfg): ``(params,
    tokens)``, plus ``img_embed`` (vlm) or ``frames`` (enc-dec), as the
    step takes them."""
    cfg = serve_config(cfg)
    B, S = shape.global_batch, shape.seq_len
    p_sds, _ = param_structs(cfg, mesh)
    ins = _input_structs(cfg, shape, mesh, S)
    c_sds = cache_structs(cfg, mesh, B, S, enc_len=S if cfg.is_encdec
                          else None)
    extra = [k for k in ("img_embed", "frames") if k in ins]

    def step(params, tokens, *more):
        if len(more) != len(extra):
            raise TypeError(f"{cfg.name}: the prefill step takes params, "
                            f"tokens{''.join(', ' + k for k in extra)}")
        for name, t in zip(["tokens"] + extra, (tokens,) + more):
            rules.check_placed(name, t, ins[name])
        cache = rules.zeros(c_sds)
        with rules.use_mesh(mesh):
            if cfg.is_encdec:
                return encdec.prefill(params, more[0], tokens, cfg,
                                      cache=cache)
            return lm.prefill(params, tokens, cfg,
                              img_embed=more[0] if more else None,
                              cache=cache)

    return step, (p_sds, ins["tokens"], *(ins[k] for k in extra)), cfg


def grow_cache(cache: PyTree, structs: PyTree) -> PyTree:
    """A prefill's cache of S positions inside a zero cache placed by a
    longer step's :func:`cache_structs` (the reference pads the prefill's
    cache to the decode length): attention leaves fill their first S
    positions (axis -3), SSM leaves, which carry no positions, are copied
    whole."""
    out = rules.zeros(structs)

    def fill(dst, src):
        if dst.shape == src.shape:
            dst.copy_(src)
        else:
            dst[..., :src.shape[-3], :, :].copy_(src)
        return dst
    return tree_map(fill, out, cache)
