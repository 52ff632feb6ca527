"""Decoder LM (the port's ``repro.models.lm`` for the ``dense`` and
``ssm`` families; the other families raise ``NotImplementedError``):

  dense — internlm2 (GQA attention + GLU MLP)
  ssm   — mamba2 (attention-free Mamba-2 blocks)

Params keep the reference's tree: ``embed``, ``final_norm`` and
``blocks`` with every leaf stacked ``[n_layers, ...]``; layers run in a
Python loop over views of the stacks. Training (``forward``,
``loss_fn``) runs each block under ``cfg.remat`` (``_maybe_remat``), the
attention through the plain ``attention_core`` and the SSD scan through
``nn/ssm.ssm_block_apply`` (K6's forward on the card). Prefill's causal
self-attention goes through ``kernels/flash_attention/ops.gqa_attention``
and the SSM prefill's scan through ``kernels/ssd/ops.ssd`` (the CUDA
kernels on the card); decode stays on the plain ``attention_core`` and
SSM step, as in the reference. Decode updates the cache in place.

API:
  init_params(gen, cfg, device)              → params
  params_from_jax(tree, cfg, device)         → params (reference weights)
  forward(params, tokens, cfg)               → (logits, moe aux loss)
  loss_fn(params, batch, cfg)                → (loss, {"ce", "lb"})
  init_cache(cfg, batch, max_len, device=)   → cache
  prefill(params, tokens, cfg, max_len=)     → (last_logits, cache)
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
from repro_torch.nn import ssm as ssm_mod

Params = dict
FAMILIES = ("dense", "ssm")


def _check_family(cfg: LMConfig) -> None:
    if cfg.family not in FAMILIES or cfg.n_experts or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"serves {FAMILIES}; ROADMAP.md, queue 1)")
    if cfg.qk_norm or cfg.act != "silu":
        raise NotImplementedError(
            f"{cfg.name}: qk-norm and GeGLU come with the remaining LM "
            f"architectures (ROADMAP.md, queue 1)")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init(gen: torch.Generator | None, cfg: LMConfig) -> Params:
    """The parameter tree drawn on ``gen``'s device, or on ``meta`` (shapes
    and dtypes only) when ``gen`` is None."""
    _check_family(cfg)
    n = (cfg.n_layers,)
    pd = L.pdt(cfg)
    params: Params = {"embed": L.embed_init(gen, cfg),
                      "final_norm": L.rmsnorm_init(gen, cfg.d_model, pd)}
    if cfg.family == "dense":
        params["blocks"] = {
            "ln1": L.rmsnorm_init(gen, cfg.d_model, pd, n),
            "attn": L.attn_init(gen, cfg, n),
            "ln2": L.rmsnorm_init(gen, cfg.d_model, pd, n),
            "mlp": L.mlp_init(gen, cfg, n),
        }
    else:
        params["blocks"] = {"ln": L.rmsnorm_init(gen, cfg.d_model, pd, n),
                            "ssm": ssm_mod.ssm_init(gen, cfg, n)}
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
    dev = resolve_device(device)
    skeleton = _init(None, cfg)

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

def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device: str | torch.device | None = None) -> dict:
    _check_family(cfg)
    dtype = dtype or L.cdt(cfg)
    dev = resolve_device(device)
    if cfg.family == "dense":
        shape = (cfg.n_layers, batch, max_len, cfg.phys_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return ssm_mod.ssm_init_cache(cfg, batch, dtype, dev, (cfg.n_layers,))


def _layer(blocks: Params, i: int) -> Params:
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
    """Returns (h, moe aux loss); the aux loss is 0 (no MoE is ported)."""
    h = h + L.self_attention(bp["attn"], L.rmsnorm(h, bp["ln1"],
                                                   cfg.norm_eps),
                             cfg, causal=True, positions=positions)
    y = L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"], cfg.norm_eps), cfg)
    return h + y, torch.zeros((), dtype=torch.float32, device=h.device)


def _ssm_block_fwd(h: torch.Tensor, bp: Params, cfg: LMConfig
                   ) -> torch.Tensor:
    return h + ssm_mod.ssm_block_apply(
        bp["ssm"], L.rmsnorm(h, bp["ln"], cfg.norm_eps), cfg)


def backbone(params: Params, h: torch.Tensor, cfg: LMConfig,
             positions: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the layer stack. Returns (hidden, total moe aux loss)."""
    layers = _layers(params["blocks"], cfg.n_layers)
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "dense":
        def body(h, lb, bp):
            h, lb_i = _dense_block_fwd(h, bp, cfg, positions)
            return h, lb + lb_i
        body = _maybe_remat(body, cfg)
        for bp in layers:
            h, lb = body(h, lb, bp)
        return h, lb
    body = _maybe_remat(partial(_ssm_block_fwd, cfg=cfg), cfg)
    for bp in layers:
        h = body(h, bp)
    return h, lb


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, Vp], moe aux loss)."""
    _check_family(cfg)
    h = L.embed_apply(params["embed"], tokens, cfg)
    h, lb = backbone(params, h, cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg), lb


def loss_fn(params: Params, batch: dict, cfg: LMConfig,
            lb_coef: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Training loss through the chunked CE (no [B, S, V] logits kept).
    Returns (loss, {"ce", "lb"})."""
    _check_family(cfg)
    h = L.embed_apply(params["embed"], batch["tokens"], cfg)
    h, lb = backbone(params, h, cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    ce = L.chunked_cross_entropy(params["embed"], h, batch["labels"], cfg)
    return ce + lb_coef * lb, {"ce": ce, "lb": lb}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params: Params, token: torch.Tensor, pos: torch.Tensor,
                cache: dict, cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """token [B, 1] → (logits [B, 1, Vp], cache updated in place). ``pos``
    is a scalar or per-row ``[B]`` tensor of write positions."""
    _check_family(cfg)
    h = L.embed_apply(params["embed"], token, cfg)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        bp = _layer(blocks, i)
        if cfg.family == "dense":
            h = h + L.decode_attention(
                bp["attn"], L.rmsnorm(h, bp["ln1"], cfg.norm_eps),
                cache["k"][i], cache["v"][i], pos, cfg)
            h = h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"],
                                                     cfg.norm_eps), cfg)
        else:
            c = {k: v[i] for k, v in cache.items()}
            y, c = ssm_mod.ssm_block_decode(
                bp["ssm"], L.rmsnorm(h, bp["ln"], cfg.norm_eps), c, cfg)
            for k, v in c.items():
                cache[k][i].copy_(v)
            h = h + y
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg), cache


# ---------------------------------------------------------------------------
# prefill — build the cache for a prompt, return last-token logits
# ---------------------------------------------------------------------------

def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """tokens [B, S] → (last logits [B, Vp], cache with S entries of
    ``max_len`` positions)."""
    _check_family(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    h = L.embed_apply(params["embed"], tokens, cfg)
    blocks = params["blocks"]
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    if cfg.family == "dense":
        positions = torch.arange(S, device=tokens.device)[None, :]
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            xn = L.rmsnorm(h, bp["ln1"], cfg.norm_eps)
            q, k, v = L.project_qkv(bp["attn"], xn, xn, cfg, positions,
                                    positions)
            o = gqa_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
            h = h + L.attn_out(bp["attn"], o, cfg)
            h = h + L.mlp_apply(bp["mlp"], L.rmsnorm(h, bp["ln2"],
                                                     cfg.norm_eps), cfg)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    else:
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            y, st, tails = ssm_mod._ssm_block_full(
                bp["ssm"], L.rmsnorm(h, bp["ln"], cfg.norm_eps), cfg)
            h = h + y
            cache["state"][i] = st
            cache["conv_x"][i] = tails["x"]
            cache["conv_bc"][i] = tails["bc"]
    h = L.rmsnorm(h[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg)[:, 0], cache
