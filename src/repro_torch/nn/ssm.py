"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block (the
port's ``repro.nn.ssm``).

Training (``ssm_block_apply``) runs the differentiable chunked SSD scan:
``ssd_chunked`` itself on the CPU, as the reference does, and on the card
``kernels/ssd/ops.ssd_trainable`` (the CUDA kernel forward, the gradient
of ``ssd_chunked``). Prefill runs the forward-only ``ops.ssd`` (the CUDA
kernel on the card, the sequential recurrence on the CPU) and returns the
final state and the conv tails; decode carries (conv_state, ssm_state) and
costs O(1) per token. Projections stay split (wz / wx / wbc / wdt), as in
the reference, so the parameter trees are the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.ssd.ops import on_shards, ssd, ssd_trainable
from repro_torch.nn.layers import _device, _full, _normal, cdt, pdt, rmsnorm

Params = dict


def ssm_dims(cfg: LMConfig) -> dict:
    di = cfg.ssm_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return dict(di=di, gn=gn, nh=cfg.ssm_nheads, hp=cfg.ssm_head_dim)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_init(gen, cfg: LMConfig, lead: tuple = ()) -> Params:
    d = ssm_dims(cfg)
    D = cfg.d_model
    s = 1.0 / math.sqrt(D)
    dt = pdt(cfg)
    dev = _device(gen)
    f32 = torch.float32
    nh = d["nh"]
    lin = torch.linspace(1e-3, 0.1, nh, dtype=f32, device=dev)
    dt_init = torch.log(torch.exp(lin) - 1.0)                 # inv softplus
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev))
    # the reference draws out_proj from wbc's key: the same random stream,
    # so the two leaves of one layer are not independent there; here each
    # leaf has its own draws (weights are carried across by params_from_jax)
    return {
        "wz": _normal(gen, lead + (D, d["di"]), s, dt),
        "wx": _normal(gen, lead + (D, d["di"]), s, dt),
        "wbc": _normal(gen, lead + (D, 2 * d["gn"]), s, dt),
        "wdt": _normal(gen, lead + (D, nh), s, dt),
        "conv_wx": _normal(gen, lead + (cfg.ssm_conv, d["di"]), 0.2, dt),
        "conv_bx": _full(gen, lead + (d["di"],), 0.0, dt),
        "conv_wbc": _normal(gen, lead + (cfg.ssm_conv, 2 * d["gn"]), 0.2, dt),
        "conv_bbc": _full(gen, lead + (2 * d["gn"],), 0.0, dt),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D_skip": _full(gen, lead + (nh,), 1.0, f32),
        "dt_bias": dt_init.expand(lead + (nh,)).clone(),
        "norm": _full(gen, lead + (d["di"],), 1.0, dt),
        "out_proj": _normal(gen, lead + (d["di"], D),
                            (1.0 / math.sqrt(d["di"]))
                            / math.sqrt(2 * cfg.n_layers), dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x [B,S,C], w [K,C] → [B,S,C]. On DTensors it
    runs on each rank's shards (``local_map``; rows and channels are
    independent, so x's placements are kept, w's and b's channels
    following x's): torch 2.11's DTensor pads (``constant_pad_nd``) with
    one placement whatever the mesh."""
    if hasattr(x, "placements"):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        if any(isinstance(p, Shard) and p.dim == 1 for p in x.placements):
            raise NotImplementedError("the causal conv on a mesh takes an "
                                      "unsharded sequence")
        from torch.distributed.tensor import Partial
        wp = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2
                   else Replicate() for p in x.placements)
        bp = tuple(Shard(0) if isinstance(p, Shard) else p for p in wp)
        # w's and b's gradients sum over the batch shards
        over_b = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
        wg, bg = ([Partial() if o else p for o, p in zip(over_b, q)]
                  for q in (wp, bp))
        return local_map(_causal_conv, out_placements=list(x.placements),
                         in_placements=(x.placements, wp, bp),
                         in_grad_placements=(x.placements, wg, bg),
                         device_mesh=x.device_mesh,
                         redistribute_inputs=True)(x, w, b)
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def _scan(x: torch.Tensor, reverse: bool, block: int = 16) -> torch.Tensor:
    """Inclusive sums along the last axis (suffix sums if ``reverse``) as
    a two-level scan: each block of ``block`` summed left to right, the
    block totals scanned the same way, each block's carry added last."""
    n = x.shape[-1]
    if n <= block:
        acc = x.clone()
        if reverse:        # acc[i] = ((x_i + x_i+1) + x_i+2) + ...
            for d in range(1, n):
                acc[..., :n - d] = acc[..., :n - d] + x[..., d:]
            return acc
        for k in range(1, n):
            acc[..., k] = acc[..., k - 1] + x[..., k]
        return acc
    inner = _scan(F.pad(x, (0, -n % block)).reshape(x.shape[:-1]
                                                     + (-1, block)),
                  reverse, block)
    tot = _scan(inner[..., 0 if reverse else -1], reverse, block)
    zero = torch.zeros_like(tot[..., :1])
    carry = (torch.cat([tot[..., 1:], zero], -1) if reverse
             else torch.cat([zero, tot[..., :-1]], -1))
    return (inner + carry[..., None]).flatten(-2)[..., :n]


class _Cumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scan(x, reverse=False)

    @staticmethod
    def backward(ctx, g):
        return _scan(g, reverse=True)


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum`` along ``dim`` with the association XLA's CPU backend
    gives it, forward and transposed (blocks of 16, ``_scan``), so the
    decay sums, which ``exp`` turns into relative errors of the same size,
    round as the reference's do, on either device; ``torch.cumsum`` rounds
    otherwise (in double on the CPU)."""
    return _Cumsum.apply(x.movedim(dim, -1).contiguous()).movedim(-1, dim)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., L] log-decay increments → [..., L, L] lower-tri cumulative
    sums S[i,j] = sum_{k=j+1..i} a_k (i ≥ j), -inf above the diagonal."""
    L = a.shape[-1]
    cs = _cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan, differentiable, in float32: the quadratic form inside
    each chunk plus a linear recurrence over the chunk states.

    x [b,s,h,p], dt [b,s,h] (post-softplus), A [h] (negative), B, C
    [b,s,g,n] with h % g == 0; s a multiple of ``min(chunk, s)``. Returns
    (y [b,s,h,p] of x's type, state [b,h,p,n] float32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hr = h // g
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc = s // chunk

    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()

    a = dtc * A                                              # [b,nc,L,h] ≤ 0
    a_cs = _cumsum(a, 2)                                     # [b,nc,L,h]

    # ---- intra-chunk (quadratic within chunk) --------------------------
    seg = _segsum(a.movedim(2, -1))                          # [b,nc,h,L,L]
    decay = torch.exp(seg)
    scores = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)      # [b,nc,g,L,L]
    scores = scores.repeat_interleave(hr, 2)                 # g → h
    scores = scores * decay * dtc.movedim(2, -1)[..., None, :]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", scores, xc)

    # ---- chunk states ----------------------------------------------------
    decay_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)         # [b,nc,L,h]
    Bh = Bc.repeat_interleave(hr, 3)                         # [b,nc,L,h,n]
    S_chunk = torch.einsum("bclhn,bclh,bclhp->bchpn",
                           Bh, dtc * decay_end, xc)          # [b,nc,h,p,n]

    # ---- inter-chunk recurrence -----------------------------------------
    chunk_decay = torch.exp(a_cs[:, :, -1, :])               # [b,nc,h]
    state = (initial_state.float() if initial_state is not None
             else x.new_zeros((b, h, p, n), dtype=torch.float32))
    prev_states = []
    for c in range(nc):
        prev_states.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    prev = torch.stack(prev_states, 1)                       # [b,nc,h,p,n]

    Ch = Cc.repeat_interleave(hr, 3)                         # [b,nc,L,h,n]
    y_inter = torch.einsum("bclhn,bclh,bchpn->bclhp",
                           Ch, torch.exp(a_cs), prev)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), state


def _trainable_scan(x, dt, A, B, C, chunk: int):
    """The training block's scan: ``ssd_chunked`` on the CPU (the
    reference's ``_ssm_block_full``), ``ssd_trainable`` on CUDA tensors;
    the state is not returned on the card. DTensors on the CPU run
    ``ssd_chunked`` on each rank's shards (``ops.on_shards``)."""
    if x.device.type == "cpu":
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return on_shards(lambda *a: ssd_chunked(*a, chunk=chunk),
                             x, dt, A, B, C)
        return ssd_chunked(x, dt, A, B, C, chunk)
    return ssd_trainable(x, dt, A, B, C), None


def _project(p: Params, x: torch.Tensor, cfg: LMConfig):
    """Shared projection path. x [B,S,D] → (z, x_raw, bc_raw, dt_raw)."""
    dt_ = cdt(cfg)
    x = x.to(dt_)
    return (x @ p["wz"].to(dt_), x @ p["wx"].to(dt_),
            x @ p["wbc"].to(dt_), x @ p["wdt"].to(dt_))


def ssm_block_apply(p: Params, x: torch.Tensor, cfg: LMConfig,
                    chunk: int = 128) -> torch.Tensor:
    """Full Mamba-2 block (training). x: [B, S, D] → [B, S, D]."""
    y, _, _ = _ssm_block_full(p, x, cfg, chunk, scan=_trainable_scan)
    return y


def _ssm_block_full(p: Params, x: torch.Tensor, cfg: LMConfig,
                    chunk: int = 128, scan=ssd):
    """x [B, S, D] → (out [B, S, D], final ssm state [B, nh, hp, N] f32,
    conv tails {"x": [B, K-1, di], "bc": [B, K-1, 2gn]}); prefill needs all
    three. ``scan(x, dt, A, B, C, chunk)`` → (y, state) is the SSD scan:
    the forward-only ``ops.ssd`` for prefill, ``_trainable_scan`` for
    training."""
    d = ssm_dims(cfg)
    dt_ = cdt(cfg)
    B_, S_, _ = x.shape
    z, x_raw, bc_raw, dt_raw = _project(p, x, cfg)
    xs = F.silu(_causal_conv(x_raw, p["conv_wx"].to(dt_),
                             p["conv_bx"].to(dt_)))
    bcs = F.silu(_causal_conv(bc_raw, p["conv_wbc"].to(dt_),
                              p["conv_bbc"].to(dt_)))
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B_, S_, d["nh"], d["hp"])
    Bm = bcs[..., :d["gn"]].reshape(B_, S_, cfg.ssm_groups, cfg.ssm_state)
    Cm = bcs[..., d["gn"]:].reshape(B_, S_, cfg.ssm_groups, cfg.ssm_state)
    y, state = scan(xh, dt, A, Bm, Cm, chunk)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xh
    y = y.reshape(B_, S_, d["di"])
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    K = cfg.ssm_conv
    tails = {"x": x_raw[:, -(K - 1):, :], "bc": bc_raw[:, -(K - 1):, :]}
    return out, state, tails


# ---------------------------------------------------------------------------
# decode path — O(1) per token
# ---------------------------------------------------------------------------

def ssm_init_cache(cfg: LMConfig, batch: int, dtype, device=None,
                   lead: tuple = ()) -> dict:
    d = ssm_dims(cfg)
    z = dict(device=device)
    return {
        "conv_x": torch.zeros(lead + (batch, cfg.ssm_conv - 1, d["di"]),
                              dtype=dtype, **z),
        "conv_bc": torch.zeros(lead + (batch, cfg.ssm_conv - 1, 2 * d["gn"]),
                               dtype=dtype, **z),
        "state": torch.zeros(lead + (batch, d["nh"], d["hp"], cfg.ssm_state),
                             dtype=torch.float32, **z),
    }


def _ssm_step(state, dt, A, Bm, Cm, xh):
    """One token's recurrence: state [B,nh,hp,N], dt [B,nh], A [nh],
    Bm/Cm [B,nh,N], xh [B,nh,hp] → (new state, y [B,nh,hp]). On DTensors
    it runs on each rank's rows and heads (``local_map``; torch 2.11's
    DTensor cannot flatten its einsums' sharded batch and heads)."""
    if hasattr(state, "placements"):
        from torch.distributed.tensor.experimental import local_map

        from repro_torch.sharding.rules import local_placements
        mesh = state.device_mesh
        model = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
        h = 1 if state.shape[1] % model == 0 else None
        pl = [local_placements(mesh, t.shape, 0, h) for t in
              (state, dt, Bm, Cm, xh)]
        pa = local_placements(mesh, A.shape, None, 0 if h else None)
        return local_map(_ssm_step, out_placements=(pl[0], pl[4]),
                         in_placements=(pl[0], pl[1], pa, pl[2], pl[3],
                                        pl[4]),
                         device_mesh=mesh, redistribute_inputs=True
                         )(state, dt, A, Bm, Cm, xh)
    decay = torch.exp(dt * A)                                     # [B,nh]
    state = (state * decay[..., None, None]
             + torch.einsum("bh,bhn,bhp->bhpn", dt, Bm, xh))
    return state, torch.einsum("bhn,bhpn->bhp", Cm, state)


def ssm_block_decode(p: Params, x: torch.Tensor, cache: dict, cfg: LMConfig
                     ) -> tuple[torch.Tensor, dict]:
    """x: [B, 1, D] one token. Returns (y [B,1,D], new cache)."""
    d = ssm_dims(cfg)
    dt_ = cdt(cfg)
    B_ = x.shape[0]
    z, x_raw, bc_raw, dt_raw = (t[:, 0] for t in _project(p, x[:, 0:1], cfg))

    def conv_step(win_cache, new, w, b):
        win = torch.cat([win_cache, new[:, None, :].to(win_cache.dtype)],
                        dim=1)                                     # [B,K,C]
        out = torch.einsum("bkc,kc->bc", win.to(dt_), w.to(dt_)) + b.to(dt_)
        return F.silu(out), win[:, 1:, :]

    xs, new_cx = conv_step(cache["conv_x"], x_raw, p["conv_wx"], p["conv_bx"])
    bcs, new_cbc = conv_step(cache["conv_bc"], bc_raw, p["conv_wbc"],
                             p["conv_bbc"])
    dt = _softplus(dt_raw.float() + p["dt_bias"])                 # [B,nh]
    A = -torch.exp(p["A_log"])
    hr = d["nh"] // cfg.ssm_groups
    xh = xs.reshape(B_, d["nh"], d["hp"]).float()
    Bm = bcs[..., :d["gn"]].reshape(B_, cfg.ssm_groups, cfg.ssm_state
                                    ).repeat_interleave(hr, 1).float()
    Cm = bcs[..., d["gn"]:].reshape(B_, cfg.ssm_groups, cfg.ssm_state
                                    ).repeat_interleave(hr, 1).float()
    state, y = _ssm_step(cache["state"], dt, A, Bm, Cm, xh)
    y = y + p["D_skip"][:, None] * xh
    y = y.reshape(B_, d["di"]).to(dt_)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    y = (y @ p["out_proj"].to(dt_))[:, None, :]
    return y, {"conv_x": new_cx, "conv_bc": new_cbc, "state": state}
