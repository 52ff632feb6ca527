"""Spiking-CNN substrate — ``repro.core.snn`` in PyTorch: LIF neurons
with an ATan surrogate gradient, conv/BN/dense/pool helpers, and the
paper's backbone (4× [conv→BN→LIF→maxpool] → FC512 → LIF → FC, rate
decoding), in training (BN batch statistics) and evaluation.

Params and state are plain dicts of tensors with the reference's names,
and the public functions keep its layouts (activations NHWC, conv weights
HWIO), so a reference checkpoint loads unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

Params = dict
State = dict

_SG_ALPHA = 2.0


class _SpikeFn(torch.autograd.Function):
    """Heaviside forward, ATan surrogate backward (SpikingJelly's default)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x > 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        sg = _SG_ALPHA / (2.0 * (1.0 + (0.5 * math.pi * _SG_ALPHA * x) ** 2))
        return g * sg


def spike_fn(x: torch.Tensor) -> torch.Tensor:
    """Heaviside spike with ATan surrogate gradient."""
    return _SpikeFn.apply(x)


# ---------------------------------------------------------------------------
# LIF dynamics
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LIFConfig:
    tau: float = 2.0          # membrane time constant (in timesteps)
    v_threshold: float = 1.0
    soft_reset: bool = True   # subtract threshold on spike (vs reset to 0)


def lif_step(v: torch.Tensor, x: torch.Tensor, cfg: LIFConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LIF update. Returns (new membrane, spikes)."""
    v = v + (x - v) / cfg.tau
    s = spike_fn(v - cfg.v_threshold)
    if cfg.soft_reset:
        v = v - s * cfg.v_threshold
    else:
        v = v * (1.0 - s)
    return v, s


def lif_over_time(x: torch.Tensor, cfg: LIFConfig) -> torch.Tensor:
    """Run LIF over the leading time axis. x: [T, B, ...] → spikes."""
    v = torch.zeros_like(x[0])
    spikes = []
    for xt in x:
        v, s = lif_step(v, xt, cfg)
        spikes.append(s)
    return torch.stack(spikes)


# ---------------------------------------------------------------------------
# Stateless layer helpers (NHWC activations, HWIO weights)
# ---------------------------------------------------------------------------

def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``"SAME"`` along one axis. With an
    even size and stride 2 it pads 0 before and 1 after — not the
    symmetric padding of ``F.conv2d(padding=1)``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME-padded cross-correlation. x [N, H, W, C] NHWC, w [kh, kw, C, F]
    HWIO → [N, H', W', F] NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    pt, pb = same_pads(x.shape[1], kh, stride)
    pl, pr = same_pads(x.shape[2], kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _normal(gen: torch.Generator, shape: tuple, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int
              ) -> Params:
    fan_in = kh * kw * c_in
    return {"w": _normal(gen, (kh, kw, c_in, c_out), math.sqrt(2.0 / fan_in)),
            "b": torch.zeros(c_out)}


def conv_apply(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: [N, H, W, C] NHWC."""
    return conv_same(x, p["w"], stride) + p["b"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    return {"w": _normal(gen, (d_in, d_out), math.sqrt(2.0 / d_in)),
            "b": torch.zeros(d_out)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def bn_init(c: int) -> tuple[Params, State]:
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def bn_apply_eval(p: Params, s: State, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm at evaluation (running statistics) over the last axis."""
    return (x - s["mean"]) * torch.rsqrt(s["var"] + eps) * p["scale"] + p["bias"]


def bn_apply(p: Params, s: State, x: torch.Tensor, *, train: bool,
             momentum: float = 0.9, eps: float = 1e-5
             ) -> tuple[torch.Tensor, State]:
    """BatchNorm over all axes but the last (channels) → (y, new state).

    In training it normalises by the batch mean and the biased variance
    (the reference's ``jnp.var``) and moves the running statistics by
    ``momentum·old + (1 − momentum)·batch`` (detached: the state is not
    differentiated). ``F.batch_norm`` is not used: it updates the running
    variance with the unbiased estimate, and its momentum weighs the
    batch, not the old value."""
    if not train:
        return bn_apply_eval(p, s, x, eps), s
    axes = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=axes)
    var = torch.mean(torch.square(x - mean), dim=axes)
    new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
             "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_s


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """x: [N, H, W, C] → non-overlapping window max pool (VALID). Under
    autograd the gradient goes to the first maximal element of each
    window in row-major order (``F.max_pool2d``), as XLA's
    ``reduce_window`` max routes it: ties are the rule on binary spikes
    (an all-zero window too), and ``amax`` would split the gradient over
    them. Without a gradient the window max is an ``amax``, the same
    values in half the device time of ``max_pool2d`` on NHWC at the
    physics eval's shape."""
    if torch.is_grad_enabled() and x.requires_grad:
        return F.max_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)
    N, H, W, C = x.shape
    ho, wo = H // window, W // window
    x = x[:, :ho * window, :wo * window]
    return x.reshape(N, ho, window, wo, window, C).amax(dim=(2, 4))


# ---------------------------------------------------------------------------
# The paper's backbone spiking CNN
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpikingCNNConfig:
    """4 conv blocks (conv→BN→LIF→pool) + FC(512)→LIF→FC(n_classes); with
    ``first_layer_external`` the P²M layer supplies block 1."""
    in_channels: int = 2                        # DVS ON/OFF
    channels: tuple[int, ...] = (16, 32, 64, 64)
    kernel_size: int = 3
    first_stride: int = 1
    fc_hidden: int = 512
    n_classes: int = 11
    input_hw: tuple[int, int] = (128, 128)
    lif: LIFConfig = field(default_factory=LIFConfig)
    first_layer_external: bool = False

    @property
    def n_conv(self) -> int:
        return len(self.channels)


def spiking_cnn_init(gen: torch.Generator, cfg: SpikingCNNConfig
                     ) -> tuple[Params, State]:
    """Fresh backbone params (He-normal, drawn on the CPU from ``gen``)
    and BN state, with the reference's names and shapes."""
    params: Params = {}
    state: State = {}
    h, w = cfg.input_hw
    c_in = cfg.in_channels
    start = 0
    if cfg.first_layer_external:
        c_in = cfg.channels[0]
        h //= (2 * cfg.first_stride)
        w //= (2 * cfg.first_stride)
        start = 1
    for i in range(start, cfg.n_conv):
        stride = cfg.first_stride if i == 0 else 1
        params[f"conv{i}"] = conv_init(gen, cfg.kernel_size, cfg.kernel_size,
                                       c_in, cfg.channels[i])
        params[f"bn{i}"], state[f"bn{i}"] = bn_init(cfg.channels[i])
        c_in = cfg.channels[i]
        h = h // (2 * stride)
        w = w // (2 * stride)
    params["fc0"] = dense_init(gen, h * w * c_in, cfg.fc_hidden)
    params["fc1"] = dense_init(gen, cfg.fc_hidden, cfg.n_classes)
    return params, state


def spiking_cnn_apply(params: Params, state: State, x: torch.Tensor,
                      cfg: SpikingCNNConfig, *, train: bool
                      ) -> tuple[torch.Tensor, State, dict]:
    """Forward over time.

    x: [B, T, H, W, C] → (logits [B, n_classes], new BN state, aux):
    ``aux["spikes/<layer>"]`` holds spike totals and
    ``aux["synops/<layer>"]`` synaptic-operation counts (detached, for the
    energy and bandwidth model), with the reference's keys and values.
    With ``train`` BN normalises by batch statistics and the returned
    state carries the moved running statistics; else the state is
    returned as it came.
    """
    B, T = x.shape[0], x.shape[1]
    aux: dict = {}
    new_state: State = {}
    h = x.transpose(0, 1)                      # [T, B, ...]
    start = 1 if cfg.first_layer_external else 0
    for i in range(start, cfg.n_conv):
        stride = cfg.first_stride if i == 0 else 1
        y = conv_apply(params[f"conv{i}"], h.reshape((T * B,) + h.shape[2:]),
                       stride=stride)
        # each output element consumed k·k·c_in inputs; count sparsity
        c_in = h.shape[-1]
        fan_in = cfg.kernel_size * cfg.kernel_size * c_in
        aux[f"synops/conv{i}"] = (torch.sum(h != 0) * fan_in
                                  * (cfg.channels[i] / c_in)).detach()
        y, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"], state[f"bn{i}"],
                                          y, train=train)
        s = lif_over_time(y.reshape((T, B) + y.shape[1:]), cfg.lif)
        tb = max_pool(s.reshape((T * B,) + s.shape[2:]))
        h = tb.reshape((T, B) + tb.shape[1:])
        aux[f"spikes/conv{i}"] = torch.sum(s).detach()
    flat = h.reshape(T, B, -1)
    z = dense_apply(params["fc0"], flat)
    aux["synops/fc0"] = (torch.sum(flat != 0).float()
                         * params["fc0"]["w"].shape[1])
    s = lif_over_time(z, cfg.lif)
    aux["spikes/fc0"] = torch.sum(s).detach()
    logits_t = dense_apply(params["fc1"], s)
    aux["synops/fc1"] = (torch.sum(s != 0).float()
                         * params["fc1"]["w"].shape[1])
    return logits_t.mean(dim=0), new_state, aux


# ---------------------------------------------------------------------------
# streaming (one-coarse-frame-at-a-time) evaluation
# ---------------------------------------------------------------------------

def _stream_shapes(cfg: SpikingCNNConfig) -> tuple[dict, int]:
    """Per-layer LIF membrane shapes and the layer the stream starts at."""
    h, w = cfg.input_hw
    start = 0
    if cfg.first_layer_external:
        h //= (2 * cfg.first_stride)
        w //= (2 * cfg.first_stride)
        start = 1
    shapes = {}
    for i in range(start, cfg.n_conv):
        stride = cfg.first_stride if i == 0 else 1
        h_c, w_c = h // stride, w // stride       # conv output (SAME pad)
        shapes[f"lif{i}"] = (h_c, w_c, cfg.channels[i])
        h, w = h_c // 2, w_c // 2                 # 2x pool
    shapes["lif_fc0"] = (cfg.fc_hidden,)
    return shapes, start


def spiking_cnn_stream_init(cfg: SpikingCNNConfig, batch: int,
                            device: torch.device | str = "cpu") -> State:
    """Zero LIF membranes for step-wise (online) evaluation."""
    shapes, _ = _stream_shapes(cfg)
    return {k: torch.zeros((batch,) + s, device=device)
            for k, s in shapes.items()}


def spiking_cnn_stream_step(params: Params, state: State, mem: State,
                            x_t: torch.Tensor, cfg: SpikingCNNConfig
                            ) -> tuple[torch.Tensor, State]:
    """One coarse timestep of the backbone with explicit LIF state.

    ``x_t`` is one coarse frame [B, H, W, C]; ``mem`` carries every
    layer's membrane between calls. Stepping T frames and averaging the
    per-step logits equals :func:`spiking_cnn_apply` on the stacked input.
    """
    _, start = _stream_shapes(cfg)
    new_mem: State = {}
    h = x_t
    for i in range(start, cfg.n_conv):
        stride = cfg.first_stride if i == 0 else 1
        y = conv_apply(params[f"conv{i}"], h, stride=stride)
        y = bn_apply_eval(params[f"bn{i}"], state[f"bn{i}"], y)
        v, s = lif_step(mem[f"lif{i}"], y, cfg.lif)
        new_mem[f"lif{i}"] = v
        h = max_pool(s)
    z = dense_apply(params["fc0"], h.reshape(h.shape[0], -1))
    v, s = lif_step(mem["lif_fc0"], z, cfg.lif)
    new_mem["lif_fc0"] = v
    return dense_apply(params["fc1"], s), new_mem


# ---------------------------------------------------------------------------
# loss and metric
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of logits [B, C] against int labels [B]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels[:, None].long(),
                                            dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of samples whose arg-max logit is the label."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))
