"""Synthetic DVS event streams (the analytic generator of
``repro.data.events``, drawn from a ``torch.Generator``).

Class-conditioned analytic scenes: a moving Gaussian blob for the
``gesture`` family, two oriented bars on a 3-saccade path for ``nmnist``.
Each fine slot's ON/OFF rates are the positive/negative intensity change
over ``oversample`` sub-steps, scaled by ``contrast_gain``, and the counts
are Poisson draws. The two RNGs differ, so the same seed gives other
events than the reference; the model and its statistics are the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_SLOT_BLOCK = 64      # slots generated at once (bounds host memory)


@dataclass(frozen=True)
class EventStreamConfig:
    name: str = "gesture"            # "gesture" | "nmnist"
    height: int = 24
    width: int = 24
    n_classes: int = 11
    duration_ms: float = 2000.0
    contrast_gain: float = 18.0      # expected events per unit intensity change
    oversample: int = 3              # intensity samples per slot (anti-alias)
    blob_sigma: float = 0.12         # in units of min(H, W)
    seed_jitter: bool = True         # per-sample phase/position jitter


def dvs_gesture_like(hw: int = 24) -> EventStreamConfig:
    return EventStreamConfig(name="gesture", height=hw, width=hw, n_classes=11)


def nmnist_like(hw: int = 20) -> EventStreamConfig:
    return EventStreamConfig(name="nmnist", height=hw, width=hw, n_classes=10,
                             duration_ms=1200.0, blob_sigma=0.08)


def _grid(cfg: EventStreamConfig) -> tuple[torch.Tensor, torch.Tensor]:
    ys = torch.linspace(-1.0, 1.0, cfg.height)
    xs = torch.linspace(-1.0, 1.0, cfg.width)
    return torch.meshgrid(ys, xs, indexing="ij")


def _gesture_centers(t: torch.Tensor, label: int, phase: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blob centre path of a gesture class at normalized times ``t``."""
    c = float(label)
    rot = (c % 3.0) - 1.0                       # -1, 0, +1
    axis = 2.0 * math.pi * math.floor(c / 3.0) / 4.0
    speed = 1.0 + 0.5 * (math.floor(c / 3.0) % 2.0)
    ang = 2.0 * math.pi * speed * t + phase
    r = 0.55
    if rot == 0.0:      # oscillate along the axis
        osc = r * torch.sin(ang)
        return osc * math.cos(axis), osc * math.sin(axis)
    return r * torch.cos(rot * ang + axis), r * torch.sin(rot * ang + axis)


def _saccade(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """N-MNIST 3-saccade triangle path at normalized times ``t``."""
    seg = torch.clamp(torch.floor(t * 3.0), 0, 2)
    u = t * 3.0 - seg
    amp = 0.25
    vx = torch.tensor([-amp, amp, 0.0, -amp])
    vy = torch.tensor([-amp, -amp, amp, -amp])
    i = seg.long()
    return (vx[i] * (1 - u) + vx[i + 1] * u, vy[i] * (1 - u) + vy[i + 1] * u)


def _intensity(t: torch.Tensor, label: int, phase: float,
               cfg: EventStreamConfig) -> torch.Tensor:
    """Scene intensity at normalized times ``t`` [n] → [n, H, W]."""
    yy, xx = _grid(cfg)
    sig = cfg.blob_sigma * 2.0
    if cfg.name == "gesture":
        px, py = _gesture_centers(t, label, phase)
        d2 = (xx - px[:, None, None]) ** 2 + (yy - py[:, None, None]) ** 2
        return torch.exp(-d2 / (2 * sig ** 2))
    if cfg.name == "nmnist":
        c = float(label)
        sx, sy = _saccade(t)
        out = torch.zeros((t.shape[0],) + xx.shape)
        for a in (math.pi * c / 10.0, math.pi * (0.5 + (c * 3.0 % 10.0) / 10.0)):
            ux, uy = math.cos(a), math.sin(a)
            dx, dy = xx - sx[:, None, None], yy - sy[:, None, None]
            along = dx * ux + dy * uy
            perp = -dx * uy + dy * ux
            out = out + torch.exp(-(perp ** 2) / (2 * (sig * 0.4) ** 2)) * \
                torch.exp(-(along ** 2) / (2 * 0.45 ** 2))
        return out
    raise ValueError(cfg.name)


def sample_events(gen: torch.Generator, cfg: EventStreamConfig,
                  labels: list[int], n_slots: int, n_sub: int = 1
                  ) -> torch.Tensor:
    """Event counts float32 [B, n_slots, n_sub, H, W, 2] (ON, OFF) spanning
    ``cfg.duration_ms``, drawn on the CPU from ``gen``."""
    B = len(labels)
    total = n_slots * n_sub
    phase = (torch.rand(B, generator=gen) * 2 * math.pi if cfg.seed_jitter
             else torch.zeros(B))
    m = cfg.oversample
    dt = 1.0 / (total * m)
    out = torch.empty((B, total, cfg.height, cfg.width, 2))
    steps = dt * torch.arange(m + 1)
    for lo in range(0, total, _SLOT_BLOCK):
        idx = torch.arange(lo, min(lo + _SLOT_BLOCK, total))
        ts = (idx.float() / total)[:, None] + steps[None, :]   # [n, m+1]
        for b, label in enumerate(labels):
            frames = _intensity(ts.reshape(-1), int(label), float(phase[b]),
                                cfg).reshape(len(idx), m + 1, cfg.height,
                                             cfg.width)
            d = torch.diff(frames, dim=1)                      # [n, m, H, W]
            rates = torch.stack([d.clamp(min=0).sum(1),
                                 (-d).clamp(min=0).sum(1)], dim=-1)
            out[b, lo:lo + len(idx)] = torch.poisson(
                rates * cfg.contrast_gain, generator=gen)
    return out.reshape(B, n_slots, n_sub, cfg.height, cfg.width, 2)


def sample_batch(gen: torch.Generator, cfg: EventStreamConfig,
                 batch_size: int, t_intg_ms: float, n_sub: int = 1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(events [B, n_slots, n_sub, H, W, 2], labels [B]) at a given
    first-layer integration time, labels uniform over the classes."""
    labels = torch.randint(0, cfg.n_classes, (batch_size,), generator=gen)
    return sample_batch_with_labels(gen, cfg, labels, t_intg_ms, n_sub)


def sample_batch_with_labels(gen: torch.Generator, cfg: EventStreamConfig,
                             labels: torch.Tensor, t_intg_ms: float,
                             n_sub: int = 1
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Events for *given* labels (class-conditional analysis)."""
    n_slots = int(round(cfg.duration_ms / t_intg_ms))
    events = sample_events(gen, cfg, [int(x) for x in labels], n_slots, n_sub)
    return events, torch.as_tensor(labels)


def events_to_frames(events: torch.Tensor) -> torch.Tensor:
    """Collapse sub-slots: [B, T, n_sub, H, W, 2] → [B, T, H, W, 2] counts."""
    return events.sum(dim=2)


def refine_slots(events: torch.Tensor, factor: int) -> torch.Tensor:
    """Re-bin [B, T, n_sub, ...] onto a coarser T grid, T → T // factor
    with factor · n_sub sub-slots each: the same stream integrated at a
    longer T_INTG, event counts conserved."""
    B, T, n_sub = events.shape[:3]
    if T % factor:
        raise ValueError(f"{T} slots do not split into groups of {factor}")
    return events.reshape((B, T // factor, factor * n_sub) + events.shape[3:])
