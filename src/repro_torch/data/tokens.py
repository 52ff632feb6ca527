"""Deterministic synthetic LM token stream with restart skip-ahead (the
port's ``repro.data.tokens``).

The stream is a small hidden-Markov source over the vocab: ``n_states``
latent states, each with its own emission distribution, and a transition
table between them, both drawn from ``seed`` at ``markov_temp``. So

  * batches are **deterministic in the step index**: restarting from a
    checkpoint at step N regenerates exactly the batches N, N+1, ... that
    the crashed run would have seen (the data cursor is just the step);
  * the stream has real bigram structure, so loss curves descend;
  * ``host_slice`` cuts the global batch by process index.

The reference draws with ``jax.random``; the port draws with a CPU
``torch.Generator`` seeded from (seed, step), so the two streams have the
same contract and statistics but other tokens (the RNGs cannot agree).
Batches are CPU tensors; the caller moves them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_temp: float = 0.6     # lower = more predictable stream
    n_states: int = 16           # latent states of the source (fewer = more
                                 # visible bigram structure to learn)


def _cdfs(cfg: TokenStreamConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Cumulative emission [n_states, vocab] and transition [n_states,
    n_states] probabilities (float64) of the source drawn from ``seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    emit = torch.randn((cfg.n_states, cfg.vocab_size), generator=gen)
    trans = torch.randn((cfg.n_states, cfg.n_states), generator=gen)
    return tuple(torch.softmax(t.double() / cfg.markov_temp, -1).cumsum(-1)
                 for t in (emit, trans))


def _draw(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws: the first index whose cumulative probability
    exceeds ``u`` (clamped against the last entry's roundoff)."""
    idx = torch.searchsorted(cdf, u[..., None], right=True)[..., 0]
    return idx.clamp_(max=cdf.shape[-1] - 1)


def sample_batch(cfg: TokenStreamConfig, step: int) -> dict:
    """Global batch for ``step``: {'tokens': [B, S], 'labels': [B, S]},
    int64 on the CPU. labels[i, t] = tokens[i, t+1] (next-token
    prediction); the final label wraps to the first token."""
    emit_cdf, trans_cdf = _cdfs(cfg)
    seed = np.random.SeedSequence([cfg.seed ^ 0x5EED, int(step)])
    gen = torch.Generator().manual_seed(int(seed.generate_state(1)[0]))
    B, S = cfg.global_batch, cfg.seq_len
    state = torch.randint(0, cfg.n_states, (B,), generator=gen)
    u_trans = torch.rand((S, B), generator=gen, dtype=torch.float64)
    u_emit = torch.rand((B, S), generator=gen, dtype=torch.float64)
    states = torch.empty((B, S), dtype=torch.long)
    for t in range(S):
        states[:, t] = state
        state = _draw(trans_cdf[state], u_trans[t])
    tokens = torch.empty((B, S), dtype=torch.long)
    for k in range(cfg.n_states):
        at = states == k
        tokens[at] = _draw(emit_cdf[k], u_emit[at])
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return {"tokens": tokens, "labels": labels}


def host_slice(batch: dict, process_index: int, process_count: int) -> dict:
    """Slice the global batch to this host's shard (batch-axis sharding)."""
    if process_count == 1:
        return batch
    def sl(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


class TokenLoader:
    """Stateful cursor: ``next()`` yields (step, batch); ``seek(n)`` is the
    restart skip-ahead, O(1) since generation is step-keyed."""

    def __init__(self, cfg: TokenStreamConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = start_step

    def seek(self, step: int) -> None:
        self._step = step

    @property
    def step(self) -> int:
        return self._step

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, dict]:
        s = self._step
        batch = sample_batch(self.cfg, s)
        self._step += 1
        return s, batch
