"""Shared helpers of the port's registry and adaptation tests (not collected:
no ``test_`` prefix): pre-drawn event records replayed to either package's
serving engine, and the JAX-written deployments both packages serve."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.binning import frames_to_events
from repro_torch.data.sources import rechunk_events

LOGIT_ATOL = 1e-4


def awake(params, gain=2.0):
    """Fresh He-init backbones go silent by their third layer (every logit
    exactly 0, which would make the logit checks vacuous); doubling the BN
    scales and the fc0 weights keeps spikes flowing to the head."""
    bb = dict(params["backbone"])
    for k, v in bb.items():
        if k.startswith("bn"):
            bb[k] = {**v, "scale": v["scale"] * gain}
    bb["fc0"] = {**bb["fc0"], "w": bb["fc0"]["w"] * gain}
    return {**params, "backbone": bb}


def jax_deployment(j_deploy, cfg, seed, **leak):
    """A fresh, awake JAX deployment of ``cfg`` with the leak fields
    ``leak`` (circuit, null_mismatch, ...) replaced."""
    cfg = dataclasses.replace(cfg, p2m=dataclasses.replace(
        cfg.p2m, leak=dataclasses.replace(cfg.p2m.leak, **leak)))
    dep = j_deploy.fresh_deployment(cfg, seed=seed)
    return dataclasses.replace(dep, params=awake(dep.params))


class Replay:
    """Feeds the same pre-drawn event records to either package's engine:
    the ``i``-th stream opened (admission order) replays record ``i``, and
    only the records in ``labeled`` keep their label (others replay -1)."""

    def __init__(self, records, labels, hw, duration_ms, n_classes,
                 labeled=None):
        self.records, self.labels = records, labels
        self.labeled = None if labeled is None else set(labeled)
        self.name = "replay"
        self.height = self.width = hw
        self.sensor_hw = (hw, hw)
        self.n_classes = n_classes
        self.duration_ms = duration_ms
        self._opened = 0

    def n_slots(self, t_intg_ms):
        return int(round(self.duration_ms / t_intg_ms))

    def iter_event_chunks(self, key, *, chunk_us, slot_us=None):
        i = self._opened
        self._opened += 1
        n = int(round(self.duration_ms * 1000 / chunk_us))
        label = (self.labels[i] if self.labeled is None or i in self.labeled
                 else -1)
        return label, rechunk_events(self.records[i], chunk_us, n)


def replay_factory(n_streams, hw, duration_ms, slot_us, n_classes, *,
                   seed=11, rate=0.25):
    """A factory of fresh :class:`Replay` sources over ``n_streams``
    numpy-seeded Poisson records (one per call, so every serve starts at
    record 0)."""
    rng = np.random.default_rng(seed)
    n_total = int(duration_ms * 1000 // slot_us)
    records = [frames_to_events(rng.poisson(rate, (n_total, hw, hw, 2))
                                .astype(np.float32), slot_us)
               for _ in range(n_streams)]
    labels = [int(v) for v in rng.integers(0, n_classes, n_streams)]
    return lambda labeled=None: Replay(records, labels, hw, duration_ms,
                                       n_classes, labeled)


def by_stream(report):
    return {r.stream_id: r for r in report.results}


def assert_logits_close(got, want, atol=LOGIT_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(want).max() > 0.05, "vacuous: the head never spiked"
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
