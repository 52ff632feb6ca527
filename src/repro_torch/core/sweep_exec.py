"""Execution policy of a stacked leading axis — the port's
``repro.core.sweep_exec`` at one device.

The reference shards a leading axis (the sweep's ``[n_cfg]`` variants,
the serving engine's ``[capacity]`` lanes) over a 1-D device mesh with
``shard_map``; ``devices=1`` is its exact unsharded path (no mesh, no
padding), which is the only one the port runs. :class:`MeshExecutor`
holds that policy, refuses more devices before any compute, and names the
geometry the launchers write into their artifacts;
:class:`SweepExecutor` is the sweep's instance and
``stream/shard.LaneExecutor`` the serving engine's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshExecutor:
    """A 1-D ``axis`` mesh of ``devices`` cards; only ``devices=1`` runs."""
    devices: int = 1
    axis: str = "cfg"

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.devices > 1:
            raise NotImplementedError(
                f"devices={self.devices}: sharding the {self.axis!r} axis "
                f"over several cards is not ported (ROADMAP.md queue 1 item "
                f"5 leaves the multi-GPU mesh open); the port runs on one "
                f"card")

    @property
    def is_sharded(self) -> bool:
        return self.devices > 1

    def padded_size(self, n: int) -> int:
        """The leading axis padded up to a multiple of ``devices``."""
        return math.ceil(n / self.devices) * self.devices


@dataclass(frozen=True)
class SweepExecutor(MeshExecutor):
    """The sweep engine's executor: the variant axis."""
    axis: str = "cfg"


def make_executor(devices: int | None) -> SweepExecutor:
    """CLI entry: ``None`` or 1 → the one-device executor; more raise
    before any compute."""
    return SweepExecutor(devices=devices or 1)
