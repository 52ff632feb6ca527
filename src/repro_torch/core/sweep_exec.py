"""Execution policy of the sweep's stacked variant axis — the port's
``repro.core.sweep_exec`` at one device.

The reference shards the ``[n_cfg]`` axis over a 1-D device mesh with
``shard_map``; ``devices=1`` is its exact unsharded path (no mesh, no
padding), which is the only one the port runs: the sweep takes no
executor, and this module only refuses more devices before any compute
and names the count the launcher writes into the artifact.
"""
from __future__ import annotations

from dataclasses import dataclass


def _one_device_only(devices: int) -> NotImplementedError:
    return NotImplementedError(
        f"devices={devices}: sharding the variant axis over several cards "
        f"comes with a later slice of the port (ROADMAP.md queue 1 item 5); "
        f"the port runs the sweep on one card")


@dataclass(frozen=True)
class SweepExecutor:
    """The sweep engine's executor at ``devices=1``."""
    devices: int = 1

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.devices > 1:
            raise _one_device_only(self.devices)


def make_executor(devices: int | None) -> SweepExecutor:
    """CLI entry: ``None`` or 1 → the one-device executor; more raise
    before any compute."""
    return SweepExecutor(devices=devices or 1)
