"""The serving engine's lane axis on a device mesh (``repro.stream.shard``
in PyTorch).

The reference shards the ``[capacity]`` lane axis of the fold/readout
steps over a 1-D ``"lane"`` mesh; every lane's numerics are independent,
so sharded serving is bit-identical to ``devices=1``. :class:`LaneExecutor`
is :class:`~repro_torch.core.sweep_exec.MeshExecutor` for that axis:
``devices=1`` is the identity path (no padding, the lane table on one
card) and more devices raise ``NotImplementedError`` naming ROADMAP.md —
one H100 cannot show a lane mesh, and the reference's forced host devices
have no PyTorch counterpart. The engine takes it as ``executor=`` and
writes its geometry into the artifact's ``sharding`` block; the per-shard
bookkeeping is ``serve.slots.ShardedSlots``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.sweep_exec import MeshExecutor
from repro_torch.serve.slots import ShardedSlots

LANE_AXIS = "lane"

__all__ = ["LANE_AXIS", "LaneExecutor", "make_lane_executor",
           "ShardedSlots"]


@dataclass(frozen=True)
class LaneExecutor(MeshExecutor):
    """The serving engine's executor: the lane axis."""
    axis: str = LANE_AXIS


def make_lane_executor(devices: int | None) -> LaneExecutor:
    """CLI entry: ``None`` or 1 → the one-device executor; more raise before
    any stream is opened."""
    return LaneExecutor(devices=devices or 1)
