"""The serving engine's lane axis over several devices
(``repro.stream.shard`` in PyTorch).

The ``[capacity]`` lane axis of the fold/readout steps
(``stream/accumulator.py``, ``stream/adapt.py``) is embarrassingly
parallel — every lane integrates its own stream with the same deployed
weights — so it shards as the sweep's variant axis does
(``core/sweep_exec.py``): the capacity pads up to a multiple of
``devices`` and shard ``k`` folds and reads out lanes ``[k·L, (k+1)·L)``
on its own device, with its lane state and frames in allocations of its
own there. Padding lanes are never admitted (``serve.slots.ShardedSlots``),
so sharded serving gives every stream the bits of ``devices=1`` wherever
the steps' numerics do not depend on the lane count (see
``tests/test_torch_shard.py``). :class:`LaneExecutor` is
:class:`~repro_torch.core.sweep_exec.MeshExecutor` for that axis;
``devices=1`` is the identity path.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.core.sweep_exec import MeshExecutor
from repro_torch.serve.slots import ShardedSlots

LANE_AXIS = "lane"

__all__ = ["LANE_AXIS", "LaneExecutor", "make_lane_executor",
           "shard_lane_fns", "ShardedSlots"]


@dataclass(frozen=True)
class LaneExecutor(MeshExecutor):
    """The serving engine's executor: the lane axis."""
    axis: str = LANE_AXIS


def make_lane_executor(devices: int | None, device: str | None = None
                       ) -> LaneExecutor:
    """CLI entry: ``None`` → the one-device executor. With ``device``
    (the launcher's ``--device``) a sharded executor is checked against
    the visible cards here, before any stream is opened."""
    return LaneExecutor(devices=devices or 1, device=device)


def shard_lane_fns(ex: LaneExecutor, capacity: int, dev: torch.device,
                   build: Callable[[int, torch.device], Any],
                   specs: dict[str, tuple[str, ...]]) -> Any:
    """The lane-batched serving steps of a sharded ``ex``: ``build(L,
    place)`` makes one shard's unsharded steps for its ``L = capacity /
    devices`` lanes on its device, and each step named in ``specs`` runs
    every shard's on its block of the arguments (``AXIS``: lane-leading,
    ``REP``: the bundle, replicated with ``ex.replicate``). The state is a
    tree of :class:`~repro_torch.core.sweep_exec.Blocks`, so the per-lane
    resets and reads address global lanes unchanged."""
    if capacity % ex.devices:
        raise ValueError(
            f"capacity={capacity} must be a multiple of "
            f"executor.devices={ex.devices} — pad the lane axis first "
            f"(LaneExecutor.padded_size)")
    places = ex.bind(dev)
    shards = [build(capacity // ex.devices, p) for p in places]
    steps = {name: ex.shard([getattr(s, name) for s in shards], spec, places)
             for name, spec in specs.items()}
    return replace(shards[0], **steps, device=places[0])
