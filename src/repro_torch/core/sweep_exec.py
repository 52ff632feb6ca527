"""Sharded execution of a stacked leading axis (the port's
``repro.core.sweep_exec``).

Two batched axes are embarrassingly parallel — every element runs the
same program with its own numerics — and both shard the same way: the
sweep's stacked ``[n_cfg]`` variant axis (:class:`SweepExecutor`) and the
serving engine's ``[capacity]`` lane axis (``stream/shard.LaneExecutor``).
No op mixes elements, so no collective is needed: one process drives a
tuple of devices, one per shard. Shard ``k`` owns the contiguous block
``[k·L, (k+1)·L)`` of the axis padded to a multiple of ``devices``, as the
reference's 1-D mesh does, holds it as its own tensors on its device
(:class:`Blocks`), and runs its body there; the shards are launched one
after another with no host synchronisation between them, and results are
read back in shard order.

``devices=n`` on cuda shards over ``cuda:0 … cuda:n-1``, and more than
``torch.cuda.device_count()`` raises ``ValueError`` before any compute;
when the entry point runs on the CPU the ``n`` shards are all ``cpu`` (the
counterpart of XLA's forced host devices). ``places=`` (tests and
chip_smoke.py) may put several shards on one device. Nothing falls back:
an executor runs exactly its shards, on the device family it was given.
``devices=1`` is the exact unsharded path (no padding, no blocks).
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from repro_torch.utils import tree_map

CFG_AXIS = "cfg"
# in_specs of :meth:`MeshExecutor.shard`: an argument split on the axis,
# or one every shard sees whole
AXIS, REP = "axis", "rep"


class Blocks:
    """One leaf of a tree sharded on its leading axis: shard ``k``'s rows
    as a tensor of their own on shard ``k``'s device (for a replicated
    leaf, shard ``k``'s copy). Integer row indexing addresses the global
    axis, so per-row reads and in-place resets work as on one tensor;
    ``cpu()`` gathers every block, in shard order, on the host."""
    __slots__ = ("blocks",)

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = tuple(blocks)

    def _at(self, row) -> tuple[torch.Tensor, int]:
        k, i = divmod(operator.index(row), self.blocks[0].shape[0])
        return self.blocks[k], i

    def __getitem__(self, row) -> torch.Tensor:
        block, i = self._at(row)
        return block[i]

    def __setitem__(self, row, value) -> None:
        block, i = self._at(row)
        block[i] = value

    def cpu(self) -> torch.Tensor:
        return torch.cat([b.cpu() for b in self.blocks])


def _rows(x: Any, k: int, n: int) -> Any:
    """Shard ``k`` of ``n`` of one leaf (or of a list with one item per
    row): a :class:`Blocks` gives its block, anything else its ``k``-th
    contiguous slice of rows."""
    if isinstance(x, Blocks):
        return x.blocks[k]
    rows = len(x) if isinstance(x, list) else x.shape[0]
    if rows % n:
        raise ValueError(f"a leading axis of {rows} rows does not split "
                         f"over {n} shards — pad it first (padded_size)")
    size = rows // n
    return x[k * size:(k + 1) * size]


def _block(arg: Any, k: int, n: int, spec: str, place: torch.device) -> Any:
    """Shard ``k``'s view of one argument under ``spec``, its tensors on
    ``place``."""
    if spec == AXIS and isinstance(arg, list):   # one item per row
        return _rows(arg, k, n)

    def one(x):
        if isinstance(x, Blocks):
            return x.blocks[k]
        if spec == AXIS:
            x = _rows(x, k, n)
        return x.to(place) if isinstance(x, torch.Tensor) else x
    return tree_map(one, arg)


@dataclass(frozen=True)
class MeshExecutor:
    """Execution policy of one stacked axis: ``devices`` shards, on
    ``places`` when given, else on the devices :meth:`bind` derives from
    the entry point's device. ``device`` names that family up front, so a
    CLI's ``--devices`` is checked against the visible cards at
    construction (``make_executor``); an executor without it is checked
    when an entry point binds it, still before any compute."""
    devices: int = 1
    axis: str = CFG_AXIS
    device: str | None = None
    places: tuple[str, ...] | None = None

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.places is not None and len(self.places) != self.devices:
            raise ValueError(f"places {self.places} must name one device "
                             f"per shard ({self.devices})")
        if self.is_sharded and (self.places is not None
                                or self.device is not None):
            self.bind(self.device or torch.device(self.places[0]).type)

    @property
    def is_sharded(self) -> bool:
        return self.devices > 1

    def bind(self, device: str | torch.device) -> tuple[torch.device, ...]:
        """The shards' devices for an entry point on ``device``. Raises
        ``ValueError`` when the shards would run on another device family
        or on more cards than are visible; unsharded, ``(device,)``."""
        dev = torch.device(device)
        if not self.is_sharded:
            return (dev,)
        if self.device is not None and torch.device(self.device).type \
                != dev.type:
            raise ValueError(
                f"sharding the {self.axis!r} axis on {self.device} but the "
                f"entry point runs on {dev}: an executor never falls back "
                f"to another device")
        if self.places is not None:
            places = tuple(torch.device(p) for p in self.places)
        elif dev.type == "cuda":
            places = tuple(torch.device("cuda", i)
                           for i in range(self.devices))
        else:
            places = (dev,) * self.devices
        if any(p.type != dev.type for p in places):
            raise ValueError(
                f"sharding the {self.axis!r} axis on {places} but the entry "
                f"point runs on {dev}: an executor never falls back to "
                f"another device")
        if dev.type == "cuda":
            want = 1 + max(p.index or 0 for p in places)
            seen = torch.cuda.device_count()
            if want > seen:
                raise ValueError(
                    f"sharding the {self.axis!r} axis over "
                    f"{self.devices} shards wants {want} CUDA device(s) "
                    f"but only {seen} are visible; pass device='cpu' "
                    f"(--device cpu) to run the shards on the host")
        return places

    def padded_size(self, n: int) -> int:
        """Smallest multiple of the device count >= ``n``."""
        return math.ceil(n / self.devices) * self.devices

    def pad_stacked(self, tree: Any, n: int) -> Any:
        """Pad every leaf's leading ``[n]`` axis (or a list with one item
        per row) to ``padded_size(n)`` by repeating the last row: real
        work, discarded on read-back."""
        pad = self.padded_size(n) - n
        if pad == 0:
            return tree
        if isinstance(tree, list):
            return tree + tree[-1:] * pad
        return tree_map(lambda x: torch.cat(
            [x, x[-1:].expand((pad,) + x.shape[1:])]), tree)

    def split(self, tree: Any, places: Sequence[torch.device]) -> Any:
        """A tree stacked on the padded axis → the same tree of
        :class:`Blocks`, each shard's rows copied into a tensor of its own
        on its device (identity when unsharded)."""
        if not self.is_sharded:
            return tree
        n = len(places)
        return tree_map(lambda x: Blocks(
            _rows(x, k, n).to(p, copy=True) for k, p in enumerate(places)),
            tree)

    def replicate(self, tree: Any, places: Sequence[torch.device]) -> Any:
        """One copy of every tensor leaf per shard, as :class:`Blocks`
        (identity when unsharded): a replicated argument moved once, not
        at every call."""
        if not self.is_sharded:
            return tree
        return tree_map(lambda x: Blocks(x.to(p) for p in places)
                        if isinstance(x, torch.Tensor) else x, tree)

    def gather(self, tree: Any, n: int | None = None) -> Any:
        """Every :class:`Blocks` leaf concatenated in shard order on the
        first shard's device, and every leaf cut to its first ``n`` rows
        (the unpadded axis)."""
        def one(x):
            if isinstance(x, Blocks):
                dev = x.blocks[0].device
                x = torch.cat([b.to(dev) for b in x.blocks])
            return x if n is None else x[:n]
        return tree_map(one, tree)

    def synchronize(self, places: Sequence[torch.device]) -> None:
        for p in dict.fromkeys(places):
            if p.type == "cuda":
                torch.cuda.synchronize(p)

    def shard(self, bodies: Sequence[Callable], in_specs: Sequence[str],
              places: Sequence[torch.device]) -> Callable:
        """Run ``bodies[k]`` (built for ``places[k]``) on shard ``k``'s
        block of every ``AXIS`` argument and on its copy of every ``REP``
        one (a tensor leaf is moved to ``places[k]`` unless it is already
        :class:`Blocks`), all shards in turn with no host synchronisation
        between them; every output leaf comes back as :class:`Blocks`.
        Unsharded, the one body itself (the identity path)."""
        if not self.is_sharded:
            return bodies[0]
        n = len(bodies)

        def run(*args):
            outs = [body(*(_block(a, k, n, spec, places[k])
                           for a, spec in zip(args, in_specs)))
                    for k, body in enumerate(bodies)]
            return tree_map(lambda *xs: Blocks(xs), outs[0], *outs[1:])

        return run


@dataclass(frozen=True)
class SweepExecutor(MeshExecutor):
    """The sweep engine's executor: the stacked circuit-variant axis."""


def make_executor(devices: int | None, device: str | None = None
                  ) -> SweepExecutor:
    """CLI entry: ``None`` → the one-device executor. With ``device``
    (the launcher's ``--device``) a sharded executor is checked against
    the visible cards here, so a bad ``--devices`` fails before any
    compute."""
    return SweepExecutor(devices=devices or 1, device=device)
