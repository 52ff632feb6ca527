"""Continuous-batching lane table (the port's own copy of
``repro.serve.slots``).

A :class:`SlotManager` is a fixed-capacity table of serving lanes: work
items are admitted into the lowest free lane at a batching boundary
(``refill`` takes them from the head of a pending deque), one batched step
advances every occupied lane, finished lanes are released and refilled on
the next boundary; ``swap`` rebinds an occupied lane without ever freeing
it. :class:`ShardedSlots` stacks one manager per shard of a sharded batch
axis behind a single admission front, so placement matches one manager
lane for lane; with ``devices=1`` it is exactly one plain manager.
"""
from __future__ import annotations

from collections import deque
from typing import Generic, Iterator, TypeVar

T = TypeVar("T")


class SlotManager(Generic[T]):
    """Fixed-capacity lane table with admit / release."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._items: list[T | None] = [None] * capacity

    @property
    def capacity(self) -> int:
        return len(self._items)

    @property
    def n_occupied(self) -> int:
        return sum(item is not None for item in self._items)

    @property
    def n_free(self) -> int:
        return self.capacity - self.n_occupied

    def is_empty(self) -> bool:
        return self.n_occupied == 0

    def is_full(self) -> bool:
        return self.n_free == 0

    def get(self, slot: int) -> T | None:
        return self._items[slot]

    def occupied(self) -> Iterator[tuple[int, T]]:
        """(lane index, item) pairs for every occupied lane, in lane order."""
        for i, item in enumerate(self._items):
            if item is not None:
                yield i, item

    def active_mask(self) -> list[bool]:
        """Per-lane occupancy, lane i ↔ batch row i."""
        return [item is not None for item in self._items]

    def admit(self, item: T) -> int | None:
        """Place ``item`` into the lowest free lane; None when full."""
        if item is None:
            raise ValueError("cannot admit None (None marks a free lane)")
        for i, existing in enumerate(self._items):
            if existing is None:
                self._items[i] = item
                return i
        return None

    def release(self, slot: int) -> T:
        """Free ``slot`` and return the item it held."""
        item = self._items[slot]
        if item is None:
            raise ValueError(f"slot {slot} is already free")
        self._items[slot] = None
        return item

    def swap(self, slot: int, item: T) -> T:
        """Replace the item in occupied lane ``slot`` and return the old
        one: the lane is rebound without ever being free, so no admission
        can take it mid-rebind."""
        if item is None:
            raise ValueError("cannot swap in None (None marks a free lane)")
        old = self._items[slot]
        if old is None:
            raise ValueError(f"slot {slot} is free — swap only rebinds "
                             f"occupied lanes (use admit)")
        self._items[slot] = item
        return old

    def refill(self, queue: deque[T]) -> list[tuple[int, T]]:
        """Admit items from the head of ``queue`` (popped with
        ``popleft``, in order) until it is empty or every lane is full;
        the (lane, item) placements. ``queue`` must be deque-like: a
        list's head pop is O(n) per admit, quadratic over a long
        backlog."""
        if not hasattr(queue, "popleft"):
            raise TypeError(
                f"refill requires a deque-like queue with popleft "
                f"(got {type(queue).__name__}); list-head pops are "
                f"quadratic over long pending queues")
        placed: list[tuple[int, T]] = []
        while queue and not self.is_full():
            item = queue.popleft()
            placed.append((self.admit(item), item))
        return placed


class ShardedSlots(Generic[T]):
    """Per-shard :class:`SlotManager` table presenting one global lane space
    ``[0, capacity)`` inside a padded axis ``[0, padded_capacity)``: shard
    ``s`` owns lanes ``[s·L, (s+1)·L)``, and the padding tail lanes are
    never admitted. Admission fills the lowest free global lane."""

    def __init__(self, capacity: int, devices: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self._capacity = capacity
        self.devices = devices
        self.padded_capacity = -(-capacity // devices) * devices
        self.lanes_per_shard = self.padded_capacity // devices
        self._shards: list[SlotManager[T] | None] = []
        for s in range(devices):
            real = min(self.lanes_per_shard,
                       max(0, capacity - s * self.lanes_per_shard))
            self._shards.append(SlotManager(real) if real else None)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def n_occupied(self) -> int:
        return sum(m.n_occupied for m in self._shards if m is not None)

    @property
    def n_free(self) -> int:
        return self._capacity - self.n_occupied

    def is_empty(self) -> bool:
        return self.n_occupied == 0

    def is_full(self) -> bool:
        return self.n_free == 0

    def shard_of(self, lane: int) -> int:
        """The shard global lane ``lane`` lives on."""
        if not 0 <= lane < self.padded_capacity:
            raise ValueError(f"lane {lane} outside padded capacity "
                             f"{self.padded_capacity}")
        return lane // self.lanes_per_shard

    def admit(self, item: T) -> int | None:
        """Place ``item`` into the lowest free real global lane; None when
        every real lane is occupied."""
        for s, mgr in enumerate(self._shards):
            if mgr is None or mgr.is_full():
                continue
            local = mgr.admit(item)
            return s * self.lanes_per_shard + local
        return None

    def _local(self, lane: int) -> tuple[SlotManager[T], int]:
        """The manager and local index of real global lane ``lane``."""
        s = self.shard_of(lane)
        mgr = self._shards[s]
        local = lane - s * self.lanes_per_shard
        if mgr is None or local >= mgr.capacity:
            raise ValueError(f"lane {lane} is a padding lane")
        return mgr, local

    def release(self, lane: int) -> T:
        """Free global lane ``lane`` and return the item it held."""
        mgr, local = self._local(lane)
        return mgr.release(local)

    def swap(self, lane: int, item: T) -> T:
        """Rebind occupied global lane ``lane`` in place and return the
        old item (a padding lane rejects, as in ``release``)."""
        mgr, local = self._local(lane)
        return mgr.swap(local, item)

    def occupied(self) -> Iterator[tuple[int, T]]:
        """(global lane, item) pairs in global lane order."""
        for s, mgr in enumerate(self._shards):
            if mgr is None:
                continue
            base = s * self.lanes_per_shard
            for local, item in mgr.occupied():
                yield base + local, item

    def active_mask(self) -> list[bool]:
        """Per-lane occupancy over the full padded axis."""
        mask = [False] * self.padded_capacity
        for lane, _ in self.occupied():
            mask[lane] = True
        return mask

    def per_shard_occupied(self) -> list[int]:
        """Occupied-lane count per shard."""
        return [0 if m is None else m.n_occupied for m in self._shards]
