"""PyTorch port: the serving lane table (``repro_torch.serve.slots``) held
to the reference's slot contracts (``tests/test_slots.py``,
``tests/test_slots_property.py``): admit / release / refill / swap on a
``SlotManager``, the per-shard ``ShardedSlots`` with its padding lanes,
and a lockstep walk of random operations driving the port's
``ShardedSlots``, the reference's ``ShardedSlots`` and one port
``SlotManager`` side by side — every return value, every refusal and the
full occupancy equal after every step."""
from __future__ import annotations

import random
from collections import deque

import pytest

from repro.serve.slots import ShardedSlots as JShardedSlots
from repro.serve.slots import SlotManager as JSlotManager
from repro_torch.serve.slots import ShardedSlots, SlotManager


# ---------------------------------------------------------------------------
# SlotManager (tests/test_slots.py)
# ---------------------------------------------------------------------------

def test_admit_until_full():
    m = SlotManager(3)
    assert m.capacity == 3 and m.is_empty() and not m.is_full()
    assert [m.admit(f"r{i}") for i in range(3)] == [0, 1, 2]
    assert m.is_full() and m.n_free == 0 and m.n_occupied == 3
    assert m.admit("overflow") is None
    assert m.active_mask() == [True, True, True]


def test_release_frees_lowest_lane_for_reuse():
    m = SlotManager(2)
    m.admit("a"), m.admit("b")
    assert m.release(0) == "a"
    assert m.active_mask() == [False, True]
    assert m.admit("c") == 0
    assert m.get(0) == "c" and m.get(1) == "b"


def test_release_and_admit_refusals():
    m = SlotManager(2)
    with pytest.raises(ValueError, match="already free"):
        m.release(1)
    with pytest.raises(ValueError, match="None"):
        m.admit(None)
    with pytest.raises(ValueError):
        SlotManager(0)


def test_refill_pops_queue_in_order():
    m = SlotManager(2)
    queue = deque(["a", "b", "c"])
    assert m.refill(queue) == [(0, "a"), (1, "b")]
    assert list(queue) == ["c"]
    assert m.refill(queue) == []
    m.release(1)
    assert m.refill(queue) == [(1, "c")] and not queue


def test_refill_rejects_a_list():
    """refill pops with popleft: a list's head pop is O(n) per admit, so a
    list raises TypeError instead of going quadratic."""
    with pytest.raises(TypeError, match="popleft"):
        SlotManager(2).refill(["a", "b"])


def test_swap_rebinds_only_occupied_lanes():
    m = SlotManager(3)
    m.admit("a"), m.admit("b")
    assert m.swap(1, "b2") == "b" and m.get(1) == "b2"
    assert m.active_mask() == [True, True, False]
    with pytest.raises(ValueError, match="free"):
        m.swap(2, "x")
    with pytest.raises(ValueError, match="None"):
        m.swap(0, None)
    assert m.admit("c") == 2            # the swapped lane was never free


def test_continuous_recycling():
    m = SlotManager(2)
    queue = deque(f"r{i}" for i in range(7))
    done = []
    while queue or not m.is_empty():
        m.refill(queue)
        for lane, _ in list(m.occupied()):
            done.append(m.release(lane))
        assert len(done) <= 7
    assert done == [f"r{i}" for i in range(7)]


# ---------------------------------------------------------------------------
# ShardedSlots (tests/test_stream_shard.py, test_slots_property.py)
# ---------------------------------------------------------------------------

def test_sharded_degenerates_to_one_manager():
    s = ShardedSlots(4)
    assert (s.devices, s.padded_capacity, s.lanes_per_shard) == (1, 4, 4)
    assert s.admit("a") == 0 and s.admit("b") == 1
    assert s.active_mask() == [True, True, False, False]
    assert s.per_shard_occupied() == [2]


def test_padding_lanes_never_admitted_released_or_swapped():
    s = ShardedSlots(3, devices=2)       # lane 3 is padding
    assert s.padded_capacity == 4 and s.lanes_per_shard == 2
    assert [s.admit(i) for i in "abc"] == [0, 1, 2]
    assert s.admit("d") is None
    assert s.active_mask() == [True, True, True, False]
    with pytest.raises(ValueError, match="padding"):
        s.release(3)
    with pytest.raises(ValueError, match="padding"):
        s.swap(3, "x")
    with pytest.raises(ValueError, match="outside"):
        s.shard_of(4)


def test_pure_padding_shard():
    s = ShardedSlots(2, devices=4)       # shards 2 and 3 hold no real lane
    assert [s.admit(i) for i in "ab"] == [0, 1]
    assert s.admit("c") is None
    assert s.per_shard_occupied() == [1, 1, 0, 0]
    with pytest.raises(ValueError, match="padding"):
        s.release(2)


def test_swap_is_invisible_to_placement():
    s, ref = ShardedSlots(4, devices=2), SlotManager(4)
    for item in "abc":
        assert s.admit(item) == ref.admit(item)
    assert s.swap(1, "b2") == ref.swap(1, "b2") == "b"
    assert s.admit("d") == ref.admit("d") == 3
    assert s.admit("e") is ref.admit("e") is None
    assert s.release(1) == "b2"
    with pytest.raises(ValueError, match="free"):
        s.swap(1, "x")


def test_sharded_rejects_bad_args():
    with pytest.raises(ValueError, match="capacity"):
        ShardedSlots(0)
    with pytest.raises(ValueError, match="devices"):
        ShardedSlots(2, devices=0)


# ---------------------------------------------------------------------------
# lockstep walk: the port's ShardedSlots, the reference's, one SlotManager
# ---------------------------------------------------------------------------

ADMIT, RELEASE, REFILL, SWAP = range(4)


def _both(fn_port, fn_ref):
    """The two packages' results of one operation, or both refusals'
    types and messages."""
    out = []
    for fn in (fn_port, fn_ref):
        try:
            out.append(("ok", fn()))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1], out
    return out[0]


def _walk(capacity, devices, ops):
    port, ref = ShardedSlots(capacity, devices), JShardedSlots(capacity,
                                                              devices)
    one = SlotManager(capacity)
    assert (port.padded_capacity, port.lanes_per_shard) == \
        (ref.padded_capacity, ref.lanes_per_shard)
    n = 0
    for code, arg in ops:
        if code == ADMIT:
            kind, lane = _both(lambda: port.admit(f"s{n}"),
                               lambda: ref.admit(f"s{n}"))
            assert lane == one.admit(f"s{n}")
            n += 1
        elif code == RELEASE:
            lane = arg % port.padded_capacity
            kind, item = _both(lambda: port.release(lane),
                               lambda: ref.release(lane))
            if kind == "ok":
                assert one.release(lane) == item
        elif code == REFILL:
            items = [f"s{n + i}" for i in range(arg % (capacity + 2))]
            n += len(items)
            q = deque(items)
            placed = one.refill(q)
            assert list(q) == items[len(placed):]
            # the sharded front admits one item at a time: the same lanes
            for lane, item in placed:
                assert _both(lambda: port.admit(item),
                             lambda: ref.admit(item)) == ("ok", lane)
        else:
            lane = arg % port.padded_capacity
            kind, old = _both(lambda: port.swap(lane, f"s{n}"),
                              lambda: ref.swap(lane, f"s{n}"))
            if kind == "ok":
                assert one.swap(lane, f"s{n}") == old
            n += 1
        assert list(port.occupied()) == list(ref.occupied()) == \
            list(one.occupied())
        assert port.active_mask() == ref.active_mask()
        assert port.active_mask()[:capacity] == one.active_mask()
        assert not any(port.active_mask()[capacity:])
        assert port.per_shard_occupied() == ref.per_shard_occupied()
        assert (port.n_occupied, port.n_free, port.is_full(),
                port.is_empty()) == (ref.n_occupied, ref.n_free,
                                     ref.is_full(), ref.is_empty())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("capacity,devices", [(1, 1), (4, 2), (3, 2),
                                              (5, 4), (2, 4), (7, 3)])
def test_lockstep_walk_equals_the_reference(capacity, devices, seed):
    rng = random.Random(seed * 1000 + capacity * 10 + devices)
    _walk(capacity, devices,
          [(rng.randrange(4), rng.randrange(1 << 16)) for _ in range(80)])


def test_refill_equals_the_reference():
    """The port's refill places the same items on the same lanes as the
    reference's, over admit / release / refill rounds."""
    items = [f"r{i}" for i in range(11)]
    port, ref = SlotManager(3), JSlotManager(3)
    qp, qr = deque(items), deque(items)
    for round_ in range(6):
        assert port.refill(qp) == ref.refill(qr)
        assert list(qp) == list(qr)
        assert port.active_mask() == ref.active_mask()
        for lane in [i for i, _ in port.occupied()][round_ % 2::2]:
            assert port.release(lane) == ref.release(lane)
