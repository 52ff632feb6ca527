"""PyTorch port: the file-backed data slice (``data/formats.py``,
``data/cache.py``, ``data/sources.py``, ``data/fixtures.py``) against the
JAX package, on the same numpy inputs and the same files.

Held to:
- the writers' bytes equal, and each package reads the other's files to
  the same arrays (numpy on both sides: bit for bit);
- sample lists, labels, windows and splits equal on fixture directories
  the reference wrote; ``_gather`` frames and labels bit-identical on the
  same sample indices (the two RNGs cannot agree, so parity is held at the
  level of indices);
- the fixture writers' file names and labels CSVs equal (byte for byte);
  the events inside differ, drawn from other generators;
- the sweep on a file source (circuits a and c × T_INTG 100 and 1000 ms,
  both protocols, smoke step counts) fed the reference's drawn indices,
  from the reference's initial params, as ``tests/test_torch_sweep.py``
  holds the synthetic sweep: counts, accuracy, labels equal; bandwidth
  and sensor energy within 1e-5; retention within 1e-6 frozen and 1e-5
  unfrozen; backend energies within 1e-3;
- the replay guarantee of ``tests/test_streaming.py`` on a fixture
  recording: the port's online serve equals the port's offline forward on
  ``bin_chunks`` frames within rtol 1e-5 / atol 1e-5, and the reference's
  offline forward on the same checkpoint within 1e-4 (the port's serving
  tolerance across frameworks), at two T_INTG values and both protocols.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import codesign as j_codesign
from repro.core import sweep as j_sweep
from repro.core.leakage import CircuitConfig as JCircuit
from repro.data import binning as j_binning
from repro.data import cache as j_cache
from repro.data import fixtures as j_fixtures
from repro.data import formats as j_formats
from repro.data import sources as j_sources
from repro.stream import deploy as j_deploy
from repro_torch.core import codesign, sweep
from repro_torch.core.leakage import CircuitConfig
from repro_torch.data import binning, cache, fixtures, formats, sources
from repro_torch.stream import deploy
from repro_torch.stream.engine import StreamEngine

from stream_replay import awake
from torch_threads import one_torch_thread  # noqa: F401

HW = 16
T_GRID = (100.0, 1000.0)
RET_RTOL = {"frozen": 1e-6, "unfrozen": 1e-5}
RTOL_KEYS = ("bandwidth_ratio", "bandwidth_norm", "sensor_energy_p2m_j")
COUNTER_KEYS = ("backend_energy_conventional_j", "backend_energy_p2m_j",
                "energy_improvement")
EQUAL_KEYS = ("label", "circuit", "null_mismatch", "protocol", "t_intg_ms",
              "n_sub", "variant", "accuracy", "layer1_spikes",
              "input_events")
LOGIT_ATOL = 1e-4


def _random_events(rng, n, *, hw, t_max, sort=True):
    t = rng.integers(0, t_max, n)
    if sort:
        t = np.sort(t)
    return formats.EventChunk(
        t=t.astype(np.int64), x=rng.integers(0, hw, n).astype(np.int32),
        y=rng.integers(0, hw, n).astype(np.int32),
        p=rng.integers(0, 2, n).astype(np.int8))


def _as_ref(ev):
    return j_formats.EventChunk(ev.t, ev.x, ev.y, ev.p)


def _assert_chunks_equal(a, b):
    for f in ("t", "x", "y", "p"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _listing(src):
    return [(s.sample_id, s.label, s.t0_us, s.t1_us, s.split_id)
            for s in src.samples]


@pytest.fixture(scope="module")
def dvs_root(tmp_path_factory):
    """A DVS128-Gesture fixture the reference wrote: 5 recordings of 3
    gesture trials; fixture_user04.aedat hashes to val, the rest to train."""
    return j_fixtures.make_dvs128_fixture(
        tmp_path_factory.mktemp("dvs"), n_recordings=5,
        trials_per_recording=3)


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

class TestFormats:
    def test_aedat31_bytes_equal_and_cross_read(self, tmp_path):
        ev = _random_events(np.random.default_rng(0), 10_000, hw=128,
                            t_max=5_000_000)
        formats.write_aedat31(tmp_path / "p.aedat", ev,
                              events_per_packet=997)
        j_formats.write_aedat31(tmp_path / "j.aedat", _as_ref(ev),
                                events_per_packet=997)
        assert (tmp_path / "p.aedat").read_bytes() == \
            (tmp_path / "j.aedat").read_bytes()
        _assert_chunks_equal(formats.concat_chunks(
            formats.read_aedat31(tmp_path / "j.aedat")), ev)
        _assert_chunks_equal(j_formats.concat_chunks(
            j_formats.read_aedat31(tmp_path / "p.aedat")), ev)

    def test_aedat31_empty(self, tmp_path):
        formats.write_aedat31(tmp_path / "p.aedat", formats.concat_chunks([]))
        j_formats.write_aedat31(tmp_path / "j.aedat",
                                j_formats.concat_chunks([]))
        assert (tmp_path / "p.aedat").read_bytes() == \
            (tmp_path / "j.aedat").read_bytes()
        assert len(formats.concat_chunks(
            formats.read_aedat31(tmp_path / "p.aedat"))) == 0

    def test_aedat31_t_stop_cuts_tail_packets(self, tmp_path):
        ev = _random_events(np.random.default_rng(1), 4000, hw=128,
                            t_max=1_000_000)
        p = tmp_path / "win.aedat"
        formats.write_aedat31(p, ev, events_per_packet=100)
        cut = formats.concat_chunks(formats.read_aedat31(p,
                                                         t_stop_us=500_000))
        assert 0 < len(cut) < len(ev)
        assert int(cut.t[0]) == int(ev.t[0])
        # it stops on a packet's first timestamp: whole packets, the last
        # one starting before the cut, the next one at or after it
        n = len(cut)
        assert n % 100 == 0 and int(ev.t[n - 100]) < 500_000 <= int(ev.t[n])
        _assert_chunks_equal(cut, j_formats.concat_chunks(
            j_formats.read_aedat31(p, t_stop_us=500_000)))

    def test_aedat31_packets_the_reader_skips(self, tmp_path):
        """Hand-built packets: a timestamp overflow, invalid events, an IMU
        packet, a polarity packet of eventSize 16, a truncated tail; the
        port decodes what the reference decodes."""
        hdr = formats._PACKET_HEADER
        rng = np.random.default_rng(2)

        def pol(n, overflow, size=8, valid_every=3):
            raw = np.zeros((n, size // 4), dtype="<u4")
            data = ((rng.integers(0, 128, n) << 17)
                    | (rng.integers(0, 128, n) << 2)
                    | (rng.integers(0, 2, n) << 1))
            raw[:, 0] = data | (np.arange(n) % valid_every != 0)
            raw[:, 1] = np.sort(rng.integers(0, (1 << 32) - 1, n))
            return hdr.pack(1, 0, size, 4, overflow, n, n, n) + raw.tobytes()

        body = (pol(50, 0) + pol(40, 2)
                + hdr.pack(2, 0, 36, 4, 0, 3, 3, 3) + bytes(36 * 3)
                + pol(20, 0, size=16) + pol(30, 1, valid_every=1 << 30)
                + pol(30, 3)[:-5])
        p = tmp_path / "hand.aedat"
        p.write_bytes(formats.AEDAT31_MAGIC + b"\r\n# a\r\n# b\r\n" + body)
        got = list(formats.read_aedat31(p))
        want = list(j_formats.read_aedat31(p))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _assert_chunks_equal(a, b)
        # bit 31 of the time from the overflow counter, a u32 timestamp word
        assert got[1].t.min() >= 2 << 31 and got[2].t.min() >= 1 << 31
        assert len(got[0]) == 50 - len(range(0, 50, 3))

    def test_aedat31_rejects_other_magic(self, tmp_path):
        p = tmp_path / "v2.aedat"
        p.write_bytes(b"#!AER-DAT2.0\r\n" + b"\x00" * 64)
        for mod in (formats, j_formats):
            with pytest.raises(ValueError, match="AEDAT"):
                list(mod.read_aedat31(p))

    @pytest.mark.parametrize("field,value", [("x", 1 << 15), ("y", 1 << 15),
                                             ("t", -1), ("t", 1 << 31)])
    def test_aedat31_range_check(self, tmp_path, field, value):
        f = dict(t=np.array([0], np.int64), x=np.array([1], np.int32),
                 y=np.array([0], np.int32), p=np.array([1], np.int8))
        f[field] = np.array([value], f[field].dtype)
        for mod in (formats, j_formats):
            with pytest.raises(ValueError, match="range"):
                mod.write_aedat31(tmp_path / "bad.aedat", mod.EventChunk(**f))

    def test_nmnist_bin_bytes_equal_and_cross_read(self, tmp_path):
        ev = _random_events(np.random.default_rng(3), 7_531, hw=34,
                            t_max=(1 << 23) - 1, sort=False)
        formats.write_nmnist_bin(tmp_path / "p.bin", ev)
        j_formats.write_nmnist_bin(tmp_path / "j.bin", _as_ref(ev))
        assert (tmp_path / "p.bin").read_bytes() == \
            (tmp_path / "j.bin").read_bytes()
        _assert_chunks_equal(formats.concat_chunks(formats.read_nmnist_bin(
            tmp_path / "j.bin", chunk_events=512)), ev)
        _assert_chunks_equal(j_formats.concat_chunks(
            j_formats.read_nmnist_bin(tmp_path / "p.bin", chunk_events=512)),
            ev)

    def test_nmnist_timestamp_is_23_bits(self, tmp_path):
        """Byte 2 holds the polarity in bit 7 and time bits 22-16 below."""
        raw = np.array([[3, 4, 0xFF, 0x12, 0x34], [5, 6, 0x7F, 0, 1],
                        [7, 8, 0x80, 0xFF, 0xFF]], np.uint8)
        p = tmp_path / "hand.bin"
        p.write_bytes(raw.tobytes() + b"\x01\x02")     # a partial record
        got = formats.concat_chunks(formats.read_nmnist_bin(p))
        np.testing.assert_array_equal(
            got.t, [(0x7F << 16) | 0x1234, (0x7F << 16) | 1, 0xFFFF])
        np.testing.assert_array_equal(got.p, [1, 0, 1])
        _assert_chunks_equal(got, j_formats.concat_chunks(
            j_formats.read_nmnist_bin(p)))

    @pytest.mark.parametrize("field,value", [("x", 1 << 8), ("t", 1 << 23),
                                             ("t", -1)])
    def test_nmnist_bin_range_check(self, tmp_path, field, value):
        f = dict(t=np.array([0], np.int64), x=np.array([0], np.int32),
                 y=np.array([0], np.int32), p=np.array([0], np.int8))
        f[field] = np.array([value], f[field].dtype)
        for mod in (formats, j_formats):
            with pytest.raises(ValueError, match="range"):
                mod.write_nmnist_bin(tmp_path / "bad.bin", mod.EventChunk(**f))


# ---------------------------------------------------------------------------
# binning on file inputs
# ---------------------------------------------------------------------------

class TestBinning:
    def test_frames_to_events_to_frames_exact(self):
        frames = np.random.default_rng(4).poisson(
            0.7, (16, 8, 8, 2)).astype(np.float32)
        ev = binning.frames_to_events(frames, 2000)
        _assert_chunks_equal(ev, j_binning.frames_to_events(frames, 2000))
        back = binning.bin_chunks([ev], n_total=16, slot_us=2000,
                                  sensor_hw=(8, 8), out_hw=(8, 8))
        np.testing.assert_array_equal(back, frames)

    def test_rebin_at_coarser_t_intg_conserves_counts(self):
        frames = np.random.default_rng(5).poisson(
            0.5, (20, 8, 8, 2)).astype(np.float32)
        ev = binning.frames_to_events(frames, 1000)
        fine = binning.bin_chunks([ev], n_total=20, slot_us=1000,
                                  sensor_hw=(8, 8), out_hw=(8, 8))
        coarse = binning.bin_chunks([ev], n_total=4, slot_us=5000,
                                    sensor_hw=(8, 8), out_hw=(8, 8))
        np.testing.assert_array_equal(
            coarse, fine.reshape(4, 5, 8, 8, 2).sum(axis=1))

    def test_spatial_downscale_conserves_counts(self):
        ev = _random_events(np.random.default_rng(6), 5000, hw=128,
                            t_max=10_000)
        down = binning.bin_chunks([ev], n_total=10, slot_us=1000,
                                  sensor_hw=(128, 128), out_hw=(16, 16))
        assert down.shape == (10, 16, 16, 2) and down.sum() == 5000
        np.testing.assert_array_equal(down, j_binning.bin_chunks(
            [_as_ref(ev)], n_total=10, slot_us=1000, sensor_hw=(128, 128),
            out_hw=(16, 16)))

    def test_polarity_and_window_conventions(self):
        """p=1 (ON) in channel 0; events before t0, past the last slot or
        at/after t_stop dropped."""
        ev = formats.EventChunk(t=np.array([10, 20, -5, 500, 9_999, 10_000],
                                           np.int64),
                                x=np.array([1, 2, 0, 0, 0, 0], np.int32),
                                y=np.array([3, 4, 0, 0, 0, 0], np.int32),
                                p=np.array([1, 0, 1, 1, 1, 1], np.int8))
        kw = dict(n_total=10, slot_us=1000, sensor_hw=(8, 8), out_hw=(8, 8),
                  t_stop_us=9_999)
        out = binning.bin_chunks([ev], **kw)
        assert out[0, 3, 1, 0] == 1.0 and out[0, 4, 2, 1] == 1.0
        assert out.sum() == 3.0
        np.testing.assert_array_equal(out, j_binning.bin_chunks([ev], **kw))

    def test_slot_us_for_rejects_fractional(self):
        assert binning.slot_us_for(10.0, 2) == 5000
        with pytest.raises(ValueError, match="microsecond"):
            binning.slot_us_for(0.0005, 3)

    @pytest.mark.parametrize("t_intg,n_sub", [(10.0, 4), (250.0, 2)])
    def test_bin_chunks_on_a_recording(self, dvs_root, t_intg, n_sub):
        """A reference-written AEDAT window binned by both packages, with
        its t0 / t_stop and the 128 → 16 downscale: equal."""
        path = dvs_root / "fixture_user01.aedat"
        t0, t1 = 2_100_000, 4_100_000
        slot = binning.slot_us_for(t_intg, n_sub)
        kw = dict(n_total=int(2000 / t_intg) * n_sub, slot_us=slot,
                  sensor_hw=(128, 128), out_hw=(HW, HW), t0_us=t0,
                  t_stop_us=t1)
        got = binning.bin_chunks(formats.read_aedat31(path, t_stop_us=t1),
                                 **kw)
        want = j_binning.bin_chunks(j_formats.read_aedat31(path,
                                                           t_stop_us=t1),
                                    **kw)
        assert got.sum() > 0
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# splits and the frame cache
# ---------------------------------------------------------------------------

class TestSplitsAndCache:
    def test_split_of_equals_reference(self):
        ids = ([f"user{u:02d}_led.aedat#{k}" for u in range(30)
                for k in range(12)]
               + [f"fixture_user{r:02d}.aedat" for r in range(10)]
               + [f"Train/{d}/{i:05d}.bin" for d in range(10)
                  for i in range(5)])
        got = [sources.split_of(i) for i in ids]
        assert got == [j_sources.split_of(i) for i in ids]
        assert got == [sources.split_of(i, sources.VAL_PERCENT) for i in ids]
        assert set(got) == {"train", "val"}
        assert [sources.split_of(f"fixture_user{r:02d}.aedat")
                for r in range(5)] == ["train"] * 4 + ["val"]
        assert sources.VAL_PERCENT == j_sources.VAL_PERCENT
        assert sources.SPLITS == j_sources.SPLITS

    def test_recording_level_split_via_split_id(self):
        """Windows of one recording never straddle splits, as in the
        reference; train and val are disjoint and exhaustive."""
        def mk(mod, rec, k):
            return mod.FileSample(f"{rec}#{k}", 0, lambda: iter([]),
                                  split_id=rec)

        out = {}
        for mod in (sources, j_sources):
            samples = [mk(mod, f"rec{r:02d}.aedat", k) for r in range(40)
                       for k in range(5)]
            out[mod] = {sp: _listing(mod.FileEventSource(
                "x", samples, sensor_hw=(8, 8), hw=8, n_classes=1,
                duration_ms=100.0, split=sp)) for sp in ("train", "val")}
        assert out[sources] == out[j_sources]
        recs = {sp: {row[4] for row in rows}
                for sp, rows in out[sources].items()}
        assert not recs["train"] & recs["val"]
        assert recs["train"] | recs["val"] == {f"rec{r:02d}.aedat"
                                               for r in range(40)}

    def test_frame_cache_path_equals_reference(self, tmp_path):
        c, jc = (cache.FrameCache(tmp_path, "dvs128"),
                 j_cache.FrameCache(tmp_path, "dvs128"))
        assert cache.CACHE_DIRNAME == j_cache.CACHE_DIRNAME
        paths = set()
        for sid in ("a#0", "sub dir/user 01 (x).aedat#11", "Test/3/00001.bin",
                    "x" * 80 + "#2"):
            for kw in (dict(slot_us=1000, out_hw=(16, 16), n_total=10),
                       dict(slot_us=5000, out_hw=(16, 16), n_total=2),
                       dict(slot_us=1000, out_hw=(32, 32), n_total=10)):
                p = c.path(sid, **kw)
                assert str(p) == str(jc.path(sid, **kw))
                paths.add(p)
        assert len(paths) == 12

    def test_cache_hit_is_exact_and_reused(self, dvs_root, tmp_path):
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="all",
                                       cache_root=tmp_path)
        ev1, _ = src.sample_batch(torch.Generator().manual_seed(5), 2, 500.0)
        files = sorted(tmp_path.rglob("*.npy"))
        assert files and all(np.load(f).dtype == np.float32 for f in files)
        mtimes = [f.stat().st_mtime_ns for f in files]
        ev2, _ = src.sample_batch(torch.Generator().manual_seed(5), 2, 500.0)
        assert torch.equal(ev1, ev2)
        assert [f.stat().st_mtime_ns for f in files] == mtimes
        with pytest.raises(ValueError, match="expected"):
            src.cache.get_or_build("bad", lambda: np.zeros((1, 2, 2, 2)),
                                   slot_us=1, out_hw=(HW, HW), n_total=1)

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_cache_read_across_packages(self, dvs_root, tmp_path,
                                        monkeypatch, writer):
        """Frames one package cached are loaded by the other, which bins
        nothing (its binner is made to raise), and equal it."""
        idx = np.array([0, 4, 7])
        kw = dict(hw=HW, split="all", cache_root=tmp_path)
        p_src = sources.DVSGestureSource(dvs_root, **kw)
        j_src = j_sources.DVSGestureSource(dvs_root, **kw)

        def boom(*a, **k):
            raise AssertionError("binned although the frames were cached")

        if writer == "reference":
            want = np.asarray(j_src._gather(idx, 200.0, 2)[0])
            monkeypatch.setattr(sources, "bin_chunks", boom)
            got = p_src._gather(idx, 200.0, 2)[0].numpy()
        else:
            want = p_src._gather(idx, 200.0, 2)[0].numpy()
            monkeypatch.setattr(j_sources, "bin_chunks", boom)
            got = np.asarray(j_src._gather(idx, 200.0, 2)[0])
        assert len(list(tmp_path.rglob("*.npy"))) == 3
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# file sources on reference-written fixtures
# ---------------------------------------------------------------------------

class TestFileSources:
    @pytest.mark.parametrize("split", ["train", "val", "all"])
    def test_dvs128_sample_lists_equal(self, dvs_root, split):
        src = sources.DVSGestureSource(dvs_root, hw=HW, split=split)
        want = j_sources.DVSGestureSource(dvs_root, hw=HW, split=split)
        assert _listing(src) == _listing(want)
        assert (src.name, src.sensor_hw, src.n_classes, src.duration_ms) == \
            (want.name, want.sensor_hw, want.n_classes, want.duration_ms)
        assert len(src.samples) == {"train": 12, "val": 3, "all": 15}[split]
        assert src._by_class == want._by_class

    @pytest.mark.parametrize("t_intg,n_sub", [(10.0, 4), (500.0, 2)])
    def test_gather_bit_identical(self, dvs_root, tmp_path, t_intg, n_sub):
        """The same indices, each package binning on its own (two cache
        roots): frames and labels equal bit for bit."""
        idx = np.array([3, 0, 14, 3, 8])
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="all",
                                       cache_root=tmp_path / "p")
        j_src = j_sources.DVSGestureSource(dvs_root, hw=HW, split="all",
                                           cache_root=tmp_path / "j")
        ev, lab = src._gather(idx, t_intg, n_sub)
        j_ev, j_lab = j_src._gather(idx, t_intg, n_sub)
        assert ev.dtype == torch.float32 and lab.dtype == torch.int64
        assert ev.shape == (5, int(2000 / t_intg), n_sub, HW, HW, 2)
        np.testing.assert_array_equal(ev.numpy(), np.asarray(j_ev))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
        assert float(ev.sum()) > 0

    def test_event_source_contract_matches_synthetic(self, dvs_root):
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="all")
        syn = sources.resolve_dataset("synthetic-gesture", hw=HW)
        for s in (src, syn):
            ev, lab = s.sample_batch(torch.Generator().manual_seed(0), 3,
                                     500.0, n_sub=2)
            assert ev.shape == (3, 4, 2, HW, HW, 2)
            assert ev.dtype == torch.float32 and ev.device.type == "cpu"
            assert lab.shape == (3,) and lab.dtype == torch.int64
            assert float(ev.min()) >= 0.0 and float(ev.sum()) > 0.0
            assert int(lab.max()) < s.n_classes

    def test_two_t_intg_values_conserve_counts(self, dvs_root):
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="all")
        ev_a, lab_a = src.sample_batch(torch.Generator().manual_seed(1), 2,
                                       200.0)
        ev_b, lab_b = src.sample_batch(torch.Generator().manual_seed(1), 2,
                                       1000.0)
        assert ev_a.shape[1] == 10 and ev_b.shape[1] == 2
        assert torch.equal(lab_a, lab_b)
        assert float(ev_a.sum()) == float(ev_b.sum())

    def test_sample_batch_draws_from_the_generator(self, dvs_root):
        """The indices are torch.randint(0, n, (B,)) of the caller's
        generator: deterministic in its seed, another seed another draw."""
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="all")
        ev1, l1 = src.sample_batch(torch.Generator().manual_seed(3), 4, 500.0)
        ev2, l2 = src.sample_batch(torch.Generator().manual_seed(3), 4, 500.0)
        assert torch.equal(ev1, ev2) and torch.equal(l1, l2)
        idx = torch.randint(0, 15, (4,),
                            generator=torch.Generator().manual_seed(3))
        ev3, l3 = src._gather(idx.tolist(), 500.0, 1)
        assert torch.equal(ev1, ev3) and torch.equal(l1, l3)

    def test_sample_batch_with_labels_draws_from_class_pools(self, dvs_root,
                                                             monkeypatch):
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="train")
        seen = []
        gather = src._gather
        monkeypatch.setattr(src, "_gather", lambda idx, *a: (
            seen.append(list(idx)), gather(idx, *a))[1])
        want = torch.tensor([0, 2, 1, 2])
        ev, lab = src.sample_batch_with_labels(
            torch.Generator().manual_seed(4), want, 500.0)
        assert torch.equal(lab, want) and ev.shape[0] == 4
        assert [src.samples[i].label for i in seen[0]] == want.tolist()
        with pytest.raises(ValueError, match="no train samples for class 7"):
            src.sample_batch_with_labels(torch.Generator(),
                                         torch.tensor([7]), 500.0)

    def test_iter_event_chunks_equals_reference(self, dvs_root):
        src = sources.DVSGestureSource(dvs_root, hw=HW, split="all")
        j_src = j_sources.DVSGestureSource(dvs_root, hw=HW, split="all")
        for index in (0, 7, 14):
            label, chunks = src.iter_event_chunks(
                torch.Generator(), chunk_us=25_000, index=index)
            j_label, j_chunks = j_src.iter_event_chunks(
                jax.random.PRNGKey(0), chunk_us=25_000, index=index)
            chunks, j_chunks = list(chunks), list(j_chunks)
            assert label == j_label == src.samples[index].label
            assert len(chunks) == len(j_chunks) == 80
            for a, b in zip(chunks, j_chunks):
                _assert_chunks_equal(a, b)
            _assert_chunks_equal(src.sample_events(index),
                                 j_src.sample_events(index))
        label, _ = src.iter_event_chunks(torch.Generator().manual_seed(9),
                                         chunk_us=25_000)
        i = int(torch.randint(0, 15, (1,),
                              generator=torch.Generator().manual_seed(9)))
        assert label == src.samples[i].label
        with pytest.raises(ValueError, match="does not divide"):
            src.iter_event_chunks(torch.Generator(), chunk_us=30_000,
                                  index=0)

    def test_window_end_clips_next_gesture(self, tmp_path):
        """A duration longer than the labeled window does not pull the next
        gesture's events in (back-to-back windows)."""
        root = j_fixtures.make_dvs128_fixture(
            tmp_path / "dvs0", n_recordings=1, trials_per_recording=4,
            duration_ms=1000.0, gap_us=0)
        src = sources.DVSGestureSource(root, hw=HW, split="all")
        ev, _ = src.sample_batch_with_labels(torch.Generator(),
                                             torch.tensor([0]), 1000.0)
        assert ev[0, 0].sum() > 0 and ev[0, 1].sum() == 0
        j_src = j_sources.DVSGestureSource(root, hw=HW, split="all")
        for i in range(4):
            _assert_chunks_equal(src.sample_events(i),
                                 j_src.sample_events(i))

    def test_trials_listing_defines_the_split(self, tmp_path):
        root = fixtures.make_dvs128_fixture(tmp_path / "dvs", n_recordings=3,
                                            trials_per_recording=2,
                                            duration_ms=100.0)
        (root / "trials_to_train.txt").write_text(
            "fixture_user00.aedat\nfixture_user02.aedat\n\n")
        (root / "trials_to_test.txt").write_text("fixture_user01.aedat\n")
        for split, recs in (("train", {"00", "02"}), ("val", {"01"}),
                            ("all", {"00", "01", "02"})):
            src = sources.DVSGestureSource(root, duration_ms=100.0,
                                           split=split)
            want = j_sources.DVSGestureSource(root, duration_ms=100.0,
                                              split=split)
            assert _listing(src) == _listing(want)
            assert {s.sample_id[12:14] for s in src.samples} == recs

    @pytest.mark.parametrize("train_test_dirs", [False, True])
    def test_nmnist_layouts_and_splits(self, tmp_path, train_test_dirs):
        root = j_fixtures.make_nmnist_fixture(
            tmp_path / "nm", n_per_class=3, duration_ms=200.0,
            train_test_dirs=train_test_dirs)
        ids = {}
        for split in ("train", "val", "all"):
            src = sources.NMNISTSource(root, duration_ms=1000.0, split=split)
            want = j_sources.NMNISTSource(root, duration_ms=1000.0,
                                          split=split)
            assert _listing(src) == _listing(want)
            ids[split] = {s.sample_id for s in src.samples}
        assert ids["train"] | ids["val"] == ids["all"]
        assert not ids["train"] & ids["val"]
        if train_test_dirs:
            assert all(i.startswith("Train/") for i in ids["train"])
            assert all(i.startswith("Test/") for i in ids["val"])
        src = sources.NMNISTSource(root, duration_ms=1000.0, split="all")
        j_src = j_sources.NMNISTSource(root, duration_ms=1000.0, split="all")
        idx = np.array([0, 5, 11])
        ev, lab = src._gather(idx, 250.0, 2)
        assert ev.shape == (3, 4, 2, 16, 16, 2)
        np.testing.assert_array_equal(ev.numpy(),
                                      np.asarray(j_src._gather(idx, 250.0,
                                                               2)[0]))
        np.testing.assert_array_equal(lab.numpy(), [0, 1, 3])

    def test_resolve_dataset_and_eval_split(self, dvs_root, tmp_path):
        """A fixture whose recordings all hash to train has no val source
        ((None, "train")); one with user04 has; N-MNIST's Test dir is val;
        synthetic names have no split; missing roots raise as in the
        reference."""
        small = fixtures.make_dvs128_fixture(tmp_path / "two",
                                             n_recordings=2,
                                             trials_per_recording=1,
                                             duration_ms=100.0)
        for name, kw in (("dvs128", dict(data_root=str(small))),
                         ("synthetic-gesture", {})):
            assert sources.resolve_eval_dataset(name, hw=HW, **kw) == \
                j_sources.resolve_eval_dataset(name, hw=HW, **kw)
        assert sources.resolve_eval_dataset(
            "dvs128", data_root=str(small)) == (None, "train")
        src, split = sources.resolve_eval_dataset("dvs128", hw=HW,
                                                  data_root=str(dvs_root))
        assert split == "val" and isinstance(src, sources.DVSGestureSource)
        assert [s.split_id for s in src.samples] == \
            ["fixture_user04.aedat"] * 3
        nm = j_fixtures.make_nmnist_fixture(tmp_path / "nm", n_per_class=1,
                                            duration_ms=200.0,
                                            train_test_dirs=True)
        src, split = sources.resolve_eval_dataset("nmnist",
                                                  data_root=str(nm))
        assert split == "val" and src.duration_ms == 300.0
        assert all(s.sample_id.startswith("Test/") for s in src.samples)
        src = sources.resolve_dataset("dvs128", data_root=str(dvs_root),
                                      split="all", cache_root=tmp_path / "c")
        assert src.cache.root == tmp_path / "c"
        assert sources.resolve_dataset("dvs128", data_root=str(dvs_root)
                                       ).cache.root == \
            dvs_root / sources.CACHE_DIRNAME
        assert {s.label for s in sources.DVSGestureSource(
            dvs_root, split="all").samples} == {0, 1, 2}
        with pytest.raises(ValueError, match="no samples"):
            sources.DVSGestureSource(tmp_path / "nope", hw=HW)
        with pytest.raises(ValueError, match="file-backed"):
            sources.resolve_dataset("dvs128")
        with pytest.raises(ValueError, match="unknown dataset"):
            sources.resolve_dataset("cifar")
        with pytest.raises(ValueError, match="split"):
            sources.DVSGestureSource(dvs_root, split="test")
        assert sources.DATASETS == j_sources.DATASETS
        assert sources.DATASET_DURATIONS_MS == j_sources.DATASET_DURATIONS_MS


# ---------------------------------------------------------------------------
# the fixture writers
# ---------------------------------------------------------------------------

class TestFixtures:
    @pytest.mark.parametrize("kw", [
        dict(n_recordings=2, trials_per_recording=3, duration_ms=200.0),
        dict(n_recordings=1, trials_per_recording=13, duration_ms=100.0,
             gap_us=0, slot_us=25_000),
    ])
    def test_dvs128_fixture_layout_equals_reference(self, tmp_path, kw):
        """File names and labels CSVs byte-equal; the port's recordings
        read in the reference's parser to the port's events and rebin to
        counts on the generator's 16×16 grid; every window holds events."""
        root = fixtures.make_dvs128_fixture(tmp_path / "p", **kw)
        j_root = j_fixtures.make_dvs128_fixture(tmp_path / "j", **kw)
        names = sorted(p.name for p in root.iterdir())
        assert names == sorted(p.name for p in j_root.iterdir())
        for name in names:
            if name.endswith(".csv"):
                assert (root / name).read_bytes() == \
                    (j_root / name).read_bytes()
            else:
                _assert_chunks_equal(
                    formats.concat_chunks(formats.read_aedat31(root / name)),
                    j_formats.concat_chunks(
                        j_formats.read_aedat31(root / name)))
        src = sources.DVSGestureSource(root, duration_ms=kw["duration_ms"],
                                       split="all")
        assert len(src.samples) == kw["n_recordings"] * \
            kw["trials_per_recording"]
        for i in range(len(src.samples)):
            ev = src.sample_events(i)
            assert len(ev) > 0
            assert ev.t.min() >= 0 and ev.t.max() < kw["duration_ms"] * 1000
            assert ev.x.max() < 128 and ev.y.max() < 128

    def test_seed_repeats_and_rebins_to_generator_counts(self, tmp_path):
        a = fixtures.make_dvs128_fixture(tmp_path / "a", n_recordings=1,
                                         trials_per_recording=2,
                                         duration_ms=200.0, seed=4)
        b = fixtures.make_dvs128_fixture(tmp_path / "b", n_recordings=1,
                                         trials_per_recording=2,
                                         duration_ms=200.0, seed=4)
        c = fixtures.make_dvs128_fixture(tmp_path / "c", n_recordings=1,
                                         trials_per_recording=2,
                                         duration_ms=200.0, seed=5)
        f = "fixture_user00.aedat"
        assert (a / f).read_bytes() == (b / f).read_bytes()
        assert (a / f).read_bytes() != (c / f).read_bytes()
        frames = binning.bin_chunks(formats.read_aedat31(a / f), n_total=4,
                                    slot_us=50_000, sensor_hw=(128, 128),
                                    out_hw=(16, 16), t_stop_us=200_000)
        # each generator pixel was repeated over an 8×8 sensor block
        assert frames.sum() > 0 and not (frames % 64).any()

    @pytest.mark.parametrize("train_test_dirs", [False, True])
    def test_nmnist_fixture_layout_equals_reference(self, tmp_path,
                                                    train_test_dirs):
        kw = dict(n_per_class=2, duration_ms=100.0,
                  train_test_dirs=train_test_dirs)
        root = fixtures.make_nmnist_fixture(tmp_path / "p", **kw)
        j_root = j_fixtures.make_nmnist_fixture(tmp_path / "j", **kw)
        files = sorted(p.relative_to(root).as_posix()
                       for p in root.rglob("*.bin"))
        assert files == sorted(p.relative_to(j_root).as_posix()
                               for p in j_root.rglob("*.bin"))
        assert len(files) == 20 * (2 if train_test_dirs else 1)
        ev = formats.concat_chunks(formats.read_nmnist_bin(root / files[0]))
        assert 0 < len(ev) and ev.x.max() < 34 and ev.t.max() < 100_000
        _assert_chunks_equal(ev, j_formats.concat_chunks(
            j_formats.read_nmnist_bin(root / files[0])))


# ---------------------------------------------------------------------------
# the sweep on a file source, and serving fixture recordings
# ---------------------------------------------------------------------------

class _RecordingDVS(j_sources.DVSGestureSource):
    """The reference's source, logging the sample indices it draws (the
    reference's own draw, then its own ``_gather``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.drawn = []

    def sample_batch(self, key, batch_size, t_intg_ms, n_sub=1):
        idx = np.asarray(jax.random.randint(key, (batch_size,), 0,
                                            len(self.samples)))
        self.drawn.append(idx)
        return self._gather(idx, t_intg_ms, n_sub)


class _ReplayDVS(sources.DVSGestureSource):
    """The port's source gathering the reference's indices in order (the
    generator is not drawn from)."""

    def __init__(self, *a, drawn, **kw):
        super().__init__(*a, **kw)
        self.drawn, self.n = list(drawn), 0

    def sample_batch(self, gen, batch_size, t_intg_ms, n_sub=1):
        idx = self.drawn[self.n]
        self.n += 1
        assert len(idx) == batch_size
        return self._gather(idx, t_intg_ms, n_sub)


def _quiet(*_):
    pass


def _narrow(setup):
    """paper_setup(fast=True) on the dataset, cut to smoke step counts and
    the 2 × 2 grid of tests/test_streaming.py."""
    data, model, scfg, grid = setup
    grid = dataclasses.replace(grid, t_intg_grid_ms=T_GRID)
    scfg = dataclasses.replace(scfg, batch_size=2, pretrain_steps=2,
                               finetune_steps=1, eval_batches=1,
                               t_intg_grid_ms=T_GRID)
    return model, scfg, grid


@pytest.fixture(scope="module")
def sweeps(dvs_root, tmp_path_factory):
    """The reference's narrow sweep on the fixture (train split, eval on
    val), recording its indices, and the port's on replays of them from
    the reference's initial params."""
    caches = tmp_path_factory.mktemp("caches")
    kw = dict(hw=HW, cache_root=caches / "j")
    model, scfg, grid = _narrow(j_sweep.paper_setup(
        fast=True, hw=HW, dataset="dvs128", data_root=str(dvs_root)))
    grid = dataclasses.replace(grid, circuits=(JCircuit.BASIC,
                                               JCircuit.NULLIFIED))
    train = _RecordingDVS(dvs_root, split="train", **kw)
    val = _RecordingDVS(dvs_root, split="val", **kw)
    key = jax.random.PRNGKey(scfg.seed)
    pre_cfg = dataclasses.replace(model, p2m=dataclasses.replace(
        model.p2m, t_intg_ms=max(T_GRID), mode="curvefit",
        leak=dataclasses.replace(model.p2m.leak, circuit=JCircuit.IDEAL)))
    init = j_codesign.model_init(key, pre_cfg)
    init_tree = jax.tree.map(np.asarray, {"params": init[0],
                                          "bn_state": init[1]})
    pre = j_sweep.pretrain_backbone(key, train, model, scfg, _quiet)
    j_res = {p: j_sweep.run_grid(train, model, scfg, grid, _quiet,
                                 protocol=p, pretrained=pre,
                                 keep_params=True, eval_data=val)
             for p in j_sweep.PROTOCOLS}

    kw = dict(hw=HW, cache_root=caches / "p")
    t_model, t_scfg, t_grid = _narrow(sweep.paper_setup(
        fast=True, hw=HW, dataset="dvs128", data_root=str(dvs_root)))
    t_grid = dataclasses.replace(t_grid, circuits=(CircuitConfig.BASIC,
                                                   CircuitConfig.NULLIFIED))
    t_train = _ReplayDVS(dvs_root, split="train", drawn=train.drawn, **kw)
    t_val = _ReplayDVS(dvs_root, split="val", drawn=val.drawn, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codesign, "model_init", lambda gen, cfg:
                   deploy.params_from_jax(init_tree, device="cpu"))
        t_pre = sweep.pretrain_backbone(torch.Generator().manual_seed(0),
                                        t_train, t_model, t_scfg, _quiet,
                                        device="cpu")
        t_res = {p: sweep.run_grid(t_train, t_model, t_scfg, t_grid, _quiet,
                                   protocol=p, pretrained=t_pre,
                                   keep_params=True, eval_data=t_val,
                                   device="cpu")
                 for p in sweep.PROTOCOLS}
    assert (t_train.n, t_val.n) == (len(train.drawn), len(val.drawn))
    assert val.drawn, "the eval batches never came from the val split"
    return j_res, t_res, model, t_model


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_file_sweep_records_match_reference(sweeps, protocol):
    j_res, t_res, _, _ = sweeps
    jr, tr = j_res[protocol], t_res[protocol]
    assert list(tr.labels) == list(jr.labels) == ["a", "c@m=0.06"]
    assert len(tr.records) == len(jr.records) == 4
    j_recs = json.loads(json.dumps(jr.records, default=float))
    for t, j in zip(json.loads(json.dumps(tr.records)), j_recs):
        assert list(t) == list(j)
        for k in EQUAL_KEYS:
            assert t[k] == j[k], (protocol, j["label"], j["t_intg_ms"], k)
        assert t["input_events"] > 0
        for k in RTOL_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
        for k in ("retention_err_v", "retention_surface_v"):
            np.testing.assert_allclose(t[k], j[k], rtol=RET_RTOL[protocol],
                                       atol=0, err_msg=k)
        for k in COUNTER_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3, err_msg=k)


def _run_reference_cli(argv, main, monkeypatch):
    """A reference launcher's ``main()``, which parses ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["launch"] + argv)
    return main()


def test_sweep_cli_data_block_equals_reference(dvs_root, tmp_path,
                                               monkeypatch):
    """Both launchers on the fixture (circuit c, T_INTG 1000 ms, frozen):
    the artifacts' ``data`` blocks are equal, eval split ``val``."""
    from repro.launch import sweep as j_launch
    from repro_torch.launch import sweep as launch
    argv = ["--grid", "fast", "--protocol", "frozen", "--circuits", "c",
            "--t-intg", "1000", "--dataset", "dvs128", "--data-root",
            str(dvs_root), "--hw", str(HW)]
    assert launch.main(argv + ["--device", "cpu", "--out",
                               str(tmp_path / "p")]) == 0
    assert _run_reference_cli(argv + ["--out", str(tmp_path / "j")],
                              j_launch.main, monkeypatch) == 0
    got, want = (json.loads((tmp_path / d / "codesign_grid_fast.json")
                            .read_text()) for d in ("p", "j"))
    assert got["data"] == want["data"]
    assert got["data"]["eval_split"] == "val"
    assert got["data"]["dataset"] == "dvs128"
    assert [r["label"] for r in got["records"]] == ["c@m=0.06"]


def _offline_frames(source, index, t_intg_ms, n_sub):
    n_slots = source.n_slots(t_intg_ms)
    frames = binning.bin_chunks(
        [source.sample_events(index)], n_total=n_slots * n_sub,
        slot_us=binning.slot_us_for(t_intg_ms, n_sub),
        sensor_hw=source.sensor_hw, out_hw=(source.height, source.width))
    return frames.reshape(n_slots, n_sub, source.height, source.width, 2)


class _Pinned:
    """A source replaying a fixed sequence of sample indices, so each
    stream's recording is known."""

    def __init__(self, src, indices):
        self._src, self._indices, self._i = src, list(indices), 0
        for attr in ("name", "height", "width", "n_classes", "duration_ms",
                     "sensor_hw", "n_slots"):
            setattr(self, attr, getattr(src, attr))

    def iter_event_chunks(self, gen, *, chunk_us, slot_us=None):
        idx = self._indices[self._i % len(self._indices)]
        self._i += 1
        return self._src.iter_event_chunks(gen, chunk_us=chunk_us,
                                           slot_us=slot_us, index=idx)


@pytest.mark.parametrize("protocol", ["frozen", "unfrozen"])
def test_replay_guarantee_on_fixture_recordings(sweeps, dvs_root, tmp_path,
                                                protocol):
    """Circuit c's checkpoint at T_INTG 100 and 1000 ms, deployed by the
    reference from its sweep: the port serves 3 fixture recordings
    online, equal to the port's offline forward on the offline binning
    and to the reference's offline forward on the same frames. The smoke
    sweep's head barely spikes, so both packages' loaded deployments get
    ``awake``'s gain (BN scales and fc0 doubled) to keep the logit checks
    from being vacuous."""
    j_res, _, model, _ = sweeps
    src = sources.DVSGestureSource(dvs_root, hw=HW, split="all",
                                   cache_root=tmp_path / "c")
    indices = [0, 7, 13]
    top = 0.0
    for t_intg in T_GRID:
        rec = j_deploy.select_record(j_res[protocol].records,
                                     t_intg_ms=t_intg, label="c@m=0.06")
        ckpt = tmp_path / f"ckpt_{t_intg:g}"
        j_deploy.deploy_from_sweep(j_res[protocol], model, rec, ckpt)
        dep = deploy.load_deployment(ckpt, device="cpu")
        dep = dataclasses.replace(dep, params=awake(dep.params))
        j_dep = j_deploy.load_deployment(ckpt)
        j_dep = dataclasses.replace(j_dep, params=awake(j_dep.params))
        n_sub = dep.model_cfg.p2m.n_sub
        frames = np.stack([_offline_frames(src, i, t_intg, n_sub)
                           for i in indices])
        off = deploy.offline_forward(dep, torch.from_numpy(frames))
        off_logits = off["logits"].numpy()
        j_off = j_deploy.offline_forward(j_dep, jax.numpy.asarray(frames))
        np.testing.assert_allclose(off_logits, np.asarray(j_off["logits"]),
                                   rtol=0, atol=LOGIT_ATOL)
        report = StreamEngine(dep, capacity=2, device="cpu").serve(
            _Pinned(src, indices), len(indices), seed=0)
        by_id = {r.stream_id: r for r in report.results}
        assert len(by_id) == len(indices)
        for k, idx in enumerate(indices):
            r = by_id[k]
            assert r.label == src.samples[idx].label
            np.testing.assert_allclose(np.asarray(r.logits), off_logits[k],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{protocol} T={t_intg} {k}")
            assert r.prediction == int(np.argmax(off_logits[k]))
            assert r.n_readouts == src.n_slots(t_intg)
        top = max(top, float(np.abs(off_logits).max()))
    assert top > 0.05, f"vacuous: the head never spiked (max |logit| {top})"


def test_file_replay_rebins_to_offline_frames(dvs_root):
    """Chunk-by-chunk re-binning of a replayed recording reproduces the
    offline binning exactly; the replay conserves the window's events."""
    src = sources.DVSGestureSource(dvs_root, hw=HW, split="all")
    t_intg, n_sub = 100.0, 2
    slot_us = binning.slot_us_for(t_intg, n_sub)
    _, chunks = src.iter_event_chunks(torch.Generator(), chunk_us=slot_us,
                                      index=1)
    chunks = list(chunks)
    offline = _offline_frames(src, 1, t_intg, n_sub)
    got = [binning.bin_chunks([c], n_total=1, slot_us=slot_us,
                              sensor_hw=src.sensor_hw, out_hw=(HW, HW),
                              t0_us=i * slot_us)[0]
           for i, c in enumerate(chunks)]
    assert len(got) == offline.shape[0] * n_sub
    np.testing.assert_array_equal(np.stack(got).reshape(offline.shape),
                                  offline)
    replayed = formats.concat_chunks(chunks)
    assert len(replayed) == len(src.sample_events(1)) > 0
    assert (np.diff(replayed.t) >= 0).all()


def test_smoke_nmnist_refusal_equals_reference(tmp_path, capsys):
    """--smoke's nmnist fixture (300 ms recordings) cannot hold the smoke
    grid's 1000 ms point: the port's launcher prints ``error:`` and the
    reference's message and exits 2, as the reference's launcher does."""
    from repro_torch.launch import stream as launch
    assert launch.main(["--smoke", "--dataset", "nmnist", "--device", "cpu",
                        "--out", str(tmp_path / "o")]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    root = j_fixtures.make_nmnist_fixture(tmp_path / "nm", n_per_class=1)
    with pytest.raises(ValueError) as want:
        j_deploy.train_and_deploy(tmp_path / "j", dataset="nmnist",
                                  data_root=str(root), smoke=True,
                                  t_intg_grid_ms=T_GRID)
    assert got == f"error: {want.value}"
    assert "T_INTG values [1000.0] do not divide" in got
