"""On-disk binned-frame cache of the file-backed event sources (the port's
own copy of ``repro.data.cache``).

Parsing and binning a recording is the expensive part of file-backed
sampling; its fine-slot histogram is one float32 ``.npy`` per (sample,
binning) under

    <cache_root>/<dataset>/t<slot_us>us_<H>x<W>_n<n_total>/<safe_id>.npy

the reference's path scheme and content, so a cache written by either
package is read by the other. ``safe_id`` is a sanitized, hash-suffixed
form of the sample's logical id (relative path + window index). The
default root is ``<data_root>/.p2m-frame-cache``.
"""
from __future__ import annotations

import hashlib
import re
from pathlib import Path

import numpy as np

CACHE_DIRNAME = ".p2m-frame-cache"


def _safe_id(sample_id: str) -> str:
    tag = hashlib.sha1(sample_id.encode()).hexdigest()[:12]
    stem = re.sub(r"[^A-Za-z0-9_.-]+", "_", sample_id)[-48:]
    return f"{stem}__{tag}"


class FrameCache:
    """Get-or-build cache of per-sample binned frames."""

    def __init__(self, root: str | Path, dataset: str):
        self.root = Path(root)
        self.dataset = dataset

    def path(self, sample_id: str, *, slot_us: int, out_hw: tuple[int, int],
             n_total: int) -> Path:
        h, w = out_hw
        d = self.root / self.dataset / f"t{slot_us}us_{h}x{w}_n{n_total}"
        return d / f"{_safe_id(sample_id)}.npy"

    def get_or_build(self, sample_id: str, build, *, slot_us: int,
                     out_hw: tuple[int, int], n_total: int) -> np.ndarray:
        """The cached ``[n_total, H, W, 2]`` float32 frames of a sample,
        calling ``build()`` on a miss and writing its result (to a
        temporary name, then renamed)."""
        p = self.path(sample_id, slot_us=slot_us, out_hw=out_hw,
                      n_total=n_total)
        if p.exists():
            return np.load(p)
        frames = np.asarray(build(), dtype=np.float32)
        if frames.shape != (n_total, *out_hw, 2):
            raise ValueError(f"built frames {frames.shape}, expected "
                             f"{(n_total, *out_hw, 2)}")
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp.npy")
        np.save(tmp, frames)
        tmp.replace(p)
        return frames
