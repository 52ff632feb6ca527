"""Atomic checkpoints in the reference's format (``repro.checkpoint.store``):

    <dir>/step_000000123/
        index.json        # manifest: step, leaf paths/shapes/dtypes, extra
        host_00000.npz    # every leaf as a numpy array
        COMMIT            # written last; a directory without it is garbage

So a checkpoint either package writes loads in the other. Everything is
written into ``step_X.tmp/`` and renamed after COMMIT lands.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_paths, unflatten_dict

_FORMAT_VERSION = 1


def _is_committed(d: Path) -> bool:
    return (d / "COMMIT").exists()


def latest_step(directory: str | Path) -> int | None:
    """Newest committed step in ``directory`` (None when no checkpoint)."""
    d = Path(directory)
    if not d.exists():
        return None
    steps = []
    for child in d.iterdir():
        if child.name.startswith("step_") and _is_committed(child):
            try:
                steps.append(int(child.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    extra: dict | None = None) -> Path:
    """Write one committed checkpoint of a tree of tensors/arrays."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:09d}"
    tmp = d / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {path: _to_numpy(leaf) for path, leaf in tree_paths(tree)}
    np.savez(tmp / "host_00000.npz", **arrays)
    index = {
        "version": _FORMAT_VERSION,
        "step": step,
        "hosts": 1,
        "leaves": {p: {"shape": list(a.shape), "dtype": str(a.dtype)}
                   for p, a in arrays.items()},
        "extra": extra or {},
        "saved_unix": time.time(),
    }
    (tmp / "index.json").write_text(json.dumps(index, indent=2))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_checkpoint(directory: str | Path, step: int | None = None
                    ) -> tuple[dict, dict]:
    """Load ``step`` (default: latest committed). Returns (tree of numpy
    arrays, extra)."""
    d = Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {d}")
    cdir = d / f"step_{step:09d}"
    if not _is_committed(cdir):
        raise FileNotFoundError(f"checkpoint {cdir} is not committed")
    index = json.loads((cdir / "index.json").read_text())
    arrays: dict[str, np.ndarray] = {}
    for f in sorted(cdir.glob("host_*.npz")):
        with np.load(f) as z:
            for k in z.files:
                arrays[k] = z[k]
    missing = set(index["leaves"]) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint {cdir} missing leaves: "
                         f"{sorted(missing)[:5]}")
    return unflatten_dict(arrays), index.get("extra", {})
