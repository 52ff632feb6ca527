"""Atomic checkpoints in the reference's format (``repro.checkpoint.store``):

    <dir>/step_000000123/
        index.json        # manifest: step, leaf paths/shapes/dtypes, extra
        host_00000.npz    # every leaf as a numpy array
        COMMIT            # written last; a directory without it is garbage

So a checkpoint either package writes loads in the other. Everything is
written into ``step_X.tmp/`` and renamed after COMMIT lands.

``CheckpointManager`` adds the training loop's policy: periodic saves,
async writes in a background thread (the tree is copied to host numpy
before ``save`` returns, since a donated train step overwrites its
tensors in place), retention of the newest ``keep`` and restore onto a
device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
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


def _host_copy(leaf) -> np.ndarray:
    """A host numpy array that shares no memory with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


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


class CheckpointManager:
    """Periodic and preemption-triggered checkpoints, written in the
    background, with retention (``repro.checkpoint.CheckpointManager``)."""

    def __init__(self, directory: str | Path, *, every_steps: int = 100,
                 keep: int = 3):
        self.directory = Path(directory)
        self.every_steps = every_steps
        self.keep = keep
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_saved: int | None = None
        self._lock = threading.Lock()

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every_steps == 0

    def save(self, step: int, tree: Any, extra: dict | None = None,
             blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``. Async (``blocking=False``): the
        leaves are copied to host numpy now, written by a thread; at most
        one writer runs, and a writer's error surfaces at the next
        ``save`` or ``wait``."""
        self.wait()
        if blocking:
            self._save_now(step, tree, extra)
            return
        snapshot = unflatten_dict({p: _host_copy(leaf)
                                   for p, leaf in tree_paths(tree)})

        def write():
            try:
                self._save_now(step, snapshot, extra)
            except Exception as e:           # re-raised by wait()
                self._error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()

    def _save_now(self, step: int, tree: Any, extra: dict | None) -> None:
        with self._lock:
            save_checkpoint(self.directory, step, tree, extra)
            self._last_saved = step
            self._gc()

    def wait(self) -> None:
        """Join the background writer; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
        self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, device: str | torch.device | None = None,
                step: int | None = None) -> tuple[dict, dict] | None:
        """(tree, extra) of ``step`` (default: the newest committed), or
        None when there is none. With ``device`` every leaf is a tensor
        there (the reference's ``shardings=``); without, a numpy array."""
        try:
            tree, extra = load_checkpoint(self.directory, step)
        except FileNotFoundError:
            return None
        if device is not None:
            dev = torch.device(device)
            tree = unflatten_dict({p: torch.from_numpy(a).to(dev)
                                   for p, a in tree_paths(tree)})
        return tree, extra

    @property
    def last_saved(self) -> int | None:
        return self._last_saved

    def _gc(self) -> None:
        steps = sorted(
            int(c.name.split("_")[1])
            for c in self.directory.iterdir()
            if c.name.startswith("step_") and not c.name.endswith(".tmp")
            and _is_committed(c))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:09d}", ignore_errors=True)
