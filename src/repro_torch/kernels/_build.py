"""Builds the hand-written CUDA kernels and loads them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles, with one ``nvcc`` per source (all started together), into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout. The
digest covers the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited kernel or header rebuilds and an unchanged one is
reused. The first use of a kernel builds it; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on ``PATH``, else under ``CUDA_HOME``
    or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels cannot be built")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: its name carries a
    digest of the source, of every shared header ``csrc/*.cuh`` (which any
    source may include) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: list[str] | None = None) -> float:
    """Compile every named source (default: all) whose library is not
    built yet, one ``nvcc`` each, all running at once. Returns the wall
    seconds spent; raises with the compiler's output if any build fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    try:
        for n in todo:
            tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
            else:
                os.replace(tmp, lib_path(n))
    finally:
        for tmp, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]
