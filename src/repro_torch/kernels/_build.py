"""Build and load a hand-written CUDA source as a shared library, and
check the tensors handed to it.

Each kernel package keeps its source under ``csrc/`` and its build under
``build/`` next to it (listed in ``.gitignore``). ``build`` compiles the
source with ``nvcc`` for ``sm_90a`` into a library with a plain C
interface, named by the hash of the source and every local header it
includes, at first use; ``load`` opens it with ``ctypes``. Nothing here runs when a module is imported, so the CPU
tests can import every kernel module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

import torch


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_sources(src: Path) -> list[Path]:
    """``src`` and every file its ``#include "..."`` lines reach, followed
    recursively (a quoted name is looked up next to the file that names it,
    then in ``src``'s directory, nvcc's order with ``-I`` that directory),
    each once, in the order first reached."""
    seen, todo = [], [src.resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for name in _INCLUDE.findall(f.read_bytes()):
            for base in (f.parent, src.resolve().parent):
                cand = (base / name.decode()).resolve()
                if cand.is_file():
                    todo.append(cand)
                    break
    return seen


def library_path(src: Path, build_dir: Path) -> Path:
    """Where ``build`` puts ``src``'s library: named by a hash of the source
    and the local headers it includes, so that an edit to either builds
    anew."""
    h = hashlib.sha256()
    for f in local_sources(src):
        h.update(f.read_bytes())
    return build_dir / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(src: Path, build_dir: Path) -> dict:
    """Compile ``src`` if this content has not been built yet. Returns
    ``{"path", "seconds", "log"}``; ``log`` holds ptxas' register and
    shared-memory report of a fresh build (empty when the library was
    already there)."""
    so = library_path(src, build_dir)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "log": ""}
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src.parent), "-o", str(tmp), str(src),
    ]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({r.returncode}):\n{r.stderr[-8000:]}")
    os.replace(tmp, so)  # atomic: no process ever loads a half-written library
    return {"path": str(so), "seconds": time.perf_counter() - t0, "log": r.stderr}


def load(src: Path, build_dir: Path) -> ctypes.CDLL:
    return ctypes.CDLL(build(src, build_dir)["path"])


def require(t: torch.Tensor, name: str, dtype, shape=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``): what every kernel entry point assumes of its pointers."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy of it when its data does not start on a
    16-byte boundary (the kernels' 16-byte loads and cp.async chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
