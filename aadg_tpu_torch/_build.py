"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so``, then loaded with
ctypes. Builds happen at first use (or all at once, in parallel, through
``build_all``); a library newer than its source is reused. Nothing here
runs at import time, so the CPU-only tests can import every module.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("hist3", "lut_apply3", "sinkhorn_solve", "softmin")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _is_fresh(name: str) -> bool:
    lib = _lib_path(name)
    return lib.exists() and lib.stat().st_mtime >= (
        CSRC / f"{name}.cu").stat().st_mtime


def _start(name: str) -> Tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(exist_ok=True)
    # write to a private name, then rename: concurrent builds never load
    # a half-written library
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))
    return out


def build_all(force: bool = False) -> Dict[str, Tuple[float, str]]:
    """Compile every kernel source in parallel (one nvcc each).
    Returns {name: (seconds, compiler output)}; skips fresh libraries
    unless ``force``."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in KERNEL_SOURCES
               if force or not _is_fresh(name)}
    results = {}
    try:
        for name, (proc, tmp) in started.items():
            out = _finish(name, proc, tmp)
            results[name] = (time.perf_counter() - t0, out)
    finally:
        for proc, tmp in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return results


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in KERNEL_SOURCES:
        raise KeyError(name)
    if not _is_fresh(name):
        proc, tmp = _start(name)
        _finish(name, proc, tmp)
    return ctypes.CDLL(str(_lib_path(name)))


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
