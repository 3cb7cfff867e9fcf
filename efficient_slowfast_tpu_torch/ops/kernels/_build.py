"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source ``efficient_slowfast_tpu_torch/csrc/<name>.cu`` has a plain C
interface and becomes ``build/torch_kernels/lib<name>.so`` under the
repository root, compiled by ``nvcc`` for ``sm_90a`` (Hopper). A library is
rebuilt when its source, or any header ``csrc/*.cuh`` that sources may
include, is newer; several are compiled in parallel, one ``nvcc`` per
source. Nothing is built at import: the first kernel call (or
``build()``) does it, and a failed build raises with the compiler's output.
Processes that build at once (the ranks of a job started from a fresh
tree) take turns under a file lock, so only the first compiles.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("fused_bottleneck", "flash_attention", "flash_attention_bwd",
           "int8_conv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not os.path.exists(so):
        return True
    inputs = [os.path.join(CSRC, f"{name}.cu")]
    inputs += glob.glob(os.path.join(CSRC, "*.cuh"))
    return max(map(os.path.getmtime, inputs)) > os.path.getmtime(so)


@contextlib.contextmanager
def _build_lock():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library among ``names``; returns ptxas reports.

    The compilers run in parallel. Each writes to a temporary file that is
    renamed into place, so a concurrent reader never sees half a library.
    """
    names = list(names)
    if not any(_stale(n) for n in names):
        return {}
    with _build_lock():
        return _build([n for n in names if _stale(n)])


def _build(todo) -> Dict[str, str]:
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built if needed and loaded once per process."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(lib_path(name))
        _loaded[name] = lib
    return lib
