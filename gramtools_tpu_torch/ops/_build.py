"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` into ``build/lib<name>-<hash>.so`` inside the package (the
directory is git-ignored), at first use, and loaded with ``ctypes``.
The file name carries a hash of the source, of every shared header
``csrc/*.cuh`` (a source includes them from ``csrc``, which is on the
include path) and of the flags, so an edited kernel or header is
rebuilt and a stale library is never loaded. Nothing here
runs at import time: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR)]

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    digest = hashlib.sha256(h.digest()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process, temporary output, final output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True), tmp, out)


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)


def build_all(names) -> None:
    """Compile every named kernel that is not built yet, one nvcc
    process each, all started together; ``build_seconds`` gets the wall
    time of the whole build for each of them."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names if name not in _LIBS}
    try:
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    for name in jobs:
        build_seconds[name] = time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded
    library. The build seconds are kept in ``build_seconds[name]``
    (0.0 when a built library was already there); the first load is a
    span ``kernel_load:<name>`` under ``GRAMTOOLS_TPU_TIMERS=1``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    from ..common.timers import recorder

    with recorder().span(f"kernel_load:{name}"):
        t0 = time.perf_counter()
        job = _start(name)
        if job is not None:
            _finish(name, job)
        build_seconds.setdefault(name, time.perf_counter() - t0)
        lib = ctypes.CDLL(str(library_path(name)))
    _LIBS[name] = lib
    return lib


def kernel_attrs(fn, *flags: int) -> dict:
    """A kernel's registers a thread, local (spill) bytes a thread and
    static shared bytes a block (cudaFuncGetAttributes), from its
    library's ``<name>_attrs(int*, int...)`` function ``fn``; ``flags``:
    the int arguments that pick a kernel's instance, if it has several."""
    out = (ctypes.c_int * 3)()
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * len(flags)
    fn.restype = ctypes.c_int
    err = fn(out, *flags)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "shared_bytes": out[2]}
