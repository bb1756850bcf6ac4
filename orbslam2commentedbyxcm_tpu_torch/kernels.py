"""Build and bind the hand-written CUDA kernels in csrc/.

The sources are compiled at first use with nvcc, one process per source, all
started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with ctypes.
The library lands in `build/kernels/` at the repository root, named by a hash
of the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Nothing here runs at import time: this module imports on
machines without a CUDA toolkit, and only `library()` needs nvcc.

No --use_fast_math: the frontend kernel's blur must round as its torch twin
does, and the pose solve relies on IEEE division, sqrt, sin, cos.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # int orb_frontend_set_taps(taps[9] (host))
    "orb_frontend_set_taps": [_P],
    # int orb_frontend_pyramid(levels, out, total, table (host), n_levels, th_hi, th_lo, stream)
    "orb_frontend_pyramid": [_P, _P, _I, _P, _I, _F, _F, _P],
    # int pose_opt(t_in, pts, obs, mask, isig, n, fx, fy, cx, cy, bf, n_rounds, n_iters,
    #              t_out, inliers, counts, chi2, stream)
    "pose_opt": [_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}  # {"path", "seconds", "built", "log"} after library()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def compile_library(path: Path, sources, defines=()) -> str:
    """Build the shared library `path` from the .cu `sources`, each compiled
    with `defines` (e.g. "-DNAME=VALUE") by its own nvcc process, all started
    together, then linked. Returns the compilers' log; raises if one fails."""
    nvcc = _nvcc()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=path.parent)
    try:
        jobs = []
        for src in sources:
            obj = os.path.join(work, Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, _, proc in jobs:
            log += proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})")
        if failed:
            raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n" + log)
        tmp = os.path.join(work, path.name)
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return log


def load(path) -> ctypes.CDLL:
    """Load a library built by `compile_library` and bind the launchers it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode() + src.read_bytes())
    path = BUILD_DIR / f"libslam_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    built = not path.exists()
    if built:
        log = compile_library(path, [s for s in _sources() if s.suffix == ".cu"])
    lib = load(path)
    build_info.update(path=str(path), seconds=time.perf_counter() - t0, built=built, log=log)
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
