"""Build and bind the hand-written CUDA kernels in csrc/, and the host C++
runtime beside them: the PNG decoder's row filters (csrc/png_unfilter.cpp),
the Map's observation and covisibility index (csrc/mapgraph.cpp), the
keyframe database's inverted file (csrc/invindex.cpp) and the DBoW2 text
parser (csrc/vocloader.cpp), bound in `native/`.

The sources are compiled at first use with nvcc, one process per source, all
started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with ctypes.
The library lands in `build/kernels/` at the repository root, named by a hash
of the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Nothing here runs at import time: this module imports on
machines without a CUDA toolkit, and only `library()` needs nvcc.
`host_library()` builds the .cpp sources the same way with the host C++
compiler (g++), which the CPU machines have too, and raises if it cannot:
nothing falls back to Python in its place.

No --use_fast_math: the frontend kernel's blur and the pyramid kernel's
gain and resize must round as their torch twins do, and the pose solve
relies on IEEE division, sqrt, sin, cos.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D = ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    # int orb_frontend_set_taps(taps[9] (host))
    "orb_frontend_set_taps": [_P],
    # int orb_frontend_pyramid(levels, out, total, table (host), n_levels, th_hi, th_lo, stream)
    "orb_frontend_pyramid": [_P, _P, _I, _P, _I, _F, _F, _P],
    # int orb_pyramid(img, h, w, part, n_part_words, target, records, n_records, out, total, table (host),
    #                 n_levels, device, stream)
    "orb_pyramid": [_P, _I, _I, _P, _I, _F, _P, _I, _P, _I, _P, _I, _I, _P],
    # int pose_opt(t_in, pts, obs, mask, isig, n, fx, fy, cx, cy, bf, n_rounds, n_iters,
    #              t_out, inliers, counts, chi2, stream)
    "pose_opt": [_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P],
}

HOST_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-pthread"]
# name: (restype, argtypes); pointers go as addresses (ndarray.ctypes.data)
_HOST_SIGNATURES = {
    # int png_unfilter(src, dst, height, stride, bpp)
    "png_unfilter": (_I, [_P, _P, _I, _I, _I]),
    # mapgraph.cpp: handle = mg_new(); mg_free / mg_clear(h)
    "mg_new": (_P, []),
    "mg_free": (_I, [_P]),
    "mg_clear": (_I, [_P]),
    # mg_add(h, pid, kf, feat); feat = mg_erase(h, pid, kf); mg_erase_point(h, pid)
    "mg_add": (_I, [_P, _L, _L, _L]),
    "mg_erase": (_L, [_P, _L, _L]),
    "mg_erase_point": (_I, [_P, _L]),
    # rows = mg_covisibility(h, kf, map_pt, n, out_kf, out_w, cap)
    "mg_covisibility": (_L, [_P, _L, _P, _L, _P, _P, _L]),
    # rows = mg_points_seen_by(h, kfs, n, out, cap)
    "mg_points_seen_by": (_L, [_P, _P, _L, _P, _L]),
    # rows = mg_export_observers(h, pids, n, out_idx, out_kf, out_feat, cap)
    "mg_export_observers": (_L, [_P, _P, _L, _P, _P, _P, _L]),
    # invindex.cpp: handle = ii_new(); ii_free / ii_clear(h); n = ii_size(h)
    "ii_new": (_P, []),
    "ii_free": (_I, [_P]),
    "ii_clear": (_I, [_P]),
    "ii_size": (_L, [_P]),
    # ii_add(h, kf, words, vals, n); ii_erase(h, kf); rows = ii_keyframes(h, out, cap)
    "ii_add": (_I, [_P, _L, _P, _P, _L]),
    "ii_erase": (_I, [_P, _L]),
    "ii_keyframes": (_L, [_P, _P, _L]),
    # ii_score(h, kf1, kf2, &out); ii_score_vec(h, words, vals, n, kf, &out)
    "ii_score": (_I, [_P, _L, _L, _P]),
    "ii_score_vec": (_I, [_P, _P, _P, _L, _L, _P]),
    # rows = ii_query(h, words, vals, n, exclude, n_excl, min_score, out_kf, out_score, cap)
    "ii_query": (_L, [_P, _P, _P, _L, _P, _L, _D, _P, _P, _L]),
    # vocloader.cpp: handle = voc_parse(buf, len, info); voc_fill(handle, parent, leaf, desc, weight)
    "voc_parse": (_P, [_P, _L, _P]),
    "voc_fill": (_I, [_P, _P, _P, _P, _P]),
    "voc_free": (_I, [_P]),
}

_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None
_host_lock = threading.Lock()
build_info: dict = {}  # {"path", "seconds", "built", "log"} after library()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path(stem: str, flags, sources, toolchain: str = "") -> Path:
    """BUILD_DIR / stem_<hash of the flags, sources and `toolchain`>.so: an
    edited source or flag, or another compiler, names another file, so a
    stale build is never loaded."""
    digest = hashlib.sha256(" ".join(flags).encode() + toolchain.encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"


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
    path = _library_path("libslam_kernels", NVCC_FLAGS, _sources())
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


def host_library() -> ctypes.CDLL:
    """The host C++ runtime (csrc/*.cpp), built with g++ at first use into
    `build/kernels/libslam_host_<hash>.so`, one compiler process per source,
    all started together, and bound with ctypes (a foreign call releases the
    GIL). Raises RuntimeError without a compiler or when a build fails."""
    global _host_lib
    with _host_lock:
        if _host_lib is not None:
            return _host_lib
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++) found: the port's host runtime (csrc/*.cpp) needs one")
        sources = sorted(CSRC.glob("*.cpp"))
        # a library built by another compiler or for another machine (and so
        # perhaps another C library) is never loaded: both name the file
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
        path = _library_path("libslam_host", HOST_FLAGS, sources, f"{cxx}\n{version}{platform.machine()}")
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            work = tempfile.mkdtemp(dir=path.parent)
            try:
                jobs = []
                for src in sources:
                    obj = os.path.join(work, src.stem + ".o")
                    cmd = [cxx, *HOST_FLAGS, "-c", "-o", obj, str(src)]
                    jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True)))
                log, failed = "", []
                for cmd, _, proc in jobs:
                    log += proc.communicate()[0]
                    if proc.returncode != 0:
                        failed.append(f"{' '.join(cmd)} ({proc.returncode})")
                if failed:
                    raise RuntimeError(f"{cxx} failed: " + "; ".join(failed) + "\n" + log)
                tmp = os.path.join(work, path.name)
                proc = subprocess.run([cxx, *HOST_FLAGS, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cxx} link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)  # atomic: a process building at the same time never loads a partial file
            finally:
                shutil.rmtree(work, ignore_errors=True)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _host_lib = lib
        return lib
