"""Device and call times of the port's CUDA kernels over their design
choices, on one CUDA GPU.

    python3 tools/profile_kernels.py    # from the repository root

Builds each design choice from csrc/ into a library of its own under
build/profile/, through the -D defines the sources read (all builds at
once), and times it through the port's own wrappers:

- K1 (csrc/frontend.cu): one pyramid launch per output tile size
  (K1_TILE_W x K1_TILE_H) at the TUM1, EuRoC and KITTI image sizes; then,
  with the shipped kernel at 640x480, the level images packed back to back
  against each level on a 128-byte line (frontend_kernel.level_table's
  layout), for K1 and for the resize matmuls that write the levels;
- K2 (csrc/poseopt.cu): threads per block (K2_THREADS) x blocks per cluster
  (K2_CLUSTER) at N = 1000 and 2000 edges (stereo 0.5), and at N = 32 one
  block against a cluster of 8 (K2_ONE_BLOCK_EDGES=0);
- the pyramid kernel (csrc/pyramid.cu): the image box a block stages
  (PYR_BOX_ROWS x PYR_BOX_COLS, with its buffer PYR_BUF_*) and threads per
  block (PYR_THREADS), one call per extraction at the TUM1, EuRoC and KITTI
  sizes, gain on and off.

Device time is the kernel's own time under torch.profiler; call time is the
CUDA-event round trip of the Python wrapper, what the main path pays.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch import kernels  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops import poseopt_kernel as pk  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops import pyramid_kernel as pyr  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, _resize_weights  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera  # noqa: E402

OUT = ROOT / "build" / "profile"
DEV = torch.device("cuda", 0)
CAM = (cs.FX, cs.FY, cs.CX, cs.CY, cs.BF)
SIZES = [(640, 480), (752, 480), (1241, 376)]
TILES = [(32, 16), (64, 16), (64, 32), (128, 16)]
K2_SHAPES = [(128, 1), (128, 2), (128, 4), (128, 8), (256, 1), (256, 2), (256, 4), (256, 8)]
# pyramid variants, named by the image values a box stages (its own and a
# halo of 7: taps up to 8 at 8 levels of scale 1.2): name -> defines, the
# shipped one first with none
PYR_VARIANTS = {
    "buf24x64": [],
    "buf16x64": ["-DPYR_BOX_ROWS=8", "-DPYR_BUF_ROWS=16"],
    "buf40x64": ["-DPYR_BOX_ROWS=32", "-DPYR_BUF_ROWS=40", "-DPYR_T_WORDS=9216"],
    "buf24x32": ["-DPYR_BOX_COLS=32", "-DPYR_BUF_COLS=32"],
    "buf24x128": ["-DPYR_BOX_COLS=128", "-DPYR_BUF_COLS=128", "-DPYR_REC_WORDS=4096", "-DPYR_T_WORDS=9216"],
    "threads128": ["-DPYR_THREADS=128"],
    "threads512": ["-DPYR_THREADS=512"],
    "copies1": ["-DPYR_PART_COPIES=1"],
    "copies32": ["-DPYR_PART_COPIES=32"],
}


def build_variants():
    """{name: loaded library} of every design choice, built in parallel."""
    jobs = {f"k1_{w}x{h}": ("frontend.cu", [f"-DK1_TILE_W={w}", f"-DK1_TILE_H={h}"]) for w, h in TILES}
    jobs.update({f"k2_{nt}x{cl}": ("poseopt.cu", [f"-DK2_THREADS={nt}", f"-DK2_CLUSTER={cl}"])
                 for nt, cl in K2_SHAPES})
    jobs["k2_128x8_always"] = ("poseopt.cu", ["-DK2_ONE_BLOCK_EDGES=0"])
    jobs.update({f"pyr_{name}": ("pyramid.cu", defines) for name, defines in PYR_VARIANTS.items()})
    with ThreadPoolExecutor(max_workers=8) as pool:
        builds = [pool.submit(kernels.compile_library, OUT / f"{name}.so", [kernels.CSRC / src], defines)
                  for name, (src, defines) in jobs.items()]
        for build in builds:
            build.result()
    return {name: kernels.load(OUT / f"{name}.so") for name in jobs}


@contextlib.contextmanager
def using(lib):
    """Route the port's wrappers to `lib` (the taps are loaded into it anew)."""
    saved = kernels._lib
    kernels._lib = lib
    fk._taps_set.clear()
    try:
        yield
    finally:
        kernels._lib = saved
        fk._taps_set.clear()


def times(fn, kernel, reps=200):
    return cs._device_ms(fn, 50, kernel)[0], cs._cuda_ms(fn, reps)


def frame(w, h):
    seq = BoxSequence(camera=default_camera(w, h), seed=5, n_frames=100, turns=0.35)
    return torch.from_numpy(seq.render(0)).to(DEV)


def pose_args(n):
    t0, pts, obs, mask, _ = cs.make_pose_problem(np.random.default_rng(0), n, 0.5)
    return [torch.from_numpy(a).to(DEV) for a in (t0, pts, obs, mask, np.ones(n, np.float32))]


def sweep_tiles(libs):
    print("K1 one pyramid launch per extraction, by tile (w x h): device ms (torch.profiler) / call ms (CUDA events)")
    for w, h in SIZES:
        buf, table = ORBExtractor(n_features=1000)._pyramid(frame(w, h))
        row = []
        for tw, th in TILES:
            with using(libs[f"k1_{tw}x{th}"]):
                dev_ms, call_ms = times(lambda: fk.fused_frontend_pyramid(buf, table, 20.0, 7.0), "frontend_kernel")
            row.append(f"{tw}x{th} {dev_ms:.4f} / {call_ms:.4f}")
        print(f"  {w}x{h} ({sum(a * b for a, b in table.shapes)} px): " + "; ".join(row))


def packed(table):
    """`table`'s levels back to back, with no padding between them."""
    offsets, rows, off = [], [], 0
    for h, w in table.shapes:
        offsets.append(off)
        rows += (off, h, w)
        off += h * w
    return fk.LevelTable(table.shapes, tuple(offsets), off, (ctypes.c_int * len(rows))(*rows))


def write_levels(img, table, buf):
    """The level images written into `buf` laid out by `table`: the copy and
    the 14 dense resize products `wh @ img @ ww.T` the extractor ran before
    the pyramid kernel."""
    h, w = img.shape
    for lvl, view in enumerate(fk.level_views(buf, table)):
        if lvl == 0:
            view.copy_(img)
        else:
            hl, wl = view.shape
            wh, ww = (torch.from_numpy(_resize_weights(n, m)).to(DEV) for n, m in ((h, hl), (w, wl)))
            torch.matmul(wh @ img, ww.T, out=view)


def compare_layouts():
    ext = ORBExtractor(n_features=1000)
    img = frame(640, 480)
    aligned = ext._pyramid(img)[1]
    tables = {"packed": packed(aligned), "aligned": aligned}
    print("K1 and the writing of the level images (copy + 14 resize matmuls) at 640x480, by level layout, in "
          "the order packed, aligned, aligned, packed: K1 device / call ms; levels device (every kernel, "
          "torch.profiler) / call ms")
    for name in ("packed", "aligned", "aligned", "packed"):
        table = tables[name]
        buf = torch.empty(table.total, device=DEV)
        write_levels(img, table, buf)
        k1 = times(lambda: fk.fused_frontend_pyramid(buf, table, 20.0, 7.0), "frontend_kernel")
        levels = times(lambda: write_levels(img, table, buf), "")
        print(f"  {name}: K1 {k1[0]:.4f} / {k1[1]:.4f}; levels {levels[0]:.4f} / {levels[1]:.4f}")


def sweep_blocks(libs):
    print("K2 one solve, stereo 0.5, by threads per block x blocks per cluster: device ms (torch.profiler) / "
          "call ms (CUDA events)")
    for n in (1000, 2000):
        args = pose_args(n)
        row = []
        for nt, cl in K2_SHAPES:
            with using(libs[f"k2_{nt}x{cl}"]):
                dev_ms, call_ms = times(lambda: pk.pose_optimization_fused(*args, *CAM), "pose_opt_kernel")
                evals = pk.pose_optimization_fused.last_counts.tolist()[1]
            row.append(f"{nt}x{cl} {dev_ms:.4f} / {call_ms:.4f} ({evals} evaluations)")
        print(f"  N={n}: " + "; ".join(row))
    args = pose_args(32)
    row = []
    for name, label in (("k2_128x8", "one block of 128"), ("k2_128x8_always", "8 blocks of 128")):
        with using(libs[name]):
            dev_ms, call_ms = times(lambda: pk.pose_optimization_fused(*args, *CAM), "pose_opt_kernel")
            evals = pk.pose_optimization_fused.last_counts.tolist()[1]
        row.append(f"{label} {dev_ms:.4f} / {call_ms:.4f} ({evals} evaluations)")
    print("  N=32: " + "; ".join(row))


def sweep_pyramid(libs):
    print("pyramid kernel, one call per extraction (gain on / off), by variant: device ms (torch.profiler) / "
          "call ms (CUDA events); the box plan (rows, columns a box owns, row and column bands)")
    target = ORBExtractor().exposure_target_mad
    for w, h in SIZES:
        img = frame(w, h)
        table = ORBExtractor(n_features=1000)._pyramid(img)[1]
        row = []
        for name in PYR_VARIANTS:
            lib = libs[f"pyr_{name}"]
            with using(lib):
                on = times(lambda: pyr.pyramid_resize(img, table, target), "pyramid_fused")
                off = times(lambda: pyr.pyramid_resize(img, table), "pyramid_fused")
                head = pyr._plan(h, w, table.shapes, table.offsets, str(DEV), pyr._geometry(lib)).head
            row.append(f"{name} {on[0]:.4f} / {on[1]:.4f}, off {off[0]:.4f} / {off[1]:.4f} "
                       f"({head[0]}x{head[1]}, {head[4]}x{head[5]})")
        print(f"  {w}x{h}: " + "; ".join(row))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.library()
    libs = build_variants()
    sweep_tiles(libs)
    compare_layouts()
    sweep_blocks(libs)
    sweep_pyramid(libs)


if __name__ == "__main__":
    main()
