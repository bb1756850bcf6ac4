"""Where the time goes inside the port's CUDA kernels, in SM clock cycles,
on one CUDA GPU.

    python3 tools/probe_kernels.py    # from the repository root

Copies csrc/frontend.cu, csrc/poseopt.cu and csrc/pyramid.cu into
build/probe/, inserts
clock64() reads at fixed places of their code (it stops if a place is no
longer found), builds each copy with the kernels' nvcc flags into a library
of its own (all builds at once) and runs it:

- K1, one pyramid launch over the 8 levels of a 640x480 frame: mean cycles
  per block in staging, the horizontal blur, the compass pass, the full
  FAST pass, and the vertical blur + NMS + stores;
- K2 at N = 32, 1000 and 2000 edges (stereo 0.5), as shipped (one block up
  to 128 edges, a cluster of 8 above) and on one block (-DK2_CLUSTER=1):
  cycles per evaluation in the edge loop and in the cross-warp /
  cross-block sum, per LM iteration in the 6x6 solve and the SE3 exp, and
  in the whole launch, as block 0's thread 0 sees them;
- the pyramid kernel, one call on a 640x480 frame with the gain on and
  off: mean cycles per block (its first box) in the gain's first sum, in
  the two grid barriers with the second sum and the gain, waiting for the
  staged box, the spans, the vertical phase with level 0, the horizontal
  phase, and the whole block, as each block's thread 0 sees them.

The reads cost a few cycles each and serialise nothing else; the probed
kernels are not the ones the port runs.
"""

from __future__ import annotations

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
from orbslam2commentedbyxcm_tpu_torch.ops import pyramid_kernel as pyr  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera  # noqa: E402

OUT = ROOT / "build" / "probe"
DEV = torch.device("cuda", 0)
READ = """
extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_dbg, sizeof(g_dbg));
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_dbg, z, sizeof(z));
  return static_cast<int>(e);
}
"""
COUNTER = "__device__ unsigned long long g_dbg[8];\n\nnamespace {\n"

K1_MARKS = [
    ("  const int tid = threadIdx.x;\n  const int bid = blockIdx.x;\n",
     "  const long long k0 = clock64();\n  const int tid = threadIdx.x;\n  const int bid = blockIdx.x;\n"),
    ("  if (tid == 0) s_count = 0;\n  __syncthreads();\n",
     "  if (tid == 0) s_count = 0;\n  __syncthreads();\n  const long long k1 = clock64();\n"),
    ("  constexpr int NPX = (TH + 2) * (TW + 2);\n",
     "  const long long k2 = clock64();\n  constexpr int NPX = (TH + 2) * (TW + 2);\n"),
    ("  __syncthreads();\n  const int n_full = s_count;\n",
     "  __syncthreads();\n  const long long k3 = clock64();\n  const int n_full = s_count;\n"),
    ("    s_lo[sy][sx] = v > th_lo ? v : 0.0f;\n  }\n  __syncthreads();\n",
     "    s_lo[sy][sx] = v > th_lo ? v : 0.0f;\n  }\n  __syncthreads();\n  const long long k4 = clock64();\n"),
    ("    nms_lo[o] = (sl >= ml && sl > 0.0f) ? sl : 0.0f;\n  }\n}\n",
     "    nms_lo[o] = (sl >= ml && sl > 0.0f) ? sl : 0.0f;\n  }\n"
     "  if (tid == 0) {\n    const long long k5 = clock64(), ks[6] = {k0, k1, k2, k3, k4, k5};\n"
     "    for (int j = 0; j < 5; ++j) atomicAdd(&g_dbg[j], (unsigned long long)(ks[j + 1] - ks[j]));\n"
     "    atomicAdd(&g_dbg[5], 1ull);\n  }\n}\n"),
]

K2_MARKS = [
    ("  float acc[NRED];\n#pragma unroll\n  for (int j = 0; j < NRED; ++j) acc[j] = 0.0f;\n"
     "  for (int i = threadIdx.x; i < cnt; i += NT) {\n",
     "  const long long c0 = clock64();\n  float acc[NRED];\n#pragma unroll\n"
     "  for (int j = 0; j < NRED; ++j) acc[j] = 0.0f;\n  for (int i = threadIdx.x; i < cnt; i += NT) {\n"),
    ("  cluster_sum<NT / 32, CL>(acc, recv, bars, k, out);\n}\n",
     "  const long long c1 = clock64();\n  cluster_sum<NT / 32, CL>(acc, recv, bars, k, out);\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) { g_dbg[0] += c1 - c0; g_dbg[1] += clock64() - c1; }\n}\n"),
    ("      lm_solve(cur, lam, dx);\n      se3_exp_mul(dx, t, trial);\n",
     "      const long long s0 = clock64();\n      lm_solve(cur, lam, dx);\n      const long long s1 = clock64();\n"
     "      se3_exp_mul(dx, t, trial);\n"
     "      if (tid == 0 && blockIdx.x == 0) { g_dbg[2] += s1 - s0; g_dbg[3] += clock64() - s1; }\n"),
    ("  const int tid = threadIdx.x;\n  const int rank =",
     "  const long long k0 = clock64();\n  const int tid = threadIdx.x;\n  const int rank ="),
    ("  if constexpr (CL > 1) cg::this_cluster().sync();  // no block leaves while a push to it is in flight\n}\n",
     "  if constexpr (CL > 1) cg::this_cluster().sync();  // no block leaves while a push to it is in flight\n"
     "  if (tid == 0 && blockIdx.x == 0) g_dbg[4] += clock64() - k0;\n}\n"),
]

PYR_MARKS = [
    ("  const bool gained = part != nullptr;\n\n",
     "  const bool gained = part != nullptr;\n  const long long p0 = clock64();\n  long long p1 = p0, p2 = p0;\n"),
    ("    }\n    grid.sync();\n    if (item < n_boxes) {",
     "    }\n    p1 = clock64();\n    grid.sync();\n    if (item < n_boxes) {"),
    ("    g.gain = fminf(fmaxf(__fdiv_rn(target, fmaxf(mad, 1e-3f)), 0.125f), 8.0f);\n",
     "    g.gain = fminf(fmaxf(__fdiv_rn(target, fmaxf(mad, 1e-3f)), 0.125f), 8.0f);\n    p2 = clock64();\n"),
    ("    if (gained) gain_box(box, s_box, g);\n    __syncthreads();\n",
     "    if (gained) gain_box(box, s_box, g);\n    __syncthreads();\n    const long long p3 = clock64();\n"),
    ("    __syncthreads();\n    // Every level's vertical pass",
     "    __syncthreads();\n    const long long p4 = clock64();\n    // Every level's vertical pass"),
    ("    write_level0(s_lv[0], box, s_box, out);\n    __syncthreads();\n",
     "    write_level0(s_lv[0], box, s_box, out);\n    const long long p5 = clock64();\n    __syncthreads();\n"),
    ("    __syncthreads();  // the box and its records are read before the next box is staged\n",
     "    if (threadIdx.x == 0 && item == static_cast<int>(blockIdx.x)) {\n"
     "      const long long p6 = clock64(), ps[7] = {p0, p1, p2, p3, p4, p5, p6};\n"
     "      for (int j = 0; j < 6; ++j) atomicAdd(&g_dbg[j], (unsigned long long)(ps[j + 1] - ps[j]));\n"
     "      atomicAdd(&g_dbg[6], (unsigned long long)(p6 - p0));\n      atomicAdd(&g_dbg[7], 1ull);\n    }\n"
     "    __syncthreads();  // the box and its records are read before the next box is staged\n"),
]


def build(name: str, marks, tag: str, defines=()) -> ctypes.CDLL:
    src = (kernels.CSRC / name).read_text()
    if "namespace {\n" not in src:
        sys.exit(f"{name}: no anonymous namespace to put the counters before")
    src = src.replace("namespace {\n", COUNTER, 1)
    for old, new in marks:
        if src.count(old) != 1:
            sys.exit(f"{name}: probe place not found once: {old.splitlines()[0]!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    cu.write_text(src + READ)
    kernels.compile_library(so, [cu], defines)
    lib = kernels.load(so)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    return lib


def run(lib, launch):
    """Counters of the third of three launches."""
    host = (ctypes.c_ulonglong * 8)()
    for _ in range(3):
        kernels.check(lib.probe_read(host), "probe_read")
        kernels.check(launch(), "probed launch")
        torch.cuda.synchronize()
    kernels.check(lib.probe_read(host), "probe_read")
    return list(host)


def probe_k1(lib):
    kernels.check(lib.orb_frontend_set_taps(fk._TAPS.ctypes.data), "orb_frontend_set_taps")
    seq = BoxSequence(camera=default_camera(), seed=5, n_frames=100, turns=0.35)
    buf, t = ORBExtractor(n_features=1000)._pyramid(torch.from_numpy(seq.render(0)).to(DEV))
    out = torch.empty((3, t.total), device=DEV)
    v = run(lib, lambda: lib.orb_frontend_pyramid(
        buf.data_ptr(), out.data_ptr(), t.total, t.c_rows, len(t.shapes), 20.0, 7.0,
        torch.cuda.current_stream().cuda_stream))
    print("K1 640x480 pyramid, mean cycles per block: staging / horizontal blur / compass pass / full FAST / "
          f"vertical blur + NMS + stores ({v[5]} blocks): " + " / ".join(f"{x / v[5]:.0f}" for x in v[:5]))


def probe_k2(libs):
    print("K2 stereo 0.5, cycles: per evaluation edge loop / sum; per LM iteration solve / exp; whole launch")
    for n in (32, 1000, 2000):
        t0, pts, obs, mask, _ = cs.make_pose_problem(np.random.default_rng(0), n, 0.5)
        args = [torch.from_numpy(a).to(DEV) for a in (t0, pts, obs, mask, np.ones(n, np.float32))]
        for label, lib in libs.items():
            outs = (torch.empty(16, device=DEV), torch.empty(n, dtype=torch.bool, device=DEV),
                    torch.empty(3, dtype=torch.int32, device=DEV), torch.empty((), device=DEV))
            v = run(lib, lambda: lib.pose_opt(
                *(a.data_ptr() for a in args), n, cs.FX, cs.FY, cs.CX, cs.CY, cs.BF, 4, 10,
                *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream))
            _, evals, edges = outs[2].tolist()
            iters = max(1, evals - 4)
            print(f"  N={n} {label} ({evals} evaluations, {edges} edge evaluations): "
                  f"{v[0] / evals:.0f} / {v[1] / evals:.0f}; {v[2] / iters:.0f} / {v[3] / iters:.0f}; {v[4]}")


def probe_pyramid(lib):
    seq = BoxSequence(camera=default_camera(), seed=5, n_frames=100, turns=0.35)
    img = torch.from_numpy(seq.render(0)).to(DEV)
    table = ORBExtractor()._pyramid(img)[1]
    saved = kernels._lib
    kernels._lib = lib  # the wrapper plans with the probed library's geometry
    try:
        print("pyramid 640x480, mean cycles per block (its first box): first sum / barriers + second sum + gain / "
              "waiting for the box / spans / vertical phase + level 0 / horizontal phase; whole block")
        for target in (ORBExtractor().exposure_target_mad, None):
            v = run(lib, lambda: (pyr.pyramid_resize(img, table, target), 0)[1])
            print(f"  gain {'on' if target else 'off'} ({v[7]} blocks): "
                  + " / ".join(f"{x / v[7]:.0f}" for x in v[:6]) + f"; {v[6] / v[7]:.0f}")
    finally:
        kernels._lib = saved


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    with ThreadPoolExecutor() as pool:
        k1 = pool.submit(build, "frontend.cu", K1_MARKS, "k1")
        k2 = pool.submit(build, "poseopt.cu", K2_MARKS, "k2")
        k2_one = pool.submit(build, "poseopt.cu", K2_MARKS, "k2_one_block", ["-DK2_CLUSTER=1"])
        pyramid = pool.submit(build, "pyramid.cu", PYR_MARKS, "pyramid")
        k1, k2, k2_one, pyramid = k1.result(), k2.result(), k2_one.result(), pyramid.result()
    probe_k1(k1)
    probe_k2({"as shipped": k2, "one block": k2_one})
    probe_pyramid(pyramid)


if __name__ == "__main__":
    main()
