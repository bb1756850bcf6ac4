#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from orbslam2commentedbyxcm_tpu_torch/csrc,
checks each against its plain torch twin on the card, and drives the port the
way a user would: the per-frame tracking step, then the System's synchronous
RGB-D, stereo and monocular SLAM, relocalization with the shipped vocabulary,
localization mode, loop closing with map save and load, the async pipeline,
the figure-eight loop gate, the three dataset formats read from disk and the
sharded global solvers, in the System and across two processes.
Phases, each printing one line:

  1. device   the card's name and power limit (nvidia-smi), TF32 flags
  2. build    nvcc build of both kernels (one nvcc per source, in parallel), seconds;
              g++ build of the PNG decoder's row filters
  3. K1       one launch of the fused frontend over the 8-level pyramid of a
              640x480 frame vs the twin, level by level (bit-equal), and each
              level alone; device time (torch.profiler), call time (CUDA
              events) of one pyramid launch and of 8 single-level launches,
              twin time, bound; then the same pyramid check and times at
              phase 15's 752x480 and 1241x376
  4. K2       pose-optimization kernel vs twin at N=1000, 1200 and 2000 (the
              edge counts of phases 6-15), stereo 0 / 0.5 / 1; device and
              call time at N=1000, 1200 and 2000, the latency floor
              (device time at N=32), twin time, bound from the kernel's own
              count of the evaluations it ran on this input
  5. flagship entry.flagship(device="cuda"): kernels vs twins, compared
  6. tracking BoxSequence at 640x480: frames 1-10 tracked by fused_track_step
              against a 4096-point pack built from frame 0's depth; launch
              counters (one K1 per extraction), pose error, per-frame time
  7. rgbd     System(Sensor.RGBD, device="cuda") on 60 frames of the same
              sequence: tracked frames, keyframes, local BAs, ATE against
              the JAX package's, per-frame times, launches, peak memory
  8. stereo   System(Sensor.STEREO) on 30 rounded stereo pairs: the same
              checks, 2 K1 launches per frame (left + right extraction)
  9. mono     System(Sensor.MONOCULAR) on 60 frames of SyntheticSequence
              ("sideways"): initialization frame, tracked frames, Sim3 ATE
              against the JAX package's, per-frame times, launches per frame
 10. reloc    System(Sensor.RGBD, vocabulary="bootstrap") maps frames 0-39 of
              BoxSequence seed 5, loses track on a textureless frame and
              relocalizes on revisited frames 15-19: pose error, the
              relocalization frame's time split, vocabulary load / upload
 11. loc      localization mode on frames 20-29 of the same System, then the
              visual-odometry fallback: frozen map, tracked frames, launches
 12. loop     System(Sensor.RGBD) with loop closing on and vocabulary=None
              until its lazy trainer has trained a vocabulary on the card
              (the tree bit-equal to one trained on the CPU), then with
              vocabulary="bootstrap" over a 130-frame BoxSequence orbit of
              1.3 turns: the loop is detected, its Sim3 computed, the map
              corrected, the essential graph optimized and global BA run on
              its thread; closures adjudicated against ground truth, ATE
              against the JAX package's and against the same frames with
              loop closing off, the drift at the loop edge cut; the loop
              keyframe's time split; then save_map, load_map into a fresh
              System and one revisited frame relocalized
 13. async    phase 12's orbit through System(async_mapping=True, tracer=Tracer()):
              mapping and loop closing on worker threads; 130/130 tracked, a
              loop closed with no false closure, ATE within phase 12's bound,
              shutdown() raising nothing and joining both workers; frame
              times (ordinary, keyframe, the loop keyframe's) beside phase
              12's synchronous ones, ordinary frames split by whether a worker
              was busy, the queue cap's deferrals, aborted local BAs, the
              loop worker's split, the first and later calls of the loop
              solvers on each thread, the tracer's table
 14. eight    the gauntlet's figure-eight (utils/gauntlet.run_sequence, 420
              frames at 400x300, 900 features, exposure drift and a moving
              occluder), synchronous then async, each held to the JAX
              mini-gauntlet's gates: tracked >= frames - 5, a loop closed, no
              false and no missed closure, drift under 0.8%
 15. datasets the three dataset formats from disk (DATASET_FIXTURES: TUM
              RGB-D at TUM1.yaml's 640x480, KITTI stereo at KITTI00-02.yaml's
              1241x376, raw distorted EuRoC stereo at EuRoC.yaml's 752x480),
              each written by the port's writer and run through
              cli.run_dataset.main(--device cuda --trace) as a user would:
              tracked frames, ATE against the JAX CLI's on the same fixture,
              the trajectory file, rectification, kernel launches, frame
              times from the tracer, host decode (+ rectify) ms per frame,
              wall fps, peak memory; then utils/vocab_tools trains a
              vocabulary from 20 KITTI images on the card and quantizes one
              frame with it; cv2 and PIL never loaded
 16. mesh     System(mesh=make_mesh(8)) over phase 12's orbit with the
              essential graph's gate at 0 vertices (global BA's at its
              default 2048 points): 130/130 tracked, a loop closed, no false
              closure, both sharded paths taken, ATE against the JAX
              package's mesh run; then, on the mesh run's global-BA problem
              and essential graph, the sharded solvers (dense and CG BA, the
              pose graph) at 1, 4 and 8 shards against the single-device
              ones, a 4-shard repeat bit-equal; 2 processes x 4 shards (gloo,
              both on this card, torchrun variables) against 1 x 8, ms per
              solve, psums and bytes; gn and dogleg against lm (K2) at N=1000
 17. kernels  one JSON line: per kernel, launches summed over phases 6-16,
              error, times, bound

The last line is {"ok": true, "device": {...}}. Any failed phase exits non-zero
without that line. Without a CUDA device it exits 2 and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_TRACK = 10
N_RGBD, N_STEREO, N_MONO = 60, 30, 60
# ATE of the JAX package on the CPU over the same runs
# (tools/jax_reference_ate.py): SE3
# alignment for RGB-D and stereo, Sim3 for mono; the port's bound is 1.5 x
# that + 1 cm
JAX_ATE_RGBD, JAX_ATE_STEREO, JAX_ATE_MONO = 0.0298, 0.0408, 0.0137
N_RELOC_MAP, REVISIT = 40, 15   # relocalization: frames mapped, first revisited frame
RELOC_MAX_POS_M, RELOC_MAX_ROT_DEG = 0.05, 2.0
# loop closing: the fewest orbit frames at which the JAX package closes the
# loop on the CPU, its ATE there (frame trajectory after global BA with each
# keyframe frame at its keyframe, as the port records it; SE3 alignment;
# tools/jax_reference_ate.py loop), and the frame relocalized against the
# reloaded map
N_LOOP, JAX_ATE_LOOP, LOOP_RELOC_FRAME = 130, 0.0205, 2
# a correction that did little fails these: the ATE must be at most
# LOOP_ATE_CUT x the loop-off ATE of frames 0 to the loop frame, and the loop
# edge's drift (the error of the relative pose between the two frames it
# joins) at most LOOP_DRIFT_CUT x the same frames' drift with loop closing off
LOOP_ATE_CUT, LOOP_DRIFT_CUT = 0.9, 0.5
# phase 16: the JAX package's ATE on the CPU over phase 12's run with
# System(mesh=make_mesh(8)) on 8 virtual devices and the essential graph's
# gate at 0 vertices (tools/jax_reference_ate.py mesh; keyframe frames at
# their keyframe, SE3); the port's bound is 1.5 x that + 1 cm
JAX_ATE_MESH = 0.0186
MESH_SHARDS = (1, 4, 8)     # one-process meshes the solvers are held to the single-device ones at
MESH_RANKS, MESH_RANK_SHARDS = 2, 4   # the cross-process run: 2 ranks (gloo, one card) x 4 shards
MESH_POSE_TOL = 5e-3        # tests/test_dist_ba.py: pose error (norm of the se3 log) of a sharded solve
# CG steps per LM iteration when the sharded CG solve is held to the dense
# optimum: global BA's 25 (the JAX package's system_bridge) stop short of it
# (this phase's 42-pose problem on an H100: poses 0.028 off at a cost 0.02%
# higher; a 320x240 CPU rehearsal's 50 poses: 0.4 off at 0.9%); 200 reach it
MESH_PARITY_CG = 200
MESH_GRAPH_TOL = 2e-3       # tests/test_dist_posegraph.py: assert_allclose on the Sim3 poses
ALGORITHM_TOL = 2e-3        # tests/test_optim.py: gn / dogleg pose error against lm
# phase 15: each dataset format's fixture, written to disk by the port's
# writer from a utils/synth BoxSequence seen through the published settings
# file's camera and feature count; the distortion terms are zeroed (the
# renderer is pinhole: TUM1's k1..k3 are left out, and EuRoC's distortion is
# the writer's raw rig). TUM and EuRoC fly a 6 m box (half_size 3) so that
# their walls fall inside ThDepth x baseline (3.1 m / 3.9 m), as a desk or
# room sequence's do; KITTI drives the default 16 m box's "line".
N_DATASET = 60
DATASET_FIXTURES = {
    # format: (examples/settings file, BoxSequence arguments)
    "tum": ("TUM1.yaml", {"seed": 11, "trajectory": "orbit", "turns": 0.25, "half_size": 3.0, "radius": 1.0}),
    "kitti": ("KITTI00-02.yaml", {"seed": 12, "trajectory": "line"}),
    "euroc": ("EuRoC.yaml", {"seed": 13, "trajectory": "orbit", "turns": 0.3, "half_size": 3.0, "radius": 1.0}),
}
DATASET_FLAGS = ["--no-loop-closing"]
# the JAX CLI's ATE on the CPU over the same fixture written by the JAX writer
# (tools/jax_reference_ate.py dataset), in metres; each port bound is 1.5 x
# that + 1 cm
JAX_ATE_DATASET = {"tum": 0.0241, "kitti": 0.0132, "euroc": 0.0177}
N_VOCAB_IMAGES = 20  # KITTI left images the vocabulary is trained on


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls between two CUDA events,
    after one warm-up: the call time the main path pays, host work included
    when the host enqueues more slowly than the device runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Idle seconds inside each profiling window before the first launch and after
# the last. torch.profiler keeps a kernel only if its device timestamp, put on
# the host's clock, falls inside the window, and that conversion can run up to
# a few ms early: on an H100 with torch 2.11 (CUDA 12.8), about one session in
# a hundred without a margin lost its first kernels (1 to all 50 of 50), the
# kept ones stamped before the calls that launched them; with the margin none
# did (tools/profiler_margin.py).
PROFILE_MARGIN_S = 0.02


def _device_ms(fn, reps: int, kernel: str, per_call: int | None = None) -> tuple[float, int]:
    """(device milliseconds per fn() call, kernel launches seen) of the kernels
    whose name contains `kernel`, summed by torch.profiler over `reps` calls
    after one warm-up. With `per_call`, the profiler must have seen exactly
    `per_call` such launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    events = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in events)
    us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    _check(n > 0 and us > 0, f"torch.profiler recorded no device time for {kernel}")
    _check(per_call is None or n == per_call * reps,
           f"torch.profiler saw {n} {kernel} launches for {reps} calls of {per_call}")
    return us / 1e3 / reps, n


# H100 SXM peaks (NVIDIA's data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what sets it)."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


# K1 operations per pixel, counted from csrc/frontend.cu: the two blur
# passes (18 multiplies + 18 adds), the compass test (4 differences, 8
# compares), two threshold compares and the two 3x3 NMS (16 max, 4 compares);
# a pixel that passes the compass test adds 12 differences and the doubling
# (4 x 16 min, 4 x 16 max, 2 x 15 reductions, 1 negation).
K1_OPS_PER_PX, K1_OPS_FAST = 70, 12 + 128 + 31


def k1_ops(levels, th: float) -> int:
    """Operations K1 does on these level images: the compass test decides,
    per interior pixel, whether the full FAST response is computed."""
    ops = 0
    for lv in levels:
        c = lv[3:-3, 3:-3]
        q = (lv[:-6, 3:-3] - c, lv[3:-3, 6:] - c, lv[6:, 3:-3] - c, lv[3:-3, :-6] - c)
        nb = sum((x > th).int() for x in q)
        nd = sum((-x > th).int() for x in q)
        ops += K1_OPS_PER_PX * lv.numel() + K1_OPS_FAST * int(((nb >= 2) | (nd >= 2)).sum())
    return ops


# K2 floating-point operations, counted from csrc/poseopt.cu: per active edge
# and evaluation the projection (37), Jacobian rows (33), weights and Huber
# (~8), the 21 H and 6 g sums (180) and the error; per edge of a chi2
# relabel the projection and the test (40); per LM iteration the 6x6
# Gauss-Jordan (~480) and the SE3 exp and product (~170).
K2_OPS_EDGE_EVAL, K2_OPS_PROJECTION, K2_OPS_ITERATION = 260, 40, 650


def k2_bound(work, n_mask: int, n: int, n_rounds: int = 4) -> tuple[float, str]:
    """Bound of one solve from the kernel's own count of its work (`work`:
    evaluations, edge evaluations); bytes: pose, points, observations,
    inv_sigma2 and mask read once, pose, chi2, n_inliers and the inlier
    mask written once."""
    evals, edge_evals = work
    ops = (K2_OPS_EDGE_EVAL * edge_evals + K2_OPS_PROJECTION * (n_rounds + 1) * n_mask
           + K2_OPS_ITERATION * (evals - n_rounds))
    return _bound(ops, 64 + 29 * n + 72 + n)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"matmul.allow_tf32={tf32[0]} cudnn.allow_tf32={tf32[1]} float32_matmul_precision={tf32[2]}")
    _check(not tf32[0] and tf32[2] == "highest", "float32 matmuls would run in TF32")
    return card


def phase_build():
    from orbslam2commentedbyxcm_tpu_torch import kernels

    kernels.library()
    info = kernels.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    t0 = time.perf_counter()
    kernels.host_library()  # the PNG decoder's row filters (g++), for phase 15
    print(f"[2 build] nvcc {'built' if info['built'] else 'cached'} {Path(info['path']).name} "
          f"in {info['seconds']:.3f} s; host library (g++) in {time.perf_counter() - t0:.3f} s | "
          + " ; ".join(ptxas))


def _k1_pyramid(torch, fk, ext, img, tag: str):
    """One K1 launch over the extractor's pyramid of `img` against the twin,
    level by level (bit-equal). Returns (buffer, table, levels, hi corners)."""
    th_hi, th_lo = ext.ini_th, ext.min_th
    buf, table = ext._pyramid(img)
    levels = fk.level_views(buf, table)
    out = fk.fused_frontend_pyramid(buf, table, th_hi, th_lo)
    refs = [fk.fused_frontend_plain(lv, th_hi, th_lo) for lv in levels]
    torch.cuda.synchronize()
    n_corners = 0
    for lvl, ref in enumerate(refs):
        for name, pyr, b in zip(("blur", "nms_hi", "nms_lo"), (fk.level_views(o, table)[lvl] for o in out), ref):
            _check(torch.equal(pyr, b), f"K1 pyramid {name} differs from the twin at {tag} level {lvl} "
                   f"{tuple(b.shape)}: {int((pyr != b).sum())} pixels")
        n_corners += int((ref[1] > 0).sum())
    _check(n_corners > 100, f"K1 found only {n_corners} corners at {tag}")
    return buf, table, levels, n_corners


def _k1_times(torch, fk, ext, buf, table, levels):
    """(device ms, call ms, bound ms, bound by) of one pyramid launch."""
    def pyramid():
        fk.fused_frontend_pyramid(buf, table, ext.ini_th, ext.min_th)

    call_ms = _cuda_ms(pyramid, 200)
    device_ms, _ = _device_ms(pyramid, 50, "frontend_kernel", per_call=1)
    n_px = sum(lv.numel() for lv in levels)
    return (device_ms, call_ms) + _bound(k1_ops(levels, min(ext.ini_th, ext.min_th)), 16 * n_px)


# level-0 shapes K1 is also held to its twin at in phase 3: the EuRoC and
# KITTI frames of phase 15 (KITTI's odd width makes odd and ragged levels)
K1_DATASET_SIZES = ((752, 480), (1241, 376))


def phase_k1(torch, dev):
    """Frontend kernel vs twin on the 8 pyramid levels of a 640x480 frame,
    built as the extractor builds them (one flat buffer, one launch), then at
    the dataset sizes of K1_DATASET_SIZES."""
    from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    seq = BoxSequence(camera=default_camera(), seed=5, n_frames=100, turns=0.35)
    img = torch.from_numpy(seq.render(0)).to(dev)
    ext = ORBExtractor(n_features=1000)
    th_hi, th_lo = ext.ini_th, ext.min_th
    buf, table, levels, n_corners = _k1_pyramid(torch, fk, ext, img, "640x480")
    singles = [fk.fused_frontend(lv, th_hi, th_lo) for lv in levels]
    for lvl, (one, ref) in enumerate(zip(singles, [fk.fused_frontend_plain(lv, th_hi, th_lo) for lv in levels])):
        for name, a, b in zip(("blur", "nms_hi", "nms_lo"), one, ref):
            _check(torch.equal(a, b), f"K1 single-level {name} differs from the twin at level {lvl}")

    def per_level():
        for lv in levels:
            fk.fused_frontend(lv, th_hi, th_lo)

    device_ms, call_ms, bound_ms, bound_by = _k1_times(torch, fk, ext, buf, table, levels)
    level_call_ms = _cuda_ms(per_level, 200)
    level_device_ms, _ = _device_ms(per_level, 50, "frontend_kernel", per_call=len(levels))
    plain_ms = _cuda_ms(lambda: [fk.fused_frontend_plain(lv, th_hi, th_lo) for lv in levels], 20)
    n_px = sum(lv.numel() for lv in levels)
    print(f"[3 K1] 8 levels {list(table.shapes)} ({n_px} px) "
          f"in one launch: blur and both score maps bit-equal to the twin, so is each level alone; "
          f"{n_corners} hi corners | per extraction: device {device_ms:.4f} ms (torch.profiler), call "
          f"{call_ms:.4f} ms (CUDA events); as 8 single-level launches device {level_device_ms:.4f} ms, "
          f"call {level_call_ms:.4f} ms; twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    sizes = {}
    for w, h in K1_DATASET_SIZES:
        cam = default_camera(w, h)
        big = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
        buf_s, table_s, levels_s, corners = _k1_pyramid(torch, fk, ext, torch.from_numpy(big.render(0)).to(dev),
                                                        f"{w}x{h}")
        d_ms, c_ms, b_ms, b_by = _k1_times(torch, fk, ext, buf_s, table_s, levels_s)
        p_ms = _cuda_ms(lambda: [fk.fused_frontend_plain(lv, th_hi, th_lo) for lv in levels_s], 20)
        sizes[f"{w}x{h}"] = {"device_ms": d_ms, "call_ms": c_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by}
        print(f"[3 K1 {w}x{h}] 8 levels {list(table_s.shapes)} ({sum(lv.numel() for lv in levels_s)} px) in one "
              f"launch: bit-equal to the twin level by level; {corners} hi corners | device {d_ms:.4f} ms, call "
              f"{c_ms:.4f} ms, twin {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"max_abs_err": 0.0, "ms": device_ms, "device_ms": device_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per_level_device_ms": level_device_ms, "per_level_call_ms": level_call_ms, "sizes": sizes}


FX = FY = 500.0
CX, CY, BF = 320.0, 240.0, 40.0


def make_pose_problem(rng, n, stereo_frac, outlier_frac=0.1):
    """The construction of tests/test_pallas_poseopt._make_problem (same numpy
    draws), with the port's se3_exp."""
    import torch

    from orbslam2commentedbyxcm_tpu_torch.utils.geometry import se3_exp

    def exp(xi):
        return se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()

    pts = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1
    ).astype(np.float32)
    t_true = exp([0.1, -0.05, 0.08, 0.02, -0.03, 0.01])
    pc = pts @ t_true[:3, :3].T + t_true[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    ur = u - BF / pc[:, 2]
    stereo = rng.random(n) < stereo_frac
    obs = np.stack(
        [u + rng.normal(0, 0.5, n), v + rng.normal(0, 0.5, n),
         np.where(stereo, ur + rng.normal(0, 0.5, n), -1.0)], -1,
    ).astype(np.float32)
    out_idx = rng.choice(n, int(n * outlier_frac), replace=False)
    obs[out_idx, :2] += rng.normal(0, 40, (len(out_idx), 2))
    mask = np.ones(n, bool)
    mask[rng.choice(n, n // 20, replace=False)] = False
    t0 = exp([0.12, -0.02, 0.05, 0.01, -0.01, 0.03])
    return t0, pts, obs, mask, t_true


# edge counts K2 is held to its twin at in phase 4: the extractor capacities
# of phases 6-14 and TUM1 (1000), EuRoC (1200) and KITTI (2000, whose edges
# take the opt-in shared-memory limit) in phase 15
K2_PARITY_SIZES = (1000, 1200, 2000)


def phase_k2(torch, dev):
    """Pose kernel vs twin on the card at N in K2_PARITY_SIZES edges, stereo
    0 / 0.5 / 1; times at N=1000, 1200 and 2000 and the latency floor at
    N=32."""
    from orbslam2commentedbyxcm_tpu_torch.ops.optim import pose_optimization, pose_optimization_plain
    from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused

    cam = (FX, FY, CX, CY, BF)

    def problem(n, frac):
        t0, pts, obs, mask, t_true = make_pose_problem(np.random.default_rng(0), n, frac)
        return [torch.from_numpy(a).to(dev) for a in (t0, pts, obs, mask, np.ones(n, np.float32))], t_true

    n = 1000
    worst = {}
    for size in K2_PARITY_SIZES:
        w = worst[size] = {"pose": 0.0, "flips": 0, "dn": 0}
        for frac in (0.0, 0.5, 1.0):
            tag = f"N={size}, stereo {frac}"
            args, t_true = problem(size, frac)
            rk = pose_optimization(*args, *cam)
            rp = pose_optimization_plain(*args, *cam)
            tk, tp = rk.t_cw.cpu().numpy(), rp.t_cw.cpu().numpy()
            _check(np.abs(tk - t_true).max() < 5e-3, f"K2 pose off truth by {np.abs(tk - t_true).max()} ({tag})")
            _check(np.abs(tp - t_true).max() < 5e-3, f"twin pose off truth by {np.abs(tp - t_true).max()} ({tag})")
            d_pose = float(np.abs(tk - tp).max())
            flips = int((rk.inliers != rp.inliers).sum())
            dn = abs(int(rk.n_inliers) - int(rp.n_inliers))
            _check(d_pose < 2e-3, f"K2 vs twin pose {d_pose} ({tag})")
            _check(flips <= max(3, size // 100), f"K2 vs twin {flips} inlier flips ({tag})")
            _check(dn <= 3, f"K2 vs twin n_inliers differ by {dn} ({tag})")
            _check(int(rk.n_inliers) == int(rk.inliers.sum()), f"K2 n_inliers disagrees with its mask ({tag})")
            for key, val in (("pose", d_pose), ("flips", flips), ("dn", dn)):
                w[key] = max(w[key], val)
    times = {}
    for size in (*K2_PARITY_SIZES, 32):
        args, _ = problem(size, 0.5)
        pose_optimization(*args, *cam)
        work = pose_optimization_fused.last_counts.tolist()[1:]
        times[size] = {
            "call_ms": _cuda_ms(lambda: pose_optimization(*args, *cam), 200),
            "device_ms": _device_ms(lambda: pose_optimization(*args, *cam), 50, "pose_opt_kernel", per_call=1)[0],
            "bound": k2_bound(work, int(args[3].sum()), size), "evaluations": work[0],
        }
        if size == n:
            plain_ms = _cuda_ms(lambda: pose_optimization_plain(*args, *cam), 5)
    t = times[n]
    print("[4 K2] vs twin at stereo 0/0.5/1: " + "; ".join(
        f"N={k} max|pose d|={w['pose']:.3g}, inlier flips <= {w['flips']}, |d n_inliers| <= {w['dn']}"
        for k, w in worst.items()) + " | stereo 0.5, per solve: " + "; ".join(
              f"N={k} device {v['device_ms']:.4f} ms (torch.profiler), call {v['call_ms']:.4f} ms (CUDA events), "
              f"{v['evaluations']} evaluations, bound {v['bound'][0]:.6f} ms ({v['bound'][1]})"
              for k, v in times.items()) + f"; twin {plain_ms:.4f} ms (N={n})")
    return {"max_abs_err": max(w["pose"] for w in worst.values()), "ms": t["device_ms"], "device_ms": t["device_ms"],
            "call_ms": t["call_ms"], "plain_ms": plain_ms, "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None,
            "n1200_device_ms": times[1200]["device_ms"], "n1200_call_ms": times[1200]["call_ms"],
            "n2000_device_ms": times[2000]["device_ms"], "n2000_call_ms": times[2000]["call_ms"],
            "n32_device_ms": times[32]["device_ms"]}


def phase_flagship(torch, dev):
    from orbslam2commentedbyxcm_tpu_torch import entry

    # torch.argmin must return the first minimum on the card (project_and_match relies on it)
    ties = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 0.0], [2.0, 0.0]], device=dev)
    _check(torch.argmin(ties, dim=0).tolist() == [1, 2], "torch.argmin is not first-occurrence on CUDA")
    step, args = entry.flagship(device=dev)
    t_k, n_k = step(*args)
    # the twins run where the tensors are on the CPU
    step_p, args_p = entry.flagship(device="cpu")
    t_p, n_p = step_p(*args_p)
    d_pose = float((t_k.cpu() - t_p).abs().max())
    n_k, n_p = int(n_k), int(n_p)
    _check(bool(torch.isfinite(t_k).all()) and t_k.shape == (4, 4), "flagship pose not finite (4, 4)")
    _check(d_pose <= 2e-3, f"flagship kernels vs twins pose differs by {d_pose}")
    _check(abs(n_k - n_p) <= max(3, n_p // 100), f"flagship n_inliers {n_k} vs {n_p}")
    print(f"[5 flagship] 640x480 / 1000 features / 2048 points: kernels (card) vs twins (CPU) T_cw max|d|={d_pose:.3g}, "
          f"n_inliers {n_k} vs {n_p}; argmin first-occurrence on CUDA ok")


def track_sequence(torch, dev, n_frames, timer):
    """Track frames 1..n_frames of BoxSequence(seed=5) with fused_track_step
    against a pack from frame 0's depth; each frame's estimated pose is the
    next frame's motion prior, as bench.py chains frames.
    Returns (seq, [(i, T_cw numpy, n_inliers, per-frame ms)])."""
    from orbslam2commentedbyxcm_tpu_torch.models.frame import rgbd_observations
    from orbslam2commentedbyxcm_tpu_torch.models.map import map_pack_from_rgbd_frame
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import LOCAL_POINT_CAP, TrackingConfig, fused_track_step
    from orbslam2commentedbyxcm_tpu_torch.ops import matching
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    cfg = TrackingConfig()
    ext = ORBExtractor(n_features=cfg.n_features)
    feats0 = ext(torch.from_numpy(seq.render(0)).to(dev))
    _, _, depth0 = rgbd_observations(feats0, torch.from_numpy(seq.depth_map(0)).to(dev), cam)
    t0 = torch.from_numpy(seq.pose(0)).to(dev)
    *pack, angle = map_pack_from_rgbd_frame(feats0, depth0, t0, cam, LOCAL_POINT_CAP)
    frames = [(torch.from_numpy(seq.render(i)), torch.from_numpy(seq.depth_map(i)))
              for i in range(1, n_frames + 1)]
    t_last = t0
    out = []
    for i, (img_h, depth_h) in enumerate(frames, start=1):
        timer.start()
        img, depth = img_h.to(dev), depth_h.to(dev)
        feats = ext(img)
        obs, isig, _ = rgbd_observations(feats, depth, cam)
        res = fused_track_step(
            *pack, angle, *pack,
            t_last, feats.uv, feats.desc, feats.level, feats.valid, feats.angle,
            obs, isig,
            cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height), cam.bf,
            cfg.motion_search_radius, cfg.localmap_search_radius, float(matching.TH_HIGH),
            math.log(cfg.scale_factor), cfg.n_levels,
        )
        t_last = t_cw = res[8]
        ms = timer.stop()
        out.append((i, t_cw.cpu().numpy(), int(res[10]), ms))
    return seq, out


class _EventTimer:
    def __init__(self, torch):
        self.torch = torch

    def start(self):
        self.a = self.torch.cuda.Event(enable_timing=True)
        self.b = self.torch.cuda.Event(enable_timing=True)
        self.a.record()

    def stop(self):
        self.b.record()
        self.b.synchronize()
        return self.a.elapsed_time(self.b)


def pose_errors(t_est, t_gt):
    """(translation error of the camera center in m, rotation error in deg)."""
    t_est, t_gt = np.asarray(t_est, np.float64), np.asarray(t_gt, np.float64)
    c_est = -t_est[:3, :3].T @ t_est[:3, 3]
    c_gt = -t_gt[:3, :3].T @ t_gt[:3, 3]
    r = t_est[:3, :3] @ t_gt[:3, :3].T
    ang = math.degrees(math.acos(max(-1.0, min(1.0, (np.trace(r) - 1.0) / 2.0))))
    return float(np.linalg.norm(c_est - c_gt)), ang


MAX_POS_ERR_M = 0.08      # 8 cm, against walls 6-10 m away (the JAX package tracks this run within 3.5 cm)
MAX_ROT_ERR_DEG = 0.6


def phase_tracking(torch, dev, k1, k2):
    from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend, fused_frontend_pyramid
    from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused

    fused_frontend_pyramid.launches = fused_frontend.launches = 0
    pose_optimization_fused.launches = 0
    seq, out = track_sequence(torch, dev, N_TRACK, timer=_EventTimer(torch))
    launches = {"fused_frontend": fused_frontend_pyramid.launches,
                "pose_optimization_fused": pose_optimization_fused.launches}
    # frame 0 (the map pack) and frames 1..N are each extracted once
    _check(launches["fused_frontend"] == N_TRACK + 1 and fused_frontend.launches == 0,
           f"K1 launched {launches['fused_frontend']} times (+{fused_frontend.launches} single-level) for "
           f"{N_TRACK + 1} extractions (want 1 per extraction)")
    _check(launches["pose_optimization_fused"] == 2 * N_TRACK,
           f"K2 launched {launches['pose_optimization_fused']} times for {N_TRACK} frames (want 2 per frame)")
    worst_pos = worst_rot = 0.0
    min_inl = min(n for _, _, n, _ in out)
    for i, t_cw, n_inl, _ in out:
        _check(np.isfinite(t_cw).all(), f"frame {i}: pose not finite")
        pos, rot = pose_errors(t_cw, seq.pose(i))
        worst_pos, worst_rot = max(worst_pos, pos), max(worst_rot, rot)
        _check(n_inl >= 30, f"frame {i}: {n_inl} inliers < 30 (min_localmap_inliers)")
        _check(pos <= MAX_POS_ERR_M and rot <= MAX_ROT_ERR_DEG,
               f"frame {i}: pose error {pos:.4f} m / {rot:.4f} deg over {MAX_POS_ERR_M} m / {MAX_ROT_ERR_DEG} deg")
    ms = [m for _, _, _, m in out]
    print(f"[6 tracking] BoxSequence 640x480, 1000 features, 4096-point pack, frames 1-{N_TRACK}: "
          f"n_inliers min {min_inl}, worst pose error {worst_pos:.4f} m / {worst_rot:.4f} deg "
          f"(bound {MAX_POS_ERR_M} m / {MAX_ROT_ERR_DEG} deg) | per-frame ms median {statistics.median(ms):.3f} "
          f"(min {min(ms):.3f}, max {max(ms):.3f}; extraction + obs + fused_track_step, CUDA events) | "
          f"launches {launches} | K1 (8 levels) device {k1['device_ms']:.4f} ms, call {k1['call_ms']:.4f} ms vs "
          f"twin {k1['plain_ms']:.4f} ms; K2 device {k2['device_ms']:.4f} ms, call {k2['call_ms']:.4f} ms vs "
          f"twin {k2['plain_ms']:.4f} ms")
    return launches


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


def phase_slam(torch, dev, sensor_name, n_frames, jax_ate, tag):
    """Drive System(sensor, device=dev) over BoxSequence seed 5 at 640x480,
    every frame's images rendered beforehand and handed over as numpy arrays,
    as a user would. Returns the kernel launches of the run."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend_pyramid
    from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    sensor = Sensor[sensor_name]
    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    if sensor == Sensor.RGBD:
        frames = [(seq.render(i), seq.depth_map(i)) for i in range(n_frames)]
    else:
        frames = [(np.round(seq.render(i)), np.round(seq.render_right(i))) for i in range(n_frames)]
    slam = System(cam, sensor, config=TrackingConfig(max_frames_between_kf=8, kf_tracked_ratio=0.95),
                  enable_loop_closing=False, device=dev)
    track = slam.track_rgbd if sensor == Sensor.RGBD else slam.track_stereo
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_frontend_pyramid.launches = 0
    pose_optimization_fused.launches = 0
    rows = []  # (i, pose, ms, keyframe inserted, K1 launches, K2 launches)
    for i, (a, b) in enumerate(frames):
        kf_before, k1, k2 = slam.map.next_kf_id, fused_frontend_pyramid.launches, pose_optimization_fused.launches
        timer.start()
        pose = track(a, b, i / 30.0)
        ms = timer.stop()
        rows.append((i, pose, ms, slam.map.next_kf_id > kf_before,
                     fused_frontend_pyramid.launches - k1, pose_optimization_fused.launches - k2))
    launches = {"fused_frontend": fused_frontend_pyramid.launches,
                "pose_optimization_fused": pose_optimization_fused.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    tracked = [(i, p) for i, p, *_ in rows if p is not None]
    _check(len(tracked) == n_frames, f"{sensor_name}: {len(tracked)} of {n_frames} frames tracked")
    _check(not slam._archived_kf_trajectory, f"{sensor_name}: tracking was lost and the System reset")
    for i, p in tracked:
        _check(p.shape == (4, 4) and np.isfinite(p).all(), f"{sensor_name} frame {i}: pose not finite (4, 4)")
    n_kf = slam.map.next_kf_id
    n_good = len(slam.map.good_keyframes())
    n_ba = slam.local_mapping.n_local_ba
    est = positions_from_tcw(np.stack([p for _, p in tracked]))
    gt = positions_from_tcw(np.stack([seq.pose(i) for i, _ in tracked]))
    ate = ate_rmse(est, gt, with_scale=False)
    bound = 1.5 * jax_ate + 0.01
    min_kf = 6 if sensor == Sensor.RGBD else 3
    _check(n_kf >= min_kf, f"{sensor_name}: {n_kf} keyframes inserted, want >= {min_kf}")
    if sensor == Sensor.RGBD:
        _check(n_ba >= 4, f"{sensor_name}: local BA ran {n_ba} times, want >= 4")
    _check(ate <= bound, f"{sensor_name}: ATE {ate:.4f} m over {bound:.4f} m (1.5 x JAX {jax_ate} m + 1 cm)")
    k1_per = {r[4] for r in rows}
    _check(k1_per == {1 if sensor == Sensor.RGBD else 2},
           f"{sensor_name}: K1 launches per frame {sorted(k1_per)}")
    k2_per = [r[5] for r in rows[1:]]
    _check(min(k2_per) >= 2, f"{sensor_name}: K2 launched {min(k2_per)} times on a tracked frame (want >= 2)")

    def stats(ms):
        return (f"median {statistics.median(ms):.3f} p90 {_percentile(ms, 0.9):.3f} "
                f"max {max(ms):.3f}" if ms else "none")

    kf_ms = [r[2] for r in rows[1:] if r[3]]
    plain_ms = [r[2] for r in rows[1:] if not r[3]]
    print(f"[{tag} {sensor_name.lower()}] System({sensor_name}, device={dev}), BoxSequence seed 5, 640x480, "
          f"1000 features, {n_frames} frames: {len(tracked)}/{n_frames} tracked, {n_kf} keyframes inserted "
          f"({n_good} kept), {slam.map.n_valid_points()} map points, {n_ba} local BAs | ATE {ate:.4f} m "
          f"(bound {bound:.4f} m = 1.5 x JAX CPU {jax_ate} m + 1 cm) | per-frame ms (CUDA events, frames 1-"
          f"{n_frames - 1}): ordinary frames ({len(plain_ms)}) {stats(plain_ms)}; keyframe frames "
          f"({len(kf_ms)}, tracking + synchronous local mapping + local BA) {stats(kf_ms)}; frame 0 "
          f"{rows[0][2]:.3f} | launches per frame: K1 {sorted(k1_per)}, K2 mean "
          f"{statistics.mean(k2_per):.2f} (min {min(k2_per)}, max {max(k2_per)}) | peak device memory "
          f"{peak_mib:.1f} MiB (torch.cuda.max_memory_allocated)")
    return launches


def _launch_counters():
    from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend_pyramid
    from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused

    return fused_frontend_pyramid, pose_optimization_fused


def _stats(ms):
    return (f"median {statistics.median(ms):.3f} p90 {_percentile(ms, 0.9):.3f} max {max(ms):.3f}"
            if ms else "none")


def _track_timed(track, rows, args, timer):
    """One System call timed with CUDA events, appended to `rows` as (pose,
    ms, K1 launches, K2 launches); returns the pose."""
    k1c, k2c = _launch_counters()
    k1, k2 = k1c.launches, k2c.launches
    timer.start()
    pose = track(*args)
    ms = timer.stop()
    rows.append((pose, ms, k1c.launches - k1, k2c.launches - k2))
    return pose


def phase_mono(torch, dev):
    """System(Sensor.MONOCULAR) over 60 frames of SyntheticSequence
    ("sideways") at 640x480: the two-view initialization (double extraction
    budget), then tracking and mapping. Returns the kernel launches."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import SyntheticSequence, default_camera

    cam = default_camera(640, 480)
    seq = SyntheticSequence(camera=cam, n_frames=N_MONO, trajectory="sideways")
    frames = [seq.render(i) for i in range(N_MONO)]
    slam = System(cam, Sensor.MONOCULAR, config=TrackingConfig(max_frames_between_kf=8, kf_tracked_ratio=0.95),
                  enable_loop_closing=False, device=dev)
    k1c, k2c = _launch_counters()
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    k1c.launches = k2c.launches = 0
    rows, kf_new = [], []
    for i, img in enumerate(frames):
        kf_before = slam.map.next_kf_id
        _track_timed(slam.track_monocular, rows, (img, i / 30.0), timer)
        kf_new.append(slam.map.next_kf_id > kf_before)
    launches = {"fused_frontend": k1c.launches, "pose_optimization_fused": k2c.launches}

    tracked = [i for i, r in enumerate(rows) if r[0] is not None]
    _check(bool(tracked), "mono: never initialized")
    init = tracked[0]
    _check(init < 10, f"mono: initialized at frame {init}, want within 10 frames")
    _check(len(tracked) >= 50, f"mono: {len(tracked)} of {N_MONO} frames tracked, want >= 50")
    _check(not slam._archived_kf_trajectory, "mono: tracking was lost and the System reset")
    for i in tracked:
        _check(rows[i][0].shape == (4, 4) and np.isfinite(rows[i][0]).all(), f"mono frame {i}: pose not finite")
    est = positions_from_tcw(np.stack([rows[i][0] for i in tracked]))
    gt = positions_from_tcw(np.stack([seq.pose(i) for i in tracked]))
    ate = ate_rmse(est, gt, with_scale=True)
    bound = 1.5 * JAX_ATE_MONO + 0.01
    _check(ate <= bound, f"mono: Sim3 ATE {ate:.4f} m over {bound:.4f} m (1.5 x JAX {JAX_ATE_MONO} m + 1 cm)")
    _check({r[2] for r in rows} == {1}, f"mono: K1 launches per frame {sorted({r[2] for r in rows})}")
    after = [i for i in tracked if i > init]
    k2_per = [rows[i][3] for i in after]
    _check(min(k2_per) >= 2, f"mono: K2 launched {min(k2_per)} times on a tracked frame (want >= 2)")
    n_kf, n_pts = slam.map.next_kf_id, slam.map.n_valid_points()
    _check(n_kf >= 4 and n_pts >= 300, f"mono: {n_kf} keyframes, {n_pts} map points")
    kf_ms = [rows[i][1] for i in after if kf_new[i]]
    plain_ms = [rows[i][1] for i in after if not kf_new[i]]
    print(f"[9 mono] System(MONOCULAR, device={dev}), SyntheticSequence sideways, 640x480, 1000 features "
          f"(2000 while initializing), {N_MONO} frames: initialized at frame {init} "
          f"({rows[init][1]:.3f} ms: extraction + two-view + initial BA), {len(tracked)}/{N_MONO} tracked, "
          f"{n_kf} keyframes inserted ({len(slam.map.good_keyframes())} kept), {n_pts} map points | Sim3 ATE "
          f"{ate:.4f} m (bound {bound:.4f} m = 1.5 x JAX CPU {JAX_ATE_MONO} m + 1 cm) | per-frame ms (CUDA events): "
          f"before initialization {_stats([r[1] for r in rows[:init]])}; ordinary ({len(plain_ms)}) "
          f"{_stats(plain_ms)}; keyframe ({len(kf_ms)}) {_stats(kf_ms)} | launches per frame: K1 1, K2 mean "
          f"{statistics.mean(k2_per):.2f} (min {min(k2_per)}, max {max(k2_per)}) after initialization, "
          f"{rows[init][3]} at it")
    return launches


def phase_reloc(torch, dev):
    """System(RGBD, vocabulary="bootstrap") maps BoxSequence seed 5 frames
    0-39, loses track on a textureless frame, and relocalizes on frames
    15-19. Returns (launches, System, sequence) for phase 11."""
    import time as _time

    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig, TrackingState
    from orbslam2commentedbyxcm_tpu_torch.ops import bow
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    t0 = _time.perf_counter()
    voc = bow.bootstrap_vocabulary()
    load_s = _time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = _time.perf_counter()
    voc.device_tree(dev)
    torch.cuda.synchronize()
    upload_s = _time.perf_counter() - t0
    voc_mib = (torch.cuda.memory_allocated() - mem0) / 2**20
    _check(voc_mib >= voc.device_bytes() / 2**20 - 1, f"vocabulary on the card: {voc_mib:.1f} MiB")

    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(N_RELOC_MAP)]
    revisits = [(seq.render(i), seq.depth_map(i)) for i in range(REVISIT, REVISIT + 5)]
    blank = np.full((cam.height, cam.width), 128.0, np.float32)
    blank += np.random.default_rng(0).uniform(-1, 1, blank.shape).astype(np.float32)
    slam = System(cam, Sensor.RGBD, config=TrackingConfig(max_frames_between_kf=6), vocabulary=voc,
                  enable_loop_closing=False, device=dev)
    k1c, k2c = _launch_counters()
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    k1c.launches = k2c.launches = 0
    rows = []
    for i, (img, depth) in enumerate(frames):
        _track_timed(slam.track_rgbd, rows, (img, depth, i / 30.0), timer)
    _check(all(r[0] is not None for r in rows), "reloc: the mapping run lost track")
    n_kf = len(slam.map.good_keyframes())
    _check(n_kf > 5, f"reloc: {n_kf} keyframes after {N_RELOC_MAP} frames, want > 5")
    _check(len(slam.keyframe_db) >= n_kf - 1, f"reloc: {len(slam.keyframe_db)} keyframes in the database")
    lost = _track_timed(slam.track_rgbd, rows, (blank, np.zeros_like(blank), 2.0), timer)
    _check(lost is None and slam.get_tracking_state() == TrackingState.LOST,
           "reloc: the textureless frame did not lose track")
    _check(len(slam.map.good_keyframes()) == n_kf, "reloc: the System reset")
    reloc_rows = []
    for k, (img, depth) in enumerate(revisits):
        _track_timed(slam.track_rgbd, reloc_rows, (img, depth, 2.1 + 0.1 * k), timer)
        if k == 0:
            split = dict(slam.local_mapping.relocalizer.last_split)
    pose, ms, _, k2_reloc = reloc_rows[0]
    _check(pose is not None, "reloc: not relocalized on the first revisited frame")
    pos, rot = pose_errors(pose, seq.pose(REVISIT) @ np.linalg.inv(seq.pose(0)))  # map frame = camera 0
    _check(pos <= RELOC_MAX_POS_M and rot <= RELOC_MAX_ROT_DEG,
           f"reloc: pose error {pos:.4f} m / {rot:.4f} deg over {RELOC_MAX_POS_M} m / {RELOC_MAX_ROT_DEG} deg")
    _check(all(r[0] is not None for r in reloc_rows), "reloc: lost again after relocalizing")
    _check(k2_reloc >= 1, "reloc: no K2 launch in the relocalization frame")
    launches = {"fused_frontend": k1c.launches, "pose_optimization_fused": k2c.launches}
    parts = "; ".join(f"{k} {1e3 * v:.3f}" for k, v in split.items())
    map_ms = [r[1] for r in rows[1:N_RELOC_MAP]]
    print(f"[10 reloc] System(RGBD, vocabulary=bootstrap, device={dev}), BoxSequence seed 5, 640x480: mapped frames "
          f"0-{N_RELOC_MAP - 1} ({n_kf} keyframes, {len(slam.keyframe_db)} in the database; per-frame ms "
          f"{_stats(map_ms)}), lost on a textureless frame ({rows[-1][1]:.3f} ms), relocalized on frame {REVISIT} "
          f"within {pos:.4f} m / {rot:.4f} deg (bound {RELOC_MAX_POS_M} m / {RELOC_MAX_ROT_DEG} deg) in "
          f"{ms:.3f} ms (CUDA events), split (host clock, each piece ends in a host read): {parts} "
          f"(pose = projection searches + K2), K2 launches {k2_reloc}; frames {REVISIT + 1}-{REVISIT + 4} "
          f"{_stats([r[1] for r in reloc_rows[1:]])} | vocabulary {voc.n_words} words: load {1e3 * load_s:.1f} ms, "
          f"upload {1e3 * upload_s:.1f} ms, {voc_mib:.1f} MiB on the card")
    return launches, slam, seq


def phase_localization(torch, dev, slam, seq):
    """Localization mode on frames 20-29 of phase 10's System, then one frame
    with the last frame's map links cleared: the visual-odometry fallback."""
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingState

    frozen = (slam.map.next_kf_id, len(slam.map.good_keyframes()), slam.map.n_valid_points())
    slam.activate_localization_mode()
    k1c, k2c = _launch_counters()
    timer = _EventTimer(torch)
    first = REVISIT + 5
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(first, first + 11)]
    torch.cuda.synchronize()
    k1c.launches = k2c.launches = 0
    rows, errs = [], []
    for k, (img, depth) in enumerate(frames[:10]):
        pose = _track_timed(slam.track_rgbd, rows, (img, depth, 3.0 + 0.1 * k), timer)
        if pose is not None:
            errs.append(pose_errors(pose, seq.pose(first + k) @ np.linalg.inv(seq.pose(0)))[0])
    n_tracked = sum(r[0] is not None for r in rows)
    _check(n_tracked >= 8, f"loc: {n_tracked} of 10 frames tracked, want >= 8")
    _check((slam.map.next_kf_id, len(slam.map.good_keyframes()), slam.map.n_valid_points()) == frozen,
           "loc: the map changed in localization mode")
    slam.tracking.last_frame.map_pt[:] = -1  # no map anchors left: only temporal points
    img, depth = frames[10]
    vo_pose = _track_timed(slam.track_rgbd, rows, (img, depth, 4.0), timer)
    _check(vo_pose is not None and slam.tracking.vo_mode, "loc: the visual-odometry fallback did not engage")
    vo_err = pose_errors(vo_pose, seq.pose(first + 10) @ np.linalg.inv(seq.pose(0)))[0]
    _check(vo_err < 0.3, f"loc: VO pose error {vo_err:.4f} m")
    _check(slam.get_tracking_state() == TrackingState.OK, "loc: not tracking after the VO frame")
    slam.deactivate_localization_mode()
    launches = {"fused_frontend": k1c.launches, "pose_optimization_fused": k2c.launches}
    k2_per = [r[3] for r in rows[:10] if r[0] is not None]
    print(f"[11 loc] localization mode, frames {first}-{first + 9}: {n_tracked}/10 tracked, worst position error "
          f"{max(errs):.4f} m, keyframes / points unchanged ({frozen[1]} / {frozen[2]}); per-frame ms "
          f"{_stats([r[1] for r in rows[:10]])}; launches per frame K1 {sorted({r[2] for r in rows})}, K2 mean "
          f"{statistics.mean(k2_per):.2f} (min {min(k2_per)}, max {max(k2_per)}) | VO fallback on frame "
          f"{first + 10} with no map anchors: vo_mode on, position error {vo_err:.4f} m, {rows[-1][1]:.3f} ms, "
          f"K2 launches {rows[-1][3]}")
    return launches


def _loop_config():
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig

    return TrackingConfig(max_frames_between_kf=4, kf_tracked_ratio=0.95, motion_search_radius=20.0)


def _lazy_vocabulary_run(torch, dev, cam, frames, timer):
    """System(RGBD, vocabulary=None, loop closing on): tracks until the lazy
    trainer has trained a vocabulary on the card from the first keyframes,
    then trains the same descriptors on the CPU and checks the trees are bit
    for bit equal. Returns (frames tracked, rows, words, card s, CPU s)."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.ops import bow

    slam = System(cam, Sensor.RGBD, config=_loop_config(), vocabulary=None, enable_loop_closing=True, device=dev)
    rows = []
    for i, (img, depth) in enumerate(frames):
        _check(_track_timed(slam.track_rgbd, rows, (img, depth, i / 30.0), timer) is not None,
               f"lazy vocabulary: frame {i} not tracked")
        if slam.vocabulary is not None:
            break
    _check(slam.vocabulary is not None, f"lazy vocabulary: none trained in {len(frames)} frames")
    _check(slam.loop_closing is not None and slam.local_mapping.loop_closer is slam.loop_closing,
           "lazy vocabulary: loop closing not wired after training")
    # the same descriptors as System.train_vocabulary_from_map, trained again
    # on the card (timed) and on the CPU
    descs = np.concatenate([kf.desc[kf.valid] for kf in slam.map.good_keyframes()])
    trees, secs = [], []
    for where in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trees.append(bow.train_vocabulary(descs, k=8, depth=3, device=where))
        secs.append(time.perf_counter() - t0)
    for name in ("node_desc", "node_children", "node_parent", "node_level", "word_id", "word_weight", "word_node"):
        for voc in (slam.vocabulary, trees[0]):
            _check(np.array_equal(getattr(voc, name), getattr(trees[1], name)),
                   f"lazy vocabulary: {name} of the card's tree differs from the CPU's")
    slam.shutdown()
    return len(rows), rows, slam.vocabulary.n_words, secs[0], secs[1]


def _loop_run(torch, dev, cam, seq, frames, loop_closing: bool, timer):
    """System(RGBD, vocabulary="bootstrap") over `frames`; returns (System,
    rows of _track_timed, whether each frame made a keyframe, the frames on
    which a loop closed, the frames after which global BA had written back)."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System

    slam = System(cam, Sensor.RGBD, config=_loop_config(), vocabulary="bootstrap",
                  enable_loop_closing=loop_closing, device=dev)
    rows, loops, gba_frames, kf_new = [], [], [], []
    lc = slam.loop_closing
    for i, (img, depth) in enumerate(frames):
        kf_before = slam.map.next_kf_id
        n_loops, n_gba = (lc.n_loops_closed, lc.gba.n_completed) if lc else (0, 0)
        _track_timed(slam.track_rgbd, rows, (img, depth, i / 30.0), timer)
        kf_new.append(slam.map.next_kf_id > kf_before)
        if lc and lc.n_loops_closed > n_loops:
            loops.append(i)
        if lc and lc.gba.n_completed > n_gba:
            gba_frames.append(i)
    slam.shutdown()  # waits for global BA and raises what its thread raised
    if lc and lc.gba.n_completed > len(gba_frames):
        gba_frames.append(len(frames) - 1)
    return slam, rows, kf_new, loops, gba_frames


def _frame_poses(slam) -> dict:
    """{frame index: Tcw} of the frame trajectory (after global BA)."""
    return {int(round(ts * 30.0)): t for ts, t in slam.frame_trajectory()}


def _ate(poses: dict, seq, frames) -> float:
    """SE3-aligned ATE (m) of the poses at `frames`."""
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw

    frames = [f for f in frames if f in poses]
    return ate_rmse(positions_from_tcw(np.stack([poses[f] for f in frames])),
                    positions_from_tcw(np.stack([seq.pose(f) for f in frames])), with_scale=False)


def _drift(poses: dict, seq, a: int, b: int) -> tuple[float, float]:
    """(m, deg) error of the relative pose T_a T_b^-1 between frames a and b
    against ground truth: the drift a loop edge between them corrects."""
    ta, tb = (np.asarray(poses[f], np.float64) for f in (a, b))
    err = (ta @ np.linalg.inv(tb)) @ np.linalg.inv(seq.pose(a) @ np.linalg.inv(seq.pose(b)))
    ang = math.degrees(math.acos(max(-1.0, min(1.0, (float(np.trace(err[:3, :3])) - 1.0) / 2.0))))
    return float(np.linalg.norm(err[:3, 3])), ang


def phase_loop(torch, dev, card: str):
    """Loop closing on the card: a BoxSequence orbit that comes back to its
    start, driven through System with loop closing on (launches counted),
    the same frames with it off (the comparison), then save / load /
    relocalize. Returns the kernel launches."""
    import os
    import tempfile
    import time as _time

    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingState
    from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import adjudicate_loops
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, n_frames=N_LOOP, turns=1.3)
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(N_LOOP)]
    k1c, k2c = _launch_counters()
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    k1c.launches = k2c.launches = 0
    n_lazy, lazy_rows, lazy_words, lazy_card_s, lazy_cpu_s = _lazy_vocabulary_run(torch, dev, cam, frames[:40], timer)
    k1_lazy = sorted({r[2] for r in lazy_rows})
    _check(k1_lazy == [1], f"lazy vocabulary: K1 launches per frame {k1_lazy}")
    torch.cuda.reset_peak_memory_stats(dev)
    with _timed_calls(torch) as solver_calls:
        slam, rows, kf_new, loops, gba_frames = _loop_run(torch, dev, cam, seq, frames, True, timer)
    loop_frame = loops[0] if loops else None
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    launches = {"fused_frontend": k1c.launches, "pose_optimization_fused": k2c.launches}
    lc = slam.loop_closing
    _check(all(r[0] is not None for r in rows), f"loop: {sum(r[0] is None for r in rows)} frames not tracked")
    _check(not slam._archived_kf_trajectory, "loop: tracking was lost and the System reset")
    _check(lc.n_loops_closed >= 1 and loop_frame is not None, f"loop: no loop closed over {N_LOOP} frames, "
           f"stats {lc.stats}")
    adj = adjudicate_loops(slam, seq)
    _check(adj["loop_edge_hits"] + adj["false_closures"] >= 1, f"loop: no loop edge recorded ({adj})")
    _check(adj["false_closures"] == 0, f"loop: false closures by ground truth ({adj})")
    _check(lc.gba.n_completed >= 1, f"loop: global BA never completed (aborted {lc.gba.n_aborted})")
    split = lc.closure_splits[0]
    # the frames of the two keyframes the first loop edge joins (loop-edge
    # endpoints are never culled)
    edge = tuple(int(round(slam.map.keyframes[k].timestamp * 30.0)) for k in (split["kf_id"], split["loop_kf_id"]))
    poses = _frame_poses(slam)
    ate, ate_to_loop = _ate(poses, seq, range(N_LOOP)), _ate(poses, seq, range(loop_frame + 1))
    drift = _drift(poses, seq, *edge)
    _check({r[2] for r in rows} == {1}, f"loop: K1 launches per frame {sorted({r[2] for r in rows})}")
    k2_per = [r[3] for r in rows[1:]]
    _check(min(k2_per) >= 2, f"loop: K2 launched {min(k2_per)} times on a tracked frame (want >= 2)")

    # the same frames with loop closing off (not counted: a comparison run)
    k1_before, k2_before = k1c.launches, k2c.launches
    off, *_ = _loop_run(torch, dev, cam, seq, frames, False, timer)
    poses_off = _frame_poses(off)
    ate_off, ate_off_to_loop = _ate(poses_off, seq, range(N_LOOP)), _ate(poses_off, seq, range(loop_frame + 1))
    drift_off = _drift(poses_off, seq, *edge)
    del off
    k1c.launches, k2c.launches = k1_before, k2_before
    bound = 1.5 * JAX_ATE_LOOP + 0.01
    # what a failed accuracy check reports with it
    run = (f"loops closed on frames {loops}, global BA written back after frames {gba_frames}, "
           f"{len(slam.map.good_keyframes())} keyframes; ATE {ate:.4f} m (frames 0-{loop_frame} {ate_to_loop:.4f}), "
           f"loop closing off {ate_off:.4f} m (frames 0-{loop_frame} {ate_off_to_loop:.4f}); drift between frames "
           f"{edge[0]} and {edge[1]} {drift[0]:.4f} m, loop closing off {drift_off[0]:.4f} m")
    _check(ate <= bound, f"loop: ATE {ate:.4f} m over {bound:.4f} m (1.5 x JAX {JAX_ATE_LOOP} m + 1 cm) | {run}")
    _check(ate <= LOOP_ATE_CUT * ate_off_to_loop,
           f"loop: ATE {ate:.4f} m with loop closing, {ate_off_to_loop:.4f} m without over frames 0-{loop_frame} "
           f"(want <= {LOOP_ATE_CUT} x) | {run}")
    _check(drift[0] <= LOOP_DRIFT_CUT * drift_off[0],
           f"loop: drift between frames {edge[0]} and {edge[1]} {drift[0]:.4f} m with loop closing, "
           f"{drift_off[0]:.4f} m without (want <= {LOOP_DRIFT_CUT} x) | {run}")

    # save, load into a fresh System, relocalize on a revisited frame
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        t0 = _time.perf_counter()
        slam.save_map(path)
        save_s = _time.perf_counter() - t0
        size_mib = os.path.getsize(path) / 2**20
        fresh = System(cam, Sensor.RGBD, config=_loop_config(), enable_loop_closing=False, device=dev)
        t0 = _time.perf_counter()
        fresh.load_map(path)
        torch.cuda.synchronize()
        load_s = _time.perf_counter() - t0
    _check(fresh.get_tracking_state() == TrackingState.LOST, "loop: a loaded System is not LOST")
    _check(len(fresh.map.good_keyframes()) == len(slam.map.good_keyframes())
           and fresh.map.n_valid_points() == slam.map.n_valid_points(), "loop: the reloaded map differs")
    fresh.activate_localization_mode()
    reloc_rows = []
    img, depth = frames[LOOP_RELOC_FRAME]
    pose = _track_timed(fresh.track_rgbd, reloc_rows, (img, depth, 100.0), timer)
    _check(pose is not None, f"loop: frame {LOOP_RELOC_FRAME} not relocalized against the reloaded map")
    pos, rot = pose_errors(pose, seq.pose(LOOP_RELOC_FRAME) @ np.linalg.inv(seq.pose(0)))
    _check(pos <= RELOC_MAX_POS_M and rot <= RELOC_MAX_ROT_DEG,
           f"loop: relocalized pose error {pos:.4f} m / {rot:.4f} deg over {RELOC_MAX_POS_M} m / {RELOC_MAX_ROT_DEG} deg")
    launches["fused_frontend"] += reloc_rows[0][2]
    launches["pose_optimization_fused"] += reloc_rows[0][3]

    parts = ["bow_transform", "detect", "bow_match", "ransac", "grow_refine", "guided", "correction",
             "essential_graph", "gba_launch"]
    g = lc.gba.last_stats
    kf_ms = [rows[i][1] for i in range(1, N_LOOP) if kf_new[i] and i != loop_frame]
    plain_ms = [rows[i][1] for i in range(1, N_LOOP) if not kf_new[i]]
    print(f"[12 loop] {card} | System(RGBD, vocabulary=None, loop closing, device={dev}): the lazy trainer's "
          f"{lazy_words}-word tree after {n_lazy} frames, bit-equal to the CPU's (train_vocabulary on the card "
          f"{1e3 * lazy_card_s:.1f} ms, CPU {1e3 * lazy_cpu_s:.1f} ms) | "
          f"System(RGBD, vocabulary=bootstrap, loop closing, device={dev}), BoxSequence orbit "
          f"1.3 turns, 640x480, 1000 features, {N_LOOP} frames: {lc.n_loops_closed} loop(s) closed, on frames "
          f"{loops} (the first keyframe {split['kf_id']} to keyframe {split['loop_kf_id']}), global BA written back "
          f"after frames {gba_frames}, ground truth: {adj}; "
          f"{len(slam.map.good_keyframes())} keyframes, {slam.map.n_valid_points()} points, stats {lc.stats} | "
          f"ATE {ate:.4f} m (bound {bound:.4f} m = 1.5 x JAX CPU {JAX_ATE_LOOP} m + 1 cm; frames 0-{loop_frame}: "
          f"{ate_to_loop:.4f} m); loop closing off, same frames: {ate_off:.4f} m (frames 0-{loop_frame}: "
          f"{ate_off_to_loop:.4f} m, bound {LOOP_ATE_CUT} x) | drift between frames {edge[0]} and {edge[1]}: "
          f"{drift[0]:.4f} m / {drift[1]:.4f} deg, loop closing off {drift_off[0]:.4f} m / {drift_off[1]:.4f} deg (bound "
          f"{LOOP_DRIFT_CUT} x) | loop keyframe's frame "
          f"{rows[loop_frame][1]:.3f} ms (CUDA events), split (host clock, ms): "
          + "; ".join(f"{k} {1e3 * split.get(k, 0.0):.3f}" for k in parts)
          + f"; essential graph {split['eg_vertices']} vertices, {split['eg_edges']} edges, {split['eg_iterations']} LM "
          f"iterations | global BA on its thread: {1e3 * g['seconds']:.3f} ms, {g['poses']} poses, {g['points']} points, "
          f"{g['chunks']} chunks; peak {peak_mib:.1f} MiB over the loop-closing run "
          f"(torch.cuda.max_memory_allocated) | "
          f"per-frame ms: ordinary ({len(plain_ms)}) {_stats(plain_ms)}; keyframe ({len(kf_ms)}) {_stats(kf_ms)} | "
          f"save_map {1e3 * save_s:.1f} ms ({size_mib:.1f} MiB), load_map {1e3 * load_s:.1f} ms, frame "
          f"{LOOP_RELOC_FRAME} relocalized against the reloaded map within {pos:.4f} m / {rot:.4f} deg in "
          f"{reloc_rows[0][1]:.3f} ms | loop solvers, host clock with a synchronize (ms): {_calls_text(solver_calls)}")
    sync = {"ordinary": plain_ms, "keyframe": kf_ms, "loop": [rows[loop_frame][1]], "ate": ate,
            "keyframes": len(slam.map.good_keyframes()), "gba": g,
            "essential_graph": {k: split[k] for k in ("essential_graph", "eg_vertices", "eg_edges", "eg_iterations")}}
    return launches, {"cam": cam, "seq": seq, "frames": frames, "sync": sync}

@contextlib.contextmanager
def _timed_calls(torch):
    """Time every call of the loop closer's batched solvers (Sim3 RANSAC, the
    Sim3 refinement, the essential graph) on the host clock, a synchronize
    included, with the thread it ran on: [(solver, thread, ms)]. The first
    call on a thread pays for its cuSOLVER / cuBLAS handles."""
    from orbslam2commentedbyxcm_tpu_torch.models import loop_closing as lc_mod

    calls, saved = [], []
    for mod, name in ((lc_mod.sim3solver, "ransac_sim3"), (lc_mod.posegraph, "optimize_sim3"),
                      (lc_mod.posegraph, "solve_pose_graph")):
        fn = getattr(mod, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((_name, threading.current_thread().name, 1e3 * (time.perf_counter() - t0)))
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _calls_text(calls) -> str:
    """Per solver and thread: the first call, then the later ones."""
    out = []
    for key in dict.fromkeys((name, thread) for name, thread, _ in calls):
        ms = [m for name, thread, m in calls if (name, thread) == key]
        later = f", later {len(ms) - 1}: {_stats(ms[1:])}" if len(ms) > 1 else ""
        out.append(f"{key[0]} on {key[1]}: first {ms[0]:.3f}{later}")
    return "; ".join(out) or "none called"


def _busy(slam) -> bool:
    """A worker has keyframes queued or in hand, or global BA is running."""
    workers = [slam.local_mapping, slam._loop_worker]
    return (any(w is not None and w._queue.unfinished_tasks > 0 for w in workers)
            or (slam.loop_closing is not None and slam.loop_closing.gba.running()))


def phase_async_loop(torch, dev, card: str, loop):
    """Phase 12's orbit through the async pipeline (mapping and loop closing
    on worker threads) with a Tracer; frame times beside phase 12's
    synchronous ones. Returns the kernel launches."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import adjudicate_loops
    from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

    cam, seq, frames, sync = loop["cam"], loop["seq"], loop["frames"], loop["sync"]
    k1c, k2c = _launch_counters()
    timer = _EventTimer(torch)
    tracer = Tracer()
    slam = System(cam, Sensor.RGBD, config=_loop_config(), vocabulary="bootstrap", async_mapping=True,
                  tracer=tracer, device=dev)
    lc, lm = slam.loop_closing, slam.local_mapping
    workers = (lm, slam._loop_worker)
    torch.cuda.synchronize()
    k1c.launches = k2c.launches = 0
    rows, kf_new, overlap, loops, gba_frames = [], [], [], [], []
    with _timed_calls(torch) as solver_calls:
        for i, (img, depth) in enumerate(frames):
            kf_before, n_loops, n_gba = slam.map.next_kf_id, lc.n_loops_closed, lc.gba.n_completed
            busy = _busy(slam)
            _track_timed(slam.track_rgbd, rows, (img, depth, i / 30.0), timer)
            overlap.append(busy or _busy(slam))
            kf_new.append(slam.map.next_kf_id > kf_before)
            if lc.n_loops_closed > n_loops:
                loops.append(i)
            if lc.gba.n_completed > n_gba:
                gba_frames.append(i)
        n_loops, n_gba = lc.n_loops_closed, lc.gba.n_completed
        t0 = time.perf_counter()
        slam.shutdown()  # drains both queues and global BA; raises what a worker raised
        drain_s = time.perf_counter() - t0
    launches = {"fused_frontend": k1c.launches, "pose_optimization_fused": k2c.launches}
    if lc.n_loops_closed > n_loops:
        loops.append(len(frames))  # closed while shutdown drained the queues
    if lc.gba.n_completed > n_gba:
        gba_frames.append(len(frames))
    _check(not any(w._thread.is_alive() for w in workers), "async: a worker thread did not end at shutdown")
    _check(all(r[0] is not None for r in rows), f"async: {sum(r[0] is None for r in rows)} frames not tracked")
    _check(not slam._archived_kf_trajectory, "async: tracking was lost and the System reset")
    _check(lc.n_loops_closed >= 1, f"async: no loop closed over {N_LOOP} frames, stats {lc.stats}")
    adj = adjudicate_loops(slam, seq)
    _check(adj["loop_edge_hits"] >= 1 and adj["false_closures"] == 0, f"async: ground truth {adj}")
    poses = _frame_poses(slam)
    ate = _ate(poses, seq, range(N_LOOP))
    bound = 1.5 * JAX_ATE_LOOP + 0.01
    split = lc.closure_splits[0]
    loop_kf_frame = int(round(slam.map.keyframes[split["kf_id"]].timestamp * 30.0))
    _check(ate <= bound, f"async: ATE {ate:.4f} m over {bound:.4f} m (1.5 x JAX {JAX_ATE_LOOP} m + 1 cm); loops "
           f"closed after frames {loops} (keyframe of frame {loop_kf_frame}), {len(slam.map.good_keyframes())} "
           f"keyframes, global BA written back after frames {gba_frames}")
    _check({r[2] for r in rows} == {1}, f"async: K1 launches per frame {sorted({r[2] for r in rows})}")
    _check(min(r[3] for r in rows[1:]) >= 2, "async: a tracked frame launched K2 fewer than 2 times")
    ms = {"ordinary": [rows[i][1] for i in range(1, N_LOOP) if not kf_new[i] and i != loop_kf_frame],
          "keyframe": [rows[i][1] for i in range(1, N_LOOP) if kf_new[i] and i != loop_kf_frame],
          "loop": [rows[loop_kf_frame][1]]}
    plain = [i for i in range(1, N_LOOP) if not kf_new[i]]
    lap = {k: [rows[i][1] for i in plain if overlap[i] == k] for k in (True, False)}
    st = tracer.stats()["spans"]
    print(f"[13 async] {card} | System(RGBD, vocabulary=bootstrap, async_mapping=True, tracer, device={dev}), "
          f"phase 12's orbit, {N_LOOP} frames: {len(rows)}/{N_LOOP} tracked, {lc.n_loops_closed} loop(s) closed, "
          f"seen after frames {loops} (the keyframe of frame {loop_kf_frame}, keyframe {split['kf_id']} to "
          f"{split['loop_kf_id']}), global BA written back after frames {gba_frames}; ground truth {adj}; "
          f"{len(slam.map.good_keyframes())} keyframes (sync {sync['keyframes']}), {slam.map.n_valid_points()} "
          f"points | ATE {ate:.4f} m (bound {bound:.4f}; sync {sync['ate']:.4f}) | per-frame ms, CUDA events on the "
          f"shared default stream, async vs sync: " + "; ".join(
              f"{k} ({len(ms[k])}) {_stats(ms[k])} vs ({len(sync[k])}) {_stats(sync[k])}" for k in ms)
          + f" | ordinary frames while a worker or global BA was busy ({len(lap[True])}) {_stats(lap[True])}, "
          f"while all were idle ({len(lap[False])}) {_stats(lap[False])} | shutdown drained in "
          f"{1e3 * drain_s:.1f} ms | keyframes deferred by the queue cap {slam.tracking.n_kf_deferred}, local BAs "
          f"{lm.n_local_ba} ({lm.n_ba_aborted} stopped after phase 1, {lm.n_ba_deferred} skipped for newer "
          f"keyframes), deepest queue: mapping {lm.max_depth}, loop {workers[1].max_depth} | loop worker split "
          f"(host clock, ms): " + "; ".join(f"{k} {1e3 * v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                          for k, v in split.items())
          + f" | loop solvers, host clock with a synchronize (ms): {_calls_text(solver_calls)} | tracer spans "
          f"(host clock; mean / p50 / p95 ms, n): " + "; ".join(
              f"{k} {d['mean_ms']:.2f}/{d['p50_ms']:.2f}/{d['p95_ms']:.2f} ({d['n']})"
              for k, d in sorted(st.items(), key=lambda kv: -kv[1]["total_s"])))
    print(tracer.summary_table())
    return launches


EIGHT_FRAMES = 420


def _eight_camera():
    """The JAX mini-gauntlet's figure-eight camera (tests/test_mini_gauntlet.py)."""
    from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera

    return Camera(fx=312.0, fy=312.0, cx=200.0, cy=150.0, width=400, height=300, bf=25.0, th_depth=50.0)


def phase_eight(torch, dev, card: str):
    """The figure-eight of the gauntlet (utils/gauntlet.run_sequence, the
    JAX mini-gauntlet's camera and features), synchronous then async, each
    held to tests/test_mini_gauntlet.py's gates. Returns the kernel launches."""
    from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import render_frames, run_sequence
    from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

    cam = _eight_camera()
    t0 = time.perf_counter()
    images = render_frames("eight", EIGHT_FRAMES, cam)  # once for both runs
    render_s = time.perf_counter() - t0
    k1c, k2c = _launch_counters()
    launches = {"fused_frontend": 0, "pose_optimization_fused": 0}
    for async_mapping in (False, True):
        torch.cuda.synchronize()
        k1c.launches = k2c.launches = 0
        t0 = time.perf_counter()
        tracer = Tracer()
        rec = run_sequence("eight", EIGHT_FRAMES, augment=True, async_mapping=async_mapping, camera=cam,
                           n_features=900, device=dev, images=images, tracer=tracer)
        wall = time.perf_counter() - t0
        launches["fused_frontend"] += k1c.launches
        launches["pose_optimization_fused"] += k2c.launches
        tag = "async" if async_mapping else "sync"
        gt = rec["gt_loops"]
        _check(rec["tracked"] >= rec["frames"] - 5 and rec["loops_closed"] >= 1 and gt["false_closures"] == 0
               and gt["missed"] == 0 and rec["drift_pct"] < 0.8, f"eight ({tag}): {rec}")
        _check(k1c.launches >= rec["frames"] and k2c.launches >= 2 * (rec["tracked"] - 1),
               f"eight ({tag}): K1 {k1c.launches}, K2 {k2c.launches} launches over {rec['frames']} frames")
        print(f"[14 eight {tag}] {card} | run_sequence('eight', {EIGHT_FRAMES}, augment=True, "
              f"async_mapping={async_mapping}, 400x300, 900 features, device={dev}): {wall:.1f} s wall (the "
              f"frames rendered beforehand in {render_s:.1f} s), K1 {k1c.launches}, K2 {k2c.launches} launches | "
              f"{rec} | tracer spans (host clock; total s / p50 ms, n): " + "; ".join(
                  f"{k} {d['total_s']:.2f}/{d['p50_ms']:.2f} ({d['n']})"
                  for k, d in sorted(tracer.stats()["spans"].items(), key=lambda kv: -kv[1]["total_s"])))
    return launches


def write_dataset_fixture(fmt: str, root: str, writers, box_sequence, load_settings):
    """Render format `fmt`'s fixture (DATASET_FIXTURES) into `root` with
    either package's dataset_writers module, BoxSequence and load_settings;
    the settings file's feature count becomes the published file's. Returns
    the run_dataset arguments (format, paths, settings)."""
    import dataclasses

    name, kw = DATASET_FIXTURES[fmt]
    cam, cfg, _ = load_settings(str(ROOT / "examples" / "settings" / name))
    cam = dataclasses.replace(cam, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    n = N_DATASET
    seq = box_sequence(camera=cam, n_frames=n, **kw)
    if fmt == "tum":
        settings, args = writers.write_tum_rgbd(root, seq, n, fps=cam.fps), ["tum", root]
    elif fmt == "kitti":
        settings, args = writers.write_kitti(root, seq, n, fps=cam.fps), ["kitti", root, "00"]
    else:
        settings, args = writers.write_euroc(root, seq, n, fps=cam.fps, distorted=True), ["euroc", root]
    text = Path(settings).read_text()
    _check("ORBextractor.nFeatures: 800\n" in text, f"{fmt}: the writer's settings lack its feature count")
    Path(settings).write_text(text.replace("ORBextractor.nFeatures: 800\n",
                                           f"ORBextractor.nFeatures: {cfg.n_features}\n"))
    return [*args, settings]


def _render_fixture(fmt: str, root: str):
    """Worker of phase 15's process pool: the port's writer, seconds taken."""
    from orbslam2commentedbyxcm_tpu_torch.utils import dataset_writers
    from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

    t0 = time.perf_counter()
    args = write_dataset_fixture(fmt, root, dataset_writers, BoxSequence, load_settings)
    return args, time.perf_counter() - t0


def _host_ms(dataset, frames) -> float:
    """Milliseconds per `dataset[i]` (read + decode, + rectify when the
    dataset has a rectifier), on this thread alone."""
    t0 = time.perf_counter()
    for i in frames:
        dataset[i]
    return 1e3 * (time.perf_counter() - t0) / len(frames)


def _png_filter_ms(png) -> dict:
    """Host ms of png.decode on a 1241x376 gray image whose rows all carry
    one filter type (any bytes are a valid filtered stream: random rows
    decode to some image), per type: the port's writer uses None only, real
    datasets use Sub to Paeth, whose left-neighbour chain is the codec's
    sequential part."""
    import struct
    import zlib

    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (376, 1241 + 1), dtype=np.uint8)
    out = {}
    for name, f in (("None", 0), ("Sub", 1), ("Up", 2), ("Average", 3), ("Paeth", 4)):
        rows[:, 0] = f
        data = (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 1241, 376, 8, 0, 0, 0, 0))
                + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + png._chunk(b"IEND", b""))
        _check(png.decode(data).shape == (376, 1241), f"png.decode with filter {name}")
        t0 = time.perf_counter()
        for _ in range(20):
            png.decode(data)
        out[name] = 1e3 * (time.perf_counter() - t0) / 20
    return out


def phase_datasets(torch, dev, card: str):
    """The three dataset formats from disk through cli.run_dataset.main on
    the card: each fixture rendered by the port's writer (the three in a pool
    of processes), then run as a user would, with the tracer; gates on the
    tracked frames, ATE against the JAX CLI's, the trajectory file, the
    rectification and the kernel launches; then a vocabulary trained from
    KITTI images with vocab_tools on the card. Returns the kernel launches."""
    import concurrent.futures
    import io
    import multiprocessing
    import re
    import shutil
    import tempfile

    from orbslam2commentedbyxcm_tpu_torch.cli import run_dataset
    from orbslam2commentedbyxcm_tpu_torch.ops import bow
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu_torch.utils import datasets, png, vocab_tools
    from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings
    from orbslam2commentedbyxcm_tpu_torch.utils.rectify import StereoRectifier

    k1c, k2c = _launch_counters()
    launches = {"fused_frontend": 0, "pose_optimization_fused": 0}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="datasets_") as tmp:
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(max_workers=len(DATASET_FIXTURES), mp_context=ctx) as pool:
            jobs = {fmt: pool.submit(_render_fixture, fmt, str(Path(tmp) / fmt)) for fmt in DATASET_FIXTURES}
            rendered = {fmt: job.result() for fmt, job in jobs.items()}
        render_s = time.perf_counter() - t0
        for fmt, (args, secs) in rendered.items():
            settings = args[-1]
            cam, cfg, raw = load_settings(settings)
            rectifier = StereoRectifier.from_settings(raw) if fmt == "euroc" else None
            if fmt == "tum":
                data = datasets.TumRgbdDataset(args[1], depth_factor=raw["depth_map_factor"])
            elif fmt == "kitti":
                data = datasets.KittiOdometryDataset(args[1], args[2])
            else:
                data = datasets.EurocDataset(args[1], rectifier=rectifier)
            sample = range(0, N_DATASET, 6)
            host = {"decode": _host_ms(datasets.EurocDataset(args[1]) if fmt == "euroc" else data, sample)}
            if fmt == "euroc":
                host["decode + rectify"] = _host_ms(data, sample)
            prefix = str(Path(tmp) / f"{fmt}_")
            trace = prefix + "trace.jsonl"
            argv = [*args, *DATASET_FLAGS, "--device", str(dev), "--trace", trace, "--out-prefix", prefix]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k1c.launches = k2c.launches = 0
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = run_dataset.main(argv)
            wall = time.perf_counter() - t1
            k1, k2 = k1c.launches, k2c.launches
            launches["fused_frontend"] += k1
            launches["pose_optimization_fused"] += k2
            peak_mib = torch.cuda.max_memory_allocated() / 2**20
            text = out.getvalue()
            tail = text[-1500:]
            _check(rc == 0, f"{fmt}: run_dataset returned {rc}: {tail}")
            m = re.search(r"tracked (\d+)/(\d+) frames at ([0-9.]+) fps wall", text)
            a = re.search(r"ATE RMSE: ([0-9.]+) cm", text)
            _check(m is not None and a is not None, f"{fmt}: no tracked / ATE line: {tail}")
            tracked, total, fps = int(m.group(1)), int(m.group(2)), float(m.group(3))
            ate_cm = float(a.group(1))
            bound_cm = 1.5 * 100 * JAX_ATE_DATASET[fmt] + 1.0
            traj = np.loadtxt(prefix + "CameraTrajectory.txt", ndmin=2)
            n_kf = len(np.loadtxt(prefix + "KeyFrameTrajectory.txt", ndmin=2))
            per_frame = 1 if fmt == "tum" else 2
            _check(total == N_DATASET and tracked >= total - 2, f"{fmt}: tracked {tracked}/{total}: {tail}")
            _check(ate_cm <= bound_cm, f"{fmt}: ATE {ate_cm} cm over {bound_cm:.2f} cm "
                   f"(1.5 x JAX CLI {100 * JAX_ATE_DATASET[fmt]:.2f} cm + 1 cm)")
            _check(traj.shape[1] == 8 and len(traj) >= tracked - 5,
                   f"{fmt}: CameraTrajectory.txt is {traj.shape}, want 8 columns and >= {tracked - 5} rows")
            _check(fmt != "euroc" or "rectification maps built" in text, f"euroc: no rectification line: {tail}")
            _check(k1 == per_frame * total and k2 >= 2 * (tracked - 1),
                   f"{fmt}: K1 {k1}, K2 {k2} launches over {total} frames (K1 {per_frame} per frame, K2 >= 2 "
                   f"per tracked frame)")
            records = [json.loads(line) for line in open(trace)][:-1]
            frame_ms = [(1e3 * sum(r["spans"].get(k, 0.0) for k in ("extract", "stereo_match", "tracking")),
                         "local_mapping" in r["spans"]) for r in records[1:]]
            kf_ms = [ms for ms, kf in frame_ms if kf]
            plain_ms = [ms for ms, kf in frame_ms if not kf]
            print(f"[15 datasets {fmt}] {card} | {DATASET_FIXTURES[fmt][0]} {cam.width}x{cam.height}, "
                  f"{cfg.n_features} features, {total} frames written in {secs:.1f} s: run_dataset.main("
                  f"{argv[0]} {' '.join(DATASET_FLAGS)} --device {dev} --trace) {tracked}/{total} "
                  f"tracked, ATE {ate_cm:.2f} cm (bound {bound_cm:.2f} cm = 1.5 x JAX CLI "
                  f"{100 * JAX_ATE_DATASET[fmt]:.2f} cm + 1 cm), {len(traj)} trajectory rows, {n_kf} keyframes "
                  f"kept | frame ms (tracer, host clock, frames 1-{total - 1}): ordinary ({len(plain_ms)}) "
                  f"{_stats(plain_ms)}; keyframe ({len(kf_ms)}) {_stats(kf_ms)} | host ms per frame on "
                  f"dataset[i] alone: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
                  + f" | {fps:.2f} fps wall ({wall:.1f} s in main) | K1 {k1}, K2 {k2} launches | peak device "
                  f"memory {peak_mib:.1f} MiB")
            if fmt == "kitti":
                image_dir = Path(tmp) / "vocab_images"
                image_dir.mkdir()
                for i in range(N_VOCAB_IMAGES):
                    shutil.copy(Path(args[1]) / "sequences" / "00" / "image_0" / f"{3 * i:06d}.png", image_dir)
                voc_path = str(Path(tmp) / "kitti_vocab.npz")
                k1c.launches = 0
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    vrc = vocab_tools.main(["train", voc_path, str(image_dir), "--device", str(dev)])
                train_s = time.perf_counter() - t1
                k1_voc = k1c.launches
                _check(vrc == 0 and k1_voc == N_VOCAB_IMAGES, f"vocab_tools train: rc {vrc}, {k1_voc} K1 launches")
                voc = bow.Vocabulary.load(voc_path)
                frame = png.imread_gray(str(Path(args[1]) / "sequences" / "00" / "image_0" / "000001.png"))
                feats = ORBExtractor(n_features=cfg.n_features)(torch.from_numpy(frame.astype(np.float32)).to(dev))
                _check(k1c.launches == k1_voc + 1, f"the transform frame's extraction: "
                       f"{k1c.launches - k1_voc} K1 launches, want 1")
                launches["fused_frontend"] += k1c.launches
                t1 = time.perf_counter()
                words, groups, weights = bow.transform(voc, feats.desc, feats.valid)
                transform_ms = 1e3 * (time.perf_counter() - t1)
                n_valid = int(feats.valid.sum())
                _check(voc.n_words > 100 and int((words >= 0).sum()) == n_valid > 100
                       and int(words.max()) < voc.n_words, f"vocabulary: {voc.n_words} words, "
                       f"{int((words >= 0).sum())} of {n_valid} features quantized")
                print(f"[15 datasets vocab] vocab_tools.main(['train', ..., <{N_VOCAB_IMAGES} KITTI image_0 "
                      f"PNGs>]) on {dev}: k {voc.k}, depth {voc.depth}, {voc.n_words} words in {train_s:.1f} s "
                      f"({k1_voc} K1 launches) | bow.transform of frame 1's {n_valid} features (1 K1 launch) on {dev}: "
                      f"{len(set(words[words >= 0].tolist()))} distinct words, {transform_ms:.2f} ms")
    decode_ms = _png_filter_ms(png)
    image_libs = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL"))
    _check(not image_libs, f"the dataset path loaded {image_libs}")
    print(f"[15 datasets] fixtures rendered in {render_s:.1f} s (3 processes); cv2 and PIL not loaded | "
          f"png.decode of one 1241x376 gray image, every row with filter type F (host ms, mean of 20): "
          + ", ".join(f"{f} {ms:.2f}" for f, ms in decode_ms.items()))
    return launches


def _pose_error(a, b) -> float:
    """Norm of the se3 log of a b^-1 (tests/test_optim.pose_err)."""
    import torch

    from orbslam2commentedbyxcm_tpu_torch.utils.geometry import se3_log

    d = np.asarray(a, np.float64) @ np.linalg.inv(np.asarray(b, np.float64))
    return float(torch.linalg.norm(se3_log(torch.tensor(d, dtype=torch.float32))))


def _max_pose_error(a, b) -> float:
    return max(_pose_error(x, y) for x, y in zip(a, b))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_problem(torch, slam):
    """Phase 16's global-BA problem: every good keyframe of the mesh run's
    final map and their points (assemble_ba_problem, the origin fixed; RGB-D
    edges are stereo where the depth is valid, mono elsewhere), 5% of the
    edges masked out, the free poses perturbed by ~3 mm / 0.2 deg and the
    points by ~1 cm."""
    from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import assemble_ba_problem
    from orbslam2commentedbyxcm_tpu_torch.utils.geometry import se3_exp

    m = slam.map
    problem = assemble_ba_problem(m, [k.kf_id for k in m.good_keyframes()], fixed_ids={m.origin_kf_id})
    rng = np.random.default_rng(16)
    problem["omask"] = rng.random(len(problem["omask"])) >= 0.05
    free = ~problem["pose_fixed"]
    xi = torch.from_numpy(rng.normal(0, 0.003, (int(free.sum()), 6)).astype(np.float32))
    problem["poses"][free] = se3_exp(xi).numpy() @ problem["poses"][free]
    problem["points"] = problem["points"] + rng.normal(0, 0.01, problem["points"].shape).astype(np.float32)
    return problem


def _timed(fn, reps: int):
    """(last result, host ms of each of `reps` calls after one untimed call;
    each call ends in a host read, so the card is idle at both ends)."""
    out = fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def _mesh_solves(torch, mesh, problem, cam, graph, reps: int, profile: bool = False) -> dict:
    """The live pipeline's two sharded solves (system_bridge) over `mesh`:
    results as numpy, host ms per solve, psums per solve, bytes per psum;
    with `profile`, the device ms and device operations (kernels and
    copies) of one more solve (torch.profiler)."""
    from orbslam2commentedbyxcm_tpu_torch.parallel import system_bridge

    out = {}
    for name, solve in (("ba", lambda: system_bridge.solve_ba_problem_dist(problem, cam, mesh)),
                        ("graph", lambda: system_bridge.solve_pose_graph_dist(*graph, mesh, n_iters=20))):
        n0, b0 = mesh.n_psum, mesh.psum_bytes
        res, ms = _timed(solve, reps)
        n = (mesh.n_psum - n0) / (reps + 1)
        out[name] = {"ms": ms, "psums": n, "bytes": (mesh.psum_bytes - b0) / max(mesh.n_psum - n0, 1),
                     "poses": np.asarray(res.poses.cpu() if torch.is_tensor(res.poses) else res.poses),
                     "points": getattr(res, "points", None), "cost": float(res.cost)}
        if profile:
            out[name]["device_ms"], out[name]["device_ops"] = _device_ms(solve, 1, "")
    return out


def _mesh_rank(problem, cam, graph, reps: int, device: str) -> dict:
    """One rank of phase 16's cross-process run: joins the group from
    torchrun's variables (gloo), MESH_RANK_SHARDS shards on `device` (every
    rank on the same card)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from orbslam2commentedbyxcm_tpu_torch.parallel import multihost

    _check(multihost.initialize(backend="gloo"), "mesh rank: no process group from the environment")
    mesh = multihost.make_hybrid_mesh(MESH_RANK_SHARDS, device=device)
    out = _mesh_solves(torch, mesh, problem, cam, graph, reps)
    out.update(axes=mesh.axis_names, shards=mesh.n_shards, rank=mesh.rank)
    return out


def phase_mesh(torch, dev, card: str, loop, k2):
    """System(mesh=make_mesh(8)) over phase 12's orbit; the sharded solvers
    against the single-device ones at 1, 4 and 8 shards; 2 processes x 4
    shards against 1 x 8; gn and dogleg against lm. Returns the kernel
    launches of the System run."""
    from orbslam2commentedbyxcm_tpu_torch.models import loop_closing as loop_closing_mod
    from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import solve_ba_problem
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.ops.optim import ALGORITHMS, pose_optimization
    from orbslam2commentedbyxcm_tpu_torch.ops.posegraph import optimize_pose_graph_cg
    from orbslam2commentedbyxcm_tpu_torch.parallel import dist_ba, dist_posegraph, multihost
    from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import make_mesh
    from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import adjudicate_loops

    # 1. the System over an 8-shard mesh at phase 12's size; only the
    # essential graph's gate is lowered (global BA's stays at 2048 points)
    cam, seq, frames, sync = loop["cam"], loop["seq"], loop["frames"], loop["sync"]
    k1c, k2c = _launch_counters()
    timer = _EventTimer(torch)
    mesh = make_mesh(8, device=dev)
    slam = System(cam, Sensor.RGBD, config=_loop_config(), vocabulary="bootstrap", mesh=mesh, device=dev)
    lc = slam.loop_closing
    lc.dist_min_vertices = 0
    graphs = []
    solve_graph = loop_closing_mod.solve_pose_graph_dist
    loop_closing_mod.solve_pose_graph_dist = lambda *a, **kw: graphs.append(a) or solve_graph(*a, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    k1c.launches = k2c.launches = 0
    rows, loops = [], []
    try:
        for i, (img, depth) in enumerate(frames):
            n_loops = lc.n_loops_closed
            _track_timed(slam.track_rgbd, rows, (img, depth, i / 30.0), timer)
            if lc.n_loops_closed > n_loops:
                loops.append(i)
        slam.shutdown()
    finally:
        loop_closing_mod.solve_pose_graph_dist = solve_graph
    launches = {"fused_frontend": k1c.launches, "pose_optimization_fused": k2c.launches}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    _check(all(r[0] is not None for r in rows), f"mesh: {sum(r[0] is None for r in rows)} frames not tracked")
    _check(not slam._archived_kf_trajectory, "mesh: tracking was lost and the System reset")
    _check(lc.n_loops_closed >= 1, f"mesh: no loop closed over {N_LOOP} frames, stats {lc.stats}")
    adj = adjudicate_loops(slam, seq)
    _check(adj["loop_edge_hits"] >= 1 and adj["false_closures"] == 0, f"mesh: ground truth {adj}")
    _check(lc.stats["posegraph_distributed"] >= 1 and len(graphs) == lc.stats["posegraph_distributed"],
           f"mesh: essential graphs through the mesh {lc.stats['posegraph_distributed']}")
    _check(lc.gba.n_distributed >= 1 and lc.gba.last_stats.get("distributed"),
           f"mesh: global BA through the mesh {lc.gba.n_distributed} times (completed {lc.gba.n_completed}, "
           f"last {lc.gba.last_stats})")
    _check({r[2] for r in rows} == {1}, f"mesh: K1 launches per frame {sorted({r[2] for r in rows})}")
    _check(min(r[3] for r in rows[1:]) >= 2, "mesh: a tracked frame launched K2 fewer than 2 times")
    ate = _ate(_frame_poses(slam), seq, range(N_LOOP))
    bound = 1.5 * JAX_ATE_MESH + 0.01
    _check(ate <= bound, f"mesh: ATE {ate:.4f} m over {bound:.4f} m (1.5 x JAX {JAX_ATE_MESH} m + 1 cm); loops on "
           f"frames {loops}, {len(slam.map.good_keyframes())} keyframes")
    g, g12 = lc.gba.last_stats, sync["gba"]
    split, eg12 = lc.closure_splits[0], sync["essential_graph"]
    print(f"[16 mesh system] {card} | System(RGBD, vocabulary=bootstrap, mesh=make_mesh(8, device={dev})), "
          f"dist_min_vertices 0, dist_min_points {lc.gba.dist_min_points}, phase 12's {N_LOOP}-frame orbit: "
          f"{len(rows)}/{N_LOOP} tracked, loops closed on frames {loops}, ground truth {adj}, "
          f"{len(slam.map.good_keyframes())} keyframes, ATE {ate:.4f} m (bound {bound:.4f} m; phase 12 "
          f"{sync['ate']:.4f} m) | global BA through the mesh {lc.gba.n_distributed} of {lc.gba.n_completed} "
          f"completed: {1e3 * g['seconds']:.3f} ms, {g['poses']} poses, {g['points']} points "
          f"(phase 12 single-device: {1e3 * g12['seconds']:.3f} ms, {g12['poses']} poses, {g12['points']} points) | "
          f"essential graph through the mesh: {1e3 * split['essential_graph']:.3f} ms, {split['eg_vertices']} "
          f"vertices, {split['eg_edges']} edges, {split['eg_iterations']} LM iterations (phase 12 dense: "
          f"{1e3 * eg12['essential_graph']:.3f} ms, {eg12['eg_iterations']} iterations) | mesh psums "
          f"{mesh.n_psum}, {mesh.psum_bytes / 2**20:.2f} MiB reduced | K1 {launches['fused_frontend']}, K2 "
          f"{launches['pose_optimization_fused']} launches | peak {peak_mib:.1f} MiB")

    # 2. the sharded solvers against the single-device ones, on the card
    problem = _mesh_problem(torch, slam)
    graph = graphs[0][:6]
    intr = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    single = solve_ba_problem(problem, cam, dev, ((10, False),), relabel_between=False)
    single_poses = single.poses.cpu().numpy()
    g_t = [torch.as_tensor(a).to(dev) for a in graph]
    g_single = optimize_pose_graph_cg(*g_t, n_iters=20)
    parity, repeat = [], {}
    for n in MESH_SHARDS:
        m_n = make_mesh(n, device=dev)
        sh = dist_ba.shard_ba_problem(problem["points"], problem["point_valid"], problem["op"], problem["opt"],
                                      problem["ouv"], problem["omask"], problem["osig"], n)
        args = (m_n, torch.from_numpy(problem["poses"]).to(dev), torch.from_numpy(problem["pose_fixed"]).to(dev),
                *[m_n.local(a) for a in (sh[0], sh[1], *sh[3:])], *intr)
        runs = {"dense": dist_ba.distributed_bundle_adjustment(*args, n_iters=10, use_huber=False),
                "cg": dist_ba.distributed_bundle_adjustment_cg(*args, n_iters=10, n_cg=MESH_PARITY_CG,
                                                               use_huber=False),
                "cg25": dist_ba.distributed_bundle_adjustment_cg(*args, n_iters=10, n_cg=25, use_huber=False)}
        costs = {k: float(v[2]) for k, v in runs.items()}
        errs = {k: _max_pose_error(v[0].cpu().numpy(), single_poses) for k, v in runs.items()}
        held = {k: errs[k] for k in ("dense", "cg")}
        shards = dist_posegraph.shard_posegraph_problem(*graph[2:], m_n)
        g_run = dist_posegraph.distributed_pose_graph(graph[0], graph[1], *(m_n.local(a) for a in shards), mesh=m_n)
        g_err = float((g_run.poses - g_single.poses).abs().max())
        parity.append((n, errs, costs, g_err, g_run.iterations))
        _check(max(held.values()) < MESH_POSE_TOL, f"mesh solvers, {n} shards: pose error {held} against the "
               f"single-device solve (want < {MESH_POSE_TOL})")
        for cg in ("cg", "cg25"):
            _check(costs[cg] <= 1.05 * costs["dense"] + 1e-3, f"mesh solvers, {n} shards: {cg} cost {costs[cg]} "
                   f"over 1.05 x dense {costs['dense']} + 1e-3")
        _check(g_err < MESH_GRAPH_TOL, f"mesh pose graph, {n} shards: {g_err} from optimize_pose_graph_cg")
        if n == 4:
            again = dist_ba.distributed_bundle_adjustment_cg(*args, n_iters=10, n_cg=25, use_huber=False)
            g_again = dist_posegraph.distributed_pose_graph(graph[0], graph[1], *(m_n.local(a) for a in shards),
                                                            mesh=m_n)
            repeat = {"ba": all(torch.equal(a, b) for a, b in zip(runs["cg25"], again)),
                      "graph": torch.equal(g_run.poses, g_again.poses)}
            _check(all(repeat.values()), f"mesh solvers, 4 shards: a repeat is not bit-equal ({repeat})")
    n_stereo = int((problem["ouv"][:, 2] >= 0).sum())
    print(f"[16 mesh parity] global-BA problem of the mesh run's final map: {len(problem['poses'])} poses "
          f"({int(problem['pose_fixed'].sum())} fixed), {len(problem['pids'])} points, {len(problem['op'])} edges "
          f"({n_stereo} stereo, {int((~problem['omask']).sum())} masked), 10 plain LM iterations (CG: "
          f"{MESH_PARITY_CG} steps each); essential graph "
          f"{len(graph[0])} vertices, {len(graph[2])} edges | single-device: bundle_adjustment (dense), "
          f"optimize_pose_graph_cg ({g_single.iterations} iterations) | " + "; ".join(
              f"{n} shards: pose error dense {e['dense']:.3g} / CG {e['cg']:.3g} (bound {MESH_POSE_TOL}; CG with "
              f"global BA's 25 steps {e['cg25']:.3g}, not held), cost dense {c['dense']:.6g} / CG {c['cg']:.6g} / CG "
              f"25 steps {c['cg25']:.6g}, pose graph max|d| {ge:.3g} (bound {MESH_GRAPH_TOL}, {gi} iterations)"
              for n, e, c, ge, gi in parity) + f" | 4 shards, global BA's CG and the pose graph repeated: bit-equal "
          f"{repeat}")

    # 3. two processes x 4 shards (gloo, both on this card) against 1 x 8
    reps = 2
    one = _mesh_solves(torch, make_mesh(8, device=dev), problem, cam, graph, reps, profile=True)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    t0 = time.perf_counter()
    ranks = multihost.launch_local(_mesh_rank, MESH_RANKS, args=(problem, cam, graph, reps, str(dev)), env=env,
                                   timeout_s=240)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        _check(r["axes"] == ("dcn", "ici") and r["shards"] == MESH_RANKS * MESH_RANK_SHARDS,
               f"mesh rank {r['rank']}: axes {r['axes']}, {r['shards']} shards")
        d_ba = _max_pose_error(r["ba"]["poses"], one["ba"]["poses"])
        d_pts = float(np.abs(r["ba"]["points"] - one["ba"]["points"]).max())
        d_graph = float(np.abs(r["graph"]["poses"] - one["graph"]["poses"]).max())
        _check(d_ba < MESH_POSE_TOL and d_graph < MESH_GRAPH_TOL,
               f"mesh rank {r['rank']}: 2 x 4 against 1 x 8: pose error {d_ba}, pose graph {d_graph}")
        _check(r["ba"]["cost"] <= 1.05 * one["ba"]["cost"] + 1e-3, f"mesh rank {r['rank']}: cost "
               f"{r['ba']['cost']} against 1 x 8's {one['ba']['cost']}")
    same = all(np.array_equal(ranks[0][k]["poses"], ranks[1][k]["poses"]) for k in ("ba", "graph"))
    _check(same, "mesh: the two ranks hold different results")

    def solve_text(tag, s):
        dev_text = {k: (f", device {s[k]['device_ms']:.3f} ms in {s[k]['device_ops']} kernels and copies "
                        f"(torch.profiler)" if "device_ms" in s[k] else "") for k in ("ba", "graph")}
        return (f"{tag}: BA {_stats(s['ba']['ms'])} ms{dev_text['ba']}, {s['ba']['psums']:.0f} psums per solve, "
                f"{s['ba']['bytes']:.0f} B per psum; pose graph {_stats(s['graph']['ms'])} ms{dev_text['graph']}, "
                f"{s['graph']['psums']:.0f} psums, {s['graph']['bytes']:.0f} B per psum")

    print(f"[16 mesh processes] system_bridge solves of the same problems (global BA: 10 Schur-CG iterations in "
          f"chunks of 3, 25 CG steps each; essential graph: 20 LM), host ms per solve after one untimed call "
          f"({reps} timed): " + solve_text("1 process x 8 shards", one) + " | " + solve_text(
              f"{MESH_RANKS} processes x {MESH_RANK_SHARDS} shards (gloo on {dev}, torchrun variables; rank 0)",
              ranks[0]) + f" | 2 x 4 against 1 x 8: pose error "
          f"{max(_max_pose_error(r['ba']['poses'], one['ba']['poses']) for r in ranks):.3g}, points max|d| "
          f"{max(float(np.abs(r['ba']['points'] - one['ba']['points']).max()) for r in ranks):.3g}, cost "
          f"{ranks[0]['ba']['cost']:.6g} / {one['ba']['cost']:.6g}, pose graph max|d| "
          f"{max(float(np.abs(r['graph']['poses'] - one['graph']['poses']).max()) for r in ranks):.3g}; ranks "
          f"bit-equal; spawn to join {spawn_s:.1f} s")

    # 4. gn and dogleg against lm on K2's problem (N = 1000): the plain
    # solve on the card, K2 not launched
    t0, pts, obs, mask, _ = make_pose_problem(np.random.default_rng(0), 1000, 0.5)
    args = [torch.from_numpy(a).to(dev) for a in (t0, pts, obs, mask, np.ones(1000, np.float32))]
    pcam = (FX, FY, CX, CY, BF)
    lm = pose_optimization(*args, *pcam).t_cw.cpu().numpy()
    algs = {}
    for alg in ALGORITHMS[1:]:
        before = k2c.launches
        t_alg = pose_optimization(*args, *pcam, algorithm=alg).t_cw.cpu().numpy()
        ms = _cuda_ms(lambda: pose_optimization(*args, *pcam, algorithm=alg), 5)
        dev_ms, ops = _device_ms(lambda: pose_optimization(*args, *pcam, algorithm=alg), 1, "")
        _check(k2c.launches == before, f"{alg}: launched K2")
        algs[alg] = (_pose_error(t_alg, lm), ms, dev_ms, ops)
        _check(algs[alg][0] < ALGORITHM_TOL, f"{alg}: pose error {algs[alg][0]} against lm (K2)")
    print(f"[16 mesh algorithms] pose_optimization on K2's problem, N = 1000, stereo 0.5, on {dev}: " + "; ".join(
        f"{alg} pose error against lm (K2) {e:.3g} (bound {ALGORITHM_TOL}), {ms:.3f} ms per solve (CUDA events, "
        f"plain torch), device {dev_ms:.3f} ms in {ops} kernels and copies (torch.profiler)"
        for alg, (e, ms, dev_ms, ops) in algs.items()) + f"; lm: K2 call {k2['call_ms']:.4f} ms, device "
        f"{k2['device_ms']:.4f} ms (phase 4)")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import orbslam2commentedbyxcm_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing next to this script: {exc}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    secs = {}

    def timed(tag, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[tag] = time.perf_counter() - t
        return out

    card = timed(1, phase_device, torch)
    timed(2, phase_build)
    k1 = timed(3, phase_k1, torch, dev)
    k2 = timed(4, phase_k2, torch, dev)
    timed(5, phase_flagship, torch, dev)
    runs = [timed(6, phase_tracking, torch, dev, k1, k2),
            timed(7, phase_slam, torch, dev, "RGBD", N_RGBD, JAX_ATE_RGBD, 7),
            timed(8, phase_slam, torch, dev, "STEREO", N_STEREO, JAX_ATE_STEREO, 8),
            timed(9, phase_mono, torch, dev)]
    reloc_launches, slam, seq = timed(10, phase_reloc, torch, dev)
    runs += [reloc_launches, timed(11, phase_localization, torch, dev, slam, seq)]
    del slam
    loop_launches, loop = timed(12, phase_loop, torch, dev, card)
    runs += [loop_launches, timed(13, phase_async_loop, torch, dev, card, loop),
             timed(14, phase_eight, torch, dev, card), timed(15, phase_datasets, torch, dev, card),
             timed(16, phase_mesh, torch, dev, card, loop, k2)]
    launches = {name: sum(r[name] for r in runs) for name in runs[0]}
    for r in runs:
        _check(all(r.values()), f"a kernel of the main path was never launched: {r}")
    kernels = [
        {"name": "fused_frontend", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/frontend.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/pallas_frontend.py:141",
         "launches": launches["fused_frontend"], **k1},
        {"name": "pose_optimization_fused", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/poseopt.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/pallas_poseopt.py:300",
         "launches": launches["pose_optimization_fused"], **k2},
    ]
    print(f"[17 total] {time.perf_counter() - t0:.1f} s; by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
