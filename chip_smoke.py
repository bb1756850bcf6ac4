#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from orbslam2commentedbyxcm_tpu_torch/csrc,
checks each against its plain torch twin on the card, and drives the port the
way a user would: the per-frame tracking step, then the System's synchronous
RGB-D, stereo and monocular SLAM, relocalization with the shipped vocabulary,
localization mode, loop closing with map save and load, the async pipeline,
the figure-eight loop gate, the three dataset formats read from disk, the
sharded global solvers, in the System and across two processes, and the host
C++ runtime (map index, keyframe database, DBoW2 parser) against its Python
twins. Phases, each printing one line:

  1. device   the card's name and power limit (nvidia-smi), TF32 flags
  2. build    nvcc build of the kernels (one nvcc per source, in parallel), seconds;
              g++ build of the host runtime (PNG row filters, map index,
              inverted file, DBoW2 parser; one g++ per source, in parallel)
  3. pyramid  the exposure gain and pyramid kernel vs its twin, on the card and
              on the CPU (bit-equal on every level), gain on and off, on a
              rendered frame and a random image at 640x480, 752x480,
              1241x376 and 1920x1080 (2025 gain partials: more than one
              chunk); one launch per call either way; device time
              (torch.profiler), call time, twin time, bound, and the device
              time of the 14 torch.matmul calls it replaced; then the whole
              extractor on the card against the
              same extractor on the CPU, each on its own: every field (uv,
              response, angle, level, desc, valid) bit-equal on 5 frames
     select   the selection and describe kernels vs their twins on the card
              (every slot bit-equal) at 640x480, 752x480, 1241x376,
              1920x1080 and 3840x2160 (whose levels 0 and 1 are ranked by
              count) with 1000, 1200, 2000 and 4000 features, and on
              noise, a tiled texture and a flat image; one launch each per
              call; device time (torch.profiler), call time, twin time and
              bound (what this extraction's maps and keypoints need read)
              per 640x480 extraction; a whole extraction launches 4
              kernels (pyramid, K1, select, describe: torch.profiler)
     K1       one launch of the fused frontend over the 8-level pyramid of a
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
              counters (one pyramid, K1, select and describe launch per
              extraction), pose error, per-frame time
  7. rgbd     System(Sensor.RGBD, device="cuda") on 60 frames of the same
              sequence: tracked frames, keyframes, local BAs, ATE against
              the JAX package's, per-frame times, launches, peak memory
  8. stereo   System(Sensor.STEREO) on 30 rounded stereo pairs: the same
              checks, 2 K1, select and describe launches per frame (left +
              right extraction)
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
 17. index    the host C++ runtime (native/) against its Python twins, each
              warmed first and the order alternated: phase 12's orbit to its
              loop (frames 0-99), synchronous, twice with index="python" and
              twice with index="native", trajectories, keyframes,
              covisibility, spanning tree, observations (order included) and
              points_seen_by bit-equal, frame times and the index queries'
              host ms (tracer spans); the keyframe database over phase 12's
              final keyframes with the shipped vocabulary, both indexes'
              candidates equal, median ms per add and per query; the DBoW2
              parser on a file of ORBvoc.txt's shape (k 10, L 6), median
              seconds, the Python parser's once, bit-equal to it there and
              at L 4
 18. kernels  one JSON line: per kernel, launches summed over phases 6-17
              (the pyramid, select and describe kernels' one per extraction,
              as K1's), error, times, bound

The last line is {"ok": true, "device": {...}}. Any failed phase exits non-zero
without that line. Without a CUDA device it exits 2 and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
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
# did (tools/profiler_margin.py). Sessions that recorded CUDA activity
# alone still lost one launch now and then (1 of 50 select_fused or
# describe_fused launches, in chip_smoke runs on an H100 with torch 2.11).
# So a session records CPU activity too, brackets the measured calls with a
# short spin kernel at each end (not counted: a launch lost at either edge
# of the window is one of these), and a session that saw too few launches
# is profiled again, PROFILE_TRIES sessions at most; the check holds the
# last.
PROFILE_MARGIN_S = 0.02
PROFILE_TRIES = 3


@functools.lru_cache(maxsize=1)
def _sentinel_keys() -> frozenset:
    """The device events of the bracketing kernel, torch.cuda._sleep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    keys = frozenset(e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    _check(len(keys) == 1, f"torch.cuda._sleep launched device events {sorted(keys)}, want one kernel")
    return keys


def _device_ms(fn, reps: int, kernel, per_call: int | None = None) -> tuple[float, int]:
    """(device milliseconds per fn() call, kernel launches seen) of the kernels
    whose name contains `kernel` (a name or a tuple of names; "" is every
    kernel), summed by torch.profiler over `reps` calls after one warm-up.
    Only events on the device count (not the runtime calls that launched
    them). With `per_call`, the profiler must have seen exactly `per_call`
    such launches per call (a session that saw fewer is profiled again)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    sentinel = _sentinel_keys()
    for session in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.key not in sentinel and any(k in e.key for k in names)]
        n = sum(e.count for e in events)
        us = sum(getattr(e, "self_device_time_total", 0) for e in events)
        if per_call is None or n == per_call * reps or session == PROFILE_TRIES:
            break
        print(f"[profiler] session {session} saw {n} {kernel} launches for {reps} calls of {per_call}: "
              "profiling again", flush=True)
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
    kernels.host_library()  # the host runtime (g++): PNG row filters, map index, inverted file, parser
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


# the pyramid kernel's operations, counted from csrc/pyramid.cu: a fused
# multiply-add (2) per nonzero tap of each pass; per pixel the gain's two sums
# (an add, and a difference, an absolute value and an add) and its rescale
# (3)
PYRAMID_OPS_PER_TAP, PYRAMID_GAIN_OPS_PER_PX = 2, 7
# the extractor held card against CPU in phase 3: TUM1 frames (1000
# features) as in tests/test_torch_kernels_cuda.py, then one frame at each of
# phase 15's EuRoC and KITTI sizes with their settings' feature counts
EXTRACT_FRAMES_640 = (0, 20, 40)
EXTRACT_DATASET_FEATURES = {(752, 480): 1200, (1241, 376): 2000}


def pyramid_ops(h: int, w: int, table, gain: bool) -> int:
    """Operations of one pyramid call: the nonzero taps of both passes of
    every level (the vertical pass runs over the full width), and the gain."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import _resize_weights

    taps = 0
    for hl, wl in table.shapes[1:]:
        taps += int((_resize_weights(h, hl) != 0).sum()) * w + int((_resize_weights(w, wl) != 0).sum()) * hl
    return PYRAMID_OPS_PER_TAP * taps + (PYRAMID_GAIN_OPS_PER_PX * h * w if gain else 0)


def phase_pyramid(torch, dev):
    """The gain and pyramid kernel vs its twin (on the card and on the CPU),
    its times at 640x480, then the whole extractor card vs CPU."""
    from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
    from orbslam2commentedbyxcm_tpu_torch.ops import pyramid_kernel as pk
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, _pyramid_plain, _resize_weights
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    rng = np.random.default_rng(0)
    target = ORBExtractor().exposure_target_mad
    n_checked = 0
    for w, h in ((640, 480),) + K1_DATASET_SIZES + ((1920, 1080),):
        frame = BoxSequence(camera=default_camera(w, h), seed=5, n_frames=100, turns=0.35).render(0)
        for kind, img in (("frame", frame), ("uint8", rng.integers(0, 256, (h, w)))):
            img = torch.from_numpy(img.astype(np.float32))
            for gain in (None, target):
                before = pk.pyramid_resize.launches
                buf, table = ORBExtractor(n_features=1000, normalize_exposure=gain is not None)._pyramid(img.to(dev))
                _check(pk.pyramid_resize.launches == before + 1,
                       f"pyramid_resize {w}x{h} gain {gain}: {pk.pyramid_resize.launches - before} launches for a call")
                for where, ref in (("card", _pyramid_plain(img.to(dev), table, gain)),
                                   ("CPU", _pyramid_plain(img, table, gain))):
                    levels = zip(fk.level_views(buf.cpu(), table), fk.level_views(ref.cpu(), table))
                    for lvl, (a, b) in enumerate(levels):
                        _check(torch.equal(a, b), f"pyramid_resize {w}x{h} {kind} gain {gain} level {lvl}: "
                               f"{int((a != b).sum())} pixels differ from the twin on the {where}")
                n_checked += 1

    # times on the main path's input: a 640x480 frame, gain on
    h, w = 480, 640
    img = torch.from_numpy(BoxSequence(camera=default_camera(w, h), seed=5, n_frames=100,
                                       turns=0.35).render(0).astype(np.float32)).to(dev)
    _, table = ORBExtractor()._pyramid(img)
    gained = lambda: pk.pyramid_resize(img, table, target)  # noqa: E731
    plain = lambda: pk.pyramid_resize(img, table)  # noqa: E731
    call_ms, resize_call_ms = _cuda_ms(gained, 200), _cuda_ms(plain, 200)
    device_ms, _ = _device_ms(gained, 50, "pyramid_fused", per_call=1)
    resize_ms, _ = _device_ms(plain, 50, "pyramid_fused", per_call=1)
    plain_ms = _cuda_ms(lambda: _pyramid_plain(img, table, target), 10)
    mats = [(torch.from_numpy(_resize_weights(h, hl)).to(dev), torch.from_numpy(_resize_weights(w, wl)).to(dev))
            for hl, wl in table.shapes[1:]]
    matmuls = lambda: [wh @ img @ ww.T for wh, ww in mats]  # noqa: E731
    # device kernels only, a whole number per product (the H100 80GB HBM3 ran
    # 28 per call, two per product)
    library_ms, n_events = _device_ms(matmuls, 50, "")
    _check(n_events % (len(mats) * 2 * 50) == 0, f"the 14 products ran {n_events} kernels in 50 calls")
    library_call_ms = _cuda_ms(matmuls, 200)
    n_px = sum(a * b for a, b in table.shapes)
    bound_ms, bound_by = _bound(pyramid_ops(h, w, table, True), 4 * (h * w + n_px))
    resize_bound_ms, _ = _bound(pyramid_ops(h, w, table, False), 4 * (h * w + n_px))
    print(f"[3 pyramid] gain + 8 levels bit-equal to the twin on the card and on the CPU in {n_checked} cases "
          f"(640x480, 752x480, 1241x376, 1920x1080; frame and random; gain on and off) | 640x480 frame, gain on "
          f"(1 launch per extraction): device {device_ms:.4f} ms (torch.profiler), call {call_ms:.4f} ms (CUDA events), "
          f"twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / device_ms:.1f}% of "
          f"device); gain off (1 launch): device {resize_ms:.4f} ms, call {resize_call_ms:.4f} ms, bound "
          f"{resize_bound_ms:.4f} ms | the 14 torch.matmul calls it replaced: device {library_ms:.4f} ms "
          f"({n_events // 50} kernels per call), call {library_call_ms:.4f} ms")

    # the whole extractor, card against CPU, each extracting on its own
    cases = [((640, 480), 1000, i) for i in EXTRACT_FRAMES_640]
    cases += [(size, n, 0) for size, n in EXTRACT_DATASET_FEATURES.items()]
    rows = []
    for (w, h), n_features, i in cases:
        frame = BoxSequence(camera=default_camera(w, h), seed=5, n_frames=100, turns=0.35).render(i)
        ext = ORBExtractor(n_features=n_features, normalize_exposure=True)
        card, cpu = ext(torch.from_numpy(frame).to(dev)), ext(torch.from_numpy(frame))
        for f in card._fields:
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            _check(torch.equal(a, b), f"extractor {w}x{h} frame {i}: {f} differs between the card and the CPU "
                   f"in {int((a != b).reshape(len(a), -1).any(1).sum())} slots")
        n = int(cpu.valid.sum())
        _check(n > 0.5 * n_features, f"extractor {w}x{h} frame {i}: {n} keypoints")
        rows.append(f"{w}x{h} frame {i} ({n_features}): {n} keypoints")
    print("[3 extractor] card vs CPU, gain on, each extracting on its own: every field (uv, response, angle, "
          "level, desc, valid) of every slot bit-equal | " + "; ".join(rows))
    return {"max_abs_err": 0.0, "ms": device_ms, "device_ms": device_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library_call_ms": library_call_ms, "gain_off_device_ms": resize_ms,
            "gain_off_call_ms": resize_call_ms, "gain_off_bound_ms": resize_bound_ms, "kernel_launches_per_call": 1}


# the sizes and feature counts the select and describe kernels are held to
# their twins at in phase 3: TUM1, EuRoC, KITTI, 1080p and 4K frames (4K's
# levels 0 and 1 are ranked by count, the others sorted); the feature counts
# of TUM1, EuRoC and KITTI (2000 is also the mono initializer's doubled
# 1000) and of KITTI's doubled initializer
SELECT_SIZES = ((640, 480), (752, 480), (1241, 376), (1920, 1080), (3840, 2160))
SELECT_FEATURES = (1000, 1200, 2000, 4000)
# operations, counted from csrc/select.cu: per value of a cell, per map
# read and pass, a max and a compare; a ranking of n keys needs n log2 n
# compares of (key, index); from csrc/describe.cu per keypoint: 2 x 961
# moment products and 2 x 1023 tree sums, ~25 for atan2, sqrt and the
# divisions, 8 per rotated endpoint (4 products, 2 sums, 2 roundings) x 512,
# 256 compares
SELECT_OPS_PER_VALUE, DESCRIBE_OPS_PER_KEYPOINT = 2, 3968 + 25 + 8 * 512 + 256


def select_bound(table, maps, budgets, cell_size: int, k: int) -> tuple[float, str]:
    """Bound of one selection on these maps: nms_hi read once inside each
    level's margin (the kernel zeroes the margin), nms_lo only in the cells
    with no nms_hi score (the 20 -> 7 fallback), (px, py, response, valid)
    written once per slot."""
    import torch

    from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import level_views
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import MARGIN

    nbytes, ops, m, cs = 13 * sum(budgets), 0, MARGIN, cell_size
    for (h, w), hi, budget in zip(table.shapes, level_views(maps[1], table), budgets):
        if not budget:
            continue
        cy, cx = -(-h // cs), -(-w // cs)
        inner = torch.zeros((cy * cs, cx * cs), dtype=torch.bool, device=maps.device)
        inner[m : h - m, m : w - m] = True
        scored = torch.zeros_like(inner)
        scored[:h, :w] = hi > 0
        cells = lambda x: x.reshape(cy, cs, cx, cs).sum((1, 3))  # noqa: E731
        n_inner, lo = cells(inner), cells(scored & inner) == 0
        nbytes += 4 * int(n_inner.sum() + n_inner[lo].sum())
        ops += SELECT_OPS_PER_VALUE * k * cs * cs * (cy * cx + int(lo.sum()))
        n = cy * cx * k
        ops += n * max(1, (n - 1).bit_length())
    return _bound(ops, nbytes)


def describe_bound(table, blurred, pxy, budgets) -> tuple[float, str]:
    """Bound of one describe call on these keypoints: the union of the
    pixels their 48 x 48 patches cover (the patches overlap) read once,
    (px, py) read and uv, angle, level and 8 words written once a slot."""
    import torch

    from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import reflect

    dev = blurred.device
    slot_level = torch.repeat_interleave(torch.arange(len(budgets), device=dev),
                                         torch.tensor(list(budgets), device=dev))
    offs = torch.tensor(table.offsets, dtype=torch.int64, device=dev)[slot_level]
    hs = torch.tensor([h for h, _ in table.shapes], dtype=torch.int64, device=dev)[slot_level]
    ws = torch.tensor([w for _, w in table.shapes], dtype=torch.int64, device=dev)[slot_level]
    ar = torch.arange(-24, 24, device=dev)
    rows = reflect(pxy[1].long()[:, None] + ar, hs[:, None])
    cols = reflect(pxy[0].long()[:, None] + ar, ws[:, None])
    covered = torch.zeros(table.total, dtype=torch.bool, device=dev)
    covered[(offs[:, None, None] + rows[:, :, None] * ws[:, None, None] + cols[:, None, :]).reshape(-1)] = True
    n_slots = pxy.shape[1]
    return _bound(DESCRIBE_OPS_PER_KEYPOINT * n_slots, 4 * int(covered.sum()) + n_slots * (8 + 48))


def _select_describe_case(torch, ext, table, maps, tag: str):
    """One select and one describe launch against their twins on the card:
    every slot bit-equal. Returns the select outputs."""
    from orbslam2commentedbyxcm_tpu_torch.ops import describe_kernel as dk
    from orbslam2commentedbyxcm_tpu_torch.ops import select_kernel as sk
    from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import describe_plain
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import select_plain

    before = (sk.select_keypoints.launches, dk.describe_keypoints.launches)
    sel = sk.select_keypoints(maps, table, ext.budgets, ext.cell_size, ext.per_cell_k)
    tables = ext._descriptor_tables(maps.device)
    desc = dk.describe_keypoints(maps[0], table, sel[0], ext.budgets, ext.scales, tables)
    _check((sk.select_keypoints.launches - before[0], dk.describe_keypoints.launches - before[1]) == (1, 1),
           f"select / describe at {tag}: not one launch each per call")
    for name, a, b in zip(("pxy", "response", "valid"), sel,
                          select_plain(maps, table, ext.budgets, ext.cell_size, ext.per_cell_k)):
        _check(torch.equal(a, b), f"select {name} differs from the twin at {tag}: "
               f"{int((a != b).reshape(-1, a.shape[-1]).any(0).sum())} slots")
    for name, a, b in zip(("uv", "angle", "level", "desc"), desc,
                          describe_plain(maps[0], table, sel[0], ext.budgets, ext.scales, tables)):
        _check(torch.equal(a, b), f"describe {name} differs from the twin at {tag}: "
               f"{int((a != b).reshape(len(a), -1).any(1).sum())} slots")
    return sel


def phase_select_describe(torch, dev):
    """The select and describe kernels vs their twins on the card at
    SELECT_SIZES x SELECT_FEATURES and on three hard images, then their
    times per 640x480 extraction (1000 features, gain on: the main path's)."""
    from orbslam2commentedbyxcm_tpu_torch.ops import describe_kernel as dk
    from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
    from orbslam2commentedbyxcm_tpu_torch.ops import select_kernel as sk
    from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import describe_plain
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, select_plain
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    def maps_of(img, n_features):
        ext = ORBExtractor(n_features=n_features, normalize_exposure=True)
        buf, table = ext._pyramid(torch.from_numpy(img.astype(np.float32)).to(dev))
        return ext, table, fk.fused_frontend_pyramid(buf, table, ext.ini_th, ext.min_th)

    rng = np.random.default_rng(0)
    n_cases, valid = 0, {}
    for w, h in SELECT_SIZES:
        frame = BoxSequence(camera=default_camera(w, h), seed=5, n_frames=100, turns=0.35).render(0)
        for n_features in SELECT_FEATURES:
            ext, table, maps = maps_of(frame, n_features)
            sel = _select_describe_case(torch, ext, table, maps, f"{w}x{h}, {n_features} features")
            valid[(w, h, n_features)] = int(sel[2].sum())
            _check(valid[(w, h, n_features)] > 0.5 * min(n_features, 1000), f"select at {w}x{h}: few keypoints")
            n_cases += 1
    hard = {"noise": rng.integers(0, 256, (480, 640)),
            "tile": np.tile(rng.integers(0, 256, (32, 32)), (15, 20)),
            "flat": np.full((480, 640), 7.0)}
    for kind, img in hard.items():
        ext, table, maps = maps_of(img, 1000)
        sel = _select_describe_case(torch, ext, table, maps, f"640x480 {kind}")
        _check((int(sel[2].sum()) == 0) == (kind == "flat"), f"select on the {kind} image: {int(sel[2].sum())} valid")
        n_cases += 1

    frame = BoxSequence(camera=default_camera(640, 480), seed=5, n_frames=100, turns=0.35).render(0)
    ext, table, maps = maps_of(frame, 1000)
    args = (ext.budgets, ext.cell_size, ext.per_cell_k)
    tables = ext._descriptor_tables(dev)
    pxy = sk.select_keypoints(maps, table, *args)[0]
    select = lambda: sk.select_keypoints(maps, table, *args)  # noqa: E731
    describe = lambda: dk.describe_keypoints(maps[0], table, pxy, ext.budgets, ext.scales, tables)  # noqa: E731
    out = {}
    for name, fn, twin, kernel, (bound_ms, bound_by) in (
            ("select", select, lambda: select_plain(maps, table, *args), "select_fused",
             select_bound(table, maps, ext.budgets, ext.cell_size, ext.per_cell_k)),
            ("describe", describe, lambda: describe_plain(maps[0], table, pxy, ext.budgets, ext.scales, tables),
             "describe_fused", describe_bound(table, maps[0], pxy, ext.budgets))):
        call_ms = _cuda_ms(fn, 200)
        device_ms, _ = _device_ms(fn, 50, kernel, per_call=1)
        plain_ms = _cuda_ms(twin, 10)
        out[name] = {"max_abs_err": 0.0, "ms": device_ms, "device_ms": device_ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "kernel_launches_per_call": 1}
    # the whole extraction as the tracker runs it: 4 kernels, no other
    img = torch.from_numpy(frame).to(dev)
    extract_ms, n_kernels = _device_ms(lambda: ext(img), 20, "")
    _check(n_kernels == 4 * 20, f"a 640x480 extraction launched {n_kernels / 20} kernels, want 4 (pyramid, K1, "
           "select, describe)")
    extract_call_ms = _cuda_ms(lambda: ext(img), 50)
    n_px = sum(a * b for a, b in table.shapes)
    print(f"[3 select] select and describe bit-equal to their twins on the card in {n_cases} cases "
          f"({', '.join(f'{w}x{h}' for w, h in SELECT_SIZES)} x {SELECT_FEATURES} features; noise, tile, flat at "
          f"640x480) | per 640x480 extraction ({n_px} px over 8 levels, {ext.capacity} slots, "
          f"{valid[(640, 480, 1000)]} valid), 1 launch each: " + "; ".join(
              f"{name} device {o['device_ms']:.4f} ms (torch.profiler), call {o['call_ms']:.4f} ms (CUDA events), "
              f"twin {o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms ({o['bound_by']}, "
              f"{100 * o['bound_ms'] / o['device_ms']:.1f}% of device)" for name, o in out.items())
          + f" | library: none (no single PyTorch call computes either) | the whole extraction: 4 kernels "
          f"(torch.profiler), device {extract_ms:.4f} ms, call {extract_call_ms:.4f} ms")
    return out["select"], out["describe"]


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
    from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend

    _reset_launches()
    fused_frontend.launches = 0
    seq, out = track_sequence(torch, dev, N_TRACK, timer=_EventTimer(torch))
    launches = _read_launches()
    # frame 0 (the map pack) and frames 1..N are each extracted once
    _check(launches["fused_frontend"] == N_TRACK + 1 and fused_frontend.launches == 0,
           f"K1 launched {launches['fused_frontend']} times (+{fused_frontend.launches} single-level) for "
           f"{N_TRACK + 1} extractions (want 1 per extraction)")
    for name in ("pyramid_resize", "select_keypoints", "describe_keypoints"):
        _check(launches[name] == N_TRACK + 1,
               f"{name} launched {launches[name]} times for {N_TRACK + 1} extractions (want 1 per extraction)")
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
    _reset_launches()
    rows = []  # (i, pose, ms, keyframe inserted, K1 launches, K2 launches, (pyramid, select, describe) launches)
    counters = [c for name, c in zip(LAUNCH_NAMES, _launch_counters())
                if name in ("pyramid_resize", "select_keypoints", "describe_keypoints")]
    for i, (a, b) in enumerate(frames):
        kf_before, k1, k2 = slam.map.next_kf_id, fused_frontend_pyramid.launches, pose_optimization_fused.launches
        others = [c.launches for c in counters]
        timer.start()
        pose = track(a, b, i / 30.0)
        ms = timer.stop()
        rows.append((i, pose, ms, slam.map.next_kf_id > kf_before,
                     fused_frontend_pyramid.launches - k1, pose_optimization_fused.launches - k2,
                     tuple(c.launches - n for c, n in zip(counters, others))))
    launches = _read_launches()
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
    per_frame = 1 if sensor == Sensor.RGBD else 2
    _check(k1_per == {per_frame}, f"{sensor_name}: K1 launches per frame {sorted(k1_per)}")
    others_per = {r[6] for r in rows}
    _check(others_per == {(per_frame,) * 3},
           f"{sensor_name}: (pyramid, select, describe) launches per frame {sorted(others_per)}")
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
          f"{rows[0][2]:.3f} | launches per frame: K1, pyramid, select, describe {per_frame} each, K2 mean "
          f"{statistics.mean(k2_per):.2f} (min {min(k2_per)}, max {max(k2_per)}) | peak device memory "
          f"{peak_mib:.1f} MiB (torch.cuda.max_memory_allocated)")
    return launches


# the kernels of the main path, by their names in the kernels line, in the
# order of _launch_counters()
LAUNCH_NAMES = ("fused_frontend", "pose_optimization_fused", "pyramid_resize", "select_keypoints",
                "describe_keypoints")


def _launch_counters():
    """The wrappers whose `.launches` count the main path's kernel launches:
    K1 (the pyramid launch), K2, the pyramid kernel, select and describe."""
    from orbslam2commentedbyxcm_tpu_torch.ops.describe_kernel import describe_keypoints
    from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend_pyramid
    from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused
    from orbslam2commentedbyxcm_tpu_torch.ops.pyramid_kernel import pyramid_resize
    from orbslam2commentedbyxcm_tpu_torch.ops.select_kernel import select_keypoints

    return fused_frontend_pyramid, pose_optimization_fused, pyramid_resize, select_keypoints, describe_keypoints


def _reset_launches(counts: dict | None = None):
    """Set every kernel's launch count to 0, or to `counts` (a _read_launches
    result)."""
    for name, c in zip(LAUNCH_NAMES, _launch_counters()):
        c.launches = counts[name] if counts else 0


def _read_launches() -> dict:
    return {name: c.launches for name, c in zip(LAUNCH_NAMES, _launch_counters())}


def _add_launches(total: dict, counts: dict) -> None:
    for name in LAUNCH_NAMES:
        total[name] += counts[name]


def _stats(ms):
    return (f"median {statistics.median(ms):.3f} p90 {_percentile(ms, 0.9):.3f} max {max(ms):.3f}"
            if ms else "none")


def _track_timed(track, rows, args, timer):
    """One System call timed with CUDA events, appended to `rows` as (pose,
    ms, K1 launches, K2 launches); returns the pose."""
    k1c, k2c = _launch_counters()[:2]
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
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    _reset_launches()
    rows, kf_new = [], []
    for i, img in enumerate(frames):
        kf_before = slam.map.next_kf_id
        _track_timed(slam.track_monocular, rows, (img, i / 30.0), timer)
        kf_new.append(slam.map.next_kf_id > kf_before)
    launches = _read_launches()

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
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    _reset_launches()
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
    launches = _read_launches()
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
    timer = _EventTimer(torch)
    first = REVISIT + 5
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(first, first + 11)]
    torch.cuda.synchronize()
    _reset_launches()
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
    launches = _read_launches()
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
    timer = _EventTimer(torch)
    torch.cuda.synchronize()
    _reset_launches()
    n_lazy, lazy_rows, lazy_words, lazy_card_s, lazy_cpu_s = _lazy_vocabulary_run(torch, dev, cam, frames[:40], timer)
    k1_lazy = sorted({r[2] for r in lazy_rows})
    _check(k1_lazy == [1], f"lazy vocabulary: K1 launches per frame {k1_lazy}")
    torch.cuda.reset_peak_memory_stats(dev)
    with _timed_calls(torch) as solver_calls:
        slam, rows, kf_new, loops, gba_frames = _loop_run(torch, dev, cam, seq, frames, True, timer)
    loop_frame = loops[0] if loops else None
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    launches = _read_launches()
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
    before = _read_launches()
    off, *_ = _loop_run(torch, dev, cam, seq, frames, False, timer)
    poses_off = _frame_poses(off)
    ate_off, ate_off_to_loop = _ate(poses_off, seq, range(N_LOOP)), _ate(poses_off, seq, range(loop_frame + 1))
    drift_off = _drift(poses_off, seq, *edge)
    del off
    _reset_launches(before)
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
    before = _read_launches()
    pose = _track_timed(fresh.track_rgbd, reloc_rows, (img, depth, 100.0), timer)
    _check(pose is not None, f"loop: frame {LOOP_RELOC_FRAME} not relocalized against the reloaded map")
    pos, rot = pose_errors(pose, seq.pose(LOOP_RELOC_FRAME) @ np.linalg.inv(seq.pose(0)))
    _check(pos <= RELOC_MAX_POS_M and rot <= RELOC_MAX_ROT_DEG,
           f"loop: relocalized pose error {pos:.4f} m / {rot:.4f} deg over {RELOC_MAX_POS_M} m / {RELOC_MAX_ROT_DEG} deg")
    _add_launches(launches, {name: n - before[name] for name, n in _read_launches().items()})

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
    return launches, {"cam": cam, "seq": seq, "frames": frames, "sync": sync, "map": slam.map}

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
    timer = _EventTimer(torch)
    tracer = Tracer()
    slam = System(cam, Sensor.RGBD, config=_loop_config(), vocabulary="bootstrap", async_mapping=True,
                  tracer=tracer, device=dev)
    lc, lm = slam.loop_closing, slam.local_mapping
    workers = (lm, slam._loop_worker)
    torch.cuda.synchronize()
    _reset_launches()
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
    launches = _read_launches()
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
    k1c, k2c = _launch_counters()[:2]
    launches = dict.fromkeys(LAUNCH_NAMES, 0)
    for async_mapping in (False, True):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        tracer = Tracer()
        rec = run_sequence("eight", EIGHT_FRAMES, augment=True, async_mapping=async_mapping, camera=cam,
                           n_features=900, device=dev, images=images, tracer=tracer)
        wall = time.perf_counter() - t0
        _add_launches(launches, _read_launches())
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

    k1c = _launch_counters()[0]
    launches = dict.fromkeys(LAUNCH_NAMES, 0)
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
            _reset_launches()
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = run_dataset.main(argv)
            wall = time.perf_counter() - t1
            run = _read_launches()
            k1, k2 = run["fused_frontend"], run["pose_optimization_fused"]
            _add_launches(launches, run)
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
            records = [r for r in map(json.loads, open(trace)) if r.get("kind") == "frame"]
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
                _reset_launches()
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
                _add_launches(launches, _read_launches())
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
    k2c = _launch_counters()[1]
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
    _reset_launches()
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
    launches = _read_launches()
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


N_INDEX = 100              # phase 17: phase 12's orbit up to its loop (frames 0-99)
N_INDEX_WARM = 20          # each index's untimed warm-up run (frames 0-19)
INDEX_ORDER = ("python", "native", "native", "python")  # the timed runs, in this order
DB_REPEATS = 7             # new databases per index, the order alternated
PARSE_REPEATS = 3          # native parses and imports at ORBvoc.txt's shape
DBOW2_FULL = (10, 6)       # ORBvoc.txt's shape: k = 10, L = 6 (1,111,110 nodes)
DBOW2_CHECK = (10, 4)      # the parsers' bit-equality file (11,110 nodes)
INDEX_SPANS = ("map_index_points", "map_index_observers")


def write_dbow2_text(path, k: int, depth: int, seed: int) -> int:
    """A DBoW2 text vocabulary (TemplatedVocabulary::saveToTextFile's
    layout): a full k-ary tree of `depth` levels in breadth-first order, one
    line per node "parent is_leaf d0 .. d31 weight", descriptors and leaf
    weights (10 significant digits, 0 inside the tree) from `seed`. Integers
    are zero-padded to a fixed width, which loadFromTextFile and int() read
    alike, so numpy writes the whole file in one pass. Returns the node count."""
    rng = np.random.default_rng(seed)
    sizes = [k**lv for lv in range(1, depth + 1)]
    starts = np.cumsum([1] + sizes)  # starts[lv - 1]: the first id of level lv
    n = int(sum(sizes))
    parent = np.concatenate([np.zeros(k, np.int64)] + [
        starts[lv - 2] + np.arange(sizes[lv - 1], dtype=np.int64) // k for lv in range(2, depth + 1)])
    leaf = np.zeros(n, np.int64)
    leaf[-sizes[-1]:] = 1
    desc = rng.integers(0, 256, (n, 32), dtype=np.int64)
    weight = np.where(leaf == 1, rng.integers(0, 10**10, n, dtype=np.int64), 0)  # d.ddddddddd

    def digits(v, width):
        return np.stack([48 + (v // 10**j) % 10 for j in range(width - 1, -1, -1)], axis=-1).astype(np.uint8)

    col = lambda ch: np.full((n, 1), ord(ch), np.uint8)  # noqa: E731
    desc_cols = np.concatenate([np.full((n, 32, 1), 32, np.uint8), digits(desc, 3)], axis=2).reshape(n, 128)
    lines = np.concatenate([digits(parent, 7), col(" "), digits(leaf, 1), desc_cols, col(" "),
                            digits(weight // 10**9, 1), col("."), digits(weight % 10**9, 9), col("\n")], axis=1)
    with open(path, "wb") as f:
        f.write(f"{k} {depth} 0 0\n".encode())
        f.write(lines.tobytes())
    return n


def _index_run(torch, dev, cam, frames, index: str, timer, tracer):
    """System(RGBD, vocabulary="bootstrap", index=`index`, `tracer`) over
    `frames`, synchronous: (System, rows of _track_timed, whether each frame
    made a keyframe, seconds)."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System

    t0 = time.perf_counter()
    slam = System(cam, Sensor.RGBD, config=_loop_config(), vocabulary="bootstrap", tracer=tracer, device=dev,
                  index=index)
    rows, kf_new = [], []
    for i, (img, depth) in enumerate(frames):
        before = slam.map.next_kf_id
        _track_timed(slam.track_rgbd, rows, (img, depth, i / 30.0), timer)
        kf_new.append(slam.map.next_kf_id > before)
    slam.shutdown()
    return slam, rows, kf_new, time.perf_counter() - t0


def _same_map(a, b, what: str) -> None:
    """Hold two Systems' results to the bit: trajectory, keyframes, their
    covisibility (weights and order), spanning tree, observations (each
    point's observers in order, and the map index's observer rows) and
    points_seen_by over every keyframe."""
    ta, tb = a.frame_trajectory(), b.frame_trajectory()
    _check(len(ta) == len(tb) and all(x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(ta, tb)),
           f"{what}: trajectories differ")
    _check(sorted(a.map.keyframes) == sorted(b.map.keyframes), f"{what}: keyframe ids differ")
    for k, kf in a.map.keyframes.items():
        other = b.map.keyframes[k]
        _check(list(kf.covis.items()) == list(other.covis.items()), f"{what}: keyframe {k}'s covisibility differs")
        _check((kf.parent, kf.children, kf.bad) == (other.parent, other.children, other.bad),
               f"{what}: keyframe {k}'s spanning tree differs")
    _check([(p, list(o.items())) for p, o in a.map.obs.items()] == [(p, list(o.items())) for p, o in b.map.obs.items()],
           f"{what}: observations or their order differ")
    pids = np.arange(max(a.map.n_points, b.map.n_points), dtype=np.int64)
    _check(all(np.array_equal(x, y) for x, y in zip(a.map._observer_csr(pids), b.map._observer_csr(pids))),
           f"{what}: the map index's observer rows differ")
    every = sorted(a.map.keyframes)
    _check(np.array_equal(a.map.points_seen_by(every), b.map.points_seen_by(every)),
           f"{what}: points_seen_by(all keyframes) differs")


def _index_ms(records, frames) -> tuple[list, list]:
    """Per frame of `frames`: host ms in points_seen_by + _observer_csr, and
    in update_connections (tracer spans)."""
    q = [1e3 * sum(records[i]["spans"].get(n, 0.0) for n in INDEX_SPANS) for i in frames]
    c = [1e3 * records[i]["spans"].get("map_index_connections", 0.0) for i in frames]
    return q, c


def _database_queries(voc, kfs, world, index: str):
    """Every keyframe of `kfs` into a new KeyFrameDatabase(voc, index), then
    its loop query (its covisible keyframes excluded, the lowest score among
    them the minimum, as LoopClosing asks) and its relocalization query:
    (results, (ms of the first add, median ms of the others), ms per
    query)."""
    from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase

    db = KeyFrameDatabase(voc, index=index)
    add_ms = []
    for kf in kfs:
        t0 = time.perf_counter()
        db.add(kf.kf_id, *kf.bow_vec)
        add_ms.append(1e3 * (time.perf_counter() - t0))
    out = []
    t0 = time.perf_counter()
    for kf in kfs:
        connected = set(kf.covis)
        min_score = min((db.score(kf.kf_id, nb) for nb in connected), default=0.0)
        out.append((min_score, db.detect_loop_candidates(kf.kf_id, *kf.bow_vec, min_score, connected, world),
                    db.detect_relocalization_candidates(*kf.bow_vec, world)))
    return out, (add_ms[0], statistics.median(add_ms[1:])), 1e3 * (time.perf_counter() - t0) / (2 * len(kfs))


def _same_parse(a, b) -> bool:
    return a[:2] == b[:2] and all(x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8))
                                  for x, y in zip(a[2:], b[2:]))


def phase_index(torch, dev, card: str, loop):
    """The host C++ runtime (native/) against its Python twins on the card's
    host, every timing from this one call, each index warmed first and the
    order alternated: (a) phase 12's orbit to its loop, synchronous, with
    index="python" and index="native" (the default) in the order python,
    native, native, python, all four held to the bit, with the index
    queries' host ms from the tracer pooled over each index's two runs; (b)
    the keyframe database over phase 12's final keyframes with the shipped
    785,724-word vocabulary, both indexes' candidates equal, medians over
    DB_REPEATS builds and query passes; (c) the DBoW2 text parser on a file
    of ORBvoc.txt's shape, bit-equal to the Python parser there and on a
    smaller one, medians of PARSE_REPEATS native parses and imports, the
    Python parser once. Returns the first native run's kernel launches."""
    import os
    import tempfile

    from orbslam2commentedbyxcm_tpu_torch import native
    from orbslam2commentedbyxcm_tpu_torch.ops import bow
    from orbslam2commentedbyxcm_tpu_torch.utils import vocab_tools
    from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

    cam, frames = loop["cam"], loop["frames"][:N_INDEX]
    timer = _EventTimer(torch)
    for index in ("python", "native"):  # warm-up, untimed
        _index_run(torch, dev, cam, frames[:N_INDEX_WARM], index, timer, None)
    tracers = {"python": Tracer(), "native": Tracer()}
    runs, launches = [], None
    for index in INDEX_ORDER:
        first_native = index == "native" and launches is None
        if first_native:
            torch.cuda.synchronize()
            _reset_launches()
        runs.append((index, *_index_run(torch, dev, cam, frames, index, timer, tracers[index])))
        if first_native:
            launches = _read_launches()
    ref = next(r for r in runs if r[0] == "native")
    _check(ref[1].map.index == "native" and ref[1].keyframe_db.index == "native", "index: the native run is not native")
    _check(all(r[0] is not None for r in ref[2]), f"index: {sum(r[0] is None for r in ref[2])} frames lost")
    for j, (index, slam, _, kf_new, _) in enumerate(runs):
        _check(slam.map.index == index, f"index: run {j} is not on index {index}")
        _check(kf_new == ref[3], f"index: run {j} ({index}) made keyframes on other frames")
        if slam is not ref[1]:
            _same_map(ref[1], slam, f"index: run {j} ({index}) against the first native run")
    kf_new = ref[3]
    plain = [i for i in range(1, N_INDEX) if not kf_new[i]]
    kfs = [i for i in range(1, N_INDEX) if kf_new[i]]
    parts = []
    for tag in ("python", "native"):
        tracer = tracers[tag]
        rec, spans = tracer.frame_records(), tracer.stats()["spans"]
        _check(len(rec) == 2 * N_INDEX, f"index: {len(rec)} tracer frames on {tag}")
        rows = [row for r in runs if r[0] == tag for row in r[2]]
        both = lambda fr: [r * N_INDEX + i for r in (0, 1) for i in fr]  # noqa: E731
        q_plain, _ = _index_ms(rec, both(plain))
        q_kf, c_kf = _index_ms(rec, both(kfs))
        calls = "; ".join(f"{name} {spans[span]['n']} calls, p50 {spans[span]['p50_ms']:.4f} mean "
                          f"{spans[span]['mean_ms']:.4f}" for name, span in (
                              ("points_seen_by", "map_index_points"), ("_observer_csr", "map_index_observers"),
                              ("update_connections", "map_index_connections")))
        parts.append(f"{tag}: frame ms ordinary (2 x {len(plain)}) {_stats([rows[i][1] for i in both(plain)])}, "
                     f"keyframe (2 x {len(kfs)}) {_stats([rows[i][1] for i in both(kfs)])}; points_seen_by + "
                     f"_observer_csr host ms per ordinary frame {_stats(q_plain)}, per keyframe frame "
                     f"{_stats(q_kf)}; update_connections host ms per keyframe frame {_stats(c_kf)}; host ms per "
                     f"call: {calls}")
    print(f"[17 index] {card} | phase 12's orbit frames 0-{N_INDEX - 1}, System(RGBD, vocabulary=bootstrap, "
          f"tracer, device={dev}), each index warmed on frames 0-{N_INDEX_WARM - 1}, then runs "
          + ", ".join(f"{r[0]} {r[4]:.1f} s" for r in runs)
          + f": trajectories, keyframes ({len(ref[1].map.keyframes)}), covisibility, spanning tree, observations "
          f"(order included) and points_seen_by(all keyframes) bit-equal; {len(ref[1].map.good_keyframes())} good "
          f"keyframes, {ref[1].map.n_valid_points()} points | " + " | ".join(parts))
    del runs, ref

    # (b) the keyframe database over phase 12's final keyframes
    world = loop["map"]
    voc = bow.bootstrap_vocabulary()
    kf_list = sorted((kf for kf in world.good_keyframes() if kf.bow_vec is not None), key=lambda k: k.kf_id)
    _check(len(kf_list) >= 20, f"database: {len(kf_list)} keyframes with BoW vectors in phase 12's map")
    res = {index: _database_queries(voc, kf_list, world, index)[0] for index in ("python", "native")}  # warm-up
    _check(res["native"] == res["python"], "database: the native index's candidates or minimum scores differ")
    first_ms, add_ms, q_ms = ({"python": [], "native": []} for _ in range(3))
    for rep in range(DB_REPEATS):
        for index in (("python", "native") if rep % 2 == 0 else ("native", "python")):
            got, (a0, a), q = _database_queries(voc, kf_list, world, index)
            _check(got == res["python"], f"database: repeat {rep} on {index} differs")
            first_ms[index].append(a0)
            add_ms[index].append(a)
            q_ms[index].append(q)
    n_loop = sum(len(r[1]) for r in res["native"])
    n_reloc = sum(len(r[2]) for r in res["native"])
    _check(n_reloc >= len(kf_list), f"database: {n_reloc} relocalization candidates for {len(kf_list)} queries")
    med = lambda xs: f"{statistics.median(xs):.4f} [{min(xs):.4f}-{max(xs):.4f}]"  # noqa: E731
    print(f"[17 database] {card} | KeyFrameDatabase over phase 12's {len(kf_list)} final keyframes, "
          f"vocabulary bootstrap ({voc.n_words} words, {sum(len(k.bow_vec[0]) for k in kf_list)} postings): "
          f"detect_loop_candidates and detect_relocalization_candidates of every keyframe equal on both indexes "
          f"({n_loop} loop, {n_reloc} relocalization candidates), minimum scores bit-equal | host ms, median "
          f"[min-max] of {DB_REPEATS} new databases per index after one warm-up each, order alternated: per query "
          f"(the group stage included) python {med(q_ms['python'])}, native {med(q_ms['native'])}; add: a new "
          f"database's first python {med(first_ms['python'])}, native {med(first_ms['native'])}, the median of "
          f"the other {len(kf_list) - 1} python {med(add_ms['python'])}, native {med(add_ms['native'])}")

    # (c) the DBoW2 text parser
    with tempfile.TemporaryDirectory() as tmp:
        small = os.path.join(tmp, "check.txt")
        write_dbow2_text(small, *DBOW2_CHECK, seed=1)
        got = native.parse_dbow2_text(small)
        _check(_same_parse(got, vocab_tools._parse_dbow2_text_py(small)),
               "parser: the native parse differs from the Python parser's")
        full = os.path.join(tmp, "orbvoc_shape.txt")
        t0 = time.perf_counter()
        n_nodes = write_dbow2_text(full, *DBOW2_FULL, seed=0)
        write_s = time.perf_counter() - t0
        mib = os.path.getsize(full) / 2**20
        parse_s, import_s = [], []
        for _ in range(PARSE_REPEATS):
            t0 = time.perf_counter()
            parsed = native.parse_dbow2_text(full)
            parse_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            imported = vocab_tools.import_dbow2_text(full)
            import_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        py_parsed = vocab_tools._parse_dbow2_text_py(full)
        py_s = time.perf_counter() - t0
    _check(len(parsed[2]) == n_nodes and imported.n_words == DBOW2_FULL[0] ** DBOW2_FULL[1],
           f"parser: {len(parsed[2])} nodes, {imported.n_words} words")
    _check(_same_parse(parsed, py_parsed), "parser: the native parse differs from the Python parser's at full size")
    med_s = lambda xs: f"{statistics.median(xs):.3f} s [{min(xs):.3f}-{max(xs):.3f}]"  # noqa: E731
    print(f"[17 parser] {card} | DBoW2 text at ORBvoc.txt's shape (k {DBOW2_FULL[0]}, L {DBOW2_FULL[1]}, {n_nodes} "
          f"nodes, {mib:.1f} MiB, written in {write_s:.1f} s), median [min-max] of {PARSE_REPEATS}, each "
          f"parse before its import: native.parse_dbow2_text {med_s(parse_s)}, import_dbow2_text "
          f"{med_s(import_s)} ({imported.n_words} words); the Python parser once {py_s:.3f} s | bit-equal to the "
          f"Python parser there and on k {DBOW2_CHECK[0]}, L {DBOW2_CHECK[1]} ({len(got[2])} nodes)")
    _reset_launches(launches)
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
    pyramid = timed("3 pyramid", phase_pyramid, torch, dev)
    select, describe = timed("3 select", phase_select_describe, torch, dev)
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
             timed(16, phase_mesh, torch, dev, card, loop, k2), timed(17, phase_index, torch, dev, card, loop)]
    launches = {name: sum(r[name] for r in runs) for name in runs[0]}
    for r in runs:
        _check(all(r.values()), f"a kernel of the main path was never launched: {r}")
        # one pyramid, select and describe launch per K1 launch: each runs once per extraction
        for name in ("pyramid_resize", "select_keypoints", "describe_keypoints"):
            _check(r[name] == r["fused_frontend"], f"not one {name} launch per K1 launch: {r}")
    kernels = [
        {"name": "fused_frontend", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/frontend.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/pallas_frontend.py:141",
         "launches": launches["fused_frontend"], **k1},
        {"name": "pose_optimization_fused", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/poseopt.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/pallas_poseopt.py:300",
         "launches": launches["pose_optimization_fused"], **k2},
        {"name": "pyramid_resize", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/pyramid.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/orb.py:337-339",
         "launches": launches["pyramid_resize"], **pyramid},
        {"name": "select_keypoints", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/select.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/orb.py:370-441",
         "launches": launches["select_keypoints"], **select},
        {"name": "describe_keypoints", "route": "cuda",
         "source": "orbslam2commentedbyxcm_tpu_torch/csrc/describe.cu",
         "replaces": "orbslam2commentedbyxcm_tpu/ops/descriptors.py:40-134",
         "launches": launches["describe_keypoints"], **describe},
    ]
    print(f"[18 total] {time.perf_counter() - t0:.1f} s; by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    print(json.dumps({"kernels": kernels}))
    print(_ok_line(torch))
    return 0


def _ok_line(torch) -> str:
    """The last line of a run whose every phase passed."""
    return json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
