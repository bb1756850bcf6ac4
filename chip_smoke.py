#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from orbslam2commentedbyxcm_tpu_torch/csrc,
checks each against its plain torch twin on the card, and drives the port the
way a user would: the per-frame tracking step, then the System's synchronous
RGB-D, stereo and monocular SLAM, relocalization with the shipped vocabulary
and localization mode. Phases, each printing one line:

  1. device   the card's name and power limit (nvidia-smi), TF32 flags
  2. build    nvcc build of both kernels (one nvcc per source, in parallel), seconds
  3. K1       one launch of the fused frontend over the 8-level pyramid of a
              640x480 frame vs the twin, level by level (bit-equal), and each
              level alone; device time (torch.profiler), call time (CUDA
              events) of one pyramid launch and of 8 single-level launches,
              twin time, bound
  4. K2       pose-optimization kernel vs twin, N=1000, stereo 0 / 0.5 / 1;
              device and call time at N=1000 and 2000, the latency floor
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
 12. kernels  one JSON line: per kernel, launches summed over phases 6-11,
              error, times, bound

The last line is {"ok": true, "device": {...}}. Any failed phase exits non-zero
without that line. Without a CUDA device it exits 2 and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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


def _device_ms(fn, reps: int, kernel: str) -> tuple[float, int]:
    """(device milliseconds per fn() call, kernel launches seen) of the kernels
    whose name contains `kernel`, summed by torch.profiler over `reps` calls
    after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in events)
    us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    _check(n > 0 and us > 0, f"torch.profiler recorded no device time for {kernel}")
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


def phase_build():
    from orbslam2commentedbyxcm_tpu_torch import kernels

    kernels.library()
    info = kernels.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    print(f"[2 build] nvcc {'built' if info['built'] else 'cached'} {Path(info['path']).name} "
          f"in {info['seconds']:.3f} s | " + " ; ".join(ptxas))


def phase_k1(torch, dev):
    """Frontend kernel vs twin on the 8 pyramid levels of a 640x480 frame,
    built as the extractor builds them (one flat buffer, one launch)."""
    from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    seq = BoxSequence(camera=default_camera(), seed=5, n_frames=100, turns=0.35)
    img = torch.from_numpy(seq.render(0)).to(dev)
    ext = ORBExtractor(n_features=1000)
    th_hi, th_lo = ext.ini_th, ext.min_th
    buf, table = ext._pyramid(img)
    levels = fk.level_views(buf, table)
    out = fk.fused_frontend_pyramid(buf, table, th_hi, th_lo)
    singles = [fk.fused_frontend(lv, th_hi, th_lo) for lv in levels]
    refs = [fk.fused_frontend_plain(lv, th_hi, th_lo) for lv in levels]
    torch.cuda.synchronize()
    n_corners = 0
    for lvl, ref in enumerate(refs):
        for name, pyr, one, b in zip(("blur", "nms_hi", "nms_lo"), (fk.level_views(o, table)[lvl] for o in out),
                                     singles[lvl], ref):
            _check(torch.equal(pyr, b), f"K1 pyramid {name} differs from the twin at level {lvl} "
                   f"{tuple(b.shape)}: {int((pyr != b).sum())} pixels")
            _check(torch.equal(one, b), f"K1 single-level {name} differs from the twin at level {lvl}")
        n_corners += int((ref[1] > 0).sum())
    _check(n_corners > 100, f"K1 found only {n_corners} corners")

    def pyramid():
        fk.fused_frontend_pyramid(buf, table, th_hi, th_lo)

    def per_level():
        for lv in levels:
            fk.fused_frontend(lv, th_hi, th_lo)

    call_ms = _cuda_ms(pyramid, 200)
    device_ms, n_dev = _device_ms(pyramid, 50, "frontend_kernel")
    _check(n_dev == 50, f"K1: {n_dev} kernels profiled for 50 pyramid calls")
    level_call_ms = _cuda_ms(per_level, 200)
    level_device_ms, _ = _device_ms(per_level, 50, "frontend_kernel")
    plain_ms = _cuda_ms(lambda: [fk.fused_frontend_plain(lv, th_hi, th_lo) for lv in levels], 20)
    n_px = sum(lv.numel() for lv in levels)
    bound_ms, bound_by = _bound(k1_ops(levels, min(th_hi, th_lo)), 16 * n_px)
    print(f"[3 K1] 8 levels {list(table.shapes)} ({n_px} px) "
          f"in one launch: blur and both score maps bit-equal to the twin, so is each level alone; "
          f"{n_corners} hi corners | per extraction: device {device_ms:.4f} ms (torch.profiler), call "
          f"{call_ms:.4f} ms (CUDA events); as 8 single-level launches device {level_device_ms:.4f} ms, "
          f"call {level_call_ms:.4f} ms; twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": 0.0, "ms": device_ms, "device_ms": device_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per_level_device_ms": level_device_ms, "per_level_call_ms": level_call_ms}


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


def phase_k2(torch, dev):
    """Pose kernel vs twin on the card, N=1000 edges; times at N=1000 and
    2000 and the latency floor at N=32."""
    from orbslam2commentedbyxcm_tpu_torch.ops.optim import pose_optimization, pose_optimization_plain
    from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused

    cam = (FX, FY, CX, CY, BF)

    def problem(n, frac):
        t0, pts, obs, mask, t_true = make_pose_problem(np.random.default_rng(0), n, frac)
        return [torch.from_numpy(a).to(dev) for a in (t0, pts, obs, mask, np.ones(n, np.float32))], t_true

    n = 1000
    worst = {"pose": 0.0, "flips": 0, "dn": 0}
    for frac in (0.0, 0.5, 1.0):
        args, t_true = problem(n, frac)
        rk = pose_optimization(*args, *cam)
        rp = pose_optimization_plain(*args, *cam)
        tk, tp = rk.t_cw.cpu().numpy(), rp.t_cw.cpu().numpy()
        _check(np.abs(tk - t_true).max() < 5e-3, f"K2 pose off truth by {np.abs(tk - t_true).max()} (stereo {frac})")
        _check(np.abs(tp - t_true).max() < 5e-3, f"twin pose off truth by {np.abs(tp - t_true).max()} (stereo {frac})")
        d_pose = float(np.abs(tk - tp).max())
        flips = int((rk.inliers != rp.inliers).sum())
        dn = abs(int(rk.n_inliers) - int(rp.n_inliers))
        _check(d_pose < 2e-3, f"K2 vs twin pose {d_pose} (stereo {frac})")
        _check(flips <= max(3, n // 100), f"K2 vs twin {flips} inlier flips (stereo {frac})")
        _check(dn <= 3, f"K2 vs twin n_inliers differ by {dn} (stereo {frac})")
        _check(int(rk.n_inliers) == int(rk.inliers.sum()), "K2 n_inliers disagrees with its mask")
        worst = {"pose": max(worst["pose"], d_pose), "flips": max(worst["flips"], flips),
                 "dn": max(worst["dn"], dn)}
    times = {}
    for size in (1000, 2000, 32):
        args, _ = problem(size, 0.5)
        pose_optimization(*args, *cam)
        work = pose_optimization_fused.last_counts.tolist()[1:]
        times[size] = {
            "call_ms": _cuda_ms(lambda: pose_optimization(*args, *cam), 200),
            "device_ms": _device_ms(lambda: pose_optimization(*args, *cam), 50, "pose_opt_kernel")[0],
            "bound": k2_bound(work, int(args[3].sum()), size), "evaluations": work[0],
        }
        if size == n:
            plain_ms = _cuda_ms(lambda: pose_optimization_plain(*args, *cam), 5)
    t = times[n]
    print(f"[4 K2] N={n} stereo 0/0.5/1: max|pose d|={worst['pose']:.3g}, inlier flips <= {worst['flips']}, "
          f"|d n_inliers| <= {worst['dn']} | stereo 0.5, per solve: " + "; ".join(
              f"N={k} device {v['device_ms']:.4f} ms (torch.profiler), call {v['call_ms']:.4f} ms (CUDA events), "
              f"{v['evaluations']} evaluations, bound {v['bound'][0]:.6f} ms ({v['bound'][1]})"
              for k, v in times.items()) + f"; twin {plain_ms:.4f} ms (N={n})")
    return {"max_abs_err": worst["pose"], "ms": t["device_ms"], "device_ms": t["device_ms"],
            "call_ms": t["call_ms"], "plain_ms": plain_ms, "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None,
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
    phase_device(torch)
    phase_build()
    k1 = phase_k1(torch, dev)
    k2 = phase_k2(torch, dev)
    phase_flagship(torch, dev)
    runs = [phase_tracking(torch, dev, k1, k2),
            phase_slam(torch, dev, "RGBD", N_RGBD, JAX_ATE_RGBD, 7),
            phase_slam(torch, dev, "STEREO", N_STEREO, JAX_ATE_STEREO, 8),
            phase_mono(torch, dev)]
    reloc_launches, slam, seq = phase_reloc(torch, dev)
    runs += [reloc_launches, phase_localization(torch, dev, slam, seq)]
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
    print(f"[12 total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
