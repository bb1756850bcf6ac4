"""Per-stage time of the port's System on a CUDA GPU: RGB-D SLAM (60 frames)
and stereo SLAM (30 frames) of the chip_smoke scene, then torch.profiler over
eight frames of each, then the Hamming search against the XOR + SWAR
popcount formulation it replaced.

    python3 tools/profile_system.py      # from the repository root, one GPU

Each stage's time is host wall time between two device synchronizations
around the wrapped function, so nested stages overlap (local_bundle_adjustment
holds assemble_ba_problem, solve_ba_problem and write_back_ba). The first
call of a stage also pays the lazy CUDA library set-up, so the per-call
median is the steady figure and the max holds that set-up.
"""

import collections
import functools
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam2commentedbyxcm_tpu_torch.models import local_mapping as lm_mod  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.models import system as sys_mod  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.models import tracking as tr_mod  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops import matching  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera  # noqa: E402

DEV = torch.device("cuda", 0)
CFG = dict(max_frames_between_kf=8, kf_tracked_ratio=0.95)
per_call_s = collections.defaultdict(list)


def timed(owner, name):
    orig = getattr(owner, name)

    @functools.wraps(orig)
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        per_call_s[name].append(time.perf_counter() - t)
        return out

    setattr(owner, name, wrapper)


def device_ms(events):
    return sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3


def launches(events):
    return sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


def profile_sensor(cam, seq, sensor, n):
    if sensor == "RGBD":
        frames = [(seq.render(i), seq.depth_map(i)) for i in range(n)]
    else:
        frames = [(np.round(seq.render(i)), np.round(seq.render_right(i))) for i in range(n)]

    def new_system():
        s = System(cam, Sensor[sensor], config=TrackingConfig(**CFG), enable_loop_closing=False, device=DEV)
        return s, (s.track_rgbd if sensor == "RGBD" else s.track_stereo)

    per_call_s.clear()
    _, track = new_system()
    wall = []
    for i, (a, b) in enumerate(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        track(a, b, i / 30)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
    print(f"{sensor}: {n} frames, wall {sum(wall):.4f} s, median {1e3 * statistics.median(wall):.3f} ms")
    for k, ts in sorted(per_call_s.items(), key=lambda kv: -sum(kv[1])):
        print(f"  {k:28s} calls {len(ts):3d} total ms {1e3 * sum(ts):9.3f} per call median "
              f"{1e3 * statistics.median(ts):8.3f} max {1e3 * max(ts):8.3f}")

    # torch.profiler over frames 10-17 of a second run
    s, track = new_system()
    for i in range(10):
        track(*frames[i], i / 30)
    kf0 = s.map.next_kf_id
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(10, 18):
            track(*frames[i], i / 30)
        torch.cuda.synchronize()
        w = time.perf_counter() - t
    ka = prof.key_averages()
    print(f"  profiler, frames 10-17 ({s.map.next_kf_id - kf0} keyframes among them): per frame wall "
          f"{1e3 * w / 8:.3f} ms, device {device_ms(ka) / 8:.3f} ms, launches {launches(ka) / 8:.0f}")
    for e in sorted(ka, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]:
        print(f"    {e.key[:60]:60s} {getattr(e, 'self_device_time_total', 0) / 1e3:9.3f} ms  n={e.count}")


def swar_hamming(a, b):
    """XOR + SWAR popcount Hamming distances, (Na, 8) x (Nb, 8) int32."""
    x = (a[:, None, :] ^ b[None, :, :]).contiguous().view(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dim=-1, dtype=torch.int32).float()


def event_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name in ("cull_map_points", "create_new_map_points", "fuse_neighbors",
                 "local_bundle_adjustment", "cull_keyframes"):
        timed(lm_mod.LocalMapping, name)
    for name in ("assemble_ba_problem", "solve_ba_problem", "write_back_ba"):
        timed(lm_mod, name)
    for name in ("_track_fused", "_track_with_motion_model", "_track_reference_keyframe",
                 "_track_local_map", "_create_new_keyframe", "_local_keyframes"):
        timed(tr_mod.Tracking, name)
    for name in ("_make_frame", "_attach_depth"):
        timed(sys_mod.System, name)
    timed(sys_mod, "stereo_match_frame")

    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    profile_sensor(cam, seq, "RGBD", 60)
    profile_sensor(cam, seq, "STEREO", 30)

    g = torch.Generator().manual_seed(0)
    a = torch.randint(-2**31, 2**31 - 1, (4096, 8), dtype=torch.int32, generator=g).to(DEV)
    b = torch.randint(-2**31, 2**31 - 1, (1000, 8), dtype=torch.int32, generator=g).to(DEV)
    assert torch.equal(swar_hamming(a, b), matching.hamming_matrix(a, b))
    for order in ("swar", "matmul", "matmul", "swar"):
        fn = (lambda: swar_hamming(a, b)) if order == "swar" else (lambda: matching.hamming_matrix(a, b))
        print(f"hamming 4096x1000 {order}: {event_ms(fn):.4f} ms")


if __name__ == "__main__":
    main()
