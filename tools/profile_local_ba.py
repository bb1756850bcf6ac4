"""Where one local BA solve of the port spends its time on a CUDA GPU, and
the extraction time of one 640x480 frame.

    python3 tools/profile_local_ba.py    # from the repository root, one GPU

Tracks 33 RGB-D frames of the chip_smoke scene, assembles the local BA
problem of the newest keyframe, times three solves, the dense reduced-system
solve alone, one solve under torch.profiler, and the ORB extractor.
"""

import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam2commentedbyxcm_tpu_torch.models import local_mapping as lm  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera  # noqa: E402

DEV = torch.device("cuda", 0)


def host_ms(fn, reps):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    s = System(cam, Sensor.RGBD, config=TrackingConfig(max_frames_between_kf=8, kf_tracked_ratio=0.95),
               enable_loop_closing=False, device=DEV)
    for i in range(33):
        s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30)
    m = s.map
    kf = m.keyframes[max(m.keyframes)]
    problem = lm.assemble_ba_problem(m, [kf.kf_id] + kf.best_covisible())
    print(f"problem: poses {len(problem['poses'])} (fixed {int(problem['pose_fixed'].sum())}), "
          f"points {len(problem['pids'])}, edges {len(problem['op'])}")
    for _ in range(3):
        print(f"solve {host_ms(lambda: lm.solve_ba_problem(problem, cam, DEV), 1):.3f} ms")

    # the dense reduced camera system alone, at this problem's size
    n6 = 6 * len(problem["poses"])
    a = torch.randn(n6, n6, device=DEV)
    a = a @ a.T + n6 * torch.eye(n6, device=DEV)
    b = torch.randn(n6, device=DEV)
    for name, fn in (("linalg.solve", lambda: torch.linalg.solve(a, b)),
                     ("cholesky", lambda: torch.cholesky_solve(b[:, None], torch.linalg.cholesky(a)))):
        fn()
        print(f"{name} {n6}x{n6}: {host_ms(fn, 20):.4f} ms per call")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        lm.solve_ba_problem(problem, cam, DEV)
        torch.cuda.synchronize()
        w = time.perf_counter() - t
    ka = prof.key_averages()
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in ka) / 1e3
    n_launch = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"profiled solve: wall {1e3 * w:.3f} ms, device {dev_ms:.3f} ms, launches {n_launch}")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"  cpu {e.key[:55]:55s} self {e.self_cpu_time_total / 1e3:9.3f} ms n={e.count}")
    for e in sorted(ka, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]:
        print(f"  dev {e.key[:55]:55s} {getattr(e, 'self_device_time_total', 0) / 1e3:9.3f} ms n={e.count}")

    img = torch.from_numpy(seq.render(40)).to(DEV)
    for _ in range(3):
        s.extractor(img)
    print(f"extraction 640x480: {host_ms(lambda: s.extractor(img), 20):.3f} ms per frame")


if __name__ == "__main__":
    main()
