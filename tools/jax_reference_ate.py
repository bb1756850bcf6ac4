"""The JAX package's ATE on the CPU over chip_smoke.py's SLAM runs: the
references behind chip_smoke's JAX_ATE_RGBD, JAX_ATE_STEREO and JAX_ATE_MONO
(each port bound is 1.5 x that + 1 cm).

    python3 tools/jax_reference_ate.py mono      # ~75 s on 2 CPU threads
    python3 tools/jax_reference_ate.py rgbd stereo

Runs the JAX System (no loop closing, no lazy vocabulary trainer) at 640x480
with default_camera(640, 480), 1000 features and chip_smoke's keyframe
policy: RGB-D over BoxSequence seed 5 frames 0-59 (SE3 alignment), stereo over
rounded pairs 0-29 (SE3), mono over SyntheticSequence("sideways") frames 0-59
(Sim3). Needs the JAX package; the port is not imported.
"""

import os
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam2commentedbyxcm_tpu.models import system as jsystem  # noqa: E402
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig  # noqa: E402
from orbslam2commentedbyxcm_tpu.utils.evaluation import ate_rmse, positions_from_tcw  # noqa: E402
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence, SyntheticSequence, default_camera  # noqa: E402

RUNS = {"rgbd": 60, "stereo": 30, "mono": 60}


def run(which: str):
    cam = default_camera(640, 480)
    n = RUNS[which]
    sensor = {"rgbd": jsystem.Sensor.RGBD, "stereo": jsystem.Sensor.STEREO, "mono": jsystem.Sensor.MONOCULAR}[which]
    if which == "mono":
        seq = SyntheticSequence(camera=cam, n_frames=n, trajectory="sideways")
    else:
        seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    s = jsystem.System(cam, sensor, config=TrackingConfig(max_frames_between_kf=8, kf_tracked_ratio=0.95),
                       enable_loop_closing=False)
    s.local_mapping.loop_closer = None
    t0 = time.perf_counter()
    est, gt = [], []
    for i in range(n):
        if which == "rgbd":
            p = s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
        elif which == "stereo":
            p = s.track_stereo(np.round(seq.render(i)), np.round(seq.render_right(i)), i / 30.0)
        else:
            p = s.track_monocular(seq.render(i), i / 30.0)
        if p is not None:
            est.append(p)
            gt.append(seq.pose(i))
    ate = ate_rmse(positions_from_tcw(np.stack(est)), positions_from_tcw(np.stack(gt)), with_scale=which == "mono")
    print(f"{which}: JAX CPU {len(est)}/{n} tracked, ATE {ate:.6f} m ({'Sim3' if which == 'mono' else 'SE3'}), "
          f"{len(s.map.good_keyframes())} keyframes, {s.map.n_valid_points()} points, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    for which in sys.argv[1:] or ["mono"]:
        run(which)
