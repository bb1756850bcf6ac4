"""End-to-end loop closing in the port, on tests/test_e2e_loop.py's fixture:
a 320x240 RGB-D orbit inside a textured box, 130 frames, 1.3 turns, with
the JAX package's defaults (loop closing on, the vocabulary trained from the
map after 5 keyframes). Returning past a full turn must detect and close the
loop, and the loop-corrected frame trajectory must hold the JAX test's
ATE bar (0.12 m). System-level, so marked slow as its JAX counterpart is."""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

torch.set_num_threads(1)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def loop_run():
    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0, th_depth=50.0)
    seq = BoxSequence(camera=cam, n_frames=130, turns=1.3)
    cfg = TrackingConfig(n_features=600, max_frames_between_kf=4, kf_tracked_ratio=0.95, motion_search_radius=20.0)
    system = System(cam, Sensor.RGBD, config=cfg, device="cpu")
    results = [system.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) for i in range(seq.n_frames)]
    system.shutdown()
    return seq, system, results


def test_loop_is_closed(loop_run):
    seq, system, results = loop_run
    assert sum(p is not None for p in results) == seq.n_frames
    assert system.loop_closing is not None and system.loop_closing.n_loops_closed >= 1, system.loop_closing.stats
    assert system.loop_closing.gba.n_completed >= 1
    assert sum(len(kf.loop_edges) for kf in system.map.good_keyframes()) >= 1


def test_loop_corrected_trajectory_accuracy(loop_run):
    seq, system, _ = loop_run
    traj = system.frame_trajectory()
    est = np.stack([t for _, t in traj])
    gt = np.stack([seq.pose(int(round(ts * 30))) for ts, _ in traj])
    ate = ate_rmse(positions_from_tcw(est), positions_from_tcw(gt), with_scale=False)
    assert ate < 0.12, f"ATE {ate:.3f} m"
