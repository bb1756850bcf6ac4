"""The slice as a whole: the port's System against the JAX package's on
synchronous RGB-D and stereo SLAM without place recognition.

Both run BoxSequence seed 5 at 320x240 with 600 features and a keyframe at
least every 6 frames: RGB-D for 30 frames, stereo for 20 (images rounded to
integers, as 8-bit data are; see test_torch_stereo). The JAX System is
`System(cam, sensor, enable_loop_closing=False)` with its lazy vocabulary
trainer removed, the configuration this slice ports.

Each package runs its own extractor, and the extractors differ by ulps at
pyramid levels >= 1 (test_torch_orb), so the two runs drift apart and are
held to the same accuracy class, not to equal numbers: both track at least
N - 1 frames, the port's ATE (SE3 alignment) is at most 1.5 x the JAX ATE
+ 1 cm, keyframe counts agree within 1, valid map points within 15%."""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models import system as jsystem
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.evaluation import ate_rmse as j_ate_rmse
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig as TConfig
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
CFG = dict(n_features=600, max_frames_between_kf=6)
N_FRAMES = {"RGBD": 30, "STEREO": 20}


def _run(system, sensor, seq, n):
    est, gt = [], []
    for i in range(n):
        img = seq.render(i)
        if sensor == "RGBD":
            pose = system.track_rgbd(img, seq.depth_map(i), i / 30.0)
        else:
            pose = system.track_stereo(np.round(img), np.round(seq.render_right(i)), i / 30.0)
        if pose is not None:
            assert pose.shape == (4, 4) and pose.dtype == np.float32 and np.isfinite(pose).all()
            est.append(pose)
            gt.append(seq.pose(i))
    ate = ate_rmse(positions_from_tcw(np.stack(est)), positions_from_tcw(np.stack(gt)), with_scale=False)
    return len(est), ate


@pytest.mark.parametrize("sensor", ["RGBD", "STEREO"])
def test_system_matches_jax(sensor, tmp_path):
    n = N_FRAMES[sensor]
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    jsys = jsystem.System(CAM, jsystem.Sensor[sensor], config=JConfig(**CFG), enable_loop_closing=False)
    jsys.local_mapping.loop_closer = None
    tsys = tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor[sensor], config=TConfig(**CFG),
                          enable_loop_closing=False, device="cpu")
    j_tracked, j_ate = _run(jsys, sensor, seq, n)
    t_tracked, t_ate = _run(tsys, sensor, seq, n)
    j_kfs, t_kfs = len(jsys.map.good_keyframes()), len(tsys.map.good_keyframes())
    j_pts, t_pts = jsys.map.n_valid_points(), tsys.map.n_valid_points()
    print(f"{sensor}: JAX {j_tracked}/{n} tracked, ATE {j_ate:.4f} m, {j_kfs} keyframes, {j_pts} points | "
          f"port {t_tracked}/{n}, ATE {t_ate:.4f} m, {t_kfs} keyframes, {t_pts} points, "
          f"{tsys.local_mapping.n_local_ba} local BAs")
    assert j_tracked >= n - 1 and t_tracked >= n - 1
    assert t_ate <= 1.5 * j_ate + 0.01
    assert abs(t_kfs - j_kfs) <= 1 and t_kfs >= 3
    assert abs(t_pts - j_pts) <= 0.15 * j_pts
    assert tsys.local_mapping.n_local_ba >= t_kfs - 2  # every keyframe after the first
    assert tsys.get_tracking_state() == tsystem.TrackingState.OK

    # the TUM trajectory file (frame poses re-expressed through the
    # BA-corrected reference keyframes): written, read back, same cameras
    path = tmp_path / "traj.txt"
    tsys.save_trajectory_tum(str(path))
    rows = np.loadtxt(path)
    traj = tsys.frame_trajectory()
    assert rows.shape == (t_tracked, 8)
    np.testing.assert_allclose(rows[:, 0], [ts for ts, _ in traj], atol=1e-6)
    centers = positions_from_tcw(np.stack([t for _, t in traj]))
    np.testing.assert_allclose(rows[:, 1:4], centers, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
    gt = positions_from_tcw(np.stack([seq.pose(int(round(ts * 30))) for ts in rows[:, 0]]))
    file_ate = ate_rmse(rows[:, 1:4], gt, with_scale=False)
    assert file_ate == j_ate_rmse(rows[:, 1:4], gt, with_scale=False)
    assert file_ate <= 1.5 * j_ate + 0.01


def test_unported_options_raise():
    """Loop closing, the async pipeline, the tracer, the mesh and map
    save/load raise, naming their ROADMAP.md item; monocular SLAM, a
    vocabulary and localization mode are ported and construct."""
    cam = convert.camera_from_jax(CAM)
    for kw, item in ((dict(sensor=tsystem.Sensor.RGBD), 9),
                     (dict(sensor=tsystem.Sensor.MONOCULAR, vocabulary="bootstrap"), 9),
                     (dict(sensor=tsystem.Sensor.RGBD, enable_loop_closing=False, async_mapping=True), 10),
                     (dict(sensor=tsystem.Sensor.RGBD, enable_loop_closing=False, tracer=object()), 10),
                     (dict(sensor=tsystem.Sensor.RGBD, enable_loop_closing=False, mesh=object()), 11)):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 item {item}"):
            tsystem.System(cam, device="cpu", **kw)
    s = tsystem.System(cam, tsystem.Sensor.RGBD, enable_loop_closing=False, device="cpu")
    for call in (lambda: s.save_map("x"), lambda: s.load_map("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
            call()
    with pytest.raises(ValueError):
        s.track_stereo(np.zeros((240, 320)), np.zeros((240, 320)), 0.0)
    with pytest.raises(ValueError):
        s.track_monocular(np.zeros((240, 320)), 0.0)
    s.activate_localization_mode()
    assert s.tracking.localization_only and s.local_mapping.paused
    s.deactivate_localization_mode()
    mono = tsystem.System(cam, tsystem.Sensor.MONOCULAR, enable_loop_closing=False, device="cpu",
                          vocabulary="bootstrap")
    assert mono.keyframe_db is not None and mono.local_mapping.relocalizer is not None
    assert mono.tracking.vocabulary is mono.vocabulary
    if not torch.cuda.is_available():  # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsystem.System(cam, tsystem.Sensor.MONOCULAR, enable_loop_closing=False, device="cuda")


@pytest.fixture
def tracked_two_frames():
    """A port System with two RGB-D frames tracked (the second through the
    staged path, which arms the fused step) and the third frame extracted."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor.RGBD, config=TConfig(**CFG),
                       enable_loop_closing=False, device="cpu")
    for i in range(2):
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
    frame = s._make_frame(s._image(seq.render(2)), 2 / 30.0)
    s._attach_depth(frame, seq.depth_map(2))
    return s, frame


def test_fused_step_counts_only_after_its_gate(tracked_two_frames):
    """Divergence from the JAX package (tracking.py:725-745, ROADMAP Queue 3):
    there the fused step bumps the points' visible/found counters before its
    min_localmap_inliers gate, so a frame that bails out to the staged path
    is counted twice. The port bumps them only once the gate has passed."""
    s, frame = tracked_two_frames
    t = s.tracking
    visible, found = s.map.pt_visible.copy(), s.map.pt_found.copy()
    t.cfg.min_localmap_inliers = 10**6
    assert not t._track_fused(frame)
    np.testing.assert_array_equal(s.map.pt_visible, visible)
    np.testing.assert_array_equal(s.map.pt_found, found)
    assert (frame.map_pt < 0).all()
    t.cfg.min_localmap_inliers = TConfig().min_localmap_inliers
    assert t._track_fused(frame)
    assert (s.map.pt_visible > visible).sum() > 100 and (s.map.pt_found > found).sum() > 100


def test_fused_local_pack_resolves_replaced_points(tracked_two_frames):
    """Divergence from the JAX package (tracking.py:691, ROADMAP Queue 3):
    there the fused step packs the previous frame's local set as is, so a
    culled or replaced point can still match for a frame. The port resolves
    replacements and drops invalid points first."""
    s, frame = tracked_two_frames
    t, m = s.tracking, s.map
    local = t._prev_local_pids.copy()
    for a, b in zip(local[:20], local[20:40]):
        m.replace_point(int(a), int(b))
    for p in local[40:60]:
        m.erase_point(int(p))
    packed = []
    pack = m.pack_points
    m.pack_points = lambda pids, cap, device=None: packed.append(np.array(pids)) or pack(pids, cap, device)
    assert t._track_fused(frame)
    local_pack = packed[-1]  # packed after the motion stage's set
    assert m.pt_valid[local_pack].all() and len(np.unique(local_pack)) == len(local_pack)
    assert not set(local[:20].tolist()) & set(local_pack.tolist())
    assert set(local[20:40].tolist()) <= set(local_pack.tolist())
    assert m.pt_valid[frame.map_pt[frame.map_pt >= 0]].all()
