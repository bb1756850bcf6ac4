"""The slice as a whole: the port's System against the JAX package's on
synchronous RGB-D and stereo SLAM without place recognition.

Both run BoxSequence seed 5 at 320x240 with 600 features and a keyframe at
least every 6 frames: RGB-D for 30 frames, stereo for 20 (images rounded to
integers, as 8-bit data are; see test_torch_stereo). Both Systems are
`System(cam, sensor, enable_loop_closing=False)` with no vocabulary, so each
trains one lazily from its map once it holds 5 keyframes and registers its
keyframes in a database from then on.

Each package runs its own extractor, and the extractors differ by ulps at
pyramid levels >= 1 (test_torch_orb), so the two runs drift apart and are
held to the same accuracy class, not to equal numbers: both track at least
N - 1 frames, the port's ATE (SE3 alignment) is at most 1.5 x the JAX ATE
+ 1 cm, keyframe counts agree within 1, valid map points within 15%."""

from types import SimpleNamespace

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
from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import make_mesh
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

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


def test_unported_options_raise(tmp_path):
    """Every option is ported: a shard mesh on the System's device is
    handed to loop closing and global BA, and only a mesh on another device
    raises (the System never moves tensors to it); the async pipeline, the
    tracer, loop closing (with the shipped vocabulary or the lazy trainer,
    which is wired with loop closing off too), map save / load, monocular
    SLAM, a vocabulary and localization mode construct and run."""
    cam = convert.camera_from_jax(CAM)
    with pytest.raises(ValueError, match="the mesh is on meta"):
        tsystem.System(cam, tsystem.Sensor.RGBD, mesh=SimpleNamespace(device=torch.device("meta")), device="cpu")
    mesh = make_mesh(2, device="cpu")
    meshed = tsystem.System(cam, tsystem.Sensor.RGBD, vocabulary="bootstrap", mesh=mesh, device="cpu")
    assert meshed.loop_closing.mesh is meshed.loop_closing.gba.mesh is mesh
    assert (meshed.loop_closing.dist_min_vertices, meshed.loop_closing.gba.dist_min_points) == (256, 2048)
    for kw in (dict(), dict(enable_loop_closing=False)):  # the JAX package's defaults, and without loop closing
        lazy = tsystem.System(cam, tsystem.Sensor.RGBD, device="cpu", **kw)
        assert lazy.vocabulary is None and type(lazy.local_mapping.loop_closer).__name__ == "_LazyVocabTrainer"
    worker = tsystem.System(cam, tsystem.Sensor.RGBD, vocabulary="bootstrap", async_mapping=True, tracer=Tracer(),
                            device="cpu")
    assert type(worker.local_mapping).__name__ == "AsyncMapping"
    assert worker.local_mapping.loop_closer is worker._loop_worker and worker._loop_worker.inner is worker.loop_closing
    assert worker.tracking.tracer is worker.local_mapping.tracer is worker.tracer
    worker.shutdown()
    loop = tsystem.System(cam, tsystem.Sensor.MONOCULAR, vocabulary="bootstrap", device="cpu")
    assert loop.local_mapping.loop_closer is loop.loop_closing and not loop.loop_closing.fix_scale
    assert loop.loop_closing.gba.lock is loop.map_lock
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = tsystem.System(cam, tsystem.Sensor.RGBD, config=TConfig(**CFG), vocabulary="bootstrap", device="cpu")
    assert s.loop_closing.fix_scale
    for i in range(8):
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
    # every keyframe after the initial one went through the loop closer
    assert len(s.keyframe_db) == len(s.map.good_keyframes()) - 1 >= 1
    path = str(tmp_path / "map.npz")
    s.save_map(path)
    s2 = tsystem.System(cam, tsystem.Sensor.RGBD, config=TConfig(**CFG), enable_loop_closing=False, device="cpu")
    s2.load_map(path)
    assert s2.get_tracking_state() == tsystem.TrackingState.LOST and s2.vocabulary is not None
    assert s2.map.n_valid_points() == s.map.n_valid_points()
    assert len(s2.keyframe_db) == len(s2.map.good_keyframes()) == len(s.map.good_keyframes())
    assert s2.track_rgbd(seq.render(4), seq.depth_map(4), 1.0) is not None  # relocalized
    with pytest.raises(ValueError):
        s.track_stereo(np.zeros((240, 320)), np.zeros((240, 320)), 0.0)
    with pytest.raises(ValueError):
        s.track_monocular(np.zeros((240, 320)), 0.0)
    s.activate_localization_mode()
    assert s.tracking.localization_only and s.local_mapping.paused
    s.deactivate_localization_mode()
    s.shutdown()
    mono = tsystem.System(cam, tsystem.Sensor.MONOCULAR, enable_loop_closing=False, device="cpu",
                          vocabulary="bootstrap")
    assert mono.keyframe_db is not None and mono.local_mapping.relocalizer is not None
    assert mono.tracking.vocabulary is mono.vocabulary and mono.loop_closing is None
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


def test_keyframe_frame_is_its_own_reference():
    """Divergence from the JAX package (tracking.py:299-303, ROADMAP Queue 3):
    there a frame that becomes a keyframe records its pose relative to the
    keyframe after the synchronous local BA (and any loop correction) has
    moved the keyframe, so the saved trajectory keeps that frame where
    tracking put it, off the corrected keyframe. The port records the frame
    as its own keyframe (Tcr = I, as the reference does before LocalMapping
    runs): its frame-trajectory pose is the keyframe's."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    tsys = tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor.RGBD, config=TConfig(**CFG),
                          enable_loop_closing=False, device="cpu")
    jsys = jsystem.System(CAM, jsystem.Sensor.RGBD, config=JConfig(**CFG), enable_loop_closing=False)
    for i in range(8):
        for s in (tsys, jsys):
            assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
    for s in (tsys, jsys):
        kfs = {kf.timestamp: kf for kf in s.map.good_keyframes() if kf.timestamp > 0}
        own = [(ts, rel) for ts, ref, rel in s.tracking.trajectory if ts in kfs and kfs[ts].kf_id == ref]
        assert own  # a keyframe after the first, moved by local BA
        off = max(np.abs(rel - np.eye(4)).max() for _, rel in own)
        if s is tsys:
            assert off == 0.0
            poses = dict(s.frame_trajectory())
            for ts, _ in own:
                np.testing.assert_array_equal(poses[ts], kfs[ts].t_cw)
        else:
            assert off > 1e-6


def test_lazy_vocabulary_without_loop_closing_relocalizes():
    """With no vocabulary and loop closing off, the port trains one from the
    map once it holds 5 keyframes, as the JAX package does
    (models/system.py:136,142-149), registers the keyframes in the database
    and relocalizes a kidnapped frame through it."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor.RGBD, config=TConfig(**CFG),
                       enable_loop_closing=False, device="cpu")
    trained_at, poses = None, []
    for i in range(40):
        poses.append(s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0))
        assert poses[-1] is not None
        if trained_at is None and s.vocabulary is not None:
            trained_at = len(s.map.good_keyframes())
    assert trained_at == 5 and s.loop_closing is None
    assert type(s.local_mapping.loop_closer).__name__ == "_DbOnlyRegistrar"
    assert len(s.keyframe_db) == len(s.map.good_keyframes()) >= 6
    blank = np.full((CAM.height, CAM.width), 128.0, np.float32)
    assert s.track_rgbd(blank, np.zeros_like(blank), 2.0) is None
    assert s.get_tracking_state() == tsystem.TrackingState.LOST
    pose = s.track_rgbd(seq.render(15), seq.depth_map(15), 2.1)
    assert pose is not None
    # at least as close to the ground truth (the map frame is camera 0) as
    # tracking put frame 15 on the first pass
    want = np.linalg.inv(seq.pose(15) @ np.linalg.inv(seq.pose(0)))[:3, 3]
    err, err_tracked = (np.linalg.norm(np.linalg.inv(p)[:3, 3] - want) for p in (pose, poses[15]))
    print(f"frame 15 relocalized within {err:.4f} m of the ground truth, tracked within {err_tracked:.4f} m")
    assert err <= err_tracked + 0.01
