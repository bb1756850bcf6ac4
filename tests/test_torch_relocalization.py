"""Relocalization and localization mode: the port against the JAX package.

The Relocalizer: the JAX System (RGB-D, the bootstrap vocabulary, no loop
closing) maps 40 frames of BoxSequence seed 5; its map, with the keyframes'
BoW vectors and grouping nodes, is carried across (`convert.map_from_jax`)
and the port's keyframe database is filled with the same vectors. Both
relocalizers then place revisited frame 15, extracted once, with the same
EPnP samples: the JAX draws are computed from the JAX relocalizer's own key
sequence and handed to the port in place of its generator's. Bars: the same
candidate order, a pose within 1 cm / 0.5 deg of the JAX package's.

A kidnapped port System (BoxSequence seed 5, frames 0-39, a textureless
frame, then revisited frames 15-19) relocalizes on the first revisited frame
within 5 cm of ground truth. Localization mode, the port's counterparts of
tests/test_localization_mode.py: the map stays frozen, >= N - 2 frames are
tracked, the visual-odometry fallback carries the pose on temporal depth
points alone within 0.3 m, mapping resumes after deactivation, and
change_calibration reaches every consumer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models import system as jsystem
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.frame import Frame
from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase
from orbslam2commentedbyxcm_tpu_torch.models.relocalization import Relocalizer
from orbslam2commentedbyxcm_tpu_torch.models.tracking import Tracking
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig as TConfig
from orbslam2commentedbyxcm_tpu_torch.ops import bow, pnp
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, SyntheticSequence

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
TCAM = convert.camera_from_jax(CAM)
CFG = dict(n_features=600, max_frames_between_kf=6)
N_MAP, REVISIT = 40, 15


def _blank():
    img = np.full((CAM.height, CAM.width), 128.0, np.float32)
    return img + np.random.default_rng(0).uniform(-1, 1, img.shape).astype(np.float32)


def _pose_error(t_est, t_gt):
    """(camera-center distance in m, rotation angle in deg)."""
    c_est = -t_est[:3, :3].T @ t_est[:3, 3]
    c_gt = -t_gt[:3, :3].T @ t_gt[:3, 3]
    cos = (np.trace(t_est[:3, :3] @ t_gt[:3, :3].T) - 1.0) / 2.0
    return float(np.linalg.norm(c_est - c_gt)), float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


@pytest.fixture(scope="module")
def jax_map():
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = jsystem.System(CAM, jsystem.Sensor.RGBD, config=JConfig(**CFG), enable_loop_closing=False,
                       vocabulary="bootstrap")
    for i in range(N_MAP):
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
    return seq, s


def test_relocalizer_matches_jax(jax_map, monkeypatch):
    seq, jsys = jax_map
    tmap = convert.map_from_jax(jsys.map)
    voc = bow.bootstrap_vocabulary()
    tdb = KeyFrameDatabase(voc)
    # the initialization keyframe never passes through local mapping, so it
    # is not registered, in either package
    registered = [kf for kf in tmap.good_keyframes() if kf.bow_vec is not None]
    assert len(registered) == len(jsys.keyframe_db) >= len(tmap.good_keyframes()) - 1
    for kf in registered:
        tdb.add(kf.kf_id, *kf.bow_vec)

    jframe = jsys._make_frame(seq.render(REVISIT), 50.0)
    jsys._attach_depth(jframe, seq.depth_map(REVISIT))
    feats = convert.features_from_numpy(jframe)
    tframe = Frame(feats, TCAM, 50.0)
    tframe.depth, tframe.u_right = jframe.depth.copy(), jframe.u_right.copy()

    # the same candidates, in the same order
    w, _, wt = bow.transform(voc, jframe.desc, jframe.valid)
    ids, vals = bow.bow_vector(w, wt, voc.n_words)
    j_cands = jsys.keyframe_db.detect_relocalization_candidates(ids, vals, jsys.map)
    t_cands = tdb.detect_relocalization_candidates(ids, vals, tmap)
    assert t_cands == j_cands and len(t_cands) >= 1

    # the JAX relocalizer's EPnP draws, key by key
    keys = [jax.random.PRNGKey(7)]

    def jax_draw(mask, n_hypotheses, size, generator):
        keys[0], sub = jax.random.split(keys[0])
        w = jnp.asarray(mask.cpu().numpy(), jnp.float32)
        return torch.from_numpy(np.asarray(jax.random.choice(
            sub, len(w), shape=(n_hypotheses, size), p=w / jnp.maximum(w.sum(), 1.0))))

    monkeypatch.setattr(pnp, "draw_samples", jax_draw)
    tracking = Tracking(TCAM, tmap, None, TConfig(**CFG))
    reloc = Relocalizer(tmap, TCAM, keyframe_db=tdb, vocabulary=voc)
    assert reloc.relocalize(tframe, tracking)
    assert jsys.local_mapping.relocalizer.relocalize(jframe, jsys.tracking)
    d_pos, d_rot = _pose_error(tframe.t_cw, jframe.t_cw)
    print(f"relocalization: candidates {t_cands}; port vs JAX pose {d_pos * 100:.3f} cm / {d_rot:.4f} deg; "
          f"split {reloc.last_split}")
    assert d_pos < 0.01 and d_rot < 0.5
    assert tracking.ref_kf_id == jsys.tracking.ref_kf_id and tracking.velocity is None
    assert set(reloc.last_split) == {"bow", "query", "search", "epnp", "pose"}


def test_kidnapped_system_relocalizes():
    seq = BoxSequence(camera=TCAM, seed=5, n_frames=100, turns=0.35)
    s = tsystem.System(TCAM, tsystem.Sensor.RGBD, config=TConfig(**CFG), enable_loop_closing=False,
                       device="cpu", vocabulary="bootstrap")
    assert s.vocabulary.n_words == 785724
    for i in range(N_MAP):
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
    n_kf = len(s.map.good_keyframes())
    registered = [kf for kf in s.map.good_keyframes() if kf.bow_feat_nodes is not None]
    assert n_kf > 5 and len(s.keyframe_db) == len(registered) == n_kf - 1
    assert s.track_rgbd(_blank(), np.zeros((CAM.height, CAM.width), np.float32), 2.0) is None
    assert s.get_tracking_state() == tsystem.TrackingState.LOST
    pose = s.track_rgbd(seq.render(REVISIT), seq.depth_map(REVISIT), 2.1)
    assert pose is not None, "not relocalized on the first revisited frame"
    # the map's frame is the first camera's
    gt = seq.pose(REVISIT) @ np.linalg.inv(seq.pose(0))
    d_pos, d_rot = _pose_error(pose, gt)
    print(f"kidnapped: relocalized within {d_pos * 100:.3f} cm / {d_rot:.4f} deg; split "
          f"{s.local_mapping.relocalizer.last_split}")
    assert d_pos < 0.05 and d_rot < 2.0
    for k, i in enumerate(range(REVISIT + 1, REVISIT + 5)):
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), 2.2 + 0.1 * k) is not None
    # culled keyframes leave the database through the map's erase hook
    assert len(s.keyframe_db) == sum(kf.bow_vec is not None for kf in s.map.good_keyframes())
    s.reset()
    assert len(s.keyframe_db) == 0


N_LOC_MAP, N_LOC = 14, 10


def _loc_camera():
    return Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=25.0, th_depth=40.0)


@pytest.fixture(scope="module")
def loc_run():
    """tests/test_localization_mode.loc_run on the port."""
    cam = _loc_camera()
    seq = SyntheticSequence(camera=cam, n_frames=N_LOC_MAP, trajectory="sideways")
    s = tsystem.System(cam, tsystem.Sensor.RGBD, config=TConfig(n_features=600, max_frames_between_kf=6),
                       enable_loop_closing=False, device="cpu")
    for i in range(N_LOC_MAP):
        s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
    s.activate_localization_mode()
    frozen = (s.map.n_valid_points(), len(s.map.good_keyframes()))
    results = [s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) for i in range(N_LOC_MAP, N_LOC_MAP + N_LOC)]
    return seq, s, results, frozen


def test_localization_map_is_frozen(loc_run):
    _, s, _, (points, kfs) = loc_run
    assert len(s.map.good_keyframes()) == kfs
    assert s.map.n_valid_points() <= points


def test_tracks_through_localization_mode(loc_run):
    seq, _, results, _ = loc_run
    tracked = [i for i, p in enumerate(results) if p is not None]
    assert len(tracked) >= N_LOC - 2, f"tracked {len(tracked)}/{N_LOC}"
    est = np.stack([results[i] for i in tracked])
    gt = np.stack([seq.pose(N_LOC_MAP + i) for i in tracked])
    ate = ate_rmse(positions_from_tcw(est), positions_from_tcw(gt), with_scale=False)
    assert ate < 0.15, f"ATE RMSE {ate:.4f} m in localization mode"


def test_vo_fallback_and_resume(loc_run):
    seq, s, _, (_, kfs) = loc_run
    tr = s.tracking
    tr.last_frame.map_pt[:] = -1  # no map anchors left: only temporal points
    i = N_LOC_MAP + N_LOC
    pose = s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
    assert pose is not None, "the VO fallback did not carry the pose"
    assert tr.vo_mode
    err = np.linalg.norm(np.linalg.inv(pose)[:3, 3] - np.linalg.inv(seq.pose(i))[:3, 3])
    assert err < 0.3, f"VO pose error {err:.3f} m"
    assert len(s.map.good_keyframes()) == kfs
    s.deactivate_localization_mode()
    assert not tr.vo_mode and not s.local_mapping.paused
    start = i + 1
    for k in range(start, start + 8):
        s.track_rgbd(seq.render(k), seq.depth_map(k), k / 30.0)
    assert len(s.map.good_keyframes()) > kfs, "mapping did not resume"


def test_change_calibration_swaps_consumers():
    s = tsystem.System(_loc_camera(), tsystem.Sensor.RGBD, config=TConfig(n_features=200),
                       enable_loop_closing=False, device="cpu", vocabulary="bootstrap")
    cam2 = Camera(fx=260.0, fy=260.0, cx=159.0, cy=121.0, width=320, height=240, bf=26.0, th_depth=40.0)
    s.tracking.velocity = np.eye(4, dtype=np.float32)
    s.change_calibration(cam2)
    assert s.camera is cam2 and s.tracking.camera is cam2 and s.local_mapping.camera is cam2
    assert s.local_mapping.relocalizer.camera is cam2
    assert s.tracking.velocity is None
