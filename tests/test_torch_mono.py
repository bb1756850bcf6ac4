"""Monocular SLAM: the port against the JAX package.

`Frame.compact_to` and `initial_ba` are held to the JAX package on the same
input: compaction exactly, the initial BA (20 LM iterations over the
two-keyframe map of the JAX run's initialization, carried across with
`convert.map_from_jax`) to poses within 1e-3 and points within 1e-3 of their
unit median depth. Then both Systems run SyntheticSequence("sideways") at
320x240 with 600 features for 30 frames (no vocabulary: each trains one
lazily once its map holds 5 keyframes). The two draw their RANSAC samples from different
generators and their extractors differ by ulps in the exposure gain and at
levels >= 1 (the port's fixed-order sums, the same bits on the CPU and the
card, against XLA's mean and dot), so the runs are held to one accuracy
class: the port tracks >= 20 frames, its Sim3 ATE is at most 1.5 x the JAX
package's + 1 cm, its map holds >= 100 points. A
blank frame on a young map resets the System; localization mode leaves
keyframes and points as they were.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models import system as jsystem
from orbslam2commentedbyxcm_tpu.models.frame import Frame as JFrame
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import SyntheticSequence as JSequence
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.frame import Frame
from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import LocalMapping
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig as TConfig
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
from orbslam2commentedbyxcm_tpu_torch.utils.synth import SyntheticSequence

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
TCAM = convert.camera_from_jax(CAM)
CFG = dict(n_features=600, max_frames_between_kf=8, kf_tracked_ratio=0.95)
N = 30


@pytest.fixture(scope="module")
def jax_run():
    """The JAX System's 30-frame mono run, with the map before and after its
    initial BA snapshotted as port Maps."""
    seq = JSequence(camera=CAM, n_frames=N, trajectory="sideways")
    s = jsystem.System(CAM, jsystem.Sensor.MONOCULAR, config=JConfig(**CFG), enable_loop_closing=False)
    lm = s.local_mapping
    snaps = {}
    initial_ba = lm.initial_ba

    def snapshot_initial_ba(k1, k2):
        snaps["before"] = convert.map_from_jax(lm.map)
        initial_ba(k1, k2)
        snaps["after"] = convert.map_from_jax(lm.map)
        snaps["ids"] = (k1, k2)

    lm.initial_ba = snapshot_initial_ba
    poses = [s.track_monocular(seq.render(i), i / 30.0) for i in range(N)]
    return seq, s, poses, snaps


def _ate(seq, poses):
    idx = [i for i, p in enumerate(poses) if p is not None]
    est = positions_from_tcw(np.stack([poses[i] for i in idx]))
    return len(idx), ate_rmse(est, positions_from_tcw(np.stack([seq.pose(i) for i in idx])))


def test_compact_to_matches_jax():
    seq = SyntheticSequence(camera=TCAM, n_frames=N, trajectory="sideways")
    feats = ORBExtractor(n_features=1200)(seq.render(3))
    tf = Frame(feats, TCAM, 0.1)
    jf = JFrame(SimpleNamespace(**convert.features_to_numpy(feats)), CAM, 0.1)
    rng = np.random.default_rng(0)
    for f in (tf, jf):
        f.u_right = np.linspace(-1, 5, f.capacity).astype(np.float32)
        f.map_pt = np.where(rng.random(f.capacity) < 0.2, np.arange(f.capacity), -1)
        rng = np.random.default_rng(0)
    pri = np.random.default_rng(1).random(tf.capacity) < 0.3
    keep_first = pri & tf.valid
    tmap, jmap = tf.compact_to(600, pri), jf.compact_to(600, pri)
    np.testing.assert_array_equal(tmap, jmap)
    for name in ("uv", "uv_und", "angle", "level", "desc", "valid", "response", "u_right", "depth", "map_pt",
                 "is_outlier"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name), err_msg=name)
    assert tf.capacity == 600 and tf.n == 600 and keep_first[tmap < 0].sum() == 0
    np.testing.assert_array_equal(tmap[keep_first], np.arange(keep_first.sum()))
    # the device features and arrays follow the numpy ones
    dev = tf.device_arrays()
    np.testing.assert_array_equal(convert.desc_to_numpy(dev["desc"]), tf.desc)
    np.testing.assert_array_equal(dev["uv_und"].numpy(), tf.uv_und)
    np.testing.assert_array_equal(tf.feats.valid.numpy(), tf.valid)


def test_initial_ba_matches_jax(jax_run):
    _, _, _, snaps = jax_run
    before, ref = snaps["before"], snaps["after"]
    k1, k2 = snaps["ids"]
    got = convert.map_from_jax(before)
    LocalMapping(got, TCAM).initial_ba(k1, k2)
    np.testing.assert_array_equal(got.keyframes[k1].t_cw, before.keyframes[k1].t_cw)  # fixed
    assert not np.array_equal(ref.keyframes[k2].t_cw, before.keyframes[k2].t_cw)
    np.testing.assert_allclose(got.keyframes[k2].t_cw, ref.keyframes[k2].t_cw, atol=1e-3, rtol=0)
    pids = np.nonzero(ref.pt_valid & got.pt_valid)[0]
    assert len(pids) > 100
    err = np.linalg.norm(got.pt_xyz[pids] - ref.pt_xyz[pids], axis=-1)
    print(f"initial BA: {len(pids)} points, |d| median {np.median(err):.2e} max {err.max():.2e}")
    assert np.mean(err < 1e-3) >= 0.99
    assert len(set(ref.all_point_ids()) ^ set(got.all_point_ids())) <= 0.01 * ref.n_valid_points()


@pytest.fixture(scope="module")
def port_run():
    seq = SyntheticSequence(camera=TCAM, n_frames=N, trajectory="sideways")
    s = tsystem.System(TCAM, tsystem.Sensor.MONOCULAR, config=TConfig(**CFG), enable_loop_closing=False,
                       device="cpu")
    capacities = []
    poses = []
    for i in range(N):
        poses.append(s.track_monocular(seq.render(i), i / 30.0))
        capacities.append(s.tracking.last_frame.capacity)
    return seq, s, poses, capacities


def test_mono_system_matches_jax(jax_run, port_run):
    jseq, jsys, jposes, _ = jax_run
    seq, s, poses, capacities = port_run
    j_tracked, j_ate = _ate(jseq, jposes)
    t_tracked, t_ate = _ate(seq, poses)
    n_kf, n_pts = len(s.map.good_keyframes()), s.map.n_valid_points()
    print(f"mono: JAX {j_tracked}/{N} tracked, Sim3 ATE {j_ate:.4f} m, {len(jsys.map.good_keyframes())} keyframes, "
          f"{jsys.map.n_valid_points()} points | port {t_tracked}/{N}, ATE {t_ate:.4f} m, {n_kf} keyframes, "
          f"{n_pts} points")
    assert t_tracked >= 20
    assert t_ate <= 1.5 * j_ate + 0.01
    assert n_pts >= 100 and n_kf >= 2
    assert s.get_tracking_state() == tsystem.TrackingState.OK
    # the doubled budget only while initializing; every keyframe at the standard capacity
    std = s.extractor.capacity
    first = next(i for i, p in enumerate(poses) if p is not None)
    assert capacities[0] == s._init_extractor.capacity == 2 * std
    assert all(c == std for c in capacities[first:])
    assert all(len(kf.uv) == std for kf in s.map.keyframes.values())


def test_mono_localization_mode_freezes_map(port_run):
    seq, s, _, _ = port_run
    n_pts, n_kfs = s.map.n_valid_points(), len(s.map.good_keyframes())
    s.activate_localization_mode()
    try:
        for i in (N - 2, N - 1):
            assert s.track_monocular(seq.render(i), 90.0 + i) is not None
        assert s.map.n_valid_points() == n_pts and len(s.map.good_keyframes()) == n_kfs
    finally:
        s.deactivate_localization_mode()
    assert not s.local_mapping.paused and not s.tracking.localization_only


def test_blank_frame_on_young_map_resets():
    seq = SyntheticSequence(camera=TCAM, n_frames=N, trajectory="sideways")
    cfg = TConfig(n_features=600, max_frames_between_kf=100, kf_tracked_ratio=0.5)
    s = tsystem.System(TCAM, tsystem.Sensor.MONOCULAR, config=cfg, enable_loop_closing=False, device="cpu")
    for i in range(16):
        s.track_monocular(seq.render(i), i / 30.0)
        if len(s.map.good_keyframes()) >= 2:
            break
    assert 0 < len(s.map.good_keyframes()) <= 5
    blank = np.full((TCAM.height, TCAM.width), 128.0, np.float32)
    blank += np.random.default_rng(0).uniform(-1, 1, blank.shape).astype(np.float32)
    assert s.track_monocular(blank, 90.0) is None
    assert len(s.map.good_keyframes()) == 0 and s.map.n_valid_points() == 0
    assert s.get_tracking_state() == tsystem.TrackingState.NOT_INITIALIZED
    assert len(s.keyframe_trajectory()) >= 2  # archived at the reset
