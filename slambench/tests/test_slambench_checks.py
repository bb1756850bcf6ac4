"""How `correct` is decided, at a size a test run holds: the reference is
the port's extraction to the bit, the control (the reference in bfloat16 in
the program's place) fails the limits, and a run with the timed path broken
underneath comes out not correct."""

import io
import json

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.models.frame import rgbd_observations
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.ops.stereo import stereo_match
from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings
from slambench import checks, control, faults, run, scene
from slambench.reference import stereo as ref_stereo


def _frames(small_root, name, path, n=2):
    settings = small_root / "slambench" / "configs" / f"{name}.yaml"
    cam, cfg, _ = load_settings(str(settings))
    sc = scene.Scene(3.0, 512, 1000, 2**31 + 1, "cpu")
    k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    p = scene.Path(path)
    poses = torch.as_tensor(np.stack([p.pose(t) for t in (0.0, 2.5)[:n]]))
    img, depth = sc.render(poses, k, cam.width, cam.height)
    t_rl = torch.eye(4, dtype=torch.float64)
    t_rl[0, 3] = -cam.bf / cam.fx
    right, _ = sc.render(t_rl @ poses, k, cam.width, cam.height)
    u8 = lambda x: torch.round(x).clamp(0, 255).to(torch.uint8).numpy()  # noqa: E731
    return cam, cfg, checks.settings_values(str(settings)), u8(img), u8(right), depth.numpy()


ORBIT = {"trajectory": "orbit", "radius_m": 1.0, "speed_m_s": 0.25, "bob_m": 0.1, "bob_period_s": 12.566}


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_reference_is_the_ports_extraction_and_observations(small_root, sensor):
    # the stereo reference on a rectified pair of the same camera (bf 40 / 2)
    for name in ("tum3_rgbd",):
        cam, cfg, values, imgs, rights, depths = _frames(small_root, name, ORBIT)
        port = ORBExtractor(n_features=cfg.n_features, scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
                            normalize_exposure=cfg.normalize_exposure, exposure_target_mad=cfg.exposure_target_mad)
        ref = checks.reference_extractor(values)
        for img, right, depth in zip(imgs, rights, depths):
            f = port(torch.from_numpy(img.astype(np.float32)))
            r, _ = ref.extract(img)
            assert checks._field_diff({k: getattr(f, k).numpy() for k in checks.FIELDS}, r) == 0
            if sensor == "rgbd":
                d = np.where(np.isfinite(depth), depth, -1.0).astype(np.float32)
                obs, _, dep = rgbd_observations(f, torch.from_numpy(d), cam, cfg.n_levels, cfg.scale_factor)
                rd, ru = ref_stereo.rgbd(r.uv, r.valid, d, values["Camera.bf"])
                assert torch.equal(dep, rd) and torch.equal(obs[:, 2], ru)
            else:
                fr = port(torch.from_numpy(right.astype(np.float32)))
                rr, _ = ref.extract(right)
                sf = torch.tensor(cfg.scale_factor ** np.arange(cfg.n_levels), dtype=torch.float32)
                u_r, disp, ok = stereo_match(f.uv, f.desc, f.level, f.valid, fr.uv, fr.desc, fr.level, fr.valid,
                                             torch.from_numpy(img.astype(np.float32)),
                                             torch.from_numpy(right.astype(np.float32)), sf, 0.0, float(cam.fx))
                rd, ru = ref_stereo.stereo(r, rr, img, right, ref.scales, cam.fx, cam.bf)
                assert int(ok.sum()) > 20
                assert torch.equal(torch.where(ok, u_r, -1.0), ru)
                depth_port = np.where(ok.numpy(), np.float32(cam.bf) / disp.numpy(), -1.0).astype(np.float32)
                assert np.array_equal(depth_port, rd.numpy())


def test_control_fails_the_limits_and_the_program_passes(small_root):
    out = io.StringIO()
    summary = control.readings("tum3_rgbd.office_loop", [2**31 + 21], 2.0, device="cpu", root=small_root, out=out)
    lim = checks.limits(small_root)
    assert summary["lower"]["extract_diff"] == 0 and summary["lower"]["obs_diff"] == 0
    assert summary["lower"]["pose_gap_px"] <= lim["pose_gap_px"]
    assert summary["upper"]["extract_diff"] > 0 and summary["upper"]["obs_diff"] > 0
    assert summary["upper"]["pose_gap_px"] > lim["pose_gap_px"]


@pytest.mark.parametrize("fault", ["pose_unchanged", "half_slots", "desc_bit"])
def test_a_broken_timed_path_is_not_correct(small_root, fault):
    out, err = io.StringIO(), io.StringIO()
    with faults.planted(fault):
        rc = run.run_cell("tum3_rgbd.revisit", 2**31 + 31, 6.0, False, device="cpu", root=small_root, out=out,
                          err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


def test_a_sound_run_is_correct(small_root):
    out, err = io.StringIO(), io.StringIO()
    rc = run.run_cell("tum3_rgbd.revisit", 2**31 + 31, 6.0, False, device="cpu", root=small_root, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert err.getvalue().strip().splitlines()[-1].startswith("check pose_frames")


def _map(n_kf=6, seed=0):
    """Keyframe poses along an orbit and points on the walls, as the
    generator makes them; the program's copy is expressed in its origin
    keyframe's camera frame."""
    rng = np.random.default_rng(seed)
    p = scene.Path(ORBIT)
    gt = np.stack([p.pose(t) for t in np.linspace(0.0, 20.0, n_kf)])
    wall = rng.uniform(-2.5, 2.5, (200, 2))
    pts = np.concatenate([np.stack([wall[:, 0], wall[:, 1], np.full(200, 3.0)], 1),
                          np.stack([np.full(200, -3.0), wall[:, 0], wall[:, 1]], 1)])
    to_map = gt[0]  # world -> the origin keyframe's camera frame
    est = np.stack([t @ np.linalg.inv(to_map) for t in gt])
    pts_map = pts @ to_map[:3, :3].T + to_map[:3, 3]
    return est, gt, pts_map


def test_a_true_map_reads_nought():
    est, gt, pts = _map()
    got = checks.map_numbers(est, gt, 0, pts, 3.0, 1)
    assert got["kf_drift_cm"] == pytest.approx(0.0, abs=1e-9)
    assert got["map_gap_cm"] == pytest.approx(0.0, abs=1e-9)
    assert got["loops_closed"] == 1


def test_a_drifted_map_reads_its_drift():
    est, gt, pts = _map()
    shift = np.eye(4)
    shift[0, 3] = 0.04  # the last keyframe and every point 4 cm off along the map's x
    est[-1] = est[-1] @ np.linalg.inv(shift)
    got = checks.map_numbers(est, gt, 0, pts + shift[:3, 3], 3.0, 0)
    assert got["kf_drift_cm"] == pytest.approx(4.0 / np.sqrt(len(est)), rel=1e-6)
    assert 0.0 < got["map_gap_cm"] <= 4.0 + 1e-9


def test_the_map_and_the_loops_are_judged():
    lim = {"extract_diff": 0, "obs_diff": 0, "pose_gap_px": 0.05, "min_pose_frames": 4}
    sound = {"extract_diff": 0, "obs_diff": 0, "pose_gap_px": 0.001, "pose_frames": 10, "kf_drift_cm": 1.0,
             "map_gap_cm": 0.2, "loops_closed": 1}
    assert checks.judge(sound, lim, 1)[0]
    assert "loops_closed" not in checks.judge(sound, lim, None)[1]
    assert not {"kf_drift_cm", "map_gap_cm"} & set(checks.judge(sound, lim, 1)[1])  # read, not compared
    for key, bad in (("loops_closed", 0), ("pose_gap_px", 0.06), ("pose_gap_px", None), ("extract_diff", 1)):
        ok, shown = checks.judge(dict(sound, **{key: bad}), lim, 1)
        assert not ok and shown[key]["value"] == bad


LAP_S = 120.0  # a window in which the small cell goes once round its orbit on two CPU threads (~300 frames)


@pytest.mark.parametrize("fault", ["none", "loop_off", "half_kf_obs"])
def test_a_lap_closes_its_loop_and_a_broken_map_is_not_correct(small_root, fault):
    """The small office cell run for a lap: the sound run closes its loop;
    with loop closing switched off, or half of every keyframe's
    observations dropped, none closes and the run is not correct."""
    out, err = io.StringIO(), io.StringIO()
    with faults.planted(fault):
        rc = run.run_cell("tum3_rgbd.office_loop", 2**31 + 31, LAP_S, False, device="cpu", root=small_root, out=out,
                          err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    loops = result["checks"]["loops_closed"]
    assert loops["least"] == 1 and result["attempted"] > 251, err.getvalue()[-2000:]
    if fault == "none":
        assert loops["value"] >= 1, result["checks"]
    else:
        assert loops["value"] == 0 and result["correct"] is False, result["checks"]
