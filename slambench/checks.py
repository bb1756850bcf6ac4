"""How `correct` is decided: what the timed path produced, held to the plain
reference (reference/).

During the window the harness snapshots a sample of frames, drawn from the
seed: the features the port extracted, the depth and right-image
coordinate it attached to each, the pose `track_*` returned, the frame's
inlier map points and their positions as the pose solve used them. Once
the window has closed:

  extract_diff   keypoint slots whose position, level, angle, response,
                 descriptor or validity differ from the reference
                 extraction of the same image (exact: limit 0)
  obs_diff       keypoints whose depth or right coordinate differ from the
                 reference's (RGB-D: the depth map at the keypoint; stereo:
                 the reference matcher on the reference's own features of
                 both images; exact: limit 0)
  pose_gap_px    per frame, the largest image displacement over the
                 frame's inlier points between the returned pose and the
                 reference solve's optimum over the same points and
                 observations, started from the returned pose; the median
                 over the checked frames (PERF.md: the largest swings with
                 the edges the solve's last round relabels)
  pose_frames    frames whose pose could be checked (the positions read
                 while no map change happened since the frame's solve); at
                 least `min_pose_frames`

After `shutdown()`, what loop closing did, held to the configuration's
guarantee:

  loops_closed   loops the loop closer corrected; at least the mix's
                 `min_loops` where the mix states one (the configuration's
                 guarantee: loops closed by place recognition)

and two readings of what local mapping, local BA and loop closing left in
the map, against the generator's ground truth, printed and not compared (PERF.md:
neither the control nor any planted fault reads three times what sound
runs read):

  kf_drift_cm    RMS over the map's keyframes of the distance between the
                 camera centre and its true one, the map carried into the
                 world by its origin keyframe's true pose (the map's frame
                 is that keyframe's camera frame)
  map_gap_cm     the median over the map's points of their distance to the
                 nearest wall of the box, carried the same way

`measure(..., precision="bf16")` puts the reference computed in bfloat16 in
the program's place: the control, which the limits have to fail.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from slambench.reference import ate, orb, pose, stereo

HERE = Path(__file__).resolve().parent
FIELDS = ("uv", "level", "angle", "response", "desc", "valid")


def limits(root: Path = HERE.parent) -> dict:
    with open(root / "slambench" / "limits.json") as f:
        return json.load(f)


def settings_values(path: str) -> dict:
    """The numeric keys of an OpenCV-YAML settings file."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*([A-Za-z0-9_.]+)\s*:\s*([-+0-9.eE]+)\s*(#.*)?$", line)
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def reference_extractor(settings: dict) -> orb.Extractor:
    return orb.Extractor(
        n_features=int(settings["ORBextractor.nFeatures"]), scale_factor=settings["ORBextractor.scaleFactor"],
        n_levels=int(settings["ORBextractor.nLevels"]), ini_th_fast=settings["ORBextractor.iniThFAST"],
        min_th_fast=settings["ORBextractor.minThFAST"],
        exposure_target_mad=settings.get("ORBextractor.exposureTargetMAD", 18.0)
        if settings.get("ORBextractor.normalizeExposure", 1.0) else None)


def camera(settings: dict):
    return (settings["Camera.fx"], settings["Camera.fy"], settings["Camera.cx"], settings["Camera.cy"],
            settings["Camera.bf"])


def _field_diff(snap: dict, ref: orb.Features) -> int:
    """Slots where any field differs."""
    bad = np.zeros(len(snap["valid"]), bool)
    for f in FIELDS:
        a = np.asarray(snap[f])
        b = getattr(ref, f).numpy()
        if f == "desc":
            a, b = a.view(np.int32), b.view(np.int32)
        if a.shape != b.shape:
            return len(bad)
        d = a != b
        bad |= d.reshape(len(bad), -1).any(1)
    return int(bad.sum())


def reference_frame(snap: dict, images, ext: orb.Extractor, settings: dict, precision: str):
    """The reference's features, stages and (depth, u_right) for one
    snapshot; `images` maps a frame index to its left image and its depth
    map or right image."""
    left, other, sensor = images(snap["index"])
    feats, stages = ext.extract(left, precision)
    fx, _, _, _, bf = camera(settings)
    if sensor == "rgbd":
        depth, u_right = stereo.rgbd(feats.uv, feats.valid, other, bf, precision)
        right_stages = None
    else:
        r_feats, right_stages = ext.extract(other, precision)
        depth, u_right = stereo.stereo(feats, r_feats, left, other, ext.scales, fx, bf, precision)
    return feats, stages, depth, u_right, right_stages


def pose_gap(snap: dict, feats: orb.Features, u_right: torch.Tensor, settings: dict, precision: str):
    """The gap in pixels of one snapshot (None: not checkable): the reference optimum from
    the returned pose over the frame's inlier points, and with the bf16
    control the control's optimum, against the float64 optimum."""
    if snap.get("pts") is None:
        return None
    inl = snap["map_pt"] >= 0
    if inl.sum() < 10:
        return None
    cam = camera(settings)
    scale = settings["ORBextractor.scaleFactor"]
    inv_sigma2 = 1.0 / (scale ** (2.0 * feats.level.numpy().astype(np.float64)))
    obs = np.concatenate([feats.uv.numpy(), u_right.numpy()[:, None]], 1)[inl]
    t0 = snap["t_cw"].astype(np.float64)
    t_ref = pose.solve(t0, snap["pts"], obs, inv_sigma2[inl], cam, "f64")
    t_cmp = t0 if precision == "f32" else pose.solve(t0, snap["pts"], obs, inv_sigma2[inl], cam, "bf16")
    return pose.gap_px(t_cmp, t_ref, snap["pts"], cam)


def measure(snaps: list, images, settings: dict, precision: str = "f32", keep_stages: bool = False):
    """-> ({number: value}, [stages of every reference extraction]). With
    precision "f32" the program's snapshots are judged; with "bf16" the
    reference computed in bfloat16 stands in the program's place."""
    ext = reference_extractor(settings)
    extract_diff = obs_diff = 0
    gaps, stages_all = [], []
    for snap in snaps:
        feats, stages, depth, u_right, right_stages = reference_frame(snap, images, ext, settings, "f32")
        if keep_stages:
            stages_all.append(stages)
            if right_stages is not None:
                stages_all.append(right_stages)
        if precision == "f32":
            judged, j_depth, j_right = snap, snap["depth"], snap["u_right"]
        else:
            c_feats, _, c_depth, c_right, _ = reference_frame(snap, images, ext, settings, precision)
            judged = {f: getattr(c_feats, f).numpy() for f in FIELDS}
            j_depth, j_right = c_depth.numpy(), c_right.numpy()
        extract_diff += _field_diff(judged, feats)
        obs_diff += int(((np.asarray(j_depth) != depth.numpy()) | (np.asarray(j_right) != u_right.numpy())).sum())
        g = pose_gap(snap, feats, u_right, settings, precision)
        if g is not None:
            gaps.append([g, int((snap["map_pt"] >= 0).sum())])
    numbers = {"extract_diff": extract_diff, "obs_diff": obs_diff,
               "pose_gap_px": float(np.median([g for g, _ in gaps])) if gaps else None,
               "pose_frames": len(gaps),
               "pose_gaps": gaps}
    return numbers, stages_all


def map_numbers(kf_est: np.ndarray, kf_gt: np.ndarray, origin: int, points: np.ndarray, half_size: float,
                loops: int) -> dict:
    """kf_drift_cm, map_gap_cm and loops_closed of the map after shutdown():
    the keyframes' world -> camera poses as the program left them and as
    the generator rendered them, the row of the map's origin keyframe, the
    map's points, the box's half size."""
    if len(kf_est) < 2:
        return {"kf_drift_cm": None, "map_gap_cm": None, "loops_closed": int(loops)}
    kf_est, kf_gt = np.asarray(kf_est, np.float64), np.asarray(kf_gt, np.float64)
    # the map's frame is its origin keyframe's camera frame, held fixed by
    # every optimisation: the origin's true pose carries the map into the world
    a = np.linalg.inv(kf_gt[origin]) @ kf_est[origin]
    x = ate.centers(kf_est) @ a[:3, :3].T + a[:3, 3]
    kf_err = np.linalg.norm(x - ate.centers(kf_gt), axis=-1)
    p = np.asarray(points, np.float64) @ a[:3, :3].T + a[:3, 3]
    # the walls are the planes x = +-h and z = +-h
    gap = np.minimum(np.abs(half_size - np.abs(p[:, 0])), np.abs(half_size - np.abs(p[:, 2])))
    return {"kf_drift_cm": float(100.0 * np.sqrt((kf_err ** 2).mean())),
            "map_gap_cm": float(100.0 * np.median(gap)) if len(gap) else None,
            "loops_closed": int(loops)}


def judge(numbers: dict, lim: dict, min_loops: int | None = None) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}): each number at most its
    limit, pose_frames (and loops_closed where the mix asks for loops) at
    least its least. A number that could not be read (None) fails."""
    out = {name: {"value": numbers[name], "limit": lim[name]}
           for name in ("extract_diff", "obs_diff", "pose_gap_px")}
    out["pose_frames"] = {"value": numbers["pose_frames"], "least": lim["min_pose_frames"]}
    if min_loops:
        out["loops_closed"] = {"value": numbers["loops_closed"], "least": min_loops}
    ok = all(c["value"] is not None and (c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["least"])
             for c in out.values())
    return ok, out
