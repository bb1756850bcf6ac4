"""The synthetic gauntlet's pieces for the port: perturbed BoxSequence runs
through the System, adjudicated against ground truth.

Counterpart of benchmarks/gauntlet.py's `_augment`, `adjudicate_loops` and
`run_sequence` (the JAX package's gauntlet):

  orbit    loopy indoor orbit inside a textured box (1.3 turns): drift, then a
           loop closure on the return                              [RGB-D]
  forward  corridor run with a heading weave                       [stereo]
  sway     hover: an oscillating partial orbit whose revisits stay
           covisibility-connected, so no closure is needed         [RGB-D]
  eight    figure-eight over two lobes: re-entering the first lobe after a
           full away-lobe is a place-recognition closure           [RGB-D]

    rec = run_sequence("eight", 420, augment=True, async_mapping=False,
                       camera=cam, n_features=900, device="cuda")

`run_sequence` returns the JAX runner's record keys. One divergence:
`adjudicate_loops` maps a keyframe's timestamp to its frame with the
sequence's frame rate (the camera's fps), where the JAX runner fixes 30.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw, rpe
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera


def augment(img, i, rng, mode: str = "full"):
    """Exposure drift and a moving occluding panel (the ground truth is
    unaffected: the occluder hides features, as a dynamic foreground object
    does). mode: "full" | "exposure" | "occluder"."""
    out = img
    if mode in ("full", "exposure"):
        gain = 1.0 + 0.25 * float(np.sin(2 * np.pi * i / 310.0))
        out = np.clip(out * gain + 8.0 * float(np.sin(2 * np.pi * i / 97.0)), 0, 255)
    if mode in ("full", "occluder"):
        out = np.array(out, copy=True)
        h, w = out.shape
        ow = w // 6
        x0 = int((np.sin(2 * np.pi * i / 450.0) * 0.5 + 0.5) * (w - ow))
        y0 = int((np.cos(2 * np.pi * i / 530.0) * 0.5 + 0.5) * (h - ow))
        out[y0:y0 + ow, x0:x0 + ow] = 40.0 + 20.0 * rng.random((ow, ow))
    return out.astype(np.float32)


_augment = augment  # run_sequence's `augment` flag shadows the name


def adjudicate_loops(system, seq, min_kf_gap: int = 10, colocate_radius: float = 1.0,
                     max_view_angle_deg: float = 40.0) -> dict:
    """Ground-truth loop adjudication over the final map. A keyframe pair is
    co-located when its true camera centers are within `colocate_radius`
    and its viewing directions within `max_view_angle_deg`, `min_kf_gap` or
    more keyframes apart (the detector's own recency gate,
    src/LoopClosing.cc:108). A recorded loop edge between co-located
    keyframes is a hit, any other a false closure; a co-located pair that is
    covisible, parent-linked or loop-linked is connected, any other missed."""
    kfs = sorted(system.map.good_keyframes(), key=lambda k: k.kf_id)
    if len(kfs) < 3:
        return {}
    fps = seq.camera.fps
    gt = [seq.pose(int(round(kf.timestamp * fps))) for kf in kfs]
    centers = np.stack([-t[:3, :3].T @ t[:3, 3] for t in gt])
    views = np.stack([t[:3, :3].T @ np.array([0.0, 0.0, 1.0]) for t in gt])
    ids = np.array([kf.kf_id for kf in kfs])
    dist = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    cos_th = np.cos(np.deg2rad(max_view_angle_deg))
    co = ((dist < colocate_radius) & (np.clip(views @ views.T, -1.0, 1.0) > cos_th)
          & (np.abs(ids[:, None] - ids[None, :]) >= min_kf_gap))
    co_pairs = [(a, b) for a, b in zip(*np.triu_indices(len(kfs), 1)) if co[a, b]]
    slot = {kf.kf_id: s for s, kf in enumerate(kfs)}
    loop_pairs = {tuple(sorted((slot[kf.kf_id], slot[le]))) for kf in kfs for le in kf.loop_edges if le in slot}
    hits = sum(1 for a, b in loop_pairs if co[a, b])
    connected = sum(1 for a, b in co_pairs if (
        kfs[b].kf_id in kfs[a].covis or kfs[a].parent == kfs[b].kf_id or kfs[b].parent == kfs[a].kf_id
        or (a, b) in loop_pairs))
    return {"gt_colocated_pairs": len(co_pairs), "covis_connected": connected, "loop_edge_hits": hits,
            "false_closures": len(loop_pairs) - hits, "missed": len(co_pairs) - connected,
            "colocate_radius_m": colocate_radius, "max_view_angle_deg": max_view_angle_deg}


def make_sequence(name: str, frames: int, camera):
    """(BoxSequence, Sensor) of a gauntlet sequence."""
    if name == "orbit":
        return BoxSequence(camera=camera, n_frames=frames, turns=1.3, half_size=8.0, radius=2.0), Sensor.RGBD
    if name == "forward":
        return BoxSequence(camera=camera, n_frames=frames, trajectory="line", half_size=12.0), Sensor.STEREO
    if name == "sway":
        return (BoxSequence(camera=camera, n_frames=frames, trajectory="sway", turns=0.6, half_size=8.0,
                            radius=2.0), Sensor.RGBD)
    if name == "eight":
        return BoxSequence(camera=camera, n_frames=frames, trajectory="eight", half_size=8.0, radius=2.0), Sensor.RGBD
    raise ValueError(name)


def _frame(seq, sensor, i, rng, augment: bool):
    """Frame i's (image, depth map or right image), perturbed when `augment`."""
    img = seq.render(i)
    if augment:
        img = _augment(img, i, rng)
    if sensor == Sensor.RGBD:
        return img, seq.depth_map(i)
    aux = seq.render_right(i)
    return img, _augment(aux, i, rng) if augment else aux


def render_frames(name: str, frames: int, camera=None, augment: bool = True):
    """Every frame of a sequence as run_sequence renders it (its `images=`),
    so that several runs of one sequence render it once."""
    seq, sensor = make_sequence(name, frames, camera if camera is not None else default_camera())
    rng = np.random.default_rng(7)
    return [_frame(seq, sensor, i, rng, augment) for i in range(frames)]


def run_sequence(name: str, frames: int, augment: bool = True, async_mapping: bool = True, camera=None,
                 n_features: int = 1000, device="cuda", images=None, tracer=None) -> dict:
    """One gauntlet sequence through System(vocabulary="bootstrap", loop
    closing on, `tracer`) -> the JAX runner's record. `images` (from
    render_frames with the same arguments) skips the rendering."""
    cam = camera if camera is not None else default_camera()
    cfg = TrackingConfig(n_features=n_features, max_frames_between_kf=8, kf_tracked_ratio=0.95,
                         motion_search_radius=20.0)
    seq, sensor = make_sequence(name, frames, cam)
    system = System(cam, sensor, config=cfg, vocabulary="bootstrap", enable_loop_closing=True,
                    async_mapping=async_mapping, tracer=tracer, device=device)
    rng = np.random.default_rng(7)
    fps = cam.fps
    results = []
    t0 = time.perf_counter()
    t_render = 0.0
    for i in range(frames):
        tr = time.perf_counter()
        img, aux = images[i] if images is not None else _frame(seq, sensor, i, rng, augment)
        t_render += time.perf_counter() - tr
        if sensor == Sensor.RGBD:
            p = system.track_rgbd(img, aux, i / fps)
        else:
            p = system.track_stereo(img, aux, i / fps)
        results.append(p)
        if (i + 1) % 100 == 0:
            lc = system.loop_closing
            print(f"[{name}] {i + 1}/{frames} wall={time.perf_counter() - t0:.0f}s render={t_render:.0f}s "
                  f"kfs={len(system.map.good_keyframes())} pts={system.map.n_valid_points()} "
                  f"loops={0 if lc is None else lc.n_loops_closed}", file=sys.stderr, flush=True)
    wall = time.perf_counter() - t0
    system.shutdown()

    traj = system.frame_trajectory()
    est = np.stack([t for _, t in traj]) if traj else np.zeros((0, 4, 4))
    gt = np.stack([seq.pose(int(round(ts * fps))) for ts, _ in traj]) if traj else est
    ate = rpe_t = float("nan")
    if len(est) > 10:
        ate = ate_rmse(positions_from_tcw(est), positions_from_tcw(gt), with_scale=False)
        rpe_t, _ = rpe(est, gt, delta=1)
    gt_pos = positions_from_tcw(np.stack([seq.pose(i) for i in range(frames)]))
    path_len = float(np.sum(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1)))
    lc = system.loop_closing
    return {
        "sequence": name,
        "sensor": sensor.name,
        "frames": frames,
        "tracked": int(sum(p is not None for p in results)),
        "ate_rmse_m": round(float(ate), 4),
        "rpe_trans_m": round(float(rpe_t), 5),
        "path_len_m": round(path_len, 2),
        "drift_pct": round(100.0 * float(ate) / max(path_len, 1e-9), 3),
        "loops_closed": 0 if lc is None else lc.n_loops_closed,
        "keyframes": len(system.map.good_keyframes()),
        "points": int(system.map.n_valid_points()),
        "wall_s": round(wall, 1),
        "render_s": round(t_render, 1),
        "gba_completed": 0 if lc is None else lc.gba.n_completed,
        "gba_aborted": 0 if lc is None else lc.gba.n_aborted,
        "async": bool(async_mapping),
        "loop_stats": None if lc is None else dict(lc.stats),
        "gt_loops": adjudicate_loops(system, seq),
    }
