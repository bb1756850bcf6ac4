"""Materialize synthetic sequences to disk in the three dataset formats.

Counterpart of orbslam2commentedbyxcm_tpu/utils/dataset_writers.py, with the
same signatures and settings text, writing PNGs with the port's own codec
(utils/png) instead of cv2.

The reference's entire validation story is end-to-end dataset evaluation
(SURVEY.md §4; workflows the reference's README.md:101-173). No real
TUM/KITTI/EuRoC data exists in this environment, so these writers render a
synthetic sequence (utils/synth) into the exact on-disk layouts the loaders
(utils/datasets) expect — proving the loader -> Prefetcher -> System ->
trajectory-writer -> ATE path works on real files:

  * TUM RGB-D:  rgb/*.png + depth/*.png (uint16, DepthMapFactor), rgb.txt,
    depth.txt, groundtruth.txt             (README.md:101-116 workflow)
  * KITTI odometry:  sequences/SS/image_0 + image_1 + times.txt,
    poses/SS.txt                           (README.md:128-141)
  * EuRoC ASL:  mav0/cam0/data + cam1/data + data.csv,
    state_groundtruth_estimate0/data.csv   (README.md:143-173); optionally
    rendered through DISTORTED, DEROTATED raw cameras + a settings YAML with
    the rig's LEFT.*/RIGHT.* K/D/R/P so the rectification path
    (utils/rectify) is exercised from genuinely unrectified input
    (README.md:207).
"""

from __future__ import annotations

import os

import numpy as np

from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.png import write_png as _imwrite
from orbslam2commentedbyxcm_tpu_torch.utils.rectify import (
    remap_bilinear,
    undistort_normalized,
)


def _write_settings_yaml(path: str, cam: Camera, n_features: int = 800,
                         extra: str = ""):
    with open(path, "w") as f:
        f.write(f"""%YAML:1.0
Camera.fx: {cam.fx}
Camera.fy: {cam.fy}
Camera.cx: {cam.cx}
Camera.cy: {cam.cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {cam.width}
Camera.height: {cam.height}
Camera.fps: {cam.fps}
Camera.bf: {cam.bf}
Camera.RGB: 1
ThDepth: {cam.th_depth}
DepthMapFactor: 5000.0
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
{extra}""")


def write_tum_rgbd(root: str, seq, n_frames: int, fps: float = 30.0,
                   depth_factor: float = 5000.0) -> str:
    """Render `seq` (needs .render/.depth_map/.pose) into a TUM RGB-D
    directory; returns a settings YAML path alongside."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n_frames):
        ts = i / fps
        img = seq.render(i).astype(np.uint8)
        depth = seq.depth_map(i)
        d16 = np.where(
            np.isfinite(depth) & (depth > 0),
            np.clip(depth * depth_factor, 0, 65535), 0.0,
        ).astype(np.uint16)
        _imwrite(os.path.join(root, "rgb", f"{ts:.6f}.png"), img)
        _imwrite(os.path.join(root, "depth", f"{ts:.6f}.png"), d16)
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_lines.append(f"{ts:.6f} depth/{ts:.6f}.png")
        t_wc = np.linalg.inv(seq.pose(i))
        q = _quat_from_r(t_wc[:3, :3])
        p = t_wc[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("# synthetic\n" + "\n".join(lines) + "\n")
    settings = os.path.join(root, "settings.yaml")
    _write_settings_yaml(settings, seq.camera)
    return settings


def write_kitti(root: str, seq, n_frames: int, sequence: str = "00",
                fps: float = 10.0) -> str:
    """Render `seq` (needs .render/.render_right/.pose) into a KITTI odometry
    tree; returns a settings YAML path."""
    seq_dir = os.path.join(root, "sequences", sequence)
    os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "image_1"), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    times, pose_rows = [], []
    for i in range(n_frames):
        _imwrite(os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
                 seq.render(i).astype(np.uint8))
        _imwrite(os.path.join(seq_dir, "image_1", f"{i:06d}.png"),
                 seq.render_right(i).astype(np.uint8))
        times.append(f"{i / fps:.6e}")
        t_wc = np.linalg.inv(seq.pose(i))
        pose_rows.append(" ".join(f"{v:.6e}" for v in t_wc[:3].ravel()))
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(root, "poses", sequence + ".txt"), "w") as f:
        f.write("\n".join(pose_rows) + "\n")
    settings = os.path.join(root, "settings.yaml")
    _write_settings_yaml(settings, seq.camera)
    return settings


def _quat_from_r(r: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) from a rotation matrix (TUM groundtruth order)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                         (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    q[3] = (r[k, j] - r[j, k]) / s
    return q


def _small_rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def write_euroc(root: str, seq, n_frames: int, fps: float = 20.0,
                distorted: bool = True) -> str:
    """Render `seq` into an EuRoC ASL tree; returns a settings YAML path.

    With `distorted`, the raw cam0/cam1 frames are rendered through a
    DISTORTED (radial-tangential) and DEROTATED (non-coplanar) stereo rig:
    each true camera is the rectified camera rotated by R_side^T, and the raw
    image at pixel p shows the ray undistort(K^-1 p). The settings YAML then
    carries LEFT.*/RIGHT.* K/D/R/P — the loader must rectify (utils/rectify)
    before the row-band stereo matcher can work, exactly the reference's
    EuRoC contract (the reference's README.md:207)."""
    cam = seq.camera
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    for d in (cam0, cam1, gt_dir):
        os.makedirs(d, exist_ok=True)

    # raw-rig calibration (only used when distorted)
    dist_l = np.array([-0.25, 0.06, 0.0002, -0.0001, 0.0])
    dist_r = np.array([-0.26, 0.065, -0.0001, 0.0002, 0.0])
    r_l = _small_rotation(0.008, -0.012, 0.006)   # cam -> rectified frame
    r_r = _small_rotation(-0.010, 0.009, -0.007)
    k_raw_l = np.array([[cam.fx * 1.05, 0, cam.cx + 4.0],
                        [0, cam.fy * 1.05, cam.cy - 3.0], [0, 0, 1.0]])
    k_raw_r = np.array([[cam.fx * 1.04, 0, cam.cx - 5.0],
                        [0, cam.fy * 1.04, cam.cy + 2.0], [0, 0, 1.0]])
    maps = None
    if distorted:
        maps = (
            _raw_view_map(cam, k_raw_l, dist_l),
            _raw_view_map(cam, k_raw_r, dist_r),
        )

    lines = ["#timestamp [ns],filename"]
    gt_lines = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]"]
    margin = _RENDER_MARGIN
    big_cam = Camera(fx=cam.fx, fy=cam.fy, cx=cam.cx + margin, cy=cam.cy + margin,
                     width=cam.width + 2 * margin, height=cam.height + 2 * margin,
                     bf=cam.bf)
    for i in range(n_frames):
        ts_ns = int(i / fps * 1e9)
        name = f"{ts_ns}.png"
        t_rect = seq.pose(i).astype(np.float64)
        t_rl = np.eye(4)
        t_rl[0, 3] = -cam.b
        t_rect_r = t_rl @ t_rect
        if distorted:
            # true camera = rectified camera rotated by R_side^T:
            # x_cam = R_side^T x_rect  =>  T_cam_w = blkdiag(R^T) T_rect_w
            left = _render_raw(seq, big_cam, r_l, t_rect, maps[0])
            right = _render_raw(seq, big_cam, r_r, t_rect_r, maps[1])
        else:
            left = seq.render_pose(t_rect)
            right = seq.render_pose(t_rect_r)
        _imwrite(os.path.join(cam0, name), left.astype(np.uint8))
        _imwrite(os.path.join(cam1, name), right.astype(np.uint8))
        lines.append(f"{ts_ns},{name}")
        t_wc = np.linalg.inv(t_rect)
        gt_lines.append(f"{ts_ns},{t_wc[0, 3]:.6f},{t_wc[1, 3]:.6f},{t_wc[2, 3]:.6f}")
    for c in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", c, "data.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")

    settings = os.path.join(root, "settings.yaml")
    extra = ""
    if distorted:
        p_l = np.array([[cam.fx, 0, cam.cx, 0], [0, cam.fy, cam.cy, 0],
                        [0, 0, 1, 0.0]])
        p_r = p_l.copy()
        p_r[0, 3] = -cam.bf
        extra = "".join(
            _yaml_matrix(f"{side}.{key}", arr)
            for side, mats in (
                ("LEFT", {"K": k_raw_l, "D": dist_l.reshape(1, 5),
                          "R": r_l, "P": p_l}),
                ("RIGHT", {"K": k_raw_r, "D": dist_r.reshape(1, 5),
                           "R": r_r, "P": p_r}),
            )
            for key, arr in mats.items()
        ) + (f"LEFT.width: {cam.width}\nLEFT.height: {cam.height}\n"
             f"RIGHT.width: {cam.width}\nRIGHT.height: {cam.height}\n")
    _write_settings_yaml(settings, cam, extra=extra)
    return settings


_RENDER_MARGIN = 48


def _yaml_matrix(key: str, arr: np.ndarray) -> str:
    data = ", ".join(f"{v:.12g}" for v in np.ravel(arr))
    return (f"{key}: !!opencv-matrix\n   rows: {arr.shape[0]}\n"
            f"   cols: {arr.shape[1]}\n   dt: d\n   data: [{data}]\n")


def _raw_view_map(cam: Camera, k_raw: np.ndarray, dist: np.ndarray):
    """Lookup maps from raw distorted pixels into the oversized ideal render:
    raw pixel p -> normalized undistort(K_raw^-1 p) -> ideal pixel."""
    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    xn = np.stack([(us - k_raw[0, 2]) / k_raw[0, 0],
                   (vs - k_raw[1, 2]) / k_raw[1, 1]], axis=-1)
    xu = undistort_normalized(xn, dist)
    mx = (cam.fx * xu[..., 0] + cam.cx + _RENDER_MARGIN).astype(np.float32)
    my = (cam.fy * xu[..., 1] + cam.cy + _RENDER_MARGIN).astype(np.float32)
    return mx, my


def _render_raw(seq, big_cam: Camera, r_side: np.ndarray,
                t_rect: np.ndarray, view_map) -> np.ndarray:
    """Ideal pinhole render from the rotated true camera on an oversized
    canvas, then warped through the raw-view map (distortion inverse)."""
    t_cam = np.eye(4)
    t_cam[:3, :3] = r_side.T
    old_cam = seq.camera
    try:
        seq.camera = big_cam  # plain (non-frozen) dataclass field swap
        ideal = seq.render_pose(t_cam @ t_rect)
    finally:
        seq.camera = old_cam
    return remap_bilinear(ideal, view_map[0], view_map[1], fill=64.0)
