"""Stereo rectification: undistort-rectify maps + remap.

Counterpart of orbslam2commentedbyxcm_tpu/utils/rectify.py, the same numpy
code: it runs on the dataset prefetch thread (utils/datasets), never on the
card.

The reference's stereo_euroc example requires rectification before tracking
("provide rectification matrices ... otherwise the images must be
pre-rectified", the reference's README.md:207): EuRoC ships raw distorted,
non-coplanar cam0/cam1 frames, while the row-band stereo matcher
(ops/stereo.py == Frame::ComputeStereoMatches, the reference's src/Frame.cc:673)
assumes rectified epipolar rows.

`build_undistort_rectify_map` mirrors cv::initUndistortRectifyMap: for every
rectified pixel, back-project through the new projection P, de-rotate by the
rectification rotation R, apply the radial-tangential distortion model, and
project through the original K — yielding the source-pixel lookup maps.
`remap_bilinear` applies them (vectorized numpy; it runs on the dataset
prefetch thread, overlapped with device tracking). Held to cv2 and to the
JAX package in tests/test_torch_rectify.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def distort_normalized(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply radial-tangential distortion to normalized coords (..., 2).

    dist = (k1, k2, p1, p2[, k3]) — the cv2/reference model
    (the reference's src/Frame.cc:586-628 undistorts the inverse mapping).
    """
    k1, k2, p1, p2 = dist[:4]
    k3 = dist[4] if len(dist) > 4 else 0.0
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_normalized(xy_d: np.ndarray, dist: np.ndarray,
                         iters: int = 8) -> np.ndarray:
    """Invert the distortion model by fixed-point iteration (the classic
    cv::undistortPoints scheme)."""
    x = xy_d.copy()
    k1, k2, p1, p2 = dist[:4]
    k3 = dist[4] if len(dist) > 4 else 0.0
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = np.stack(
            [(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial],
            axis=-1,
        )
    return x


def build_undistort_rectify_map(
    k: np.ndarray, dist: np.ndarray, r: np.ndarray, p: np.ndarray,
    size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """(map_x, map_y) float32 (H, W): source pixel for every rectified pixel.

    Semantics of cv::initUndistortRectifyMap: `r` is the rectification
    rotation (camera frame -> rectified frame, R1/R2 from stereoRectify),
    `p` the new 3x3 or 3x4 projection. For each destination pixel:
    ray = R^-1 P^-1 [u, v, 1], distort(ray/z), then through original K.
    """
    w, h = size
    k = np.asarray(k, np.float64)
    r = np.asarray(r, np.float64)
    p3 = np.asarray(p, np.float64)[:3, :3]
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    pix = np.stack([us, vs, np.ones_like(us)], axis=-1)  # (H, W, 3)
    ray = pix @ np.linalg.inv(p3).T @ np.linalg.inv(r).T
    xy = ray[..., :2] / ray[..., 2:3]
    xy_d = distort_normalized(xy, np.asarray(dist, np.float64))
    u_src = k[0, 0] * xy_d[..., 0] + k[0, 2]
    v_src = k[1, 1] * xy_d[..., 1] + k[1, 2]
    return u_src.astype(np.float32), v_src.astype(np.float32)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
                   fill: float = 0.0) -> np.ndarray:
    """Bilinear remap (cv::remap INTER_LINEAR + BORDER_CONSTANT)."""
    h, w = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0).astype(np.float32)
    fy = (map_y - y0).astype(np.float32)
    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    im = img.astype(np.float32)
    a = im[y0c, x0c]
    b = im[y0c, x0c + 1]
    c = im[y0c + 1, x0c]
    d = im[y0c + 1, x0c + 1]
    out = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    return np.where(valid, out, fill).astype(np.float32)


@dataclasses.dataclass
class StereoRectifier:
    """Precomputed rectification maps for a stereo rig (the reference's
    stereo_euroc example builds exactly this from the LEFT.*/RIGHT.* YAML
    keys via cv::initUndistortRectifyMap)."""

    map_lx: np.ndarray
    map_ly: np.ndarray
    map_rx: np.ndarray
    map_ry: np.ndarray

    @classmethod
    def from_calibration(cls, k_l, d_l, r_l, p_l, k_r, d_r, r_r, p_r,
                         size: tuple[int, int]) -> "StereoRectifier":
        mlx, mly = build_undistort_rectify_map(k_l, d_l, r_l, p_l, size)
        mrx, mry = build_undistort_rectify_map(k_r, d_r, r_r, p_r, size)
        return cls(mlx, mly, mrx, mry)

    @classmethod
    def from_settings(cls, raw: dict) -> "StereoRectifier | None":
        """Build from a parsed settings dict carrying LEFT.*/RIGHT.* matrix
        keys (the reference EuRoC.yaml schema); None when absent."""
        need = [f"{side}.{key}" for side in ("LEFT", "RIGHT")
                for key in ("K", "D", "R", "P")]
        if not all(k in raw for k in need):
            return None
        w = int(raw.get("LEFT.width", raw.get("Camera.width", 0)))
        h = int(raw.get("LEFT.height", raw.get("Camera.height", 0)))
        if w <= 0 or h <= 0:
            raise ValueError("rectification requires LEFT.width/LEFT.height")
        return cls.from_calibration(
            raw["LEFT.K"], np.ravel(raw["LEFT.D"]), raw["LEFT.R"], raw["LEFT.P"],
            raw["RIGHT.K"], np.ravel(raw["RIGHT.D"]), raw["RIGHT.R"], raw["RIGHT.P"],
            (w, h),
        )

    def rectify_left(self, img: np.ndarray) -> np.ndarray:
        return remap_bilinear(img, self.map_lx, self.map_ly)

    def rectify_right(self, img: np.ndarray) -> np.ndarray:
        return remap_bilinear(img, self.map_rx, self.map_ry)
