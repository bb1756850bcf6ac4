"""Synthetic sequences with exact ground truth (numpy only).

Counterpart of `SyntheticSequence` (textured fronto-parallel planes),
`BoxSequence` (a camera orbiting inside a textured box) and `default_camera`
in orbslam2commentedbyxcm_tpu/utils/synth.py. The textures and poses are built
with the same numpy calls from the same seed, so both packages see the same
scene. Rendering does not use OpenCV: `_warp_perspective` reproduces
cv2.warpPerspective(INTER_LINEAR, BORDER_CONSTANT) with an inverse homography,
coordinates rounded to OpenCV's 1/32-pixel grid, and bilinear sampling in
float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera

_TAB = 32  # OpenCV INTER_TAB_SIZE: sub-pixel positions per pixel


def _make_texture(rng, size, n_blobs=4000):
    tex = np.full((size, size), 96.0, np.float32)
    ys = rng.integers(0, size - 16, n_blobs)
    xs = rng.integers(0, size - 16, n_blobs)
    for y, x in zip(ys, xs):
        h, w = rng.integers(3, 14), rng.integers(3, 14)
        tex[y : y + h, x : x + w] = rng.uniform(10, 250)
    return tex


def _warp_perspective(src: np.ndarray, hmg: np.ndarray, width: int, height: int,
                      border: float) -> np.ndarray:
    """dst(x, y) = src(H^-1 (x, y, 1)), bilinear, `border` outside src."""
    m = np.linalg.inv(np.asarray(hmg, np.float64))
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    w = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    w = np.divide(_TAB, w, out=np.zeros_like(w), where=w != 0)
    lim = (np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    fx = np.clip((m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) * w, *lim)
    fy = np.clip((m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) * w, *lim)
    ix, iy = np.rint(fx).astype(np.int64), np.rint(fy).astype(np.int64)
    sx = np.clip(ix >> 5, -32768, 32767)
    sy = np.clip(iy >> 5, -32768, 32767)
    ax = ((ix & (_TAB - 1)) / np.float32(_TAB)).astype(np.float32)
    ay = ((iy & (_TAB - 1)) / np.float32(_TAB)).astype(np.float32)
    sh, sw = src.shape

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
        vals = src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        return np.where(ok, vals, np.float32(border)).astype(np.float32)

    one = np.float32(1.0)
    return ((one - ay) * (one - ax) * tap(sy, sx) + (one - ay) * ax * tap(sy, sx + 1)
            + ay * (one - ax) * tap(sy + 1, sx) + ay * ax * tap(sy + 1, sx + 1))


@dataclasses.dataclass
class SyntheticSequence:
    """Textured planes z = depth (the near one a patch, so the scene is not
    planar), rendered far to near through exact plane-induced homographies.
    `pose(i)` is Tcw; the trajectories are arc (sideways + gentle yaw),
    sideways, outback (out and back to the start) and forward."""

    camera: Camera
    n_frames: int = 120
    depths: tuple = (6.0, 10.0)
    half_extents: tuple = (2.5, 16.0)
    trajectory: str = "arc"
    seed: int = 0
    tex_size: int = 1024

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.textures = [_make_texture(rng, self.tex_size) for _ in self.depths]
        # world -> texture pixel: u_tex = s (x + e), v_tex = s (y + e)
        self.tex_scales = [self.tex_size / (2 * e) for e in self.half_extents]

    def pose(self, i: int) -> np.ndarray:
        """Ground-truth Tcw for frame i (extrapolates past n_frames)."""
        t = i / max(self.n_frames - 1, 1)
        yaw = 0.0
        if self.trajectory == "sideways":
            c = np.array([2.0 * t, 0.1 * np.sin(4 * np.pi * t), 0.0])
        elif self.trajectory == "outback":
            c = np.array([3.0 * np.sin(np.pi * t), 0.05 * np.sin(2 * np.pi * t), 0.0])
        elif self.trajectory == "forward":
            c = np.array([0.3 * np.sin(2 * np.pi * t), 0.0, 2.0 * t])
        else:  # arc
            c = np.array([2.5 * t, 0.15 * np.sin(2 * np.pi * t), 0.5 * np.sin(np.pi * t)])
            yaw = 0.25 * np.sin(2 * np.pi * t)
        cy, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, :3] = r_wc.T
        t_cw[:3, 3] = -r_wc.T @ c
        return t_cw

    def render(self, i: int) -> np.ndarray:
        return self.render_pose(self.pose(i))

    def render_right(self, i: int) -> np.ndarray:
        """Right-stereo view: camera displaced by baseline b along +x."""
        t_rl = np.eye(4, dtype=np.float64)
        t_rl[0, 3] = -self.camera.b
        return self.render_pose(t_rl @ self.pose(i).astype(np.float64))

    def render_pose(self, t_cw: np.ndarray) -> np.ndarray:
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = np.asarray(t_cw, np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        img = np.zeros((cam.height, cam.width), np.float32)
        order = sorted(zip(self.textures, self.depths, self.tex_scales, self.half_extents),
                       key=lambda z: -z[1])
        for tex, depth, s, e in order:
            # texture pixel -> world (x, y, 1) -> camera -> image
            a = np.array([[1 / s, 0, -e], [0, 1 / s, -e], [0, 0, 1]])
            hmg = k @ np.column_stack([r[:, 0], r[:, 1], r[:, 2] * depth + t]) @ a
            warped = _warp_perspective(tex, hmg, cam.width, cam.height, border=-1.0)
            img = np.where(warped >= 0, warped, img)
        return img.astype(np.float32)

    def depth_map(self, i: int) -> np.ndarray:
        """Exact per-pixel depth (RGB-D)."""
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = self.pose(i).astype(np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        rays = np.linalg.inv(k) @ np.stack([us.ravel() + 0.0, vs.ravel() + 0.0, np.ones(us.size)])
        r_wc = r.T
        d_w = r_wc @ rays
        c_w = -r_wc @ t
        depth = np.full(us.size, np.inf)
        for plane_depth, e in sorted(zip(self.depths, self.half_extents), key=lambda z: -z[0]):
            lam = (plane_depth - c_w[2]) / d_w[2]
            pw = c_w[:, None] + lam * d_w
            inside = (np.abs(pw[0]) < e) & (np.abs(pw[1]) < e) & (lam > 0)
            zc = (r @ pw + t[:, None])[2]
            depth = np.where(inside, zc, depth)
        return depth.reshape(cam.height, cam.width).astype(np.float32)


@dataclasses.dataclass
class BoxSequence:
    """Camera orbiting inside a textured box, looking outward."""

    camera: Camera
    n_frames: int = 120
    half_size: float = 8.0      # box half extent
    radius: float = 2.0         # camera orbit radius
    turns: float = 1.0          # fraction of full revolutions
    seed: int = 0
    tex_size: int = 1024
    trajectory: str = "orbit"

    def __post_init__(self):
        if self.trajectory != "orbit":
            raise NotImplementedError(f"trajectory {self.trajectory!r}: only 'orbit' is ported")
        rng = np.random.default_rng(self.seed)
        h = self.half_size
        # walls: (center, e1 (u axis), e2 (v axis), texture); normals point inward
        self.walls = []
        for c, e1 in (
            (np.array([0, 0, h]), np.array([1, 0, 0])),
            (np.array([h, 0, 0]), np.array([0, 0, -1.0])),
            (np.array([0, 0, -h]), np.array([-1.0, 0, 0])),
            (np.array([-h, 0, 0]), np.array([0, 0, 1.0])),
        ):
            e2 = np.array([0, 1.0, 0])
            self.walls.append((c.astype(np.float64), e1.astype(np.float64), e2,
                               _make_texture(rng, self.tex_size)))
        self.tex_scale = self.tex_size / (2 * h)

    def pose(self, i: int) -> np.ndarray:
        """Ground-truth Tcw for frame i (circle looking outward, slight bob)."""
        t = i / max(self.n_frames - 1, 1)
        theta = 2 * np.pi * self.turns * t
        c = self.radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
        c[1] = 0.1 * np.sin(4 * np.pi * t)
        cy, sy = np.cos(theta), np.sin(theta)
        r_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, :3] = r_wc.T
        t_cw[:3, 3] = -r_wc.T @ c
        return t_cw

    def render(self, i: int) -> np.ndarray:
        return self.render_pose(self.pose(i))

    def render_right(self, i: int) -> np.ndarray:
        """Right-stereo view: camera displaced by baseline b along +x."""
        t_rl = np.eye(4, dtype=np.float64)
        t_rl[0, 3] = -self.camera.b
        return self.render_pose(t_rl @ self.pose(i).astype(np.float64))

    def render_pose(self, t_cw: np.ndarray) -> np.ndarray:
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = np.asarray(t_cw, np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        img = np.full((cam.height, cam.width), -1.0, np.float32)
        s, h = self.tex_scale, self.half_size
        for c, e1, e2, tex in self.walls:
            # only walls whose center lies in front of the camera
            if (r @ c + t)[2] < 0.3:
                continue
            # tex(u_px, v_px) -> image: world = C + (u/s - h) e1 + (v/s - h) e2
            hmg = k @ np.column_stack([r @ e1 / s, r @ e2 / s, r @ (c - h * e1 - h * e2) + t])
            warped = _warp_perspective(tex, hmg, cam.width, cam.height, border=-1.0)
            img = np.where((warped >= 0) & (img < 0), warped, img)
        return np.where(img < 0, 64.0, img).astype(np.float32)

    def depth_map(self, i: int) -> np.ndarray:
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = self.pose(i).astype(np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        rays = np.linalg.inv(k) @ np.stack([us.ravel() + 0.0, vs.ravel() + 0.0, np.ones(us.size)])
        r_wc = r.T
        d_w = r_wc @ rays
        c_w = -r_wc @ t
        h = self.half_size
        depth = np.full(us.size, np.inf)
        for cw, e1, e2, _ in self.walls:
            n = np.cross(e1, e2)
            denom = n @ d_w
            hit = np.abs(denom) > 1e-9
            lam = np.where(hit, (n @ (cw - c_w)) / np.where(hit, denom, 1.0), np.inf)
            with np.errstate(invalid="ignore"):  # rays parallel to the wall: inf * 0
                pw = c_w[:, None] + lam * d_w
                local1 = (pw - cw[:, None]).T @ e1
                local2 = (pw - cw[:, None]).T @ e2
            inside = (np.abs(local1) <= h) & (np.abs(local2) <= h) & (lam > 0)
            zc = (r @ pw + t[:, None])[2]
            depth = np.where(inside & (zc < depth), zc, depth)
        return depth.reshape(cam.height, cam.width).astype(np.float32)


def default_camera(width=640, height=480) -> Camera:
    return Camera(fx=500.0, fy=500.0, cx=width / 2, cy=height / 2,
                  width=width, height=height, bf=40.0, fps=30.0)
