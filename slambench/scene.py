"""The benchmark's scene and camera paths, rendered on the device.

The scene is the port's BoxSequence (utils/synth.py): four textured walls of
a cube around the origin, each texture 96 grey with rectangular blobs of
3 to 13 texels and uniform 10-250 intensity painted over it, later blobs on
top (the rectangles and the set of intensities fixed; the seed deals the
intensities to the rectangles in its own order); a wall spans its whole
face, so a ray that leaves the cube through the floor or the ceiling sees
the background, 64. The texture is sampled as
OpenCV's warpPerspective samples it: bilinear, with the sample position
rounded to 1/32 pixel. This copy renders by casting each pixel's ray, on
the device, in float64, and keeps a hit only in front of the camera (where
BoxSequence's homography can also map a wall that lies behind the camera).
Only the order of the walls' intensities comes from the seed.

Camera paths are functions of time, so a cell's rate and speed fix every
frame; `pose(t)` is the world -> camera pose at t seconds:
  orbit  a circle of `radius_m` looking outward, at `speed_m_s`
  eight  two tangent circles of `radius_m`, forward-looking (BoxSequence's
         figure-eight: lobe A, lobe B, back into lobe A), at `speed_m_s`
  sweep  the orbit's circle, its heading swinging +-`amplitude_deg` about
         `center_deg` as center - amplitude cos(w t), w set by the peak
         angular rate `peak_rate_deg_s`
each with a vertical bob of `bob_m` and period `bob_period_s`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TAB = 32  # OpenCV INTER_TAB_SIZE
BACKGROUND = 64.0
WALLS = (  # (center / half_size, e1); e2 is +y, the normal e1 x e2 points inward
    ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0)),
    ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)),
    ((0.0, 0.0, -1.0), (-1.0, 0.0, 0.0)),
    ((-1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
)


BLOB_SEED = 20161017  # the walls' blob rectangles and their set of values, fixed for every run


def make_textures(n_walls: int, size: int, n_blobs: int, seed: int, device) -> torch.Tensor:
    """(n_walls, size, size) float32 textures on the device: each wall's
    blobs (rectangles and their set of values) are fixed, and the seed
    draws the order in which that set of values is dealt to the blobs, so
    every seed's walls hold the same corners at the same places, with
    their contrasts in another order. A few large calls; each texel takes
    the value of the last blob that covers it."""
    g = torch.Generator(device=device)
    g.manual_seed(BLOB_SEED)
    shape = (n_walls, n_blobs)
    ys = torch.randint(0, size - 16, shape, generator=g, device=device)
    xs = torch.randint(0, size - 16, shape, generator=g, device=device)
    hs = torch.randint(3, 14, shape, generator=g, device=device)
    ws = torch.randint(3, 14, shape, generator=g, device=device)
    vals = 10.0 + 240.0 * torch.rand(shape, generator=g, device=device)
    g.manual_seed(int(seed) % (1 << 63))
    order = torch.argsort(torch.rand(shape, generator=g, device=device), dim=1)
    vals = torch.gather(vals, 1, order)
    d = torch.arange(13, device=device)
    dy, dx = d[:, None], d[None, :]
    cover = (dy < hs[..., None, None]) & (dx < ws[..., None, None])           # (W, B, 13, 13)
    texel = (ys[..., None, None] + dy) * size + xs[..., None, None] + dx
    wall = torch.arange(n_walls, device=device)[:, None, None, None]
    flat = (wall * size * size + texel)[cover]
    blob = torch.arange(n_blobs, device=device).expand(n_walls, n_blobs)[..., None, None].expand(cover.shape)[cover]
    last = torch.full((n_walls * size * size,), -1, dtype=torch.int64, device=device)
    last.scatter_reduce_(0, flat, blob, reduce="amax")
    wall_of = torch.arange(n_walls * size * size, device=device) // (size * size)
    picked = vals[wall_of, last.clamp(min=0)]
    tex = torch.where(last >= 0, picked, torch.full_like(picked, 96.0))
    return tex.view(n_walls, size, size).float()


class Scene:
    def __init__(self, half_size: float, tex_size: int, n_blobs: int, seed: int, device):
        self.half_size = float(half_size)
        self.tex_size = int(tex_size)
        self.device = torch.device(device)
        self.textures = make_textures(len(WALLS), tex_size, n_blobs, seed, self.device)
        self.centers = torch.tensor([c for c, _ in WALLS], dtype=torch.float64, device=self.device) * half_size
        self.e1 = torch.tensor([e for _, e in WALLS], dtype=torch.float64, device=self.device)
        self.e2 = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=self.device).expand(len(WALLS), 3)
        self.normals = torch.linalg.cross(self.e1, self.e2)

    def render(self, t_cw: torch.Tensor, k: np.ndarray, width: int, height: int):
        """(B, 4, 4) world -> camera poses -> (images (B, H, W) float32,
        depth (B, H, W) float32, inf where no wall is hit)."""
        dev = self.device
        t_cw = torch.as_tensor(t_cw, dtype=torch.float64, device=dev)
        kinv = torch.as_tensor(np.linalg.inv(np.asarray(k, np.float64)), device=dev)
        vs, us = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float64),
                                torch.arange(width, device=dev, dtype=torch.float64), indexing="ij")
        rays_c = (torch.stack([us.reshape(-1), vs.reshape(-1), torch.ones_like(us).reshape(-1)], -1) @ kinv.T)
        r_wc = t_cw[:, :3, :3].transpose(1, 2)                                    # (B, 3, 3)
        c_w = -(r_wc @ t_cw[:, :3, 3:])[..., 0]                                   # (B, 3)
        d_w = rays_c[None] @ r_wc.transpose(1, 2)                                 # (B, P, 3)
        h, s = self.half_size, self.tex_size / (2 * self.half_size)
        b, p = d_w.shape[:2]
        image = torch.full((b, p), -1.0, dtype=torch.float32, device=dev)
        depth = torch.full((b, p), torch.inf, dtype=torch.float32, device=dev)
        for wi in range(len(WALLS)):
            n, cw, e1, e2 = self.normals[wi], self.centers[wi], self.e1[wi], self.e2[wi]
            denom = d_w @ n
            lam = ((cw - c_w) @ n)[:, None] / torch.where(denom.abs() > 1e-12, denom, 1e-12)
            hit = c_w[:, None, :] + lam[..., None] * d_w - cw
            a1, a2 = hit @ e1, hit @ e2
            inside = (a1.abs() <= h) & (a2.abs() <= h) & (lam > 0)
            # warpPerspective's sample: the texture position on OpenCV's 1/32 grid
            ix = torch.round((a1 + h) * s * TAB).clamp(-2**31, 2**31 - 1).long()
            iy = torch.round((a2 + h) * s * TAB).clamp(-2**31, 2**31 - 1).long()
            sx, sy = ix >> 5, iy >> 5
            ax = ((ix & (TAB - 1)).float() / TAB)
            ay = ((iy & (TAB - 1)).float() / TAB)
            val = self._bilinear(wi, sx, sy, ax, ay)
            take = inside & (val >= 0) & (image < 0)
            image = torch.where(take, val, image)
            depth = torch.where(inside & (lam.float() < depth), lam.float(), depth)
        image = torch.where(image < 0, BACKGROUND, image)
        return image.view(b, height, width), depth.view(b, height, width)

    def _bilinear(self, wi, sx, sy, ax, ay):
        tex = self.textures[wi]
        n = self.tex_size

        def tap(yy, xx):
            ok = (xx >= 0) & (xx < n) & (yy >= 0) & (yy < n)
            return torch.where(ok, tex[yy.clamp(0, n - 1), xx.clamp(0, n - 1)], -1.0)

        one = 1.0
        return ((one - ay) * (one - ax) * tap(sy, sx) + (one - ay) * ax * tap(sy, sx + 1)
                + ay * (one - ax) * tap(sy + 1, sx) + ay * ax * tap(sy + 1, sx + 1))


def _pose(theta: float, c: np.ndarray) -> np.ndarray:
    """World -> camera pose of a camera at c whose optical axis is
    (sin theta, 0, cos theta), y down."""
    cy, sy = math.cos(theta), math.sin(theta)
    r_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    t_cw = np.eye(4)
    t_cw[:3, :3] = r_wc.T
    t_cw[:3, 3] = -r_wc.T @ c
    return t_cw


class Path:
    """A camera path from a traffic file's parameters."""

    KINDS = ("orbit", "eight", "sweep")

    def __init__(self, params: dict):
        self.kind = params["trajectory"]
        if self.kind not in self.KINDS:
            raise ValueError(f"trajectory {self.kind!r}: one of {self.KINDS}")
        self.p = params

    def period_s(self) -> float:
        """The time after which the path repeats: a lap of the orbit, a
        swing of the sweep, the eight's two lobes. The bob has to repeat
        with it, so that a run can cycle one period of rendered frames."""
        p = self.p
        if self.kind == "orbit":
            period = 2 * math.pi * p["radius_m"] / p["speed_m_s"]
        elif self.kind == "sweep":
            period = 2 * math.pi * p["amplitude_deg"] / p["peak_rate_deg_s"]
        else:
            period = 2 * 2 * math.pi * p["radius_m"] / p["speed_m_s"]
        bobs = period / p["bob_period_s"]
        if round(bobs) < 1 or abs(bobs - round(bobs)) > 1e-3:
            raise ValueError(f"bob_period_s {p['bob_period_s']} does not divide the path's period {period:.6f} s")
        return period

    def pose(self, t: float) -> np.ndarray:
        p = self.p
        r = p["radius_m"]
        bob = p["bob_m"] * math.sin(2 * math.pi * t / p["bob_period_s"])
        if self.kind == "orbit":
            theta = p["speed_m_s"] * t / r
            c = np.array([r * math.sin(theta), bob, r * math.cos(theta)])
        elif self.kind == "sweep":
            amp = math.radians(p["amplitude_deg"])
            w = math.radians(p["peak_rate_deg_s"]) / amp
            theta = math.radians(p["center_deg"]) - amp * math.cos(w * t)
            c = np.array([r * math.sin(theta), bob, r * math.cos(theta)])
        else:  # eight: lobe A counter-clockwise, lobe B clockwise, then lobe A again
            rev = (p["speed_m_s"] * t / (2 * math.pi * r)) % 2.0
            if rev < 1.0:
                a = 2 * math.pi * rev
                x, z, theta = -r + r * math.cos(a), r * math.sin(a), -a
            else:
                b = 2 * math.pi * (rev - 1.0)
                x, z, theta = r - r * math.cos(b), r * math.sin(b), b
            c = np.array([x, bob, z])
        return _pose(theta, c)
