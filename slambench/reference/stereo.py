"""Plain stereo and RGB-D observations: the reference for the depth and the
right-image coordinate the port attaches to each keypoint.

RGB-D (upstream Frame::ComputeStereoFromRGBD): the depth at the truncated
keypoint pixel; where it is finite and positive, u_right = u - bf / depth,
else both are -1.

Stereo (upstream Frame::ComputeStereoMatches, with the median SAD filter
once after the loop): per left keypoint the right keypoints in its row band
(2 x its level's scale) within +-1 level and the disparity range [0, fx],
the least Hamming distance (first minimum) up to 75, then an 11 x 11 SAD
slide of +-5 pixels around the match with a parabola through the best and
its neighbours, kept when the best slide is interior, the disparity
positive, and its SAD at most 1.5 x 1.4 x the median of the kept SADs. On
8-bit images every SAD is an exact sum, so the order of the sums does not
matter.

`precision="bf16"` is the control: the depth, the SAD and the parabola in
bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

TH_ORB = 75  # (TH_LOW 50 + TH_HIGH 100) / 2
SAD_W, SAD_L = 5, 5
BIG = 1e9


def rgbd(uv: torch.Tensor, valid: torch.Tensor, depth_map: np.ndarray, bf: float, precision: str = "f32"):
    """-> (depth (N,), u_right (N,)) float32, -1 where there is none."""
    dm = torch.as_tensor(np.asarray(depth_map, np.float32))
    h, w = dm.shape
    u = uv[:, 0].long().clamp(0, w - 1)
    v = uv[:, 1].long().clamp(0, h - 1)
    d = dm[v, u]
    good = torch.isfinite(d) & (d > 0) & valid
    if precision == "bf16":
        db = d.bfloat16()
        u_right = (uv[:, 0].bfloat16() - db.new_tensor(bf) / db).float()
        d = db.float()
    else:
        u_right = uv[:, 0] - d.new_tensor(bf) / d
    return torch.where(good, d, -1.0), torch.where(good, u_right, -1.0)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) bit distances."""
    return sum(_popcount32(a[:, None, k] ^ b[None, :, k]) for k in range(8)).float()


def _windows(img, y0, x0, n_rows, n_cols):
    rows = y0[:, None] + torch.arange(n_rows)
    cols = x0[:, None] + torch.arange(n_cols)
    return img[rows[:, :, None], cols[:, None, :]]


def stereo(left, right, left_img, right_img, scales, fx: float, bf: float, precision: str = "f32"):
    """left, right: reference Features; *_img: (H, W) images -> (depth,
    u_right), -1 where no match was kept."""
    limg = torch.as_tensor(np.asarray(left_img, np.float32))
    rimg = torch.as_tensor(np.asarray(right_img, np.float32))
    h, w = limg.shape
    n = left.uv.shape[0]
    sf = torch.tensor(np.asarray(scales, np.float32))
    r_band = 2.0 * sf[left.level.long()]
    dv = torch.abs(left.uv[:, 1, None] - right.uv[None, :, 1])
    lvl_ok = (right.level[None, :] >= left.level[:, None] - 1) & (right.level[None, :] <= left.level[:, None] + 1)
    disp = left.uv[:, 0, None] - right.uv[None, :, 0]
    max_disp = float(fx)
    cand = (dv <= r_band[:, None]) & lvl_ok & (disp >= 0.0) & (disp <= max_disp) & left.valid[:, None] \
        & right.valid[None, :]
    d = torch.where(cand, hamming(left.desc, right.desc), BIG)
    best_r = torch.argmin(d, dim=1)
    coarse_ok = torch.amin(d, dim=1) <= TH_ORB

    wside = 2 * SAD_W + 1
    u0 = torch.round(right.uv[best_r, 0]).long()
    vl = torch.round(left.uv[:, 1]).long()
    ul = torch.round(left.uv[:, 0]).long()
    ulc = torch.clamp(ul, SAD_W, w - SAD_W - 1)
    u0c = torch.clamp(u0, SAD_W + SAD_L, w - (SAD_W + SAD_L) - 2)
    py0 = torch.clamp(vl - SAD_W, 0, h - wside)
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    patch_l = _windows(limg, py0, ulc - SAD_W, wside, wside).to(dt)
    patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    reg_r = _windows(rimg, py0, u0c - SAD_W - SAD_L, wside, wside + 2 * SAD_L).to(dt)
    slides = reg_r.unfold(2, wside, 1).permute(0, 2, 1, 3)
    slides = slides - slides[:, :, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    sad = torch.abs(slides - patch_l[:, None]).sum(dim=(2, 3), dtype=dt)
    best_s = torch.argmin(sad, dim=1)
    best_sad = torch.amin(sad, dim=1)
    interior = (best_s > 0) & (best_s < 2 * SAD_L)
    rows = torch.arange(n)
    im1 = sad[rows, torch.clamp(best_s - 1, min=0)]
    ip1 = sad[rows, torch.clamp(best_s + 1, max=2 * SAD_L)]
    denom = im1 + ip1 - 2.0 * best_sad
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (im1 - ip1) / torch.clamp(denom, min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    u_right = (u0.to(dt) + (best_s - SAD_L).to(dt) + delta).float()
    disparity = left.uv[:, 0] - u_right
    ok = coarse_ok & interior & (disparity > 0.01) & (disparity <= max_disp)
    best_sad = best_sad.float()
    kept = torch.sort(torch.where(ok, best_sad, torch.inf)).values
    n_ok = int(ok.sum())
    median = (kept[max((n_ok - 1) // 2, 0)] + kept[min(n_ok // 2, n - 1)]) / 2.0 if n_ok else torch.tensor(0.0)
    ok = ok & (best_sad <= 1.5 * 1.4 * median)
    u_right = torch.where(ok, u_right, -1.0)
    depth = torch.where(ok, torch.tensor(np.float32(bf)) / disparity, -1.0)
    return depth, u_right
