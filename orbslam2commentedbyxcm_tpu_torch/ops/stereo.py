"""Stereo matching: row-banded Hamming + SAD subpixel disparity refinement.

Counterpart of orbslam2commentedbyxcm_tpu/ops/stereo.py (Frame::
ComputeStereoMatches, reference src/Frame.cc:673-885, with the upstream
median filter run once after the loop). The coarse stage is the same: row
band, level gate, disparity range, Hamming with the first argmin. The fine
stage gathers each feature's 11x11 left patch and 11x21 right region
directly and sums the SAD in float32; the JAX package extracts those windows
from 128-wide column panels with a bf16 one-hot contraction, a TPU shape that
rounds every pixel to bf16. The two agree exactly on integer-valued images
(8-bit data, as real datasets are); on fractional images the port's SAD is
the unrounded one.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops import matching

SAD_W = 5       # half window (11x11 like the reference)
SAD_L = 5       # search slide +-5
TH_ORB = (matching.TH_LOW + matching.TH_HIGH) // 2  # 75 (reference :724)


def _windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, n_rows: int, n_cols: int):
    """(N, n_rows, n_cols) windows of `img` with top-left corners (y0, x0)."""
    rows = y0[:, None] + torch.arange(n_rows, device=img.device)
    cols = x0[:, None] + torch.arange(n_cols, device=img.device)
    return img[rows[:, :, None], cols[:, None, :]]


def _median(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """numpy's median of x[keep] (mean of the two middle values), 0 when
    nothing is kept; no host read."""
    n = keep.sum()
    s = torch.sort(torch.where(keep, x, torch.inf)).values
    lo = s[torch.clamp((n - 1) // 2, min=0)]
    hi = s[torch.clamp(n // 2, max=len(x) - 1)]
    return torch.where(n > 0, (lo + hi) / 2.0, 0.0)


def stereo_match(
    l_uv, l_desc, l_level, l_valid,
    r_uv, r_desc, r_level, r_valid,
    left_img, right_img,
    scale_factors, min_disp, max_disp,
):
    """Batched stereo correspondence. Returns (u_right, disparity, ok).

    l_*/r_*: feature tensors of the two views; *_img: (H, W) float32 (SAD
    over raw intensities, like the reference). scale_factors: (n_levels,)
    pyramid scales for the row-band radii."""
    h, w = left_img.shape
    n = l_uv.shape[0]

    # --- coarse: row band + level gate + disparity range + Hamming --------
    r_band = 2.0 * scale_factors[l_level.long()]  # reference :698
    dv = torch.abs(l_uv[:, 1, None] - r_uv[None, :, 1])
    lvl_ok = (r_level[None, :] >= l_level[:, None] - 1) & (r_level[None, :] <= l_level[:, None] + 1)
    disp = l_uv[:, 0, None] - r_uv[None, :, 0]
    cand = ((dv <= r_band[:, None]) & lvl_ok & (disp >= min_disp) & (disp <= max_disp)
            & l_valid[:, None] & r_valid[None, :])
    d = torch.where(cand, matching.hamming_matrix(l_desc, r_desc), matching.BIG)
    best_r = torch.argmin(d, dim=1)
    coarse_ok = torch.amin(d, dim=1) <= TH_ORB

    # --- fine: SAD slide around the coarse match --------------------------
    wside = 2 * SAD_W + 1
    u0 = torch.round(r_uv[best_r, 0]).long()
    vl = torch.round(l_uv[:, 1]).long()
    ul = torch.round(l_uv[:, 0]).long()
    ulc = torch.clamp(ul, SAD_W, w - SAD_W - 1)
    u0c = torch.clamp(u0, SAD_W + SAD_L, w - (SAD_W + SAD_L) - 2)
    py0 = torch.clamp(vl - SAD_W, 0, h - wside)

    patch_l = _windows(left_img, py0, ulc - SAD_W, wside, wside)              # (N, 11, 11)
    patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    reg_r = _windows(right_img, py0, u0c - SAD_W - SAD_L, wside, wside + 2 * SAD_L)  # (N, 11, 21)
    slides = reg_r.unfold(2, wside, 1).permute(0, 2, 1, 3)                  # (N, 11 slides, 11, 11)
    # normalize by the slid patch's own center (reference :813)
    slides = slides - slides[:, :, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    sad = torch.sum(torch.abs(slides - patch_l[:, None]), dim=(2, 3))      # (N, 11)

    best_s = torch.argmin(sad, dim=1)
    best_sad = torch.amin(sad, dim=1)
    interior = (best_s > 0) & (best_s < 2 * SAD_L)
    rows = torch.arange(n, device=sad.device)
    im1 = sad[rows, torch.clamp(best_s - 1, min=0)]
    ip1 = sad[rows, torch.clamp(best_s + 1, max=2 * SAD_L)]
    denom = im1 + ip1 - 2.0 * best_sad
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (im1 - ip1) / torch.clamp(denom, min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    u_right = u0.float() + (best_s - SAD_L).float() + delta

    disparity = l_uv[:, 0] - u_right
    ok = coarse_ok & interior & (disparity > max(min_disp, 0.01)) & (disparity <= max_disp)

    # --- median SAD outlier filter (upstream-correct: once, post-loop) ----
    ok = ok & (best_sad <= 1.5 * 1.4 * _median(best_sad, ok))
    return u_right, disparity, ok


def stereo_match_frame(frame, left_img: torch.Tensor, right_img: torch.Tensor, extractor, camera):
    """Extract right-view ORB features and fill frame.u_right / frame.depth.
    Both images are (H, W) float32 tensors on the frame's device."""
    r_feats = extractor(right_img)
    lf = frame.feats
    scale_factors = torch.from_numpy(
        (frame.scale_factor ** np.arange(frame.n_levels)).astype(np.float32)).to(right_img.device)
    # reference: minD = 0, maxD = fx (i.e. minZ = baseline), src/Frame.cc:711
    u_right, disparity, ok = stereo_match(
        lf.uv, lf.desc, lf.level, lf.valid,
        r_feats.uv, r_feats.desc, r_feats.level, r_feats.valid,
        left_img, right_img, scale_factors, 0.0, float(camera.fx),
    )
    ok, u_right, disparity = ok.cpu().numpy(), u_right.cpu().numpy(), disparity.cpu().numpy()
    frame.u_right = np.where(ok, u_right, -1.0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = camera.bf / disparity
    frame.depth = np.where(ok, depth, -1.0).astype(np.float32)
    return frame
