"""Sim3 estimation on torch tensors: Horn's closed form inside a batched
RANSAC, and the Sim3-guided mutual match growing.

Counterpart of orbslam2commentedbyxcm_tpu/ops/sim3solver.py (reference
src/Sim3Solver.cc ComputeSim3 :298-438, iterate :188-275, and
ORBmatcher::SearchBySim3, src/ORBmatcher.cc:1361). Every RANSAC hypothesis is
a 3-point minimal sample; its quaternion is the top eigenvector of Horn's
4x4 N matrix, all hypotheses in one batched `torch.linalg.eigh`.
`ransac_sim3` carries a leading candidate axis, so the loop closer scores
every candidate keyframe's hypotheses in one pass (the JAX package vmaps the
single-candidate solver).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2commentedbyxcm_tpu_torch.ops import matching
from orbslam2commentedbyxcm_tpu_torch.ops.twoview import draw_samples
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import quat_to_rot, sim3_make


def _horn_n(m: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4x4 N matrix of a (..., 3, 3) correlation m."""
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
        ],
        dim=-2,
    )


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity p2 ~ s R p1 + t from paired points (..., m, 3)
    (Horn 1987, reference ComputeSim3). Returns (R, t, s)."""
    c1 = p1.mean(dim=-2, keepdim=True)
    c2 = p2.mean(dim=-2, keepdim=True)
    q1, q2 = p1 - c1, p2 - c2
    m = torch.einsum("...mi,...mj->...ij", q1, q2)
    _, v = torch.linalg.eigh(_horn_n(m))
    r = quat_to_rot(v[..., :, -1])  # largest eigenvalue -> quaternion (w, x, y, z)
    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        s = torch.sqrt(torch.sum(q2 * q2, dim=(-1, -2)) / torch.clamp(torch.sum(q1 * q1, dim=(-1, -2)), min=1e-12))
    t = c2[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", r, c1[..., 0, :])
    return r, t, s


class Sim3Result(NamedTuple):
    s12: torch.Tensor        # (C, 4, 4) [sR t; 0 1] mapping frame-2 coords -> frame-1
    inliers: torch.Tensor    # (C, N) bool
    n_inliers: torch.Tensor  # (C,)
    success: torch.Tensor    # (C,) bool


def ransac_sim3(
    pts1_cam: torch.Tensor,    # (C, N, 3) matched points in KF1's camera frame
    pts2_cam: torch.Tensor,    # (C, N, 3) the same points in KF2's camera frame
    mask: torch.Tensor,        # (C, N) bool
    k_mat: torch.Tensor,       # (3, 3)
    sigma2_1: torch.Tensor,    # (C, N) px^2 per match in image 1
    sigma2_2: torch.Tensor,
    fix_scale: bool = False,
    n_hypotheses: int = 128,
    chi2_th: float = 9.21,     # reference: th = 9.210 * sigma^2 (2 dof, 99%)
    min_inliers: int = 20,
    samples: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Sim3Result:
    """Relative Sim3 S12 (p1 = S12 p2) of C candidate pairs at once
    (reference Sim3Solver::iterate): Horn hypotheses from 3-point samples,
    a bidirectional reprojection chi2 score, then two weighted-Horn
    refinements on the consensus set, each kept when it scores at least as
    many inliers. `samples` (C, n_hypotheses, 3) are the draws; without them
    they come from `generator`."""
    if samples is None:
        samples = draw_samples(mask, n_hypotheses, 3, generator)
    samples = samples.long()
    c = pts1_cam.shape[0]
    lane = torch.arange(c, device=pts1_cam.device)[:, None, None]
    # hypotheses map 2 -> 1: (C, H, ...)
    r_all, t_all, s_all = horn_sim3(pts2_cam[lane, samples], pts1_cam[lane, samples], fix_scale)
    fx, fy, cx, cy = k_mat[0, 0], k_mat[1, 1], k_mat[0, 2], k_mat[1, 2]

    def project(p):
        z = torch.where(p[..., 2] < 1e-6, 1e-6, p[..., 2])
        return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)

    uv1_obs, uv2_obs = project(pts1_cam), project(pts2_cam)

    def score(r, t, s):
        """r (C, H, 3, 3), t (C, H, 3), s (C, H) -> counts (C, H), ok (C, H, N)."""
        p2_in_1 = s[..., None, None] * torch.einsum("cnj,chij->chni", pts2_cam, r) + t[:, :, None, :]
        e1 = torch.sum((project(p2_in_1) - uv1_obs[:, None]) ** 2, dim=-1)
        # S12^-1 p1 = R^T (p1 - t) / s
        p1_in_2 = torch.einsum("chni,chij->chnj", pts1_cam[:, None] - t[:, :, None, :], r) / s[..., None, None]
        e2 = torch.sum((project(p1_in_2) - uv2_obs[:, None]) ** 2, dim=-1)
        ok = (e1 < chi2_th * sigma2_1[:, None]) & (e2 < chi2_th * sigma2_2[:, None]) & mask[:, None]
        return ok.sum(dim=-1), ok

    counts, inls = score(r_all, t_all, s_all)
    best = torch.argmax(counts, dim=1)  # first maximum, as jnp.argmax
    ar = torch.arange(c, device=best.device)
    inliers, r, t, s = inls[ar, best], r_all[ar, best], t_all[ar, best], s_all[ar, best]

    for _ in range(2):
        w = inliers.float()[..., None]
        wsum = torch.clamp(w.sum(dim=1), min=1.0)                  # (C, 1)
        c2 = torch.sum(pts2_cam * w, dim=1) / wsum                  # (C, 3)
        c1 = torch.sum(pts1_cam * w, dim=1) / wsum
        d1, d2 = pts1_cam - c1[:, None], pts2_cam - c2[:, None]
        m = (d2 * w).transpose(1, 2) @ d1                           # weighted N matrix 2 -> 1
        _, v = torch.linalg.eigh(_horn_n(m))
        r2 = quat_to_rot(v[..., :, -1])
        if fix_scale:
            s2 = torch.ones(c, dtype=pts1_cam.dtype, device=pts1_cam.device)
        else:
            num = torch.sum((d1 * w) ** 2, dim=(1, 2))
            den = torch.clamp(torch.sum((d2 * w) ** 2, dim=(1, 2)), min=1e-12)
            s2 = torch.sqrt(num / den)
        t2 = c1 - s2[:, None] * torch.einsum("cij,cj->ci", r2, c2)
        cnt2, inl2 = score(r2[:, None], t2[:, None], s2[:, None])
        better = cnt2[:, 0] >= inliers.sum(dim=1)
        r = torch.where(better[:, None, None], r2, r)
        t = torch.where(better[:, None], t2, t)
        s = torch.where(better, s2, s)
        inliers = torch.where(better[:, None], inl2[:, 0], inliers)
    n_inl = inliers.sum(dim=1)
    return Sim3Result(s12=sim3_make(r, t, s), inliers=inliers, n_inliers=n_inl, success=n_inl >= min_inliers)


def search_by_sim3(
    s12: torch.Tensor,        # (4, 4) Sim3 mapping cam2 coords -> cam1 coords
    pts1: torch.Tensor,       # (M, 3) map points of KF1's rows, in cam1
    pdesc1: torch.Tensor,     # (M, 8) int32 point descriptors
    dmax1: torch.Tensor,      # (M,) scale-invariance max distance
    uv1: torch.Tensor,        # (M, 2) KF1 feature pixels (candidate targets)
    fdesc1: torch.Tensor,     # (M, 8) int32 KF1 feature descriptors
    lvl1: torch.Tensor,       # (M,) KF1 feature octaves
    mask1: torch.Tensor,      # (M,) the row carries a valid point
    already1: torch.Tensor,   # (M,) the feature is already matched (not a source)
    pts2, pdesc2, dmax2, uv2, fdesc2, lvl2, mask2, already2,  # the same for KF2
    k_mat: torch.Tensor,
    width: float, height: float,
    log_scale: float,
    n_levels: int,
    th: float = 7.5,          # search radius factor (reference LoopClosing.cc:344)
    max_dist: float = 100.0,  # TH_HIGH (reference :1492)
):
    """Mutual Sim3-guided projection matching between two keyframes' map
    points (SearchBySim3): KF1's points go into KF2 through S21 and KF2's
    into KF1 through S12, each takes the nearest descriptor in its window
    at the predicted octave (first on ties, as jnp.argmin), and a pair is
    kept where both directions agree. Returns (match1 (M,) index into KF2's
    rows, agree1 (M,) bool)."""
    fx, fy, cx, cy = k_mat[0, 0], k_mat[1, 1], k_mat[0, 2], k_mat[1, 2]
    s21 = torch.linalg.inv(s12)
    log_s = pts1.new_tensor(log_scale)

    def direction(s_ba, pts_a, pdesc_a, dmax_a, mask_a, already_a, uv_b, fdesc_b, lvl_b, already_b):
        q = pts_a @ s_ba[:3, :3].T + s_ba[:3, 3]
        z = q[:, 2]
        z_ok = z > 1e-6
        zs = torch.where(z_ok, z, 1.0)
        u = fx * q[:, 0] / zs + cx
        v = fy * q[:, 1] / zs + cy
        in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height)
        dist = torch.linalg.vector_norm(q, dim=-1)
        dmin_a = dmax_a / torch.exp(log_s * (n_levels - 1))
        band = (dist >= dmin_a) & (dist <= dmax_a)
        pred = torch.clamp(torch.ceil(torch.log(torch.clamp(dmax_a / torch.clamp(dist, min=1e-9), min=1e-9))
                                      / log_s), 0, n_levels - 1).int()
        radius = th * torch.exp(pred.float() * log_s)
        visible = mask_a & ~already_a & z_ok & in_img & band
        duv = torch.maximum(torch.abs(u[:, None] - uv_b[None, :, 0]), torch.abs(v[:, None] - uv_b[None, :, 1]))
        lvl_ok = (lvl_b[None, :] >= pred[:, None] - 1) & (lvl_b[None, :] <= pred[:, None])  # ref :1480-1482
        cand = visible[:, None] & (duv <= radius[:, None]) & lvl_ok & ~already_b[None, :]
        d = torch.where(cand, matching.hamming_matrix(pdesc_a, fdesc_b), matching.BIG)
        return torch.argmin(d, dim=1), torch.amin(d, dim=1) <= max_dist

    match1, ok1 = direction(s21, pts1, pdesc1, dmax1, mask1, already1, uv2, fdesc2, lvl2, already2)
    match2, ok2 = direction(s12, pts2, pdesc2, dmax2, mask2, already2, uv1, fdesc1, lvl1, already1)
    agree = ok1 & ok2[match1] & (match2[match1] == torch.arange(match1.shape[0], device=match1.device))
    return match1, agree
