"""Levenberg-Marquardt solvers on torch tensors: motion-only pose
optimization (reference Optimizer::PoseOptimization, src/Optimizer.cc:
299-502) and Schur-complement bundle adjustment (LocalBundleAdjustment
:524-870, BundleAdjustment :41-296).

Counterpart of `pose_optimization` (algorithm="lm") and `bundle_adjustment`
in orbslam2commentedbyxcm_tpu/ops/optim.py. For CUDA tensors the whole 4 x 10
pose solve is one launch of the hand-written kernel in csrc/poseopt.cu
(ops/poseopt_kernel); `pose_optimization_plain` is its plain twin and follows
the JAX package's XLA path. The twin's LM loop runs a fixed n_iters steps per
round and masks every update once the round has converged, which gives the
while-loop's result without reading a flag back to the host.

`bundle_adjustment` is plain torch, as it is XLA in the JAX package. Its
block sums are `index_add_` segment sums in float32 (the JAX package writes
them as one-hot matmuls, a TPU workaround for scatters), and its LM loop
reads the convergence flag back to the host once per iteration to stop early,
as the JAX package's while-loop does.

Conventions: pose = Tcw (4, 4) world->camera; LEFT-multiplicative tangent
update Tcw <- exp(xi) Tcw with xi = [rho, phi]; observations (u, v, u_right)
with u_right < 0 meaning monocular; chi2 limits 5.991 (mono) / 7.815 (stereo).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2commentedbyxcm_tpu_torch.ops.poseopt_kernel import pose_optimization_fused
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import hat, se3_exp

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    t_cw: torch.Tensor       # (4, 4)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # () float32 — chi2 summed over the inliers


def _project_residual_jacobian(t_cw, pts_w, obs, fx, fy, cx, cy, bf):
    """Residuals r (N, 3) and pose/point Jacobians for reprojection edges.

    Row 2 (u_right) is active only for stereo observations (obs[:, 2] >= 0).
    Returns (r, J_pose (N, 3, 6), J_point (N, 3, 3), pc, stereo_mask), with
    r(xi) = obs - proj(exp(xi) Tcw pw) and J = dr/dxi.
    """
    r_cw = t_cw[..., :3, :3]
    pc = torch.einsum("...ij,...j->...i", r_cw, pts_w) + t_cw[..., :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(z < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    stereo = obs[..., 2] >= 0

    r = torch.stack(
        [obs[..., 0] - u, obs[..., 1] - v, torch.where(stereo, obs[..., 2] - ur, 0.0)], dim=-1
    )
    zero = torch.zeros_like(x)
    dproj = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
            torch.stack([fx * inv_z, zero, (-fx * x + bf) * inv_z2], dim=-1),
        ],
        dim=-2,
    )
    row_on = torch.stack([torch.ones_like(x), torch.ones_like(x), stereo.to(x.dtype)], dim=-1)
    dproj = dproj * row_on[..., None]

    # dpc/dxi = [I | -hat(pc)] for left-multiplicative xi = [rho, phi]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -hat(pc)], dim=-1)  # (N, 3, 6)
    j_pose = -dproj @ dpc_dxi
    j_point = -dproj @ r_cw
    return r, j_pose, j_point, pc, stereo


def _chi2(r, inv_sigma2):
    return torch.sum(r * r, dim=-1) * inv_sigma2


def _huber(c2, delta2):
    """(weight rho'(e), cost rho(e)) of the Huber kernel, threshold delta^2 on chi2."""
    e = torch.sqrt(torch.clamp(c2, min=1e-12))
    d = torch.sqrt(delta2)
    inside = c2 <= delta2
    return torch.where(inside, 1.0, d / e), torch.where(inside, c2, 2.0 * d * e - delta2)


def pose_optimization(
    t_cw: torch.Tensor,
    pts_w: torch.Tensor,
    obs: torch.Tensor,
    mask: torch.Tensor,
    inv_sigma2: torch.Tensor,
    fx, fy, cx, cy, bf,
    n_rounds: int = 4,
    n_iters: int = 10,
    algorithm: str = "lm",
) -> PoseOptResult:
    """Motion-only BA: 4 rounds x <= 10 LM iterations, Huber in rounds 0-1,
    chi2 inlier relabeling between rounds. Runs through ops/poseopt_kernel:
    the CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    """
    if algorithm != "lm":
        raise NotImplementedError(f"algorithm={algorithm!r}: only 'lm' is ported")
    cam = tuple(float(c) for c in (fx, fy, cx, cy, bf))
    return PoseOptResult(*pose_optimization_fused(
        t_cw, pts_w, obs, mask, inv_sigma2, *cam, n_rounds=n_rounds, n_iters=n_iters
    ))


def pose_optimization_plain(
    t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
    n_rounds: int = 4, n_iters: int = 10,
) -> PoseOptResult:
    """The pose kernel's plain torch twin, on any device."""
    dev = pts_w.device
    stereo_all = obs[:, 2] >= 0
    delta2 = torch.where(stereo_all, CHI2_STEREO, CHI2_MONO).float()
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def robust_c2(t):
        r, _, _, pc, _ = _project_residual_jacobian(t, pts_w, obs, fx, fy, cx, cy, bf)
        return torch.where(pc[:, 2] > 0, _chi2(r, inv_sigma2), 1e6)

    def eval_point(t, active, use_huber):
        """One projection pass -> (robust cost, H, g)."""
        r, j_pose, _, pc, _ = _project_residual_jacobian(t, pts_w, obs, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2)
        behind = pc[:, 2] <= 0
        w = inv_sigma2 * active * (~behind).float()
        if use_huber:
            weight, rho = _huber(c2, delta2)
            w = w * weight
        else:
            rho = c2
        err = torch.sum(torch.where(behind, 1e6, rho) * active)
        jw = j_pose * w[:, None, None]
        h = torch.einsum("nij,nik->jk", jw, j_pose)
        g = torch.einsum("nij,ni->j", jw, r)
        return err, h, g

    t_cw = t_cw.float()
    inliers = mask
    for rnd in range(n_rounds):
        use_huber = rnd < 2
        active = inliers.float()
        err_best, h, g = eval_point(t_cw, active, use_huber)
        lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        done = torch.tensor(False, device=dev)
        t_best = t_cw
        for _ in range(n_iters):
            h_lm = h + lam * torch.diag_embed(torch.diagonal(h)) + 1e-8 * eye6
            dx = -torch.linalg.solve_ex(h_lm, g[:, None])[0][:, 0]
            t_new = se3_exp(dx) @ t_best
            err_new, h_new, g_new = eval_point(t_new, active, use_huber)
            accept = err_new < err_best
            take = accept & ~done
            t_best = torch.where(take, t_new, t_best)
            h = torch.where(take, h_new, h)
            g = torch.where(take, g_new, g)
            err_best = torch.where(take, err_new, err_best)
            lam = torch.where(done, lam, torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6))
            done = done | (torch.max(torch.abs(dx)) < 1e-6) | (lam >= 1e6)
        t_cw = t_best
        inliers = mask & (robust_c2(t_cw) <= delta2)

    c2 = robust_c2(t_cw)
    inliers = mask & (c2 <= delta2)
    return PoseOptResult(
        t_cw=t_cw,
        inliers=inliers,
        n_inliers=inliers.sum(dtype=torch.int32),
        chi2=torch.sum(torch.where(inliers, c2, 0.0)),
    )


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant); the landmark
    blocks it inverts are damped SPD."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - b * i, b * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1.0)
    adj = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj * inv_det[..., None, None]


class BAResult(NamedTuple):
    poses: torch.Tensor        # (K, 4, 4)
    points: torch.Tensor       # (P, 3)
    obs_inliers: torch.Tensor  # (E,) bool
    chi2: torch.Tensor         # () float32


def _diag(m: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))


def bundle_adjustment(
    poses: torch.Tensor,        # (K, 4, 4) Tcw
    pose_fixed: torch.Tensor,   # (K,) bool, True = held constant
    points: torch.Tensor,       # (P, 3) world points
    point_valid: torch.Tensor,  # (P,) bool
    obs_pose: torch.Tensor,     # (E,) int, pose index per edge
    obs_point: torch.Tensor,    # (E,) int, point index per edge
    obs_uvr: torch.Tensor,      # (E, 3) (u, v, u_right); u_right < 0 => mono
    obs_mask: torch.Tensor,     # (E,) bool
    inv_sigma2: torch.Tensor,   # (E,) float32
    fx, fy, cx, cy, bf,
    schedule=((5, True), (10, True)),
    active_init: torch.Tensor | None = None,
) -> BAResult:
    """Schur-complement LM over masked edges: per-landmark 3x3 blocks are
    damped and inverted in closed form, the dense reduced camera system
    S = Hcc - W Hpp^-1 W^T is solved for the free poses (fixed poses get
    identity rows), and the landmarks are back-substituted.

    `schedule` lists phases (iterations, Huber on); between phases the
    edges are relabeled by chi2 against the full obs_mask. `active_init`
    (default obs_mask) is the first phase's active set, so an edge excluded
    there can come back at a later relabel."""
    k_poses, p_pts = poses.shape[0], points.shape[0]
    dev = poses.device
    delta2 = torch.where(obs_uvr[:, 2] >= 0, CHI2_STEREO, CHI2_MONO).float()
    free = ~pose_fixed
    fp = free.float()
    op, opt = obs_pose.long(), obs_point.long()
    ar = torch.arange(k_poses, device=dev)
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    def edge_terms(poses_, points_, active, use_huber):
        r, j_pose, j_point, pc, _ = _project_residual_jacobian(
            poses_[op], points_[opt], obs_uvr, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2)
        behind = pc[:, 2] <= 0
        w = inv_sigma2 * active * (~behind).float()
        if use_huber:
            w = w * _huber(c2, delta2)[0]
        return r, j_pose, j_point, w, torch.where(behind, 1e6, c2)

    def total_cost(poses_, points_, active, use_huber):
        c2 = edge_terms(poses_, points_, active, use_huber)[4]
        rho = _huber(c2, delta2)[1] if use_huber else c2
        return torch.sum(rho * active)

    def segment_sum(values, index, n):
        return torch.zeros((n,) + values.shape[1:], device=dev).index_add_(0, index, values)

    def lm_step(poses_, points_, lam, err, active, use_huber):
        r, j_pose, j_point, w, _ = edge_terms(poses_, points_, active, use_huber)
        j_pose = j_pose * fp[op][:, None, None]  # fixed poses have no Jacobian
        jw_pose = j_pose * w[:, None, None]
        jw_point = j_point * w[:, None, None]
        hcc = segment_sum(torch.einsum("eij,eik->ejk", jw_pose, j_pose), op, k_poses)
        hpp = segment_sum(torch.einsum("eij,eik->ejk", jw_point, j_point), opt, p_pts)
        g_c = segment_sum(torch.einsum("eij,ei->ej", jw_pose, r), op, k_poses)
        g_p = segment_sum(torch.einsum("eij,ei->ej", jw_point, r), opt, p_pts)
        w_cp = segment_sum(torch.einsum("eij,eik->ejk", jw_pose, j_point),
                           op * p_pts + opt, k_poses * p_pts).reshape(k_poses, p_pts, 6, 3)

        # damped landmark blocks + closed-form inverse
        hpp_inv = inv3x3(hpp + (lam * _diag(hpp) + 1e-6 * eye3))
        hpp_inv = torch.where(point_valid[:, None, None], hpp_inv, 0.0)

        # reduced camera system; fixed poses: identity rows/cols, zero rhs
        y = torch.einsum("kpab,pbc->kpac", w_cp, hpp_inv)
        s = -torch.einsum("kpab,lpcb->kalc", y, w_cp)  # (K, 6, K, 6)
        s[ar, :, ar, :] += hcc + lam * _diag(hcc)
        g_s = g_c - torch.einsum("kpab,pb->ka", y, g_p)
        s = s * fp[:, None, None, None] * fp[None, None, :, None]
        s[ar, :, ar, :] += (1.0 - fp)[:, None, None] * eye6
        g_s = g_s * fp[:, None]
        n6 = 6 * k_poses
        s_mat = s.reshape(n6, n6) + 1e-8 * torch.eye(n6, device=dev)
        dx_c = -torch.linalg.solve(s_mat, g_s.reshape(-1)).reshape(k_poses, 6) * fp[:, None]

        # back-substitute landmarks: Hpp dx_p = -g_p - W^T dx_c
        rhs_p = -g_p - torch.einsum("kpab,ka->pb", w_cp, dx_c)
        dx_p = torch.einsum("pab,pb->pa", hpp_inv, rhs_p)
        dx_p = torch.where(point_valid[:, None], dx_p, 0.0)

        poses_new = torch.where(free[:, None, None], se3_exp(dx_c) @ poses_, poses_)
        points_new = points_ + dx_p
        err_new = total_cost(poses_new, points_new, active, use_huber)
        accept = err_new < err
        poses_ = torch.where(accept, poses_new, poses_)
        points_ = torch.where(accept, points_new, points_)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        err = torch.where(accept, err_new, err)
        step = torch.maximum(torch.max(torch.abs(dx_c)), torch.max(torch.abs(dx_p)))
        return poses_, points_, lam, err, (step < 1e-6) | (lam >= 1e6)

    inl = obs_mask if active_init is None else active_init
    for n_it, use_huber in schedule:
        active = (inl & point_valid[opt]).float()
        err = total_cost(poses, points, active, use_huber)
        lam = torch.tensor(1e-4, device=dev)
        for _ in range(n_it):
            poses, points, lam, err, done = lm_step(poses, points, lam, err, active, use_huber)
            if bool(done):  # early exit, as the JAX package's while-loop
                break
        inl = obs_mask & (edge_terms(poses, points, active, use_huber)[4] <= delta2)

    c2 = edge_terms(poses, points, (inl & point_valid[opt]).float(), False)[4]
    inl = obs_mask & (c2 <= delta2)
    return BAResult(poses=poses, points=points, obs_inliers=inl,
                    chi2=torch.sum(torch.where(inl, c2, 0.0)))
