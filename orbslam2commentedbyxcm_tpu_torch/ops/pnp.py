"""Batched RANSAC PnP on torch tensors: camera pose from 3D-2D
correspondences (the role of the reference PnPsolver, src/PnPsolver.cc, in
Tracking::Relocalization).

Counterpart of orbslam2commentedbyxcm_tpu/ops/pnp.py with the same numerics,
every RANSAC hypothesis a lane of one batch:

  * `ransac_epnp`: 256 six-point EPnP lanes (reference compute_pose :644):
    control points from a Cholesky factor of the covariance, barycentric
    coordinates (:797), the 4 smallest eigenvectors of M^T M by block inverse
    iteration (:818), the three beta cases (:860-948) polished by Gauss-Newton
    (:1035), Horn alignment by the dominant quaternion (:1115), a 3-step
    reprojection polish; scale-aware chi2 scoring (CheckInliers :381) and 2
    consensus refits (Refine :326).
  * `ransac_pnp`: 6-point DLT lanes, Horn re-orthogonalization, cheirality.

The JAX package draws its samples with `jax.random.choice`; here they come
from a `torch.Generator` or are passed as `samples`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops.optim import inv3x3
from orbslam2commentedbyxcm_tpu_torch.ops.twoview import cholesky_or_eye, draw_samples
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import quat_to_rot, rt_to_se3, so3_exp

# fixed start blocks of the iterations (the JAX package's _BLOCK_SEED, _Q_SEED)
_BLOCK_SEED = np.random.default_rng(7).standard_normal((12, 4)).astype(np.float32)
_Q_SEED = (0.631, -0.427, 0.384, 0.522)
# the 6 control-point pairs of the distance constraints (ref compute_rho :1013)
_PAIRS_A = (0, 0, 0, 1, 1, 2)
_PAIRS_B = (1, 2, 3, 2, 3, 3)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2) / det[..., None, None]


def inv_small(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched inverse for n <= 6: block Schur complements over
    2x2 / 3x3 cofactor inverses, for damped SPD normal matrices."""
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        return _inv2x2(m)
    if n == 3:
        return inv3x3(m)
    k = 3 if n > 4 else 2
    a, b = m[..., :k, :k], m[..., :k, k:]
    c, d = m[..., k:, :k], m[..., k:, k:]
    ai = inv_small(a)
    si = inv_small(d - c @ ai @ b)
    aib, cai = ai @ b, c @ ai
    top = torch.cat([ai + aib @ si @ cai, -aib @ si], dim=-1)
    return torch.cat([top, torch.cat([-si @ cai, si], dim=-1)], dim=-2)


def _mgs(x: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the columns of (..., d, k)."""
    cols = []
    for j in range(x.shape[-1]):
        c = x[..., j]
        for q in cols:
            c = c - torch.sum(c * q, dim=-1, keepdim=True) * q
        cols.append(c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-30))
    return torch.stack(cols, dim=-1)


def smallest_eigvecs_block(g: torch.Tensor, k: int = 4, iters: int = 16, eps: float = 1e-7) -> torch.Tensor:
    """Orthonormal eigenvectors of the k smallest eigenvalues of batched
    symmetric PSD g (..., d, d), columns smallest first: damped Cholesky, the
    explicit inverse, then `iters` steps of block inverse iteration with
    modified Gram-Schmidt from a fixed start block (the per-hypothesis SVD of
    M^T M in the reference, src/PnPsolver.cc:698-704)."""
    d = g.shape[-1]
    tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    a = g + (eps * torch.clamp(tr, min=1e-12) / d)[..., None, None] * _eye(d, g)
    chol = cholesky_or_eye(a)
    linv = torch.linalg.solve_triangular(chol, _eye(d, g).expand(a.shape), upper=False)
    binv = linv.transpose(-1, -2) @ linv
    x = torch.from_numpy(_BLOCK_SEED[:d, :k]).to(g).expand(g.shape[:-1] + (k,))
    for _ in range(iters):
        x = _mgs(binv @ x)
    return x


def dominant_quat(n: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of batched symmetric 4x4 N
    by shifted power iteration (the shift makes the spectrum positive)."""
    shift = torch.sqrt(torch.sum(n * n, dim=(-2, -1), keepdim=True)) + 1e-9
    a = n + shift * _eye(4, n)
    q = torch.tensor(_Q_SEED, dtype=n.dtype, device=n.device).expand(n.shape[:-1])
    for _ in range(iters):
        q = torch.einsum("...ij,...j->...i", a, q)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30)
    return q


def horn_n_matrix(m: torch.Tensor) -> torch.Tensor:
    """Horn's 4x4 N matrix of a 3x3 correlation m_ij = sum_k a_ki b_kj (its
    dominant eigenvector is the quaternion rotating a onto b)."""
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
    ], dim=-2)


class PnPResult(NamedTuple):
    t_cw: torch.Tensor       # (4, 4)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int
    success: torch.Tensor    # () bool


def _normalized(uv: torch.Tensor, k_mat: torch.Tensor) -> torch.Tensor:
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return (uv1 @ torch.linalg.inv(k_mat).T)[..., :2]


def _score(rs, ts, pts3d, uv, mask, k_mat, sigma2, chi2_th):
    """Scale-aware chi2 inliers of poses (..., 3, 3), (..., 3) over all
    correspondences -> (count (...), inliers (..., N))."""
    pc = pts3d @ rs.transpose(-1, -2) + ts[..., None, :]
    z = torch.where(pc[..., 2] < 1e-6, 1e-6, pc[..., 2])
    u_px = k_mat[0, 0] * pc[..., 0] / z + k_mat[0, 2]
    v_px = k_mat[1, 1] * pc[..., 1] / z + k_mat[1, 2]
    e2 = (u_px - uv[..., 0]) ** 2 + (v_px - uv[..., 1]) ** 2
    ok = (e2 / sigma2 < chi2_th) & (pc[..., 2] > 0) & mask
    finite = torch.isfinite(rs).flatten(-2).all(-1) & torch.isfinite(ts).all(-1)
    ok = ok & finite[..., None]
    return ok.sum(dim=-1), ok


def _ransac(solve, samples, pts3d, uv, uvn, mask, k_mat, sigma2, chi2_th, min_inliers):
    """Hypotheses from `solve` on every sample lane, the best by inlier count
    (first on ties), then 2 consensus refits, each kept when it does not lose
    inliers."""
    rs, ts = solve(pts3d[samples], uvn[samples], torch.ones(samples.shape, dtype=pts3d.dtype,
                                                            device=pts3d.device))
    counts, inl = _score(rs, ts, pts3d, uv, mask, k_mat, sigma2, chi2_th)
    best = torch.argmax(counts)
    best_inl, r, t = inl[best], rs[best], ts[best]
    for _ in range(2):
        r2, t2 = solve(pts3d, uvn, best_inl.to(pts3d.dtype))
        cnt2, inl2 = _score(r2, t2, pts3d, uv, mask, k_mat, sigma2, chi2_th)
        better = cnt2 >= best_inl.sum()
        r = torch.where(better, r2, r)
        t = torch.where(better, t2, t)
        best_inl = torch.where(better, inl2, best_inl)
    n_inl = best_inl.sum()
    return PnPResult(t_cw=rt_to_se3(r, t), inliers=best_inl, n_inliers=n_inl, success=n_inl >= min_inliers)


# -- DLT ----------------------------------------------------------------------


def _dlt_pose(pts3d: torch.Tensor, uvn: torch.Tensor, row_weight: torch.Tensor):
    """[R|t] from >= 6 weighted correspondences (..., m, 3), (..., m, 2) by
    DLT in normalized camera coordinates; a weight of 0 drops a row pair."""
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    u, v = uvn[..., 0], uvn[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, z, one, zero, zero, zero, zero, -u * x, -u * y, -u * z, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, zero, x, y, z, one, -v * x, -v * y, -v * z, -v], dim=-1)
    a = torch.cat([r1 * row_weight[..., None], r2 * row_weight[..., None]], dim=-2)
    p = smallest_eigvecs_block(a.transpose(-1, -2) @ a, k=1)[..., 0].reshape(*a.shape[:-2], 3, 4)
    # cheirality on the projective solution: most points in front
    pc_z = torch.einsum("...mi,...i->...m", pts3d, p[..., 2, :3]) + p[..., 2, 3:]
    p = torch.where((torch.sum(torch.sign(pc_z), dim=-1) < 0)[..., None, None], -p, p)
    m = p[..., :3]
    r = quat_to_rot(dominant_quat(horn_n_matrix(m.transpose(-1, -2))))
    scale = torch.sum(r * m, dim=(-2, -1)) / 3.0
    t = p[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    return r, t


def ransac_pnp(
    generator: torch.Generator | None,
    pts3d: torch.Tensor,   # (N, 3) world points
    uv: torch.Tensor,      # (N, 2) pixel observations
    mask: torch.Tensor,    # (N,) valid correspondences
    k_mat: torch.Tensor,   # (3, 3)
    sigma2: torch.Tensor,  # (N,) per-observation sigma^2 (px^2, scale-aware)
    n_hypotheses: int = 256,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    samples: torch.Tensor | None = None,
) -> PnPResult:
    """6-point DLT lanes inside batched RANSAC."""
    if samples is None:
        samples = draw_samples(mask, n_hypotheses, 6, generator)
    return _ransac(_dlt_pose, samples.to(pts3d.device).long(), pts3d, uv, _normalized(uv, k_mat),
                   mask, k_mat, sigma2, chi2_th, min_inliers)


# -- EPnP ---------------------------------------------------------------------


def _beta_products(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) betas -> the 10 quadratic monomials in the reference's L_6x10
    column order [B11 B12 B22 B13 B23 B33 B14 B24 B34 B44] (:986)."""
    b1, b2, b3, b4 = b.unbind(-1)
    return torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
                        b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4], dim=-1)


def _beta_products_jacobian(b: torch.Tensor) -> torch.Tensor:
    """d _beta_products / d betas, (..., 10, 4)."""
    b1, b2, b3, b4 = b.unbind(-1)
    z = torch.zeros_like(b1)
    rows = [(b1 + b1, z, z, z), (b2, b1, z, z), (z, b2 + b2, z, z), (b3, z, b1, z),
            (z, b3, b2, z), (z, z, b3 + b3, z), (b4, z, z, b1), (z, b4, z, b2),
            (z, z, b4, b3), (z, z, z, b4 + b4)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _lstsq_nrm(a: torch.Tensor, b: torch.Tensor, reg: float = 1e-9) -> torch.Tensor:
    """Small least squares by regularized normal equations (the reference's
    qr_solve :1268): a (..., m, n), b (..., m) -> (..., n)."""
    ata = a.transpose(-1, -2) @ a + reg * _eye(a.shape[-1], a)
    return torch.einsum("...ij,...j->...i", inv_small(ata), torch.einsum("...mi,...m->...i", a, b))


def _gauss_newton_betas(l_6x10, rho, betas, iters: int = 5):
    """Refine the betas on the 6 distance constraints (ref gauss_newton :1035)."""
    for _ in range(iters):
        resid = torch.einsum("...ij,...j->...i", l_6x10, _beta_products(betas)) - rho
        jac = l_6x10 @ _beta_products_jacobian(betas)
        betas = betas + _lstsq_nrm(jac, -resid)
    return betas


def _horn_rt(pw: torch.Tensor, pc: torch.Tensor, w: torch.Tensor):
    """Weighted absolute orientation without scale, pc ~ R pw + t
    (ref estimate_R_and_t :1115), by the dominant quaternion."""
    ws = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cw = torch.sum(w[..., None] * pw, dim=-2) / ws
    cc = torch.sum(w[..., None] * pc, dim=-2) / ws
    m = ((pw - cw[..., None, :]) * w[..., None]).transpose(-1, -2) @ (pc - cc[..., None, :])
    r = quat_to_rot(dominant_quat(horn_n_matrix(m)))
    return r, cc - torch.einsum("...ij,...j->...i", r, cw)


def _reprojection_error(r, t, pts3d, uvn, w, ws):
    pc = pts3d @ r.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    e2 = torch.sum((pc[..., :2] / z[..., None] - uvn) ** 2, dim=-1)
    err = torch.sum(w * e2, dim=-1) / ws
    return torch.where(torch.isfinite(err), err, torch.inf)


def _polish(r, t, pts3d, uvn, w):
    """One Gauss-Newton step on the reprojection error (m points, 6 DoF,
    left-multiplicative SE3 perturbation)."""
    pc = pts3d @ r.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    res = torch.cat([pc[..., 0] / z - uvn[..., 0], pc[..., 1] / z - uvn[..., 1]], dim=-1)  # (..., 2m)
    zinv = 1.0 / z
    zr = torch.zeros_like(z)
    du = torch.stack([zinv, zr, -pc[..., 0] * zinv * zinv], dim=-1)
    dv = torch.stack([zr, zinv, -pc[..., 1] * zinv * zinv], dim=-1)
    px, py, pz = pc[..., 0], pc[..., 1], pc[..., 2]
    neg_hat = torch.stack([torch.stack([zr, pz, -py], dim=-1),
                           torch.stack([-pz, zr, px], dim=-1),
                           torch.stack([py, -px, zr], dim=-1)], dim=-2)  # -hat(pc)
    j_u = torch.cat([torch.einsum("...mi,...mij->...mj", du, neg_hat), du], dim=-1)
    j_v = torch.cat([torch.einsum("...mi,...mij->...mj", dv, neg_hat), dv], dim=-1)
    j = torch.cat([j_u, j_v], dim=-2)  # (..., 2m, 6)
    wr = torch.cat([w, w], dim=-1)
    jw = (j * wr[..., None]).transpose(-1, -2)
    jtj = jw @ j
    jtr = torch.einsum("...ij,...j->...i", jw, res)
    jtj = jtj + (1e-8 * torch.diagonal(jtj, dim1=-2, dim2=-1).sum(-1))[..., None, None] * _eye(6, jtj)
    dx = -torch.einsum("...ij,...j->...i", inv_small(jtj), jtr)
    dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, torch.zeros_like(dx))
    dr = so3_exp(dx[..., :3])
    return dr @ r, torch.einsum("...ij,...j->...i", dr, t) + dx[..., 3:]


def epnp_pose(pts3d: torch.Tensor, uvn: torch.Tensor, w: torch.Tensor):
    """EPnP on weighted correspondences in normalized camera coordinates,
    batched over leading dims: pts3d (..., m, 3), uvn (..., m, 2), w (..., m)
    row weights (0 drops a correspondence). Returns (r, t, err), err the
    weighted mean squared reprojection error (ref reprojection_error :1097)."""
    ws = torch.clamp(w.sum(-1), min=1e-9)
    # control points: the centroid + a Cholesky factor of the covariance
    # (any affinely independent control points are exact for EPnP)
    c0 = torch.sum(w[..., None] * pts3d, dim=-2) / ws[..., None]
    a0 = pts3d - c0[..., None, :]
    cov = (a0 * w[..., None]).transpose(-1, -2) @ a0 / ws[..., None, None]
    tr3 = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    l = cholesky_or_eye(cov + (1e-6 * torch.clamp(tr3, min=1e-12))[..., None, None] * _eye(3, cov))
    cws = torch.cat([c0[..., None, :], c0[..., None, :] + l.transpose(-1, -2)], dim=-2)  # (..., 4, 3)

    # barycentric coordinates (ref compute_barycentric_coordinates :797)
    cc_m = (cws[..., 1:, :] - cws[..., :1, :]).transpose(-1, -2)
    cc_inv = inv_small(cc_m + 1e-12 * _eye(3, cc_m))
    a123 = (pts3d - cws[..., :1, :]) @ cc_inv.transpose(-1, -2)
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1)  # (..., m, 4)

    # M^T M and its 4 smallest eigenvectors (ref fill_M :818, :698-704)
    u_, v_ = uvn[..., 0], uvn[..., 1]
    one, zero = torch.ones_like(u_), torch.zeros_like(u_)
    shape = alphas.shape[:-1] + (12,)
    row_u = (alphas[..., :, None] * torch.stack([one, zero, -u_], -1)[..., None, :]).reshape(shape)
    row_v = (alphas[..., :, None] * torch.stack([zero, one, -v_], -1)[..., None, :]).reshape(shape)
    m_mat = torch.cat([row_u * w[..., None], row_v * w[..., None]], dim=-2)
    v4 = smallest_eigvecs_block(m_mat.transpose(-1, -2) @ m_mat, k=4)  # (..., 12, 4)

    # distance constraints (ref compute_L_6x10 :986, compute_rho :1013)
    pa, pb = list(_PAIRS_A), list(_PAIRS_B)
    vks = v4.transpose(-1, -2).reshape(*v4.shape[:-2], 4, 4, 3)  # (beta k, control point, xyz)
    dv = vks[..., :, pa, :] - vks[..., :, pb, :]                 # (..., 4, 6, 3)
    dot = torch.einsum("...kpx,...lpx->...pkl", dv, dv)          # (..., 6, 4, 4)
    l_6x10 = torch.stack([
        dot[..., 0, 0], 2 * dot[..., 0, 1], dot[..., 1, 1], 2 * dot[..., 0, 2],
        2 * dot[..., 1, 2], dot[..., 2, 2], 2 * dot[..., 0, 3], 2 * dot[..., 1, 3],
        2 * dot[..., 2, 3], dot[..., 3, 3],
    ], dim=-1)
    dcw = cws[..., pa, :] - cws[..., pb, :]
    rho = torch.sum(dcw * dcw, dim=-1)

    # beta initializations, cases N = 1 / 2 / 3 (ref find_betas_approx_1/2/3)
    b4 = _lstsq_nrm(l_6x10[..., [0, 1, 3, 6]], rho)
    s1 = torch.sign(b4[..., 0]) + (b4[..., 0] == 0).to(b4.dtype)
    beta1 = torch.sqrt(torch.abs(b4[..., 0]))
    den1 = torch.clamp(beta1, min=1e-9)
    betas_c1 = torch.stack([beta1, s1 * b4[..., 1] / den1, s1 * b4[..., 2] / den1, s1 * b4[..., 3] / den1], -1)
    b3 = _lstsq_nrm(l_6x10[..., [0, 1, 2]], rho)
    bb1 = torch.sqrt(torch.abs(b3[..., 0]))
    bb2 = torch.sqrt(torch.abs(b3[..., 2])) * torch.where(b3[..., 0] * b3[..., 2] > 0, 1.0, 0.0)
    z = torch.zeros_like(bb1)
    betas_c2 = torch.stack([bb1, torch.sign(b3[..., 1]) * bb2, z, z], -1)
    b5 = _lstsq_nrm(l_6x10[..., [0, 1, 2, 3, 4]], rho)
    cb1 = torch.sqrt(torch.abs(b5[..., 0]))
    cb2 = torch.sqrt(torch.abs(b5[..., 2])) * torch.where(b5[..., 0] * b5[..., 2] > 0, 1.0, 0.0)
    cb2 = torch.sign(b5[..., 1]) * cb2
    betas_c3 = torch.stack([cb1, cb2, b5[..., 3] / torch.clamp(cb1, min=1e-9), z], -1)

    # the three cases as one more leading dim (..., 3)
    betas = _gauss_newton_betas(l_6x10[..., None, :, :], rho[..., None, :],
                                torch.stack([betas_c1, betas_c2, betas_c3], dim=-2))
    x = torch.einsum("...ij,...cj->...ci", v4, betas)                 # (..., 3, 12)
    ccs = x.reshape(*x.shape[:-1], 4, 3)
    pcs = alphas[..., None, :, :] @ ccs                               # (..., 3, m, 3)
    w3 = w[..., None, :]
    flip = torch.sum(w3 * torch.sign(pcs[..., 2]), dim=-1) < 0       # cheirality (solve_for_sign)
    pcs = torch.where(flip[..., None, None], -pcs, pcs)
    pts3 = pts3d[..., None, :, :].expand(pcs.shape)
    rs, ts = _horn_rt(pts3, pcs, w3.expand(pcs.shape[:-1]))
    errs = _reprojection_error(rs, ts, pts3, uvn[..., None, :, :], w3, ws[..., None])
    best = torch.argmin(errs, dim=-1)
    r_best = torch.take_along_dim(rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t_best = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    err_best = torch.take_along_dim(errs, best[..., None], dim=-1)[..., 0]

    # Gauss-Newton reprojection polish, kept when it does not raise the error
    r_p, t_p = r_best, t_best
    for _ in range(3):
        r_p, t_p = _polish(r_p, t_p, pts3d, uvn, w)
    err = _reprojection_error(r_p, t_p, pts3d, uvn, w, ws)
    ok = err <= err_best
    return (torch.where(ok[..., None, None], r_p, r_best), torch.where(ok[..., None], t_p, t_best),
            torch.minimum(err, err_best))


def _epnp_solve(pts3d, uvn, w):
    r, t, _ = epnp_pose(pts3d, uvn, w)
    return r, t


def ransac_epnp(
    generator: torch.Generator | None,
    pts3d: torch.Tensor,   # (N, 3) world points
    uv: torch.Tensor,      # (N, 2) pixel observations
    mask: torch.Tensor,    # (N,) valid correspondences
    k_mat: torch.Tensor,   # (3, 3)
    sigma2: torch.Tensor,  # (N,) per-observation sigma^2 (px^2, scale-aware)
    n_hypotheses: int = 256,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    samples: torch.Tensor | None = None,
) -> PnPResult:
    """EPnP inside batched RANSAC: every hypothesis a 6-point EPnP lane (6,
    not the reference's 4, so case-1 Gauss-Newton is well posed), scored on
    all correspondences with the scale-aware chi2 gate; the winner re-solved
    by EPnP on its consensus set twice. `samples` (n_hypotheses, 6)
    overrides the draw from `generator`."""
    if samples is None:
        samples = draw_samples(mask, n_hypotheses, 6, generator)
    return _ransac(_epnp_solve, samples.to(pts3d.device).long(), pts3d, uv, _normalized(uv, k_mat),
                   mask, k_mat, sigma2, chi2_th, min_inliers)
