"""Two-view geometry on torch tensors: DLT triangulation and the monocular
two-view initialization (reference src/Initializer.cc).

Counterpart of orbslam2commentedbyxcm_tpu/ops/twoview.py with the same
numerics, so that the same hypotheses win: 200 homography DLTs and 200
eight-point fundamentals in one batch, each null space by Cholesky-backed
inverse iteration (`smallest_eigvec_psd`), scoring as a dense (S, N) residual
matrix, two consensus refits, the RH = SH / (SH + SF) > 0.40 model selection
(:145-161) and the 12-candidate cheirality + parallax vote (ReconstructH /
ReconstructF + CheckRT). `_decompose_e` and `_decompose_h` take an SVD, as the
JAX package does.

The JAX package draws its RANSAC samples with `jax.random.choice`, which
torch cannot reproduce: `initialize_two_view` draws them from a
`torch.Generator` or takes them as `samples`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops.optim import inv3x3
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import rt_to_se3

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_CAP = 5.991

# fixed start vector of the inverse iteration (the JAX package's _II_SEED)
_II_SEED = (0.537, -0.812, 0.291, 0.664, -0.173, 0.925, -0.448, 0.356, -0.609)


def cholesky_or_eye(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; a lane whose factorization fails or is
    not finite gets the identity (the JAX package's NaN guard)."""
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0) | ~torch.isfinite(chol).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.where(bad[..., None, None], eye, chol)


def smallest_eigvec_psd(g: torch.Tensor, iters: int = 10, eps: float = 1e-6) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric PSD
    g (..., d, d): damped Cholesky, then `iters` steps of inverse iteration
    (two triangular solves each) from a fixed start vector. For a DLT system
    A x = 0 the caller passes g = A^T A (the null space the reference takes
    from cv::SVD, src/Initializer.cc:241-287)."""
    d = g.shape[-1]
    tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    damp = eps * torch.clamp(tr, min=1e-12) / d
    a = g + damp[..., None, None] * torch.eye(d, dtype=g.dtype, device=g.device)
    chol = cholesky_or_eye(a)
    x = torch.tensor(_II_SEED[:d], dtype=g.dtype, device=g.device).expand(g.shape[:-1]).contiguous()
    for _ in range(iters):
        y = torch.linalg.solve_triangular(chol, x[..., None], upper=False)
        x = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)[..., 0]
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)
    return x


def _rank2_project(f: torch.Tensor) -> torch.Tensor:
    """Zero the smallest singular value of batched 3x3 F (F - s3 u3 v3^T),
    u3 / v3 the smallest eigenvectors of F F^T / F^T F."""
    v3 = smallest_eigvec_psd(f.transpose(-1, -2) @ f)
    u3 = smallest_eigvec_psd(f @ f.transpose(-1, -2))
    s3 = torch.einsum("...i,...ij,...j->...", u3, f, v3)
    return f - s3[..., None, None] * (u3[..., :, None] * v3[..., None, :])


def _normalize_points(uv: torch.Tensor, mask: torch.Tensor):
    """Mean / abs-dev normalization (reference Initializer::Normalize)."""
    w = mask.float()
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(uv - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    t = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (uv - mean) * s, t


def _h_rows(p1, p2):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return r1, r2


def _f_rows(p1, p2):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1)


def _null_3x3(a: torch.Tensor) -> torch.Tensor:
    return smallest_eigvec_psd(a.transpose(-1, -2) @ a).reshape(*a.shape[:-2], 3, 3)


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """H (p1 -> p2) by DLT over (..., m, 2) correspondences; with `mask`, the
    least-squares fit over the masked rows (the consensus refit)."""
    r1, r2 = _h_rows(p1, p2)
    if mask is not None:
        w = mask.to(p1.dtype)[..., None]
        r1, r2 = r1 * w, r2 * w
    return _null_3x3(torch.cat([r1, r2], dim=-2))


def _eight_point_f(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """F (x2^T F x1 = 0) by the eight-point system, rank 2 enforced."""
    a = _f_rows(p1, p2)
    if mask is not None:
        a = a * mask.to(p1.dtype)[..., None]
    return _rank2_project(_null_3x3(a))


def _score_h(h: torch.Tensor, uv1, uv2, mask, sigma: float):
    """Symmetric transfer error score (reference CheckHomography); h (..., 3, 3)
    -> (score (...), inliers (..., N))."""
    inv_s2 = 1.0 / (sigma * sigma)
    hinv = torch.linalg.inv(h)

    def transfer(hm, src, dst):
        x, y = src[..., 0], src[..., 1]
        hm = hm[..., None, :, :]
        d = hm[..., 2, 0] * x + hm[..., 2, 1] * y + hm[..., 2, 2]
        d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        u = (hm[..., 0, 0] * x + hm[..., 0, 1] * y + hm[..., 0, 2]) / d
        v = (hm[..., 1, 0] * x + hm[..., 1, 1] * y + hm[..., 1, 2]) / d
        return (u - dst[..., 0]) ** 2 + (v - dst[..., 1]) ** 2

    c1 = transfer(h, uv1, uv2) * inv_s2
    c2 = transfer(hinv, uv2, uv1) * inv_s2
    ok = (c1 < CHI2_H) & (c2 < CHI2_H) & mask
    score = torch.where(c1 < CHI2_H, SCORE_CAP - c1, 0.0) + torch.where(c2 < CHI2_H, SCORE_CAP - c2, 0.0)
    return torch.sum(score * mask, dim=-1), ok


def _score_f(f: torch.Tensor, uv1, uv2, mask, sigma: float):
    """Epipolar distance score (reference CheckFundamental)."""
    inv_s2 = 1.0 / (sigma * sigma)
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=-1)
    l2 = x1 @ f.transpose(-1, -2)  # line in image 2: F x1
    l1 = x2 @ f                    # line in image 1: F^T x2
    d2 = torch.sum(l2 * x2, dim=-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * x1, dim=-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    c1, c2 = d2 * inv_s2, d1 * inv_s2
    ok = (c1 < CHI2_F) & (c2 < CHI2_F) & mask
    score = torch.where(c1 < CHI2_F, SCORE_CAP - c1, 0.0) + torch.where(c2 < CHI2_F, SCORE_CAP - c2, 0.0)
    return torch.sum(score * mask, dim=-1), ok


def triangulate(p1_mat: torch.Tensor, p2_mat: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """DLT triangulation (reference Initializer::Triangulate).

    p*_mat: (..., 3, 4) projection matrices; uv*: (..., N, 2) normalized
    coordinates. Returns (..., N, 3). The homogeneous system is solved with
    w := 1 through the closed-form 3x3 normal equations; points at infinity
    come back wrong but finite and the callers' cheirality and reprojection
    gates reject them."""
    rows = []
    for p, uv in ((p1_mat, uv1), (p2_mat, uv2)):
        rows.append(uv[..., 0, None] * p[..., None, 2, :] - p[..., None, 0, :])
        rows.append(uv[..., 1, None] * p[..., None, 2, :] - p[..., None, 1, :])
    a4 = torch.stack(rows, dim=-2)  # (..., N, 4, 4)
    a, b = a4[..., :3], -a4[..., 3]
    g = a.transpose(-1, -2) @ a
    atb = torch.einsum("...ij,...i->...j", a, b)
    return torch.einsum("...ij,...j->...i", inv3x3(g), atb)


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    t21: torch.Tensor              # (4, 4) pose of view 2 in the view-1 frame
    points: torch.Tensor           # (N, 3) triangulated points, view-1 frame
    is_triangulated: torch.Tensor  # (N,) bool
    used_homography: torch.Tensor  # () bool
    n_inliers: torch.Tensor        # () int


def _check_rt(r, t, uv1n, uv2n, mask, sigma2_th: float):
    """Cheirality + reprojection + parallax vote of candidate poses (reference
    Initializer::CheckRT), batched over candidates: r (C, 3, 3), t (C, 3);
    uv*n are K-normalized correspondences (N, 2). Returns (good (C, N),
    n_good (C,), parallax cos (C,), points (C, N, 3))."""
    c = r.shape[0]
    eye34 = torch.cat([torch.eye(3, dtype=r.dtype, device=r.device),
                       torch.zeros(3, 1, dtype=r.dtype, device=r.device)], dim=1)
    p2 = torch.cat([r, t[..., None]], dim=-1)
    pts = triangulate(eye34.expand(c, 3, 4), p2, uv1n.expand(c, -1, -1), uv2n.expand(c, -1, -1))
    finite = torch.isfinite(pts).all(dim=-1)
    z1 = pts[..., 2]
    pts2 = pts @ r.transpose(-1, -2) + t[:, None, :]
    z2 = pts2[..., 2]
    c2 = -(r.transpose(-1, -2) @ t[..., None])[..., 0]
    n1, n2 = pts, pts - c2[:, None, :]
    cosp = torch.sum(n1 * n2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(n1, dim=-1) * torch.linalg.vector_norm(n2, dim=-1), min=1e-12)
    e1 = torch.sum((pts[..., :2] / torch.clamp(z1[..., None], min=1e-12) - uv1n) ** 2, dim=-1)
    e2 = torch.sum((pts2[..., :2] / torch.clamp(z2[..., None], min=1e-12) - uv2n) ** 2, dim=-1)
    good = (mask & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < sigma2_th) & (e2 < sigma2_th))
    par = torch.where(good, cosp, 1.0)
    n_good = good.sum(dim=-1)
    k = torch.clamp(torch.clamp(n_good - 1, min=0), max=50)
    parallax_cos = torch.sort(par, dim=-1).values.gather(-1, k[:, None])[:, 0]
    return good, n_good, parallax_cos, pts


def _decompose_e(e: torch.Tensor):
    """E -> 4 candidate (R, t) (reference DecomposeE)."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=e.dtype, device=e.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])


def _decompose_h(h: torch.Tensor):
    """H (normalized coordinates) -> 8 candidate (R, t), Faugeras' SVD method
    (reference Initializer::ReconstructH, src/Initializer.cc:790-976)."""
    u, s, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    d1, d2, d3 = s[0], s[1], s[2]
    sdet = torch.linalg.det(u) * torch.linalg.det(v)
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=h.dtype, device=h.device) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=h.dtype, device=h.device) * aux3
    sq = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)
    rs, ts = [], []
    # d' > 0
    st = sq / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for i in range(4):
        sti = st * torch.where(x1s[i] * x3s[i] >= 0, 1.0, -1.0)
        rp = torch.stack([torch.stack([ct, zero, -sti]), torch.stack([zero, one, zero]),
                          torch.stack([sti, zero, ct])])
        tp = torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3)
        rs.append(sdet * (u @ rp @ vt))
        ts.append(u @ tp)
    # d' < 0
    sphi = sq / torch.clamp((d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for i in range(4):
        sp = sphi * torch.where(x1s[i] * x3s[i] >= 0, 1.0, -1.0)
        rp = torch.stack([torch.stack([cphi, zero, sp]), torch.stack([zero, -one, zero]),
                          torch.stack([sp, zero, -cphi])])
        tp = torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3)
        rs.append(sdet * (u @ rp @ vt))
        ts.append(u @ tp)
    ts = torch.stack(ts)
    return torch.stack(rs), ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)


def draw_samples(mask: torch.Tensor, n_hypotheses: int, size: int, generator: torch.Generator | None):
    """(n_hypotheses, size) indices drawn with replacement, uniformly over the
    masked rows (the draw of jax.random.choice(..., p=mask / sum) in the JAX
    package, from a torch generator). With no masked row every index is
    drawn uniformly; such a draw never succeeds."""
    w = mask.float()
    if not bool(w.any()):
        w = torch.ones_like(w)
    return torch.multinomial(w, n_hypotheses * size, replacement=True,
                             generator=generator).view(n_hypotheses, size)


def initialize_two_view(
    generator: torch.Generator | None,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    mask: torch.Tensor,
    k_mat: torch.Tensor,
    sigma: float = 1.0,
    n_hypotheses: int = 200,
    min_inliers: int = 50,
    min_triangulated_ratio: float = 0.7,
    samples: torch.Tensor | None = None,
) -> TwoViewResult:
    """Monocular initialization from matched, undistorted pixel pairs.

    uv1 / uv2: (N, 2) correspondences frame 1 -> frame 2, mask (N,) bool,
    k_mat (3, 3). `samples` (n_hypotheses, 8) overrides the draw from
    `generator`. Returns the pose of view 2 in the view-1 frame and the
    triangulated points (the caller normalizes the scale)."""
    dev = uv1.device
    if samples is None:
        samples = draw_samples(mask, n_hypotheses, 8, generator)
    samples = samples.to(dev).long()

    n1, t1 = _normalize_points(uv1, mask)
    n2, t2 = _normalize_points(uv2, mask)
    s1, s2 = n1[samples], n2[samples]  # (S, 8, 2)
    t2_inv = torch.linalg.inv(t2)

    h = t2_inv @ _dlt_homography(s1, s2) @ t1
    f = t2.T @ _eight_point_f(s1, s2) @ t1
    score_h, ok_h = _score_h(h, uv1, uv2, mask, sigma)
    score_f, ok_f = _score_f(f, uv1, uv2, mask, sigma)
    bi_h, bi_f = torch.argmax(score_h), torch.argmax(score_f)
    best_h, inl_h = h[bi_h], ok_h[bi_h]
    best_f, inl_f = f[bi_f], ok_f[bi_f]

    # consensus-set refinement, 2 rounds: refit on the inliers, rescore
    for _ in range(2):
        best_h = t2_inv @ _dlt_homography(n1, n2, inl_h) @ t1
        _, inl_h = _score_h(best_h, uv1, uv2, mask, sigma)
        best_f = t2.T @ _eight_point_f(n1, n2, inl_f) @ t1
        _, inl_f = _score_f(best_f, uv1, uv2, mask, sigma)
    sh, _ = _score_h(best_h, uv1, uv2, mask, sigma)
    sf, _ = _score_f(best_f, uv1, uv2, mask, sigma)
    use_h = sh / torch.clamp(sh + sf, min=1e-12) > 0.40  # src/Initializer.cc:158

    # reconstruction over all 12 candidates, the selected model's voting
    kinv = torch.linalg.inv(k_mat)

    def to_norm(uv):
        x = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1) @ kinv.T
        return x[..., :2] / x[..., 2:3]

    uv1n, uv2n = to_norm(uv1), to_norm(uv2)
    sigma_n = k_mat.new_tensor(sigma) / k_mat[0, 0]  # a true division, as numpy's
    th_n = 4.0 * sigma_n * sigma_n
    rs_f, ts_f = _decompose_e(k_mat.T @ best_f @ k_mat)
    rs_h, ts_h = _decompose_h(kinv @ best_h @ k_mat)
    rs = torch.cat([rs_h, rs_f])
    ts = torch.cat([ts_h, ts_f])
    is_h = torch.arange(12, device=dev) < 8
    cand = torch.where(use_h, is_h, ~is_h)
    inliers = torch.where(use_h, inl_h, inl_f)
    good, n_good, par_cos, pts = _check_rt(rs, ts, uv1n, uv2n, inliers, th_n)
    n_good = torch.where(cand, n_good, -1)
    best = torch.argmax(n_good)
    n_best = n_good[best]
    n_second = torch.sort(n_good).values[-2]
    n_inl = inliers.sum()
    success = ((n_best >= min_inliers)
               & (n_best.float() > min_triangulated_ratio * n_inl.float())
               & (n_second.float() < 0.75 * n_best.float())
               & (par_cos[best] < 0.9998))  # ~1 degree of parallax
    return TwoViewResult(success=success, t21=rt_to_se3(rs[best], ts[best]), points=pts[best],
                         is_triangulated=good[best], used_homography=use_h, n_inliers=n_best)


def k_matrix(camera, device) -> torch.Tensor:
    """The camera's (3, 3) intrinsics as a float32 tensor on `device`."""
    return torch.from_numpy(np.asarray(camera.K, np.float32)).to(device)
