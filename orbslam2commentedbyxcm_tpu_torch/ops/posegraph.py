"""Sim3 pose-graph optimization (the essential graph) and the two-keyframe
Sim3 refinement, on torch tensors.

Counterpart of orbslam2commentedbyxcm_tpu/ops/posegraph.py (reference
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:873, and
Optimizer::OptimizeSim3, :1173). The JAX package differentiates the
residuals with vmapped jacfwd; here the Jacobians are closed forms, held to
that jacfwd by tests/test_torch_posegraph.py: an edge's 7x7 Jacobian is the
inverse right Jacobian of Sim3 at the residual (a 14x14 block matrix
exponential per edge), and the two-keyframe refinement differentiates its
projections directly. Forward-mode autodiff cost hundreds of small launches
per evaluation. Two solvers, dispatched by
`solve_pose_graph` on the vertex count:

  * dense (`optimize_pose_graph`): the (7K, 7K) Hessian assembled from the
    per-edge blocks with `ops/optim.segment_sum`, one Cholesky per LM
    iteration;
  * matrix-free (`optimize_pose_graph_cg`): block-Jacobi preconditioned CG
    applying H = J^T J edge-wise, O(E) memory (the g2o sparse block solver's
    role, Thirdparty/g2o/g2o/core/block_solver.hpp:51-90).

Both LM loops stop early as the JAX while-loops do, reading the convergence
flag back to the host once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2commentedbyxcm_tpu_torch.ops.optim import segment_sum
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import (
    hat,
    sim3_exp,
    sim3_inverse,
    sim3_log,
    sim3_rot,
    sim3_scale,
)


def _sim3_adjoint(x):
    """Adjoint of Sim3s (..., 4, 4) on tangents [rho, phi, sigma]:
    Ad(X) = [[sR, t^ R, -t], [0, R, 0], [0, 0, 1]]  (..., 7, 7)."""
    s, r, t = sim3_scale(x), sim3_rot(x), x[..., :3, 3]
    zeros = torch.zeros(x.shape[:-2] + (3, 3), dtype=x.dtype, device=x.device)
    zcol = torch.zeros(x.shape[:-2] + (3, 1), dtype=x.dtype, device=x.device)
    top = torch.cat([s[..., None, None] * r, hat(t) @ r, -t[..., None]], dim=-1)
    mid = torch.cat([zeros, r, zcol], dim=-1)
    bot = torch.zeros(x.shape[:-2] + (1, 7), dtype=x.dtype, device=x.device)
    bot[..., 0, 6] = 1.0
    return torch.cat([top, mid, bot], dim=-2)


def _sim3_ad(xi: torch.Tensor) -> torch.Tensor:
    """ad of sim3 tangents (B, 7) [rho, phi, sigma], (B, 7, 7): the
    commutator [G(xi), G(eta)] = G(ad(xi) eta) of the generators
    G = [[hat(phi) + sigma I, rho], [0, 0]]."""
    rho, phi, sigma = xi[:, :3], xi[:, 3:6], xi[:, 6]
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    out = torch.zeros((len(xi), 7, 7), dtype=xi.dtype, device=xi.device)
    out[:, :3, :3] = hat(phi) + sigma[:, None, None] * eye3
    out[:, :3, 3:6] = hat(rho)
    out[:, :3, 6] = -rho
    out[:, 3:6, 3:6] = hat(phi)
    return out


def _log_jacobian(xi: torch.Tensor) -> torch.Tensor:
    """d log(exp(xi) exp(u)) / du at u = 0, (B, 7, 7): the inverse of Sim3's
    right Jacobian J_r(xi) = sum_n (-ad xi)^n / (n + 1)!, read off the block
    exponential exp([[-ad xi, I], [0, 0]]) (Van Loan)."""
    m = torch.zeros((len(xi), 14, 14), dtype=xi.dtype, device=xi.device)
    m[:, :7, :7] = -_sim3_ad(xi)
    m[:, :7, 7:] = torch.eye(7, dtype=xi.dtype, device=xi.device)
    return torch.linalg.inv(torch.linalg.matrix_exp(m)[:, :7, 7:])


def _edge_res_jac(si, sj, meas):
    """Residuals (E, 7) and both Jacobians (E, 7, 7) of every edge.

    With Q = S_j S_i^-1 and X0 = meas^-1 Q:
      r(di, dj) = log(X0 . exp(Ad(Q^-1) dj) . exp(-di))
    so for F(u) = log(X0 exp(u)) with DF = dF/du at 0:
      J_j = DF . Ad(Q^-1),   J_i = -DF."""
    q = sj @ sim3_inverse(si)
    r = sim3_log(sim3_inverse(meas) @ q)
    df = _log_jacobian(r)
    return r, -df, df @ _sim3_adjoint(sim3_inverse(q))


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4) optimized Sim3 S_cw
    cost: torch.Tensor   # () weighted squared residual at `poses`
    iterations: int      # LM iterations run


def _edge_weights(edge_mask, edge_weight):
    w = edge_mask.float()
    return w if edge_weight is None else w * edge_weight


def optimize_pose_graph(
    poses: torch.Tensor,      # (K, 4, 4) Sim3 [sR t; 0 1], world -> cam
    fixed: torch.Tensor,      # (K,) bool
    edge_i: torch.Tensor,     # (E,) int
    edge_j: torch.Tensor,     # (E,) int
    edge_meas: torch.Tensor,  # (E, 4, 4) measured S_j S_i^-1
    edge_mask: torch.Tensor,  # (E,) bool
    edge_weight: torch.Tensor | None = None,
    n_iters: int = 20,
) -> PoseGraphResult:
    """Dense LM: H (7K, 7K) from the per-edge blocks by segment_sum, one
    Cholesky per iteration, fixed vertices held by zero Jacobians and a unit
    diagonal."""
    k = poses.shape[0]
    dev = poses.device
    ei, ej = edge_i.long(), edge_j.long()
    free = (~fixed).float()
    w_e = _edge_weights(edge_mask, edge_weight)
    diag7 = torch.arange(7, device=dev)

    def eval_point(p):
        """-> (cost, H (7K, 7K), diag(H) (7K,), g (7K,))."""
        r, j_i, j_j = _edge_res_jac(p[ei], p[ej], edge_meas)
        err = torch.sum(torch.sum(r * r, dim=-1) * w_e)
        j_i = j_i * (free[ei] * w_e)[:, None, None]
        j_j = j_j * (free[ej] * w_e)[:, None, None]
        r_w = r * w_e[:, None]
        b_ii = torch.einsum("eri,erj->eij", j_i, j_i)
        b_jj = torch.einsum("eri,erj->eij", j_j, j_j)
        b_ij = torch.einsum("eri,erj->eij", j_i, j_j)
        blocks = segment_sum(torch.cat([b_ii, b_jj, b_ij, b_ij.transpose(1, 2)]),
                             torch.cat([ei * k + ei, ej * k + ej, ei * k + ej, ej * k + ei]), k * k)
        h = blocks.reshape(k, k, 7, 7).permute(0, 2, 1, 3).reshape(7 * k, 7 * k)
        eij = torch.cat([ei, ej])
        g = segment_sum(torch.cat([torch.einsum("eri,er->ei", j_i, r_w), torch.einsum("eri,er->ei", j_j, r_w)]),
                        eij, k)
        dvec = segment_sum(torch.cat([b_ii[:, diag7, diag7], b_jj[:, diag7, diag7]]), eij, k)
        return err, h, dvec.reshape(-1), g.reshape(-1)

    fmask = free.repeat_interleave(7)
    p = poses
    err, h, dvec, g = eval_point(p)
    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    it = 0
    while it < n_iters:
        # fixed vertices have zero rows/cols in H and g; their unit diagonal
        # keeps the damped system SPD
        hmat = h + torch.diag(lam * dvec + 1e-8 + (1.0 - fmask))
        chol, info = torch.linalg.cholesky_ex(hmat)
        dx = -torch.cholesky_solve(g[:, None], chol)[:, 0].reshape(k, 7)
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))  # failed factor: rejected step
        dx = dx * free[:, None]
        p_new = sim3_exp(dx) @ p
        err_new, h_new, d_new, g_new = eval_point(p_new)
        accept = err_new < err
        p = torch.where(accept, p_new, p)
        h = torch.where(accept, h_new, h)
        dvec = torch.where(accept, d_new, dvec)
        g = torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        err = torch.where(accept, err_new, err)
        it += 1
        if bool((torch.amax(torch.abs(dx)) < 1e-7) | (lam >= 1e6)):
            break
    return PoseGraphResult(poses=p, cost=err, iterations=it)


def optimize_pose_graph_cg(
    poses: torch.Tensor,
    fixed: torch.Tensor,
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    edge_meas: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_weight: torch.Tensor | None = None,
    n_iters: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    mesh=None,
) -> PoseGraphResult:
    """Matrix-free LM: each CG iteration applies H = J^T J edge-wise (two
    batched (E, 7, 7) products + index adds) with a block-Jacobi (per-vertex
    7x7) preconditioner; the normal equations are never formed. The CG loop
    freezes its state once the residual is below tolerance (the JAX
    while-loop's exit) and reads that flag back every 10 iterations.

    With `mesh` (a parallel/mesh.ShardMesh) the edge arrays are this
    process's edge shards, (n_local, Es, ...), and every edge-wise sum is
    taken per shard and reduced over the mesh with `mesh.psum`: one (K, 7)
    reduction per CG iteration, the (K, 7, 7) block diagonal, the gradient
    and the cost per evaluation; the damping is added to the reduced
    product (parallel/dist_posegraph)."""
    k = poses.shape[0]
    dev = poses.device
    n_sh = 1 if mesh is None else edge_i.shape[0]
    ei, ej = edge_i.reshape(-1).long(), edge_j.reshape(-1).long()
    edge_meas = edge_meas.reshape(-1, 4, 4)
    free = (~fixed).float()
    w_e = _edge_weights(edge_mask.reshape(-1), edge_weight)
    eye7 = torch.eye(7, device=dev)
    diag7 = torch.arange(7, device=dev)

    eij = torch.cat([ei, ej])
    if mesh is not None:  # (shard, vertex) row of each edge end
        shard = torch.arange(n_sh, device=dev).repeat_interleave(len(ei) // n_sh)
        eij_sh = torch.cat([shard, shard]) * k + eij

    def scatter7(vals_i, vals_j):
        vals = torch.cat([vals_i, vals_j])
        if mesh is None:
            return segment_sum(vals, eij, k)
        return mesh.psum(segment_sum(vals, eij_sh, n_sh * k).reshape((n_sh, k) + vals.shape[1:]))

    def edge_total(x):
        return torch.sum(x) if mesh is None else mesh.psum(x.reshape(n_sh, -1).sum(1))

    def eval_point(p):
        r, j_i, j_j = _edge_res_jac(p[ei], p[ej], edge_meas)
        err = edge_total(torch.sum(r * r, dim=-1) * w_e)
        j_i = j_i * (free[ei] * w_e)[:, None, None]
        j_j = j_j * (free[ej] * w_e)[:, None, None]
        r_w = r * w_e[:, None]
        g = scatter7(torch.einsum("eri,er->ei", j_i, r_w), torch.einsum("eri,er->ei", j_j, r_w))
        bdiag = scatter7(torch.einsum("eri,erj->eij", j_i, j_i), torch.einsum("eri,erj->eij", j_j, j_j))
        return err, (j_i, j_j), g, bdiag

    def matvec(jac, x, lam, dvec):
        j_i, j_j = jac
        y = torch.einsum("eri,ei->er", j_i, x[ei]) + torch.einsum("eri,ei->er", j_j, x[ej])
        out = scatter7(torch.einsum("eri,er->ei", j_i, y), torch.einsum("eri,er->ei", j_j, y))
        return out + (lam * dvec + 1e-8) * x + (1.0 - free)[:, None] * x

    def pcg(jac, b, lam, dvec, minv):
        x = torch.zeros_like(b)
        r = b
        z = torch.einsum("kij,kj->ki", minv, r)
        p = z
        rz = torch.sum(r * z)
        bnorm = torch.sqrt(torch.sum(b * b)) + 1e-30
        running = torch.tensor(True, device=dev)
        for it in range(cg_iters):
            running = running & (torch.sqrt(torch.sum(r * r)) > cg_tol * bnorm)
            if it % 10 == 0 and not bool(running):
                break
            ap = matvec(jac, p, lam, dvec)
            alpha = rz / torch.clamp(torch.sum(p * ap), min=1e-30)
            x_n, r_n = x + alpha * p, r - alpha * ap
            z_n = torch.einsum("kij,kj->ki", minv, r_n)
            rz_n = torch.sum(r_n * z_n)
            p_n = z_n + rz_n / torch.clamp(rz, min=1e-30) * p
            x, r, z, p, rz = (torch.where(running, new, old)
                              for new, old in ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
        return x

    p = poses
    err, jac, g, bdiag = eval_point(p)
    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    it = 0
    while it < n_iters:
        dvec = bdiag[:, diag7, diag7]
        mblk = bdiag + torch.diag_embed(lam * dvec + 1e-8) + (1.0 - free)[:, None, None] * eye7
        dx = pcg(jac, -g, lam, dvec, torch.linalg.inv(mblk)) * free[:, None]
        p_new = sim3_exp(dx) @ p
        err_new, jac_new, g_new, bd_new = eval_point(p_new)
        accept = err_new < err
        p = torch.where(accept, p_new, p)
        jac = tuple(torch.where(accept, b, a) for a, b in zip(jac, jac_new))
        g = torch.where(accept, g_new, g)
        bdiag = torch.where(accept, bd_new, bdiag)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        err = torch.where(accept, err_new, err)
        it += 1
        if bool((torch.amax(torch.abs(dx)) < 1e-7) | (lam >= 1e6)):
            break
    return PoseGraphResult(poses=p, cost=err, iterations=it)


# Above this many vertices the matrix-free solver is used. The JAX package
# switches at 192 (its dense (7K)^2 Hessian and O(K^3) Cholesky outgrow the CG
# path's O(E) work on the TPU). On an H100 the dense solve is 4.7-6.7x faster
# than CG at every K from 32 to 1024, and CG stops short of the dense optimum
# from K = 384 on (tools/posegraph_crossover.py, PERF.md), so the port stays
# dense up to the largest K measured.
DENSE_VERTEX_LIMIT = 1024


def solve_pose_graph(poses, fixed, edge_i, edge_j, edge_meas, edge_mask,
                     edge_weight=None, n_iters: int = 20) -> PoseGraphResult:
    """Dense Cholesky LM up to DENSE_VERTEX_LIMIT vertices, block-Jacobi PCG
    above (both reach the same optimum)."""
    fn = optimize_pose_graph_cg if poses.shape[0] > DENSE_VERTEX_LIMIT else optimize_pose_graph
    return fn(poses, fixed, edge_i, edge_j, edge_meas, edge_mask, edge_weight, n_iters=n_iters)


class Sim3RefineResult(NamedTuple):
    s12: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _project(p, fx, fy, cx, cy):
    """Pixels of camera points (N, 3) and d pixel / d point (N, 2, 3); the
    depth is clamped at 1e-6, where its derivative is 0."""
    x, y = p[:, 0], p[:, 1]
    clamped = p[:, 2] < 1e-6
    z = torch.where(clamped, 1e-6, p[:, 2])
    zero = torch.zeros_like(z)
    dz = torch.where(clamped, 0.0, -1.0 / (z * z))
    jac = torch.stack([torch.stack([fx / z, zero, fx * x * dz], -1),
                       torch.stack([zero, fy / z, fy * y * dz], -1)], -2)
    return torch.stack([fx * x / z + cx, fy * y / z + cy], dim=-1), jac


def _sim3_pair_residuals(s, pts1, pts2, uv1, uv2, sq1, sq2, fx, fy, cx, cy, jacobian: bool = True):
    """Bidirectional reprojection residuals of S12 = s (4, 4), (N, 4):
    (pi(S p2) - uv1) sqrt(w1) and (pi(S^-1 p1) - uv2) sqrt(w2); with
    `jacobian` also their derivative (N, 4, 7) under the left update
    S <- exp(delta) S, delta = [rho, phi, sigma]:
      d(exp(delta) q) = [I, -hat(q), q]            for q = S p2,
      d(S^-1 exp(-delta) p1) = A [-I, hat(p1), -p1] with A = S^-1's 3x3."""
    sinv = sim3_inverse(s)
    q2 = pts2 @ s[:3, :3].T + s[:3, 3]
    q1 = pts1 @ sinv[:3, :3].T + sinv[:3, 3]
    uv2_in_1, pj1 = _project(q2, fx, fy, cx, cy)
    uv1_in_2, pj2 = _project(q1, fx, fy, cx, cy)
    r = torch.cat([(uv2_in_1 - uv1) * sq1, (uv1_in_2 - uv2) * sq2], dim=-1)
    if not jacobian:
        return r
    eye = torch.eye(3, dtype=s.dtype, device=s.device).expand(len(q2), 3, 3)
    d2 = torch.cat([eye, -hat(q2), q2[:, :, None]], dim=-1)
    d1 = sinv[:3, :3] @ torch.cat([-eye, hat(pts1), -pts1[:, :, None]], dim=-1)
    return r, torch.cat([sq1[:, :, None] * (pj1 @ d2), sq2[:, :, None] * (pj2 @ d1)], dim=1)


def optimize_sim3(
    s12: torch.Tensor,           # (4, 4) initial [sR t] mapping cam2 -> cam1
    pts1: torch.Tensor,          # (N, 3) matched points in cam1
    pts2: torch.Tensor,          # (N, 3) matched points in cam2
    uv1: torch.Tensor,           # (N, 2) observed pixels in image 1
    uv2: torch.Tensor,           # (N, 2) observed pixels in image 2
    mask: torch.Tensor,          # (N,) bool
    k_mat: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    fix_scale: bool = False,
    chi2_th: float = 10.0,
    n_iters: int = 10,
) -> Sim3RefineResult:
    """LM refinement of the relative Sim3 with bidirectional reprojection
    residuals (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ), inliers
    pruned by chi2 between the two rounds (reference :1290-1330). Each
    round runs its n_iters steps."""
    cam = (k_mat[0, 0], k_mat[1, 1], k_mat[0, 2], k_mat[1, 2])
    obs = (pts1, pts2, uv1, uv2, torch.sqrt(inv_sigma2_1)[:, None], torch.sqrt(inv_sigma2_2)[:, None])
    dev = pts1.device
    not_scale = torch.arange(7, device=dev) != 6

    def gn_round(s, active, iters):
        act = active[:, None]
        r0 = _sim3_pair_residuals(s, *obs, *cam, jacobian=False) * act
        lam = torch.tensor(1e-2, device=dev)
        err = torch.sum(r0 * r0)
        for _ in range(iters):
            r, j = _sim3_pair_residuals(s, *obs, *cam)
            r, j = (r * act).reshape(-1), (j * act[:, :, None]).reshape(-1, 7)
            if fix_scale:
                j = j * not_scale
            h = j.T @ j
            g = j.T @ r
            h = h + torch.diag(lam * torch.diagonal(h) + 1e-8)
            dx = -torch.linalg.solve(h, g)
            if fix_scale:
                dx = dx * not_scale
            s_new = sim3_exp(dx) @ s
            r_new = _sim3_pair_residuals(s_new, *obs, *cam, jacobian=False) * act
            err_new = torch.sum(r_new * r_new)
            accept = err_new < err
            s = torch.where(accept, s_new, s)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0), 1e-9, 1e6)
            err = torch.where(accept, err_new, err)
        return s

    def chi2(s):
        r = _sim3_pair_residuals(s, *obs, *cam, jacobian=False)
        return torch.sum(r[:, :2] ** 2, -1), torch.sum(r[:, 2:] ** 2, -1)

    s = gn_round(s12.float(), mask.float(), n_iters)
    c1, c2 = chi2(s)
    inl = mask & (c1 < chi2_th) & (c2 < chi2_th)
    s = gn_round(s, inl.float(), n_iters)
    c1, c2 = chi2(s)
    inl = mask & (c1 < chi2_th) & (c2 < chi2_th)
    return Sim3RefineResult(s12=s, inliers=inl, n_inliers=inl.sum())
