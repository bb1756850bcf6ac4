"""Distributed bundle adjustment: the landmark-sharded Schur complement over a
shard mesh (parallel/mesh.ShardMesh).

Counterpart of orbslam2commentedbyxcm_tpu/parallel/dist_ba.py. Landmarks,
and each landmark's observation edges, are dealt round-robin to the shards
(`shard_ba_problem`): a landmark's 3x3 block and its Schur contribution are
computed on its own shard, the pose-sized terms are reduced over the mesh
with `mesh.psum`, the dense pose solve is replicated, and the landmarks
back-substitute on their shard.

  * `distributed_bundle_adjustment`: the dense reduced camera system
    S = Hcc - W Hpp^-1 W^T, formed per shard (W is (K, Ps, 6, 3) per shard,
    Ps = ceil(P / shards), which is why it shards) and solved replicated;
    one psum of (6K)^2 + 36K + 6K floats per LM iteration.
  * `distributed_bundle_adjustment_cg`: matrix-free, Jacobi-preconditioned
    CG on S; one (K, 6) psum per CG iteration, memory O(E + K + P).

The process's shards are one leading (n_local, ...) axis, and every step is
written once, batched over it: the edge arrays are flattened to
(n_local * Es) rows, a landmark is addressed as shard * Ps + local index and
a shard's pose block as shard * K + pose, and every block sum goes through
ops/optim.segment_sum (the JAX package writes them as one-hot matmuls, a TPU
workaround). The LM loops run a fixed number of iterations, as the JAX
package's fori_loops do, with LM's constants (lambda 1e-4, x0.5 / x4, clipped
to [1e-8, 1e6]), and read nothing back to the host.

Both take this process's shards as tensors on the mesh's device
(`mesh.local` of what `shard_ba_problem` returns) and return (poses, this
process's point shards, cost).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops.optim import (
    CHI2_MONO,
    CHI2_STEREO,
    _chi2,
    _diag,
    _huber,
    _project_residual_jacobian,
    inv3x3,
    segment_sum,
)
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import se3_exp


def shard_ba_problem(points, point_valid, obs_pose, obs_point, obs_uvr, obs_mask, inv_sigma2, n_shards: int):
    """Host-side partitioner: point p goes to shard p % n_shards at local
    index p // n_shards, and each edge follows its point, in edge order.
    Returns numpy arrays with a leading (n_shards, ...) axis and LOCAL point
    indices: points, validity, each slot's global point index, then the
    edges' pose, local point, (u, v, u_right) (padding: u_right -1), mask
    and inverse sigma^2."""
    p = len(points)
    p_shard = -(-p // n_shards)
    slots = np.arange(p_shard * n_shards).reshape(p_shard, n_shards).T  # slot (s, j) holds point j * n + s
    filled = slots < p
    pts_sh = np.zeros((n_shards, p_shard, 3), np.float32)
    pv_sh = np.zeros((n_shards, p_shard), bool)
    gidx_sh = np.zeros((n_shards, p_shard), np.int64)
    pts_sh[filled] = points[slots[filled]]
    pv_sh[filled] = point_valid[slots[filled]]
    gidx_sh[filled] = slots[filled]

    obs_point = np.asarray(obs_point)
    shard = obs_point % n_shards
    e_counts = np.bincount(shard, minlength=n_shards)
    e_shard = max(int(e_counts.max()) if len(shard) else 0, 1)
    order = np.argsort(shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(e_counts)[:-1]])
    col = np.empty(len(shard), np.int64)
    col[order] = np.arange(len(shard)) - starts[shard[order]]
    op_sh = np.zeros((n_shards, e_shard), np.int32)
    opt_sh = np.zeros((n_shards, e_shard), np.int32)
    ouv_sh = np.zeros((n_shards, e_shard, 3), np.float32)
    ouv_sh[..., 2] = -1.0
    om_sh = np.zeros((n_shards, e_shard), bool)
    osig_sh = np.ones((n_shards, e_shard), np.float32)
    op_sh[shard, col] = obs_pose
    opt_sh[shard, col] = obs_point // n_shards
    ouv_sh[shard, col] = obs_uvr
    om_sh[shard, col] = obs_mask
    osig_sh[shard, col] = inv_sigma2
    return pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh


class _Shards:
    """This process's shards flattened for batched edge work, and the edge
    terms and robust cost every solver step starts from."""

    def __init__(self, mesh, poses, pose_fixed, pts_sh, pv_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh, cam,
                 use_huber):
        self.mesh, self.cam, self.use_huber = mesh, cam, use_huber
        self.d, self.es = op_sh.shape
        self.ps = pts_sh.shape[1]
        self.k = poses.shape[0]
        dev = pts_sh.device
        shard = torch.arange(self.d, device=dev)[:, None]
        self.op = op_sh.long().reshape(-1)
        self.opt = opt_sh.long().reshape(-1)
        self.gp = (shard * self.ps + opt_sh.long()).reshape(-1)  # landmark row of each edge
        self.kp = (shard * self.k + op_sh.long()).reshape(-1)    # (shard, pose) block of each edge
        self.ouv = ouv_sh.reshape(-1, 3)
        self.osig = osig_sh.reshape(-1)
        self.pv = pv_sh.reshape(-1)
        self.delta2 = torch.where(self.ouv[:, 2] >= 0, CHI2_STEREO, CHI2_MONO).float()
        self.active0 = (om_sh.reshape(-1) & self.pv[self.gp]).float()
        self.free = ~pose_fixed
        self.fp = self.free.float()

    def edge_terms(self, poses, pts):
        """pts: (d * Ps, 3) -> residuals, Jacobians, weights, chi2 (behind
        the camera: 1e6) of every edge."""
        r, j_pose, j_point, pc, _ = _project_residual_jacobian(poses[self.op], pts[self.gp], self.ouv, *self.cam)
        c2 = _chi2(r, self.osig)
        behind = pc[:, 2] <= 0
        w = self.osig * self.active0 * (~behind).float()
        if self.use_huber:
            w = w * _huber(c2, self.delta2)[0]
        return r, j_pose, j_point, w, torch.where(behind, 1e6, c2)

    def cost(self, poses, pts):
        c2 = self.edge_terms(poses, pts)[4]
        rho = _huber(c2, self.delta2)[1] if self.use_huber else c2
        return self.mesh.psum((rho * self.active0).reshape(self.d, self.es).sum(1))

    def pose_sum(self, vals):
        """Per-edge rows -> per-shard pose blocks (d, K, ...)."""
        return segment_sum(vals, self.kp, self.d * self.k).reshape((self.d, self.k) + vals.shape[1:])

    def point_sum(self, vals):
        """Per-edge rows -> landmark rows (d * Ps, ...)."""
        return segment_sum(vals, self.gp, self.d * self.ps)

    def accept(self, poses, pts, poses_new, pts_new, lam, err):
        """LM's accept / reject of a step, on the device."""
        err_new = self.cost(poses_new, pts_new)
        ok = err_new < err
        return (torch.where(ok, poses_new, poses), torch.where(ok, pts_new, pts),
                torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e6), torch.where(ok, err_new, err))

    def hpp_inverse(self, hpp, lam):
        eye3 = torch.eye(3, device=hpp.device)
        return torch.where(self.pv[:, None, None], inv3x3(hpp + lam * _diag(hpp) + 1e-6 * eye3), 0.0)


def distributed_bundle_adjustment(
    mesh, poses, pose_fixed,
    pts_sh, pv_sh,                              # (n_local, Ps, 3), (n_local, Ps)
    op_sh, opt_sh, ouv_sh, om_sh, osig_sh,      # (n_local, Es, ...)
    fx, fy, cx, cy, bf,
    n_iters: int = 10,
    use_huber: bool = True,
):
    """One BA solve over the mesh with the dense reduced camera system.
    Returns (poses (K, 4, 4), point shards (n_local, Ps, 3), cost)."""
    sh = _Shards(mesh, poses, pose_fixed, pts_sh, pv_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh,
                 (fx, fy, cx, cy, bf), use_huber)
    d, k, ps = sh.d, sh.k, sh.ps
    fp = sh.fp
    dev = pts_sh.device
    ar = torch.arange(k, device=dev)
    eye6 = torch.eye(6, device=dev)
    wp = sh.kp * ps + sh.opt  # (shard, pose, landmark) block of each edge

    def lm_step(poses_, pts_, lam, err):
        r, j_pose, j_point, w, _ = sh.edge_terms(poses_, pts_)
        j_pose = j_pose * fp[sh.op][:, None, None]
        jw_pose = j_pose * w[:, None, None]
        jw_point = j_point * w[:, None, None]
        hcc = sh.pose_sum(torch.einsum("eij,eik->ejk", jw_pose, j_pose))
        g_c = sh.pose_sum(torch.einsum("eij,ei->ej", jw_pose, r))
        hpp = sh.point_sum(torch.einsum("eij,eik->ejk", jw_point, j_point))
        g_p = sh.point_sum(torch.einsum("eij,ei->ej", jw_point, r)).reshape(d, ps, 3)
        w_cp = segment_sum(torch.einsum("eij,eik->ejk", jw_pose, j_point), wp, d * k * ps).reshape(d, k, ps, 6, 3)
        hpp_inv = sh.hpp_inverse(hpp, lam).reshape(d, ps, 3, 3)

        y = torch.einsum("dkpab,dpbc->dkpac", w_cp, hpp_inv)
        s_part = -torch.einsum("dkpab,dlpcb->dkalc", y, w_cp)
        g_s_part = g_c - torch.einsum("dkpab,dpb->dka", y, g_p)
        # the one collective: the camera system reduced over the shards
        s, hcc, g_s = mesh.psum(s_part, hcc, g_s_part)

        s[ar, :, ar, :] += hcc + lam * _diag(hcc)
        s = s * fp[:, None, None, None] * fp[None, None, :, None]
        s[ar, :, ar, :] += (1.0 - fp)[:, None, None] * eye6
        s_mat = s.reshape(6 * k, 6 * k) + 1e-8 * torch.eye(6 * k, device=dev)
        dx_c = -torch.linalg.solve(s_mat, g_s.reshape(-1)).reshape(k, 6) * fp[:, None]

        rhs_p = -g_p - torch.einsum("dkpab,ka->dpb", w_cp, dx_c)
        dx_p = torch.einsum("dpab,dpb->dpa", hpp_inv, rhs_p).reshape(-1, 3)
        dx_p = torch.where(sh.pv[:, None], dx_p, 0.0)
        poses_new = torch.where(sh.free[:, None, None], se3_exp(dx_c) @ poses_, poses_)
        return sh.accept(poses_, pts_, poses_new, pts_ + dx_p, lam, err)

    pts = pts_sh.reshape(-1, 3)
    err = sh.cost(poses, pts)
    lam = torch.tensor(1e-4, device=dev)
    for _ in range(n_iters):
        poses, pts, lam, err = lm_step(poses, pts, lam, err)
    return poses, pts.reshape(d, ps, 3), err


def distributed_bundle_adjustment_cg(
    mesh, poses, pose_fixed,
    pts_sh, pv_sh,
    op_sh, opt_sh, ouv_sh, om_sh, osig_sh,
    fx, fy, cx, cy, bf,
    n_iters: int = 10,
    n_cg: int = 25,
    use_huber: bool = True,
):
    """Matrix-free Schur-complement LM over the mesh (see the module
    docstring): the reduced camera system is solved by n_cg iterations of
    Jacobi-preconditioned CG whose product S x is applied edge-wise per
    shard and reduced with one (K, 6) psum, so nothing of size (6K)^2 or
    (K, P) exists. Returns (poses, point shards, cost)."""
    sh = _Shards(mesh, poses, pose_fixed, pts_sh, pv_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh,
                 (fx, fy, cx, cy, bf), use_huber)
    d, ps = sh.d, sh.ps
    fp = sh.fp[:, None]
    dev = pts_sh.device

    def lm_step(poses_, pts_, lam, err):
        r, j_pose, j_point, w, _ = sh.edge_terms(poses_, pts_)
        j_pose = j_pose * sh.fp[sh.op][:, None, None]
        jw_pose = j_pose * w[:, None, None]
        jw_point = j_point * w[:, None, None]
        # pose blocks reduced over the mesh; landmark blocks stay on their shard
        hcc, g_c = mesh.psum(sh.pose_sum(torch.einsum("eij,eik->ejk", jw_pose, j_pose)),
                             sh.pose_sum(torch.einsum("eij,ei->ej", jw_pose, r)))
        hpp = sh.point_sum(torch.einsum("eij,eik->ejk", jw_point, j_point))
        g_p = sh.point_sum(torch.einsum("eij,ei->ej", jw_point, r))
        hpp_inv = sh.hpp_inverse(hpp, lam)
        hcc_lm = hcc + lam * _diag(hcc)

        def w_times(y):
            """W y for landmark rows y (d * Ps, 3) -> (K, 6), reduced."""
            jpy = torch.einsum("eij,ej->ei", j_point, y[sh.gp])
            return mesh.psum(sh.pose_sum(torch.einsum("eij,ei->ej", jw_pose, jpy)))

        def wt_times(x):
            """W^T x for pose rows x (K, 6) -> landmark rows (d * Ps, 3)."""
            jpx = torch.einsum("eij,ej->ei", j_pose, x[sh.op])
            return sh.point_sum(torch.einsum("eij,ei->ej", jw_point, jpx))

        def schur_matvec(x):
            y = torch.einsum("pab,pb->pa", hpp_inv, wt_times(x))
            out = torch.einsum("kab,kb->ka", hcc_lm, x) - w_times(y)
            return out * fp + x * (1.0 - fp)  # identity rows keep fixed poses out of the Krylov space

        g_s = (g_c - w_times(torch.einsum("pab,pb->pa", hpp_inv, g_p))) * fp
        m_inv = fp / torch.clamp(torch.diagonal(hcc_lm, dim1=-2, dim2=-1), min=1e-8) + (1.0 - fp)
        b = -g_s
        x = torch.zeros_like(b)
        res = b
        z = m_inv * b
        pdir = z
        rz = torch.sum(b * z)
        for _ in range(n_cg):
            ap = schur_matvec(pdir)
            alpha = rz / torch.clamp(torch.sum(pdir * ap), min=1e-20)
            x = x + alpha * pdir
            res = res - alpha * ap
            z = m_inv * res
            rz_new = torch.sum(res * z)
            pdir = z + rz_new / torch.clamp(rz, min=1e-20) * pdir
            rz = rz_new
        dx_c = x * fp

        # landmark back-substitution: dx_p = Hpp^-1 (-g_p - W^T dx_c)
        dx_p = torch.einsum("pab,pb->pa", hpp_inv, -g_p - wt_times(dx_c))
        dx_p = torch.where(sh.pv[:, None], dx_p, 0.0)
        poses_new = torch.where(sh.free[:, None, None], se3_exp(dx_c) @ poses_, poses_)
        return sh.accept(poses_, pts_, poses_new, pts_ + dx_p, lam, err)

    pts = pts_sh.reshape(-1, 3)
    err = sh.cost(poses, pts)
    lam = torch.tensor(1e-4, device=dev)
    for _ in range(n_iters):
        poses, pts, lam, err = lm_step(poses, pts, lam, err)
    return poses, pts.reshape(d, ps, 3), err
