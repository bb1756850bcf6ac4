"""Plain motion-only pose solve: the reference for the pose the port returns.

The last round of upstream Optimizer::PoseOptimization optimizes the pose
over the edges still classified inliers, without the robust kernel: the
sum over edges of inv_sigma2 * |obs - proj(Tcw p)|^2, where proj gives
(u, v) for a monocular edge and (u, v, u - bf / z) for a stereo one (an
observation with u_right >= 0). `solve` runs Levenberg-Marquardt on that
cost from a given pose to convergence, in float64 (the reference) or with
the projections, residuals, Jacobians and normal equations in bfloat16 (the
control). `gap_px` measures how far two poses lie apart as the largest
image displacement of the edges' points between them.
"""

from __future__ import annotations

import numpy as np
import torch


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = (rho, phi) -> (4, 4), float64."""
    xi = xi.double()
    rho, phi = xi[:3], xi[3:]
    theta = torch.linalg.vector_norm(phi)
    k = _hat(phi)
    eye = torch.eye(3, dtype=torch.float64)
    if float(theta) < 1e-10:
        r, v = eye + k, eye + 0.5 * k
    else:
        a = torch.sin(theta) / theta
        b = (1 - torch.cos(theta)) / theta**2
        c = (theta - torch.sin(theta)) / theta**3
        r = eye + a * k + b * (k @ k)
        v = eye + b * k + c * (k @ k)
    out = torch.eye(4, dtype=torch.float64)
    out[:3, :3] = r
    out[:3, 3] = v @ rho
    return out


def project(t_cw: torch.Tensor, pts: torch.Tensor, cam) -> torch.Tensor:
    """(N, 3) world points -> (N, 3) (u, v, u - bf / z)."""
    fx, fy, cx, cy, bf = cam
    pc = pts @ t_cw[:3, :3].T + t_cw[:3, 3]
    inv_z = 1.0 / pc[:, 2]
    u = fx * pc[:, 0] * inv_z + cx
    return torch.stack([u, fy * pc[:, 1] * inv_z + cy, u - bf * inv_z], -1)


def _terms(t_cw, pts, obs, inv_sigma2, cam, dtype):
    """Residuals and Jacobians (left-multiplicative xi) in `dtype`."""
    fx, fy, cx, cy, bf = cam
    t = t_cw.to(dtype)
    p = pts.to(dtype)
    o = obs.to(dtype)
    pc = p @ t[:3, :3].T + t[:3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    stereo = obs[:, 2] >= 0
    ur = u - bf * inv_z
    r = torch.stack([o[:, 0] - u, o[:, 1] - v, torch.where(stereo, o[:, 2] - ur, 0.0)], -1)
    zero = torch.zeros_like(x)
    dproj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1),
        torch.where(stereo[:, None], torch.stack([fx * inv_z, zero, (-fx * x + bf) * inv_z2], -1), 0.0),
    ], -2)
    eye = torch.eye(3, dtype=dtype).expand(len(x), 3, 3)
    j = -dproj @ torch.cat([eye, -_hat(pc)], -1)
    w = inv_sigma2.to(dtype)
    return r, j, w


def solve(t0: np.ndarray, pts: np.ndarray, obs: np.ndarray, inv_sigma2: np.ndarray, cam,
          precision: str = "f64", max_iters: int = 50) -> np.ndarray:
    """Levenberg-Marquardt on the non-robust cost from t0 -> (4, 4) float64."""
    dtype = {"f64": torch.float64, "bf16": torch.bfloat16}[precision]
    t = torch.as_tensor(np.asarray(t0, np.float64))
    p = torch.as_tensor(np.asarray(pts, np.float64))
    o = torch.as_tensor(np.asarray(obs, np.float64))
    s = torch.as_tensor(np.asarray(inv_sigma2, np.float64))
    acc = torch.float32 if precision == "bf16" else torch.float64

    def normal_eq(tt):
        r, j, w = _terms(tt, p, o, s, cam, dtype)
        cost = (w * (r * r).sum(-1)).sum()
        jw = j * w[:, None, None]
        h = torch.einsum("nij,nik->jk", jw, j).to(acc)
        g = torch.einsum("nij,ni->j", jw, r).to(acc)
        return float(cost), h, g

    cost, h, g = normal_eq(t)
    lam = 1e-3
    for _ in range(max_iters):
        dx = -torch.linalg.solve(h + lam * torch.diag(torch.diagonal(h)), g[:, None])[:, 0]
        t_new = se3_exp(dx.double()) @ t
        if precision == "bf16":
            t_new = t_new.bfloat16().double()
        cost_new, h_new, g_new = normal_eq(t_new)
        if cost_new < cost:
            t, cost, h, g, lam = t_new, cost_new, h_new, g_new, max(lam * 0.5, 1e-12)
        else:
            lam *= 4.0
        if float(torch.max(torch.abs(dx))) < 1e-13 or lam > 1e8:
            break
    return t.numpy()


def gap_px(t_a: np.ndarray, t_b: np.ndarray, pts: np.ndarray, cam) -> float:
    """Largest (u, v) displacement of the points between two poses, pixels."""
    p = torch.as_tensor(np.asarray(pts, np.float64))
    a = project(torch.as_tensor(np.asarray(t_a, np.float64)), p, cam)[:, :2]
    b = project(torch.as_tensor(np.asarray(t_b, np.float64)), p, cam)[:, :2]
    return float(torch.linalg.vector_norm(a - b, dim=-1).max())
