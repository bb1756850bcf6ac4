"""SO3 / SE3 / Sim3 Lie-group operations on torch tensors.

Counterpart of orbslam2commentedbyxcm_tpu/utils/geometry.py: hat, vee,
so3/se3 exp and log, inverse, apply, quaternions, and the Sim3 group of loop
closing. Same conventions: rotations (..., 3, 3), transforms (..., 4, 4)
with x' = R x + t, se3 tangents (..., 6) ordered [rho, phi], Sim3 as
[sR t; 0 1] with tangents (..., 7) [rho, phi, sigma], quaternions
(w, x, y, z). Small-angle branches use Taylor expansions selected with
torch.where, so every function is branch-free over a batch and traceable by
torch.func's forward-mode transforms.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sinc_terms(theta2: torch.Tensor):
    """Stable (A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) rotation vector -> (..., 3, 3) matrix."""
    theta2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_terms(theta2)
    k = hat(phi)
    return _eye3(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO3: exp(hat(phi + dphi)) ~ exp(hat(J dphi)) exp(hat(phi))."""
    theta2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_terms(theta2)
    k = hat(phi)
    return _eye3(k) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    k = hat(phi)
    half_theta = 0.5 * theta
    sin_h = torch.sin(half_theta)
    cot = torch.cos(half_theta) / torch.where(torch.abs(sin_h) < _EPS, _EPS, sin_h)
    coeff = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0, (1.0 - half_theta * cot) / theta2)
    return _eye3(k) - 0.5 * k + coeff[..., None, None] * (k @ k)


def rot_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w >= 0), Shepperd's method."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + m00 + m11 + m22, min=0.0))
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0))
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0))
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0))
    sw, sx, sy, sz = (torch.clamp(q, min=_EPS) for q in (qw, qx, qy, qz))
    cand = torch.stack(
        [
            torch.stack([qw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1),
            torch.stack([(m21 - m12) / sx, qx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1),
            torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, qy, (m12 + m21) / sy], dim=-1),
            torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, qz], dim=-1),
        ],
        dim=-2,
    )  # (..., 4, 4)
    idx = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = q * 0.5
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalized first -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vnorm = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < _EPS, 2.0, angle / torch.clamp(vnorm, min=_EPS))
    return q[..., 1:] * scale[..., None]


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, via the quaternion (stable near pi)."""
    return quat_to_rotvec(rot_to_quat(r))


def rt_to_se3(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return rt_to_se3(so3_exp(phi), t)


def se3_log(t44: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    phi = so3_log(t44[..., :3, :3])
    rho = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(phi), t44[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(t44: torch.Tensor) -> torch.Tensor:
    rt = t44[..., :3, :3].transpose(-1, -2)
    return rt_to_se3(rt, -torch.einsum("...ij,...j->...i", rt, t44[..., :3, 3]))


def se3_apply(t44: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return torch.einsum("...ij,...j->...i", t44[..., :3, :3], pts) + t44[..., :3, 3]


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) quaternions (w, x, y, z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Sim3 as (..., 4, 4) matrices [sR t; 0 1] (g2o's Sim3, Thirdparty/g2o/g2o/
# types/sim3.h); tangents (..., 7) [rho, phi, sigma] with s = exp(sigma).
# Every branch is a torch.where, so torch.func.vmap / jacfwd trace them.
# ---------------------------------------------------------------------------

def sim3_make(r: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """[sR t; 0 1] from rotation (..., 3, 3), translation (..., 3), scale (...)."""
    s = torch.as_tensor(s, dtype=r.dtype, device=r.device)
    return rt_to_se3(s[..., None, None] * r, t)


def sim3_scale(m: torch.Tensor) -> torch.Tensor:
    """Scale of a Sim3: the norm of the first column of sR."""
    return torch.linalg.vector_norm(m[..., :3, 0], dim=-1)


def sim3_rot(m: torch.Tensor) -> torch.Tensor:
    return m[..., :3, :3] / sim3_scale(m)[..., None, None]


def sim3_inverse(m: torch.Tensor) -> torch.Tensor:
    s = sim3_scale(m)
    rt = sim3_rot(m).transpose(-1, -2)
    sinv = 1.0 / s
    return sim3_make(rt, -sinv[..., None] * torch.einsum("...ij,...j->...i", rt, m[..., :3, 3]), sinv)


def sim3_apply(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], pts) + m[..., :3, 3]


def _sim3_w(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W of the sim3 exp/log (t = W rho): a I + b K + c K^2 with
      a = (s - 1)/sigma
      b = (s sigma sin th + th (1 - s cos th)) / (th (sigma^2 + th^2))
      c = (a - (s (sigma cos th + th sin th) - sigma)/(sigma^2 + th^2)) / th^2
    (s = e^sigma). The exact forms cancel catastrophically for small th or
    sigma, so both get series below 0.05; every branch torch.where discards
    stays finite (forward-mode derivatives flow through both)."""
    s = torch.exp(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    k = hat(phi)

    sig_small = torch.abs(sigma) < 0.05
    th_small = theta < 0.05
    safe_sigma = torch.where(sig_small, 1.0, sigma)
    safe_sigma2 = safe_sigma * safe_sigma
    safe_theta = torch.where(th_small, 1.0, theta)
    safe_theta2 = torch.where(th_small, 1.0, theta2)
    c_den = torch.where(sig_small & th_small, 1.0, sigma * sigma + theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    a_coef = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma**2 / 6.0 + sigma**3 / 24.0,
                         (s - 1.0) / safe_sigma)
    b_general = (s * sigma * sin_t + theta * (1.0 - s * cos_t)) / (safe_theta * c_den)
    b_th_small = torch.where(sig_small, 0.5 + sigma / 3.0 + sigma**2 / 8.0 - theta2 / 24.0,
                             (s * safe_sigma + 1.0 - s) / safe_sigma2)
    b_coef = torch.where(th_small, b_th_small, b_general)
    c_general = (a_coef - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / c_den) / safe_theta2
    c_th_small = torch.where(
        sig_small,
        1.0 / 6.0 + sigma / 8.0 + sigma**2 / 20.0 - theta2 / 120.0,
        (s - 1.0 - s * safe_sigma + s * safe_sigma2 / 2.0) / (safe_sigma2 * safe_sigma),
    )
    c_coef = torch.where(th_small, c_th_small, c_general)
    return a_coef[..., None, None] * _eye3(k) + b_coef[..., None, None] * k + c_coef[..., None, None] * (k @ k)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim3 tangent (..., 7) [rho, phi, sigma] -> (..., 4, 4) [sR t; 0 1]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_w(phi, sigma), rho)
    return sim3_make(so3_exp(phi), t, torch.exp(sigma))


def _solve3x3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cofactor solve of batched 3x3 systems m x = v; a near-singular m
    (relative to its scale) gives nan, as a pivoted solve would."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = e * i - f * h
    c10 = f * g - d * i
    c20 = d * h - e * g
    det = a * c00 + b * c10 + c * c20
    scale = torch.amax(torch.abs(m), dim=(-2, -1))
    ok = torch.abs(det) > 1e-12 * scale * scale * scale
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), torch.full_like(det, float("nan")))
    x0 = c00 * v[..., 0] + (c * h - b * i) * v[..., 1] + (b * f - c * e) * v[..., 2]
    x1 = c10 * v[..., 0] + (a * i - c * g) * v[..., 1] + (c * d - a * f) * v[..., 2]
    x2 = c20 * v[..., 0] + (b * g - a * h) * v[..., 1] + (a * e - b * d) * v[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]


def sim3_log(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) [sR t; 0 1] -> (..., 7) [rho, phi, sigma]."""
    sigma = torch.log(sim3_scale(m))
    phi = so3_log(sim3_rot(m))
    rho = _solve3x3(_sim3_w(phi, sigma), m[..., :3, 3])
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Composition: plain matrix product of the 4x4 forms."""
    return a @ b
