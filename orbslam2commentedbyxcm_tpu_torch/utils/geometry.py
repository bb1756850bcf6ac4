"""SO3 / SE3 Lie-group operations on torch tensors.

Counterpart of orbslam2commentedbyxcm_tpu/utils/geometry.py for the pieces the
tracking step uses (hat, vee, so3/se3 exp and log, inverse, apply). Same
conventions: rotations (..., 3, 3), transforms (..., 4, 4) with x' = R x + t,
se3 tangents (..., 6) ordered [rho, phi], quaternions (w, x, y, z). Small-angle
branches use Taylor expansions selected with torch.where, so every function is
branch-free over a batch.
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
