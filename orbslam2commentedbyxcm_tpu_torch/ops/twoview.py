"""Two-view geometry on torch tensors: DLT triangulation.

Counterpart of `triangulate` in orbslam2commentedbyxcm_tpu/ops/twoview.py,
the piece local mapping calls. The rest of that module (the H/F two-view
initialization) belongs to monocular initialization and is not ported.
"""

from __future__ import annotations

import torch

from orbslam2commentedbyxcm_tpu_torch.ops.optim import inv3x3


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
