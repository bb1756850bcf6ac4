"""256-bit Hamming matching on torch tensors.

Counterpart of orbslam2commentedbyxcm_tpu/ops/matching.py. Distances are one
matrix product of the descriptors' bits as +-1 vectors: d = (256 - a.b) / 2.
Every product and partial sum is an integer of magnitude <= 256, exact in
float32 accumulation whatever the summation order, and +-1 is exact in TF32
and bf16 inputs too, so the distances are exact under any matmul precision
setting. (The JAX module takes the same product over {0, 1} bits in bf16 for
the TPU's MXU.) Thresholds mirror the reference: TH_LOW=50, TH_HIGH=100,
HISTO_LENGTH=30 (src/ORBmatcher.cc:38-40).
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1e9


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """int32 (..., 8) packed descriptors -> float (..., 256) in {0, 1}
    (bit b of word w is element 32 w + b)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.int()[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).float()


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: (..., N, 8) x (..., M, 8) int32 ->
    (..., N, M) float32, leading dims broadcast."""
    sa = unpack_bits(desc_a) * 2.0 - 1.0
    sb = unpack_bits(desc_b) * 2.0 - 1.0
    return (256.0 - sa @ sb.transpose(-1, -2)) * 0.5


def rotation_consistency(
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    idx_b: torch.Tensor,
    ok: torch.Tensor,
    n_bins: int = HISTO_LENGTH,
    keep_top: int = 3,
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the `keep_top` most
    populated of `n_bins` orientation-delta bins, dropping bins under 0.1 x
    the fullest (ComputeThreeMaxima, src/ORBmatcher.cc:1935)."""
    delta = angle_a - angle_b[idx_b.long()]
    delta = torch.remainder(delta, 2.0 * math.pi)  # jnp.mod: sign of the divisor
    bins = torch.remainder(torch.floor(delta / (2.0 * math.pi / n_bins)).int(), n_bins)
    hist = torch.zeros(n_bins, dtype=torch.float32, device=ok.device)
    hist = hist.index_add(0, bins.long(), ok.float())
    # lax.top_k order: largest first, ties to the lower bin
    order = torch.sort(hist, descending=True, stable=True)
    top_vals, top_idx = order.values[:keep_top], order.indices[:keep_top]
    keep_bins = torch.where(top_vals >= 0.1 * top_vals[0], top_idx, -1)
    in_top = (bins.long()[:, None] == keep_bins[None, :]).any(dim=-1)
    return ok & in_top


def hamming_pairs(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-wise Hamming distance for aligned pairs: (N, 8), (N, 8) -> (N,) float32."""
    return torch.sum(torch.abs(unpack_bits(desc_a) - unpack_bits(desc_b)), dim=-1)


def match_nn(
    dist: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    max_dist: float = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = False,
):
    """Nearest-neighbour matching over a (N, M) distance matrix.

    Returns (idx_b (N,) int32, match_dist (N,), ok (N,) bool). `ratio` < 1
    applies Lowe's best / second-best test (mfNNratio, e.g. 0.9 in
    SearchForInitialization, src/ORBmatcher.cc:539); `mutual` keeps a pair
    only when a is also b's nearest. Ties go to the first index, as
    jnp.argmin."""
    d = dist
    if mask is not None:
        d = torch.where(mask, d, BIG)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    ok = best <= max_dist
    if ratio < 1.0:
        cols = torch.arange(d.shape[1], device=d.device)
        second = torch.amin(torch.where(cols[None, :] == best_idx[:, None], BIG, d), dim=1)
        ok = ok & (best < ratio * second)
    if valid_a is not None:
        ok = ok & valid_a
    if mutual:
        rev = torch.argmin(d, dim=0)
        ok = ok & (rev[best_idx] == torch.arange(d.shape[0], device=d.device))
    return best_idx.int(), best, ok


def window_mask(
    uv_a: torch.Tensor,
    uv_b: torch.Tensor,
    radius,
    level_a: torch.Tensor | None = None,
    level_b: torch.Tensor | None = None,
    max_level_diff: int | None = None,
) -> torch.Tensor:
    """(N, M) candidate mask: |uv_a - uv_b|_inf <= radius (a scalar or one
    radius per row), optionally gating |level_a - level_b| (the dense form of
    GetFeaturesInArea, src/Frame.cc:488-548)."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=uv_a.device)
    if radius.dim() == 1:
        radius = radius[:, None]
    dx = torch.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dy = torch.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    m = (dx <= radius) & (dy <= radius)
    if max_level_diff is not None and level_a is not None:
        m = m & (torch.abs(level_a[:, None] - level_b[None, :]) <= max_level_diff)
    return m


def group_mask(group_a: torch.Tensor, group_b: torch.Tensor) -> torch.Tensor:
    """(N, M) candidate mask: the same vocabulary-tree grouping node (the
    FeatureVector walk of SearchByBoW, src/ORBmatcher.cc:228/:696)."""
    return group_a[:, None] == group_b[None, :]


def search_by_bow(
    desc_a: torch.Tensor, group_a: torch.Tensor, valid_a: torch.Tensor,
    desc_b: torch.Tensor, group_b: torch.Tensor, valid_b: torch.Tensor,
    angle_a: torch.Tensor | None = None, angle_b: torch.Tensor | None = None,
    max_dist: float = TH_LOW, ratio: float = 0.75, mutual: bool = True,
):
    """BoW-node-constrained matching (SearchByBoW, src/ORBmatcher.cc:228 for
    KF <-> frame, :696 for KF <-> KF). Returns (idx_b, dist, ok) over rows of
    a. `group_*` are the features' vocabulary grouping nodes (ops/bow
    `transform`); a feature outside any node (-1) never matches."""
    d = hamming_matrix(desc_a, desc_b)
    m = group_mask(group_a, group_b) & (group_a >= 0)[:, None]
    idx, dist, ok = match_nn(d, valid_a, valid_b, m, max_dist=max_dist, ratio=ratio, mutual=mutual)
    if angle_a is not None and angle_b is not None:
        ok = rotation_consistency(angle_a, angle_b, idx, ok)
    return idx, dist, ok


def search_for_initialization(
    feats_a,
    feats_b,
    window: float = 100.0,
    max_dist: float = TH_LOW,
    ratio: float = 0.9,
    check_rotation: bool = True,
    max_level: int = 1,
):
    """Windowed fine-scale matching between two frames for monocular map
    initialization (SearchForInitialization, src/ORBmatcher.cc:539).
    `feats_*` carry uv, desc, level, angle and valid tensors. As in the JAX
    package, levels <= `max_level` are admitted, where the reference takes
    level 0 only."""
    dist = hamming_matrix(feats_a.desc, feats_b.desc)
    m = window_mask(feats_a.uv, feats_b.uv, window)
    m = m & (feats_a.level[:, None] <= max_level) & (feats_b.level[None, :] <= max_level)
    idx, d, ok = match_nn(dist, feats_a.valid, feats_b.valid, m, max_dist=max_dist, ratio=ratio,
                          mutual=True)
    if check_rotation:
        ok = rotation_consistency(feats_a.angle, feats_b.angle, idx, ok)
    return idx, d, ok
