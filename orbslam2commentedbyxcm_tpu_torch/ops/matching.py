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
