"""ORB orientation + rotated-BRIEF descriptors: the plain twin of the
describe kernel (ops/describe_kernel, csrc/describe.cu).

Counterpart of orbslam2commentedbyxcm_tpu/ops/descriptors.py. The JAX module
gathers 128-wide row windows from 64-stride panels and samples them with
one-hot matrix products, shapes chosen for the TPU's DMA engine and MXU, and
sums the orientation moments as an XLA contraction. Here:

  * the 48x48 patch around each keypoint is read straight out of the flat
    blurred level buffer with the reflect index (numpy's mode="reflect", as
    the JAX package pads), each value rounded to bf16 (RNE);
  * the orientation moments m10, m01 are one written-down order of float32
    operations (`moments`), and the angle an atan2 made of float32
    multiplies, adds, divides and compares (`atan2_f32`), so the describe
    kernel computes the same bits on the card;
  * each of the 256 pattern pairs is rotated by the keypoint angle, rounded
    half-to-even (torch.round, as jnp.round), and the two patch values are
    compared; the bits are packed 32 to a word.

Every product and sum below is one separately rounded float32 operation
(eager torch contracts nothing); divisions are tensor by tensor (a division
by a Python scalar would multiply by its reciprocal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PATCH = 48       # patch rows/cols (keypoint +- 24)
HALF = PATCH // 2
MOMENT_LO, MOMENT_N = 9, 31  # the moment masks' nonzero window: patch rows and cols 9..39

# Cephes atanf: the polynomial on [-tan(pi/8), tan(pi/8)] and its constants,
# as float32 (csrc/describe.cu holds the same literals)
_ATAN_P = tuple(float(np.float32(c)) for c in (8.05374449538e-2, -1.38776856032e-1, 1.99777106478e-1,
                                               -3.33329491539e-1))
_TAN_PI_8 = float(np.float32(0.4142135623730950))
_PI_4, _PI_2, _PI = (float(np.float32(c)) for c in (np.pi / 4, np.pi / 2, np.pi))


class DescriptorTables(NamedTuple):
    """The describe stage's constants on one device."""

    pattern: torch.Tensor  # (256, 4) float32 (x0, y0, x1, y1)
    moments: torch.Tensor  # (2, 31, 31) float32: the kmx and kmy masks' nonzero window


def descriptor_tables(pattern: np.ndarray, kmx: np.ndarray, kmy: np.ndarray, device) -> DescriptorTables:
    """The (256, 2, 2) BRIEF pattern and the (48, 48) moment masks as
    DescriptorTables on `device`."""
    pat4 = np.concatenate([pattern[:, 0, :], pattern[:, 1, :]], axis=1).astype(np.float32)
    win = slice(MOMENT_LO, MOMENT_LO + MOMENT_N)
    for k in (kmx, kmy):
        outside = k.copy()
        outside[win, win] = 0
        if outside.any():
            raise ValueError("descriptor_tables: a moment mask is nonzero outside patch rows and cols 9..39")
    moments = np.ascontiguousarray(np.stack([kmx[win, win], kmy[win, win]]), np.float32)
    return DescriptorTables(torch.from_numpy(pat4).to(device), torch.from_numpy(moments).to(device))


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2 from multiplies, adds, divides and compares only (and
    the sign bits), one order on every device (csrc/describe.cu `atan2_f32`).
    The ratio min(|x|, |y|) / max(|x|, |y|) in [0, 1] is reduced past
    tan(pi/8) by (t - 1) / (t + 1) + pi/4, then Cephes atanf's polynomial;
    then reflected into the octant and quadrant of (x, y). Signed zeros as
    IEEE atan2; atan2(+0, +0) = +0. Within 3 float32 ulps of float64 atan2
    (tests/test_torch_describe.py)."""
    one = torch.ones_like(x)
    ax, ay = x.abs(), y.abs()
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    t = torch.where(mx > 0, mn / torch.where(mx > 0, mx, one), 0.0)
    big = t > _TAN_PI_8
    u = torch.where(big, (t - one) / (t + one), t)
    z = u * u
    c0, c1, c2, c3 = _ATAN_P
    p = (((z * c0 + c1) * z + c2) * z + c3) * z
    a = p * u + u
    a = torch.where(big, a + _PI_4, a)
    a = torch.where(ay > ax, _PI_2 - a, a)
    a = torch.where(torch.signbit(x), _PI - a, a)
    return torch.where(torch.signbit(y), -a, a)


def _halving_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of the 32 entries of x along `dim` as the halving tree x[:16] +
    x[16:], then [:8] + [8:], ... down to one (the butterfly a warp's
    shuffles reduce in: lane i adds lane i ^ 16, then i ^ 8, ...)."""
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def moments(patch: torch.Tensor, tables: DescriptorTables) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 48, 48) float32 patches -> (m10, m01), each (N,) float32, in one
    stated order over the 31 x 31 window, zero-padded to 32 x 32: each term
    p[r, c] k[r, c] rounded; per column c the halving tree over the rows
    (`_halving_sum`); then the halving tree over the columns. A pairwise
    order: its error grows with log2 of the 961 terms, where a sequential
    sum's grows with their count (the moments cancel: the masks are odd)."""
    win = patch[:, MOMENT_LO:MOMENT_LO + MOMENT_N, MOMENT_LO:MOMENT_LO + MOMENT_N]
    terms = win[:, None] * tables.moments[None]                      # (N, 2, 31, 31)
    terms = torch.nn.functional.pad(terms, (0, 1, 0, 1))               # (N, 2, 32, 32)
    m = _halving_sum(_halving_sum(terms, 2), 2)
    return m[:, 0], m[:, 1]


def _bits_and_angle(patch: torch.Tensor, tables: DescriptorTables):
    """(N, 48, 48) bf16-valued float32 patches -> (bits (N, 256) bool,
    angle (N,) f32)."""
    n = patch.shape[0]
    patch_f = patch.float()
    m10, m01 = moments(patch_f, tables)
    ang = atan2_f32(m01, m10)
    r = torch.sqrt(m10 * m10 + m01 * m01)
    safe = r > 0.0
    rs = torch.where(safe, r, 1.0)
    ca = torch.where(safe, m10 / rs, 1.0)[:, None]
    sa = torch.where(safe, m01 / rs, 0.0)[:, None]
    flat = patch_f.reshape(n, PATCH * PATCH)
    pat4 = tables.pattern

    def endpoint(px_, py_):
        # rotate the pattern by the keypoint angle and round to patch offsets
        rx = torch.round(px_[None, :] * ca - py_[None, :] * sa).long() + HALF
        ry = torch.round(px_[None, :] * sa + py_[None, :] * ca).long() + HALF
        inside = (rx >= 0) & (rx < PATCH) & (ry >= 0) & (ry < PATCH)
        idx = ry.clamp(0, PATCH - 1) * PATCH + rx.clamp(0, PATCH - 1)
        return torch.where(inside, torch.gather(flat, 1, idx), 0.0)

    v0 = endpoint(pat4[:, 0], pat4[:, 1])
    v1 = endpoint(pat4[:, 2], pat4[:, 3])
    return v0 < v1, ang


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words holding the uint32 bit patterns
    (bit b of word w = bits[:, 32 w + b]). Summed in int64 and wrapped to the
    int32 range explicitly, so bit 31 never overflows."""
    powers = torch.tensor(1, dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, 8, 32).long() * powers).sum(-1)
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Source index of position i (any integer) of a reflect-padded axis of
    n samples (numpy/jnp mode="reflect": the edge sample is not repeated)."""
    period = 2 * (n - 1)
    r = torch.remainder(i, period)
    return torch.where(r >= n, period - r, r)


def gather_patches(blurred: torch.Tensor, table, px: torch.Tensor, py: torch.Tensor,
                   slot_level: torch.Tensor) -> torch.Tensor:
    """The (48, 48) patch of every slot, rows py - 24 .. py + 23 and columns
    px - 24 .. px + 23 of its level of the flat blurred buffer laid out by
    `table` (ops/frontend_kernel.LevelTable), reflected at the level's edges
    and rounded to bf16 -> (N, 48, 48) float32."""
    dev = blurred.device
    offs = torch.tensor(table.offsets, dtype=torch.int64, device=dev)[slot_level]
    hs = torch.tensor([h for h, _ in table.shapes], dtype=torch.int64, device=dev)[slot_level]
    ws = torch.tensor([w for _, w in table.shapes], dtype=torch.int64, device=dev)[slot_level]
    ar = torch.arange(-HALF, HALF, device=dev)
    rows = reflect(py.long()[:, None] + ar, hs[:, None])
    cols = reflect(px.long()[:, None] + ar, ws[:, None])
    index = offs[:, None, None] + rows[:, :, None] * ws[:, None, None] + cols[:, None, :]
    return blurred[index].to(torch.bfloat16).float()


def describe_plain(blurred: torch.Tensor, table, pxy: torch.Tensor, budgets, scales, tables: DescriptorTables):
    """Plain twin of the describe kernel: the flat blurred buffer, the
    selected (px, py) (2, capacity) int32 level coordinates of every slot
    (each level's slots in turn, budgets[l] of them) -> (uv (capacity, 2)
    float32 level-0 coordinates (px, py) * scale, angle (capacity,) float32,
    level (capacity,) int32, desc (capacity, 8) int32)."""
    dev = blurred.device
    slot_level = torch.repeat_interleave(torch.arange(len(budgets), device=dev),
                                         torch.tensor(budgets, device=dev))
    px, py = pxy[0], pxy[1]
    bits, ang = _bits_and_angle(gather_patches(blurred, table, px, py, slot_level), tables)
    scale = torch.tensor(np.asarray(scales, np.float32), device=dev)[slot_level]
    uv = torch.stack([px.float(), py.float()], dim=-1) * scale[:, None]
    return uv, ang, slot_level.to(torch.int32), pack_bits(bits)
