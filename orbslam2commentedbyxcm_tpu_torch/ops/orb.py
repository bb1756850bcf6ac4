"""ORB feature extraction on torch tensors.

Counterpart of orbslam2commentedbyxcm_tpu/ops/orb.py: the same pyramid, the
same dense dual-threshold FAST-9 maps with 3x3 NMS, the same per-cell top-k
with the 20 -> 7 threshold fallback and the global (rank, -score) selection,
and the same Gaussian-moment orientation and rotated BRIEF descriptors
(ops/descriptors). Descriptors are 256 bits, packed as (N, 8) int32 words
holding the JAX package's uint32 bit patterns.

The exposure gain and the level images are computed by one hand-written CUDA
kernel for CUDA tensors (ops/pyramid_kernel, csrc/pyramid.cu) into one flat
buffer, and blur + FAST + NMS over all of them is one launch of another
(ops/frontend_kernel, csrc/frontend.cu). `_pyramid_plain` (with
`_exposure_gain` and `_tree_sum`) and `_separable_blur`, `_fast_maps` and
`_nms3` below are their plain twins, bit for bit, and run for CPU tensors;
so the CPU computes the very level images the card does. The frontend twin
has the XLA path's border semantics. The pyramid twin sums each resize's
nonzero taps in ascending order with fused multiply-adds and the gain's
mean and MAD as adjacent-pair trees: orders of its own, which the JAX
package's XLA dot and mean do not share, so levels >= 1 and the gain differ
from JAX's by f32 ulps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import (
    descriptors_from_windows,
    gather_windows,
)

# Circle-16 Bresenham ring (dx, dy), circular order (matches OpenCV FAST).
_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

PATCH_RADIUS = 15       # orientation patch radius (HALF_PATCH_SIZE in reference)
EDGE_PAD = 24           # reflected padding so rotated pattern gathers stay in-bounds
ARC_LEN = 9             # FAST-9: contiguous arc length


def make_brief_pattern(n_pairs: int = 256, patch_radius: int = PATCH_RADIUS, seed: int = 1234) -> np.ndarray:
    """Deterministic BRIEF G-I sampling pattern: (n_pairs, 2, 2) int32
    (both endpoints ~ N(0, (S/5)^2), clipped to the patch)."""
    rng = np.random.default_rng(seed)
    s = 2 * patch_radius + 1
    pat = rng.normal(0.0, s / 5.0, size=(n_pairs, 2, 2))
    pat = np.clip(np.round(pat), -patch_radius, patch_radius).astype(np.int32)
    # Avoid degenerate identical pairs.
    same = np.all(pat[:, 0] == pat[:, 1], axis=-1)
    pat[same, 1, 0] = np.clip(pat[same, 1, 0] + 3, -patch_radius, patch_radius)
    return pat


class FrameFeatures(NamedTuple):
    """Fixed-capacity ORB features for one image. Invalid slots are masked."""

    uv: torch.Tensor        # (N, 2) float32 — level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,)  float32 — FAST corner score
    angle: torch.Tensor     # (N,)  float32 — orientation, radians
    level: torch.Tensor     # (N,)  int32   — pyramid octave
    desc: torch.Tensor      # (N, 8) int32  — packed 256-bit descriptor
    valid: torch.Tensor     # (N,)  bool

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()


def _edge_index(n: int, r: int, device) -> torch.Tensor:
    return torch.arange(-r, n + r, device=device).clamp(0, n - 1)


def _separable_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable blur of a (H, W) image, replicate-padded. Each tap is a
    separately rounded multiply and add, in tap order (the kernel in
    csrc/frontend.cu does the same arithmetic)."""
    r = len(kernel) // 2
    h, w = img.shape
    x = img[:, _edge_index(w, r, img.device)]
    acc = torch.zeros_like(img)
    for k in range(len(kernel)):
        acc = acc + float(kernel[k]) * x[:, k : k + w]
    x = acc[_edge_index(h, r, img.device), :]
    acc = torch.zeros_like(img)
    for k in range(len(kernel)):
        acc = acc + float(kernel[k]) * x[k : k + h, :]
    return acc


def _gauss_kernel(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    xs = np.arange(size) - size // 2
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-resize weight matrix (triangle kernel widened by
    the downscale factor, column-normalized), as jax.image.resize(linear,
    antialias=True) builds it. The extractor uses it through `_resize_taps`;
    the JAX package multiplies by the whole matrix."""
    scale = n_out / n_in
    sample_f = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) * min(scale, 1.0)
    wgt = np.maximum(0.0, 1.0 - x)
    tot = wgt.sum(axis=0, keepdims=True)
    wgt = np.where(tot > 0, wgt / tot, 0.0)
    return np.ascontiguousarray(wgt.T.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _resize_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero run of each row of `_resize_weights(n_in, n_out)` ->
    (start int32[n_out], w float32[n_out, T]): output i is the sum over k of
    w[i, k] * x[start[i] + k], T the widest run. The weights are the
    matrix's float32 values in ascending input index, zero-padded to T; a
    row whose run ends near n_in starts earlier, with leading zeros, so
    every tap reads inside the input. Zero taps change no sum that starts
    from +0.0, so the dense matrix and the table give the same products."""
    wgt = _resize_weights(n_in, n_out)
    nz = wgt != 0
    first = nz.argmax(1)
    last = n_in - 1 - nz[:, ::-1].argmax(1)
    taps = int((last - first + 1).max())
    start = np.minimum(first, n_in - taps).astype(np.int32)
    w = np.take_along_axis(wgt, start[:, None] + np.arange(taps), 1)
    return start, np.ascontiguousarray(w)


_F32_MID, _F32_LOW = 1 << 28, (1 << 29) - 1  # bit 28 and bits 0-28 of a float64 mantissa
_F32_TINY = 2.0**-126  # least normal float32


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c), correctly rounded: a and b float64 tensors that hold
    float32 values, c float32 -> float32 (the CUDA kernel's __fmaf_rn).

    a * b is exact in float64. p + c rounded to float64 and then to float32
    is the correctly rounded sum except where the float64 sum lands exactly
    on a float32 rounding midpoint (bit 28 set, bits 0-27 clear) or in the
    float32 subnormal range: there the sum is redone with round-to-odd (the
    exact TwoSum error moves an even result one float64 step toward it),
    which then rounds to float32 correctly (Boldo and Melquiond)."""
    p = a * b
    c = c.double()
    s = p + c
    bits = s.view(torch.int64)
    maybe = ((bits & _F32_LOW) == _F32_MID) | ((s.abs() < _F32_TINY) & (s != 0))
    if bool(maybe.any()):
        a1 = s - c
        err = (p - a1) + (c - (s - a1))
        odd = torch.nextafter(s, err * torch.inf)
        s = torch.where(maybe & (err != 0) & ((bits & 1) == 0), odd, s)
    return s.float()


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of x as the adjacent-pair halving tree over its flat
    values, zero-padded to a power of two: the order csrc/pyramid.cu sums in."""
    x = x.reshape(-1)
    x = F.pad(x, (0, (1 << (x.numel() - 1).bit_length()) - x.numel()))
    while x.numel() > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _exposure_gain(img: torch.Tensor, target_mad: float) -> torch.Tensor:
    """img rescaled about its mean to a mean absolute deviation of
    `target_mad`, the gain capped to [1/8, 8]: every step a separately
    rounded float32 operation, the sums `_tree_sum`s."""
    n = img.new_tensor(img.numel())
    mu = _tree_sum(img) / n
    mad = _tree_sum((img - mu).abs()) / n
    gain = torch.clamp(img.new_tensor(target_mad) / torch.clamp(mad, min=1e-3), 0.125, 8.0)
    return (img - mu) * gain + mu


@functools.lru_cache(maxsize=64)
def _taps_on(n_in: int, n_out: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """`_resize_taps` as (gather index int64 (n_out, T), weights float64 (n_out, T)) on `device`."""
    start, w = _resize_taps(n_in, n_out)
    index = torch.from_numpy(start.astype(np.int64)[:, None] + np.arange(w.shape[1]))
    return index.to(device), torch.from_numpy(w).double().to(device)


def _resize_pass(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_in, m) float32 -> (m, n_out) float32: row i of the result is the
    resize of column i of x over its first axis, each output the
    ascending-tap fma chain of its nonzero taps from +0.0."""
    index, w = _taps_on(x.shape[0], n_out, str(x.device))
    x = x.to(torch.float64, memory_format=torch.contiguous_format)
    rows = x.index_select(0, index.reshape(-1)).view(n_out, -1, x.shape[1])
    acc = torch.zeros((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(w.shape[1]):
        acc = _fma_f32(w[:, k, None], rows[:, k], acc)
    return acc.T


def _pyramid_plain(img: torch.Tensor, table, exposure_target: float | None = None) -> torch.Tensor:
    """Plain twin of csrc/pyramid.cu: (H, W) float32 image -> the flat
    float32 buffer laid out by `table` (ops/frontend_kernel.LevelTable).
    Level 0 is the image, rescaled by `_exposure_gain` when
    `exposure_target` is given; level l > 0 resizes level 0 to its shape,
    the vertical pass over the image's rows, then the horizontal pass over
    that result's columns, each `_resize_pass`. Every level resizes from
    level 0, as the JAX package does."""
    if exposure_target is not None:
        img = _exposure_gain(img, exposure_target)
    buf = torch.empty(table.total, dtype=torch.float32, device=img.device)
    for lvl, (off, (hl, wl)) in enumerate(zip(table.offsets, table.shapes)):
        view = buf[off : off + hl * wl].view(hl, wl)
        view.copy_(img if lvl == 0 else _resize_pass(_resize_pass(img, hl), wl))
    return buf


def fast_response(ups):
    """FAST-9 response V from the 16 ring-difference planes: the largest
    threshold at which the pixel is still a corner,
      V = max(max_k min_{j in 9-window k} up_j,  max_k min_j (-up_j)).
    min/max are exact, so V is bit-identical however it is evaluated."""
    assert len(ups) == 16 and ARC_LEN == 9  # the doubling below is 9-specific
    n = len(ups)

    def window_min9(vals):
        m2 = [torch.minimum(vals[k], vals[(k + 1) % n]) for k in range(n)]
        m4 = [torch.minimum(m2[k], m2[(k + 2) % n]) for k in range(n)]
        m8 = [torch.minimum(m4[k], m4[(k + 4) % n]) for k in range(n)]
        m9 = [torch.minimum(m8[k], vals[(k + 8) % n]) for k in range(n)]
        out = m9[0]
        for k in range(1, n):
            out = torch.maximum(out, m9[k])
        return out

    return torch.maximum(window_min9(ups), window_min9([-u for u in ups]))


def _fast_maps(img: torch.Tensor, th_hi: float, th_lo: float):
    """Dense FAST-9 score maps at two thresholds -> (score_hi, score_lo,
    corner_hi), each (H, W); zero outside [3, H-3) x [3, W-3) and where the
    pixel is not a corner at that threshold."""
    h, w = img.shape
    hi, wi = h - 6, w - 6
    center = img[3 : 3 + hi, 3 : 3 + wi]
    ups = [
        img[3 + dy : 3 + dy + hi, 3 + dx : 3 + dx + wi] - center
        for dx, dy in _RING.tolist()
    ]
    v = fast_response(ups)
    s_hi = torch.where(v > th_hi, v, 0.0)
    s_lo = torch.where(v > th_lo, v, 0.0)
    pad = (3, 3, 3, 3)
    return F.pad(s_hi, pad), F.pad(s_lo, pad), F.pad(s_hi > 0.0, pad)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """Keep s where s >= its 3x3 max (-inf outside the image) and s > 0."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score, 0.0)


def _gauss_moment_taps(radius: int = PATCH_RADIUS, sigma: float = 7.0):
    """1D taps (g, x g) for Gaussian-weighted orientation moments."""
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (xs / sigma) ** 2)
    g = g / g.sum()
    return g.astype(np.float32), (xs * g).astype(np.float32)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each position of a `pad`-wide reflect padding
    (numpy/jnp mode="reflect": the edge sample is not repeated)."""
    i = torch.remainder(torch.arange(-pad, n + pad, device=device), 2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


class ORBExtractor:
    """Batched ORB extractor producing fixed-capacity FrameFeatures.

    Same constructor as the JAX ORBExtractor, without `use_pallas`: the
    gain and the pyramid run through ops/pyramid_kernel, then blur + FAST +
    NMS over the whole pyramid through ops/frontend_kernel, hand-written
    CUDA kernels for CUDA tensors and their twins for CPU tensors.
    """

    def __init__(
        self,
        n_features: int = 1000,
        scale_factor: float = 1.2,
        n_levels: int = 8,
        ini_th_fast: float = 20.0,
        min_th_fast: float = 7.0,
        cell_size: int = 32,
        per_cell_k: int = 4,
        normalize_exposure: bool = False,
        exposure_target_mad: float = 18.0,
    ):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = float(ini_th_fast)
        self.min_th = float(min_th_fast)
        self.cell_size = cell_size
        self.per_cell_k = per_cell_k
        # Exposure-gain normalization (off by default; the live tracker turns
        # it on): rescale the image to a fixed mean absolute deviation so the
        # fixed 20/7 FAST thresholds see a constant contrast.
        self.normalize_exposure = bool(normalize_exposure)
        self.exposure_target_mad = float(exposure_target_mad)

        self.scales = [scale_factor**l for l in range(n_levels)]
        # Geometric per-level budgets (reference src/ORBextractor.cc:485-500).
        inv = 1.0 / scale_factor
        n0 = n_features * (1 - inv) / (1 - inv**n_levels)
        budgets = [int(round(n0 * inv**l)) for l in range(n_levels)]
        budgets[-1] = max(0, n_features - sum(budgets[:-1]))
        self.budgets = budgets
        self.capacity = sum(budgets)

        self._pattern = make_brief_pattern()
        # Gaussian orientation-moment masks over the 48x48 descriptor patch
        # (offsets -24..23; the +-15 moment window sits at indices 9..39).
        g, xg = _gauss_moment_taps()
        lo, hi = EDGE_PAD - PATCH_RADIUS, EDGE_PAD + PATCH_RADIUS + 1
        kmx = np.zeros((2 * EDGE_PAD, 2 * EDGE_PAD), np.float32)
        kmy = np.zeros((2 * EDGE_PAD, 2 * EDGE_PAD), np.float32)
        kmx[lo:hi, lo:hi] = np.outer(g, xg)   # m10: g(y) rows, x*g(x) cols
        kmy[lo:hi, lo:hi] = np.outer(xg, g)   # m01: y*g(y) rows, g(x) cols
        self._kmx, self._kmy = kmx, kmy

    def __call__(self, image) -> FrameFeatures:
        """image: (H, W) uint8/float32 numpy array or tensor -> FrameFeatures
        on the image's device (numpy input runs on the CPU)."""
        img = torch.as_tensor(image)
        if img.dim() != 2:
            raise ValueError(f"expected an (H, W) image, got shape {tuple(img.shape)}")
        return self._extract(img.float())

    # -- pipeline ----------------------------------------------------------

    def _pyramid(self, img: torch.Tensor):
        """The exposure gain (when on) and all level images in one flat
        float32 buffer -> (buffer, LevelTable): ops/pyramid_kernel, one
        kernel launch on the card with the gain on or off, the twin
        `_pyramid_plain` on the CPU, the same bits on both. The gain is
        capped to [1/8, 8] so a near-flat frame stays feature-poor."""
        from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import level_table
        from orbslam2commentedbyxcm_tpu_torch.ops.pyramid_kernel import pyramid_resize

        h, w = img.shape
        table = level_table(tuple(
            (max(16, int(round(h / s))), max(16, int(round(w / s)))) for s in self.scales
        ))
        target = self.exposure_target_mad if self.normalize_exposure else None
        return pyramid_resize(img.contiguous(), table, target), table

    def _extract(self, img: torch.Tensor) -> FrameFeatures:
        # imported here: frontend_kernel imports this module for the twin
        from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend_pyramid, level_views

        buf, table = self._pyramid(img)
        maps = fused_frontend_pyramid(buf, table, self.ini_th, self.min_th)
        outs = [
            self._select_level(*level_maps, lvl)
            for lvl, level_maps in enumerate(zip(*(level_views(m, table) for m in maps)))
        ]
        uv, resp, level, patches, valid = (torch.cat([o[i] for o in outs]) for i in range(5))
        desc, ang = descriptors_from_windows(patches, self._pattern, self._kmx, self._kmy)
        return FrameFeatures(uv, resp, ang, level, desc, valid)

    def _select_level(self, blurred, nms_hi, nms_lo, lvl: int):
        """A level's frontend maps -> (uv0, response, level, patches, valid)."""
        budget = self.budgets[lvl]
        dev = blurred.device
        hl, wl = blurred.shape
        if budget == 0:
            return (
                torch.zeros((0, 2), device=dev), torch.zeros(0, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((0, 48, 48), dtype=torch.bfloat16, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
            )

        # Border exclusion: descriptors/orientation need EDGE margin.
        margin = PATCH_RADIUS + 1
        ys = torch.arange(hl, device=dev)[:, None]
        xs = torch.arange(wl, device=dev)[None, :]
        inbounds = (ys >= margin) & (ys < hl - margin) & (xs >= margin) & (xs < wl - margin)
        nms_hi = torch.where(inbounds, nms_hi, 0.0)
        nms_lo = torch.where(inbounds, nms_lo, 0.0)

        # Spatial-uniformity selection replacing DistributeOctTree: up to
        # per_cell_k per cell, then low within-cell rank first globally.
        cs = self.cell_size
        cy, cx = -(-hl // cs), -(-wl // cs)
        ph, pw = cy * cs, cx * cs
        k = self.per_cell_k
        in_cell = torch.arange(cs * cs, device=dev)

        def cell_topk(m):
            m = F.pad(m, (0, pw - wl, 0, ph - hl))
            cur = m.reshape(cy, cs, cx, cs).permute(0, 2, 1, 3).reshape(cy, cx, cs * cs)
            tv, ti = [], []
            for _ in range(k):
                s = cur.max(dim=-1).values                        # (cy, cx)
                sb = s[..., None]
                # first-index tie-break, as the JAX masked-min formulation
                i = torch.where((cur >= sb) & (sb > 0), in_cell, cs * cs).min(dim=-1).values
                i = torch.where(s > 0, i, 0)
                tv.append(s)
                ti.append(i)
                cur = torch.where(in_cell == i[..., None], -torch.inf, cur)
            return torch.stack(tv, -1), torch.stack(ti, -1)    # (cy, cx, k)

        # Per-cell threshold fallback (reference: retry the cell with minTh
        # when the strict threshold finds nothing, src/ORBextractor.cc:1084).
        tv_hi, ti_hi = cell_topk(nms_hi)
        tv_lo, ti_lo = cell_topk(nms_lo)
        has_hi = tv_hi[:, :, :1] > 0
        top_vals = torch.where(has_hi, tv_hi, tv_lo)
        top_idx = torch.where(has_hi, ti_hi, ti_lo)
        rank = torch.arange(k, dtype=torch.float32, device=dev)
        key = torch.where(top_vals > 0, rank * 1e6 - top_vals, torch.inf)
        flat_key = key.reshape(-1)
        # smallest keys, ties to the lower index (lax.top_k's order): a
        # stable sort, since torch.topk promises no tie order
        n_take = min(budget, flat_key.shape[0])
        sel = torch.sort(flat_key, stable=True).indices[:n_take]
        if n_take < budget:
            sel = F.pad(sel, (0, budget - n_take))
        valid = torch.isfinite(flat_key[sel])
        if n_take < budget:
            valid = valid & (torch.arange(budget, device=dev) < n_take)

        # Decode (y, x) level coordinates of selections.
        cell_flat = sel // k
        cell_y, cell_x = cell_flat // cx, cell_flat % cx
        inner = top_idx.reshape(-1)[sel]
        py = cell_y * cs + inner // cs
        px = cell_x * cs + inner % cs
        response = top_vals.reshape(-1)[sel]

        # Orientation + descriptor patches from the reflect-padded,
        # bf16-rounded blurred level.
        padded = blurred[_reflect_index(hl, EDGE_PAD, dev)][:, _reflect_index(wl, EDGE_PAD, dev)]
        patches = gather_windows(padded.to(torch.bfloat16), px, py)

        scale = torch.tensor(self.scales[lvl], dtype=torch.float32, device=dev)
        uv0 = torch.stack([px.float(), py.float()], dim=-1) * scale
        return (
            uv0,
            response,
            torch.full((budget,), lvl, dtype=torch.int32, device=dev),
            patches,
            valid,
        )
