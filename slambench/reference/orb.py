"""Plain ORB extraction: the reference the benchmark holds the port's
extraction to.

A frozen copy of the plain twins of the port's four extraction kernels
(pyramid and exposure gain, blur + FAST-9 + NMS, per-cell selection,
orientation + rotated BRIEF), in plain torch on the CPU. It imports nothing
of the port, so a later change to the port cannot move the yardstick. Every
step is a separately rounded float32 operation in a stated order (the
resize taps as correctly rounded fused multiply-adds, the sums as halving
trees), so this extraction gives the bits the card's kernels give.

`extract(image, precision="bf16")` is the control: the pyramid, the blur
and the orientation moments computed in bfloat16, the precision below the
float32 the port computes in.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)
PATCH_RADIUS = 15
EDGE_PAD = 24
MARGIN = PATCH_RADIUS + 1
ALIGN = 32  # floats: each level of the flat buffers starts on a 128-byte line
PATCH = 48
HALF = PATCH // 2
MOMENT_LO, MOMENT_N = 9, 31
_ATAN_P = tuple(float(np.float32(c)) for c in (8.05374449538e-2, -1.38776856032e-1, 1.99777106478e-1,
                                               -3.33329491539e-1))
_TAN_PI_8 = float(np.float32(0.4142135623730950))
_PI_4, _PI_2, _PI = (float(np.float32(c)) for c in (np.pi / 4, np.pi / 2, np.pi))
_F32_MID, _F32_LOW = 1 << 28, (1 << 29) - 1
_F32_TINY = 2.0**-126


class Features(NamedTuple):
    uv: torch.Tensor        # (N, 2) float32 level-0 pixel coordinates
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor     # (N,) float32 radians
    level: torch.Tensor     # (N,) int32
    desc: torch.Tensor      # (N, 8) int32, the uint32 bit patterns
    valid: torch.Tensor     # (N,) bool


class Table(NamedTuple):
    shapes: tuple   # (h, w) per level
    offsets: tuple  # element offset of each level in the flat buffers
    total: int


class Stages(NamedTuple):
    """What one extraction computed on the way, for the kernels' bounds."""

    table: Table
    levels: list          # level images, (h, w) float32 each
    maps: torch.Tensor    # (3, total): blurred, nms_hi, nms_lo
    pxy: torch.Tensor     # (2, capacity) int32 selected level coordinates


def level_table(shapes) -> Table:
    offsets, off = [], 0
    for h, w in shapes:
        offsets.append(off)
        off += -(-h * w // ALIGN) * ALIGN
    return Table(tuple(shapes), tuple(offsets), off)


def level_views(buf: torch.Tensor, table: Table):
    return [buf[o: o + h * w].view(h, w) for o, (h, w) in zip(table.offsets, table.shapes)]


def brief_pattern(n_pairs: int = 256, patch_radius: int = PATCH_RADIUS, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = 2 * patch_radius + 1
    pat = rng.normal(0.0, s / 5.0, size=(n_pairs, 2, 2))
    pat = np.clip(np.round(pat), -patch_radius, patch_radius).astype(np.int32)
    same = np.all(pat[:, 0] == pat[:, 1], axis=-1)
    pat[same, 1, 0] = np.clip(pat[same, 1, 0] + 3, -patch_radius, patch_radius)
    return pat


def gauss_kernel(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size) - size // 2
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


BLUR_TAPS = gauss_kernel(9, 3.0)


def _edge_index(n: int, r: int) -> torch.Tensor:
    return torch.arange(-r, n + r).clamp(0, n - 1)


def separable_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Replicate-padded separable blur, each tap a rounded multiply and add
    in tap order (in the image's dtype)."""
    r = len(kernel) // 2
    h, w = img.shape
    x = img[:, _edge_index(w, r)]
    acc = torch.zeros_like(img)
    for k in range(len(kernel)):
        acc = acc + float(kernel[k]) * x[:, k: k + w]
    x = acc[_edge_index(h, r), :]
    acc = torch.zeros_like(img)
    for k in range(len(kernel)):
        acc = acc + float(kernel[k]) * x[k: k + h, :]
    return acc


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased linear-resize weights (triangle kernel
    widened by the downscale factor, normalized)."""
    scale = n_out / n_in
    sample_f = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) * min(scale, 1.0)
    wgt = np.maximum(0.0, 1.0 - x)
    tot = wgt.sum(axis=0, keepdims=True)
    wgt = np.where(tot > 0, wgt / tot, 0.0)
    return np.ascontiguousarray(wgt.T.astype(np.float32))


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int):
    """Each output's nonzero run of weights -> (start (n_out,), w (n_out, T))."""
    wgt = resize_weights(n_in, n_out)
    nz = wgt != 0
    first = nz.argmax(1)
    last = n_in - 1 - nz[:, ::-1].argmax(1)
    taps = int((last - first + 1).max())
    start = np.minimum(first, n_in - taps).astype(np.int32)
    w = np.take_along_axis(wgt, start[:, None] + np.arange(taps), 1)
    return start, np.ascontiguousarray(w)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fmaf(a, b, c) for float64 tensors holding float32
    values and a float32 c: the float64 sum, redone with round-to-odd where
    it lands on a float32 rounding midpoint or in the subnormal range."""
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


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum as the adjacent-pair halving tree, zero-padded to a power of two."""
    x = x.reshape(-1)
    x = F.pad(x, (0, (1 << (x.numel() - 1).bit_length()) - x.numel()))
    while x.numel() > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def exposure_gain(img: torch.Tensor, target_mad: float) -> torch.Tensor:
    n = img.new_tensor(img.numel())
    mu = tree_sum(img) / n
    mad = tree_sum((img - mu).abs()) / n
    gain = torch.clamp(img.new_tensor(target_mad) / torch.clamp(mad, min=1e-3), 0.125, 8.0)
    return (img - mu) * gain + mu


def resize_pass(x: torch.Tensor, n_out: int, precision: str) -> torch.Tensor:
    """(n_in, m) -> (m, n_out): each output the ascending-tap chain of its
    nonzero taps from +0.0, as fused multiply-adds (float32) or as bfloat16
    products and sums (the control)."""
    start, w = resize_taps(x.shape[0], n_out)
    index = torch.from_numpy(start.astype(np.int64)[:, None] + np.arange(w.shape[1]))
    if precision == "bf16":
        wb = torch.from_numpy(w).bfloat16()
        rows = x.bfloat16().index_select(0, index.reshape(-1)).view(n_out, -1, x.shape[1])
        acc = torch.zeros((n_out, x.shape[1]), dtype=torch.bfloat16)
        for k in range(w.shape[1]):
            acc = acc + wb[:, k, None] * rows[:, k]
        return acc.float().T
    wd = torch.from_numpy(w).double()
    xd = x.to(torch.float64, memory_format=torch.contiguous_format)
    rows = xd.index_select(0, index.reshape(-1)).view(n_out, -1, x.shape[1])
    acc = torch.zeros((n_out, x.shape[1]), dtype=torch.float32)
    for k in range(w.shape[1]):
        acc = fma_f32(wd[:, k, None], rows[:, k], acc)
    return acc.T


def pyramid(img: torch.Tensor, shapes, exposure_target: float | None, precision: str):
    """Level images: level 0 the (gain-normalized) image, each other level
    resized from level 0, rows first, then columns."""
    if exposure_target is not None:
        img = exposure_gain(img.bfloat16() if precision == "bf16" else img, exposure_target).float()
    out = [img]
    for hl, wl in shapes[1:]:
        out.append(resize_pass(resize_pass(img, hl, precision), wl, precision).contiguous())
    return out


def fast_response(ups):
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


def fast_maps(img: torch.Tensor, th_hi: float, th_lo: float):
    h, w = img.shape
    hi, wi = h - 6, w - 6
    center = img[3: 3 + hi, 3: 3 + wi]
    ups = [img[3 + dy: 3 + dy + hi, 3 + dx: 3 + dx + wi] - center for dx, dy in RING.tolist()]
    v = fast_response(ups)
    pad = (3, 3, 3, 3)
    return F.pad(torch.where(v > th_hi, v, 0.0), pad), F.pad(torch.where(v > th_lo, v, 0.0), pad)


def nms3(score: torch.Tensor) -> torch.Tensor:
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score, 0.0)


def select_level(nms_hi, nms_lo, budget: int, cell_size: int, per_cell_k: int):
    """Up to per_cell_k per cell (the 20 map, else the 7 one), then low
    within-cell rank first, ties by index (a stable sort)."""
    hl, wl = nms_hi.shape
    ys = torch.arange(hl)[:, None]
    xs = torch.arange(wl)[None, :]
    inb = (ys >= MARGIN) & (ys < hl - MARGIN) & (xs >= MARGIN) & (xs < wl - MARGIN)
    nms_hi = torch.where(inb, nms_hi, 0.0)
    nms_lo = torch.where(inb, nms_lo, 0.0)
    cs, k = cell_size, per_cell_k
    cy, cx = -(-hl // cs), -(-wl // cs)
    in_cell = torch.arange(cs * cs)

    def cell_topk(m):
        m = F.pad(m, (0, cx * cs - wl, 0, cy * cs - hl))
        cur = m.reshape(cy, cs, cx, cs).permute(0, 2, 1, 3).reshape(cy, cx, cs * cs)
        tv, ti = [], []
        for _ in range(k):
            s = cur.max(dim=-1).values
            sb = s[..., None]
            i = torch.where((cur >= sb) & (sb > 0), in_cell, cs * cs).min(dim=-1).values
            i = torch.where(s > 0, i, 0)
            tv.append(s)
            ti.append(i)
            cur = torch.where(in_cell == i[..., None], -torch.inf, cur)
        return torch.stack(tv, -1), torch.stack(ti, -1)

    tv_hi, ti_hi = cell_topk(nms_hi)
    tv_lo, ti_lo = cell_topk(nms_lo)
    has_hi = tv_hi[:, :, :1] > 0
    top_vals = torch.where(has_hi, tv_hi, tv_lo)
    top_idx = torch.where(has_hi, ti_hi, ti_lo)
    rank = torch.arange(k, dtype=torch.float32)
    key = torch.where(top_vals > 0, rank * 1e6 - top_vals, torch.inf).reshape(-1)
    n_take = min(budget, key.shape[0])
    sel = torch.sort(key, stable=True).indices[:n_take]
    if n_take < budget:
        sel = F.pad(sel, (0, budget - n_take))
    valid = torch.isfinite(key[sel])
    if n_take < budget:
        valid = valid & (torch.arange(budget) < n_take)
    cell = sel // k
    inner = top_idx.reshape(-1)[sel]
    py = (cell // cx) * cs + inner // cs
    px = (cell % cx) * cs + inner % cs
    return px, py, top_vals.reshape(-1)[sel], valid


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
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
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def _reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    period = 2 * (n - 1)
    r = torch.remainder(i, period)
    return torch.where(r >= n, period - r, r)


def _moment_masks() -> torch.Tensor:
    xs = np.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, dtype=np.float64)
    g = np.exp(-0.5 * (xs / 7.0) ** 2)
    g = g / g.sum()
    g32, xg32 = g.astype(np.float32), (xs * g).astype(np.float32)
    return torch.from_numpy(np.stack([np.outer(g32, xg32), np.outer(xg32, g32)]).astype(np.float32))


_MOMENTS = _moment_masks()
_PATTERN = torch.from_numpy(np.concatenate([brief_pattern()[:, 0, :], brief_pattern()[:, 1, :]], 1)
                            .astype(np.float32))


def describe(blurred: torch.Tensor, table: Table, pxy: torch.Tensor, budgets, scales, precision: str):
    """Orientation (Gaussian moments of the bf16-rounded 48 x 48 patch,
    halving-tree sums, float32 atan2) and rotated BRIEF of every slot."""
    slot_level = torch.repeat_interleave(torch.arange(len(budgets)), torch.tensor(budgets))
    px, py = pxy[0], pxy[1]
    offs = torch.tensor(table.offsets, dtype=torch.int64)[slot_level]
    hs = torch.tensor([h for h, _ in table.shapes], dtype=torch.int64)[slot_level]
    ws = torch.tensor([w for _, w in table.shapes], dtype=torch.int64)[slot_level]
    ar = torch.arange(-HALF, HALF)
    rows = _reflect(py.long()[:, None] + ar, hs[:, None])
    cols = _reflect(px.long()[:, None] + ar, ws[:, None])
    index = offs[:, None, None] + rows[:, :, None] * ws[:, None, None] + cols[:, None, :]
    patch = blurred[index].to(torch.bfloat16).float()
    n = patch.shape[0]
    win = patch[:, MOMENT_LO:MOMENT_LO + MOMENT_N, MOMENT_LO:MOMENT_LO + MOMENT_N]
    masks = _MOMENTS
    if precision == "bf16":
        win, masks = win.bfloat16(), masks.bfloat16()
    terms = F.pad(win[:, None] * masks[None], (0, 1, 0, 1))
    m = _halving_sum(_halving_sum(terms, 2), 2).float()
    m10, m01 = m[:, 0], m[:, 1]
    ang = atan2_f32(m01, m10)
    r = torch.sqrt(m10 * m10 + m01 * m01)
    safe = r > 0.0
    rs = torch.where(safe, r, 1.0)
    ca = torch.where(safe, m10 / rs, 1.0)[:, None]
    sa = torch.where(safe, m01 / rs, 0.0)[:, None]
    flat = patch.reshape(n, PATCH * PATCH)

    def endpoint(qx, qy):
        rx = torch.round(qx[None, :] * ca - qy[None, :] * sa).long() + HALF
        ry = torch.round(qx[None, :] * sa + qy[None, :] * ca).long() + HALF
        inside = (rx >= 0) & (rx < PATCH) & (ry >= 0) & (ry < PATCH)
        idx = ry.clamp(0, PATCH - 1) * PATCH + rx.clamp(0, PATCH - 1)
        return torch.where(inside, torch.gather(flat, 1, idx), 0.0)

    bits = endpoint(_PATTERN[:, 0], _PATTERN[:, 1]) < endpoint(_PATTERN[:, 2], _PATTERN[:, 3])
    powers = torch.tensor(1, dtype=torch.int64) << torch.arange(32, dtype=torch.int64)
    words = (bits.reshape(-1, 8, 32).long() * powers).sum(-1)
    desc = (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)
    scale = torch.tensor(np.asarray(scales, np.float32))[slot_level]
    uv = torch.stack([px.float(), py.float()], dim=-1) * scale[:, None]
    return uv, ang, slot_level.to(torch.int32), desc


class Extractor:
    """ORB extraction with the port's settings semantics: n_features split
    over the levels geometrically, cells of 32 x 32 with 4 keypoints each,
    FAST at iniThFAST with the minThFAST fallback, the exposure gain to a
    mean absolute deviation of `exposure_target_mad` (None: off)."""

    def __init__(self, n_features: int, scale_factor: float, n_levels: int, ini_th_fast: float,
                 min_th_fast: float, exposure_target_mad: float | None, cell_size: int = 32, per_cell_k: int = 4):
        self.scales = [scale_factor**lvl for lvl in range(n_levels)]
        inv = 1.0 / scale_factor
        n0 = n_features * (1 - inv) / (1 - inv**n_levels)
        budgets = [int(round(n0 * inv**lvl)) for lvl in range(n_levels)]
        budgets[-1] = max(0, n_features - sum(budgets[:-1]))
        self.budgets = budgets
        self.capacity = sum(budgets)
        self.th_hi, self.th_lo = float(ini_th_fast), float(min_th_fast)
        self.target = exposure_target_mad
        self.cell_size, self.per_cell_k = cell_size, per_cell_k

    def shapes(self, h: int, w: int):
        return tuple((max(16, int(round(h / s))), max(16, int(round(w / s)))) for s in self.scales)

    def extract(self, image, precision: str = "f32") -> tuple[Features, Stages]:
        """(H, W) image (any numeric dtype, values as the System reads them)
        -> the features and the stages they came from."""
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision {precision!r}: f32 or bf16")
        img = torch.as_tensor(np.asarray(image, np.float32))
        table = level_table(self.shapes(*img.shape))
        levels = pyramid(img, table.shapes, self.target, precision)
        maps = torch.zeros((3, table.total), dtype=torch.float32)
        for lvl, (o, (h, w)) in enumerate(zip(table.offsets, table.shapes)):
            lv = levels[lvl].bfloat16() if precision == "bf16" else levels[lvl]
            blurred = separable_blur(lv, BLUR_TAPS).float()
            s_hi, s_lo = fast_maps(levels[lvl], self.th_hi, self.th_lo)
            maps[0, o: o + h * w] = blurred.reshape(-1)
            maps[1, o: o + h * w] = nms3(s_hi).reshape(-1)
            maps[2, o: o + h * w] = nms3(s_lo).reshape(-1)
        pxy = torch.zeros((2, self.capacity), dtype=torch.int32)
        response = torch.zeros(self.capacity, dtype=torch.float32)
        valid = torch.zeros(self.capacity, dtype=torch.bool)
        at = 0
        for hi, lo, budget in zip(level_views(maps[1], table), level_views(maps[2], table), self.budgets):
            if budget:
                px, py, resp, ok = select_level(hi, lo, budget, self.cell_size, self.per_cell_k)
                pxy[0, at: at + budget] = px.int()
                pxy[1, at: at + budget] = py.int()
                response[at: at + budget] = resp
                valid[at: at + budget] = ok
            at += budget
        uv, angle, level, desc = describe(maps[0], table, pxy, self.budgets, self.scales, precision)
        return Features(uv, response, angle, level, desc, valid), Stages(table, levels, maps, pxy)
