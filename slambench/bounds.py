"""The least time each of the port's kernels could take on one H100, from
the operations and bytes its inputs need (frozen copies of the arithmetic
of chip_smoke.py's `_bound`, `pyramid_ops`, `k1_ops`, `select_bound` and
`describe_bound`), counted on the benchmark's own plain extraction of the
frame (reference/orb.py). Each bound is max(operations / float32 peak,
bytes / memory bandwidth); bytes count each input read once and each output
written once, operations what these inputs need.
"""

from __future__ import annotations

import torch

from slambench.reference import orb

# H100 SXM, NVIDIA's data sheet (700 W): float32 outside the tensor cores, HBM3
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# counted from csrc/pyramid.cu: an fma (2) per nonzero tap of each pass; per
# pixel the gain's two sums and its rescale (7)
PYRAMID_OPS_PER_TAP, PYRAMID_GAIN_OPS_PER_PX = 2, 7
# counted from csrc/frontend.cu: per pixel both blur passes, the compass
# test, two threshold compares and both 3x3 NMS (70); a pixel that passes the
# compass test adds the full FAST-9 response (12 + 128 + 31)
K1_OPS_PER_PX, K1_OPS_FAST = 70, 12 + 128 + 31
# counted from csrc/select.cu and csrc/describe.cu
SELECT_OPS_PER_VALUE = 2
DESCRIBE_OPS_PER_KEYPOINT = 3968 + 25 + 8 * 512 + 256
# counted from csrc/poseopt.cu: per active edge and evaluation (260), per
# edge of a chi2 relabel (40), per LM iteration the 6x6 solve and the update
K2_OPS_EDGE_EVAL, K2_OPS_PROJECTION, K2_OPS_ITERATION = 260, 40, 650
K2_ROUNDS, K2_ITERS = 4, 10  # the reference's motion-only BA: 4 rounds of up to 10 LM iterations


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def pyramid(stages: orb.Stages, gain: bool) -> float:
    """The image read, every level written; the nonzero taps of both passes
    of every level (the vertical pass over the full width), and the gain."""
    (h, w), table = stages.table.shapes[0], stages.table
    taps = 0
    for hl, wl in table.shapes[1:]:
        taps += int((orb.resize_weights(h, hl) != 0).sum()) * w + int((orb.resize_weights(w, wl) != 0).sum()) * hl
    ops = PYRAMID_OPS_PER_TAP * taps + (PYRAMID_GAIN_OPS_PER_PX * h * w if gain else 0)
    n_px = sum(a * b for a, b in table.shapes)
    return bound_s(ops, 4 * (h * w + n_px))


def k1(stages: orb.Stages, th: float) -> float:
    """Every level read, blur and both score maps written (16 bytes a
    pixel); the compass test decides per interior pixel whether the full
    response is computed."""
    ops, n_px = 0, 0
    for lv in stages.levels:
        c = lv[3:-3, 3:-3]
        q = (lv[:-6, 3:-3] - c, lv[3:-3, 6:] - c, lv[6:, 3:-3] - c, lv[3:-3, :-6] - c)
        nb = sum((x > th).int() for x in q)
        nd = sum((-x > th).int() for x in q)
        ops += K1_OPS_PER_PX * lv.numel() + K1_OPS_FAST * int(((nb >= 2) | (nd >= 2)).sum())
        n_px += lv.numel()
    return bound_s(ops, 16 * n_px)


def select(stages: orb.Stages, budgets, cell_size: int = 32, k: int = 4) -> float:
    """nms_hi read inside each level's margin, nms_lo only in cells with no
    nms_hi score, 13 bytes written a slot; per cell value a max and a
    compare per pass, n log2 n compares per level's ranking."""
    table, m, cs = stages.table, orb.MARGIN, cell_size
    nbytes, ops = 13 * sum(budgets), 0
    for (h, w), hi, budget in zip(table.shapes, orb.level_views(stages.maps[1], table), budgets):
        if not budget:
            continue
        cy, cx = -(-h // cs), -(-w // cs)
        inner = torch.zeros((cy * cs, cx * cs), dtype=torch.bool)
        inner[m: h - m, m: w - m] = True
        scored = torch.zeros_like(inner)
        scored[:h, :w] = hi > 0
        n_inner = inner.reshape(cy, cs, cx, cs).sum((1, 3))
        lo = (scored & inner).reshape(cy, cs, cx, cs).sum((1, 3)) == 0
        nbytes += 4 * int(n_inner.sum() + n_inner[lo].sum())
        ops += SELECT_OPS_PER_VALUE * k * cs * cs * (cy * cx + int(lo.sum()))
        n = cy * cx * k
        ops += n * max(1, (n - 1).bit_length())
    return bound_s(ops, nbytes)


def describe(stages: orb.Stages, budgets) -> float:
    """The union of the pixels the 48 x 48 patches cover read once, (px,
    py) read and uv, angle, level and 8 words written once a slot."""
    table, pxy = stages.table, stages.pxy
    slot_level = torch.repeat_interleave(torch.arange(len(budgets)), torch.tensor(list(budgets)))
    offs = torch.tensor(table.offsets, dtype=torch.int64)[slot_level]
    hs = torch.tensor([h for h, _ in table.shapes], dtype=torch.int64)[slot_level]
    ws = torch.tensor([w for _, w in table.shapes], dtype=torch.int64)[slot_level]
    ar = torch.arange(-24, 24)
    rows = orb._reflect(pxy[1].long()[:, None] + ar, hs[:, None])
    cols = orb._reflect(pxy[0].long()[:, None] + ar, ws[:, None])
    covered = torch.zeros(table.total, dtype=torch.bool)
    covered[(offs[:, None, None] + rows[:, :, None] * ws[:, None, None] + cols[:, None, :]).reshape(-1)] = True
    n_slots = pxy.shape[1]
    return bound_s(DESCRIBE_OPS_PER_KEYPOINT * n_slots, 4 * int(covered.sum()) + n_slots * (8 + 48))


def k2(n_edges: int, capacity: int) -> float:
    """One motion-only solve counted from the problem: n_edges active edges
    through the reference's 4 rounds of 10 LM iterations (an evaluation to
    start each round, one per iteration), a chi2 relabel after each round
    and at the end; the pose, points, observations, inv_sigma2 and mask of
    every slot read once, the pose, chi2, count and inlier mask written."""
    evals = K2_ROUNDS * (1 + K2_ITERS)
    ops = (K2_OPS_EDGE_EVAL * evals * n_edges + K2_OPS_PROJECTION * (K2_ROUNDS + 1) * n_edges
           + K2_OPS_ITERATION * K2_ROUNDS * K2_ITERS)
    return bound_s(ops, 64 + 29 * capacity + 72 + capacity)
