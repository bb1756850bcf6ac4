"""Wrapper of the selection kernel (csrc/select.cu): the per-cell top-k of
both NMS maps of every pyramid level, the 20 -> 7 fallback per cell and
each level's `budget` smallest (rank, -score) keys, in one launch.

Replaces XLA code of the JAX package, not a Pallas kernel:
orbslam2commentedbyxcm_tpu/ops/orb.py:370-441. `select_keypoints` reads
K1's (3, total) buffer through its `frontend_kernel.LevelTable` and returns
each level's slots in turn. For a CPU tensor it runs the plain twin
(ops/orb.py `select_plain`, `select_level` per level); for a CUDA tensor it
makes one launch or raises. Both compute the same bits (every step is
exact). `select_keypoints.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import LevelTable, _check_cuda
from orbslam2commentedbyxcm_tpu_torch.ops.orb import MARGIN, select_plain

MAX_CELL, MAX_K = 32, 32  # csrc/select.cu MAX_CELL, MAX_K


class SelectPlan(NamedTuple):
    """Where each level's cells, keys and slots lie (csrc/select.cu)."""

    levels: tuple          # per level (offset, h, w, cy, cx, key_off, slot_off, budget)
    n_keys: int            # keys of every level with a budget
    capacity: int          # slots
    c_table: ctypes.Array  # the levels as a C int array for the launcher


@functools.lru_cache(maxsize=64)
def select_plan(shapes: tuple, offsets: tuple, budgets: tuple, cell_size: int, per_cell_k: int) -> SelectPlan:
    """The kernel's table for the levels of a LevelTable (`shapes`,
    `offsets`) with these per-level budgets. Raises ValueError for what the
    kernel does not take: a cell side over 32, a per-cell k over 32 or over
    the cell's values. Levels of any size are taken."""
    if len(budgets) != len(shapes):
        raise ValueError(f"select_keypoints: {len(budgets)} budgets for {len(shapes)} levels")
    if not 1 <= cell_size <= MAX_CELL or not 1 <= per_cell_k <= min(MAX_K, cell_size * cell_size):
        raise ValueError(f"select_keypoints: cell size {cell_size} and per-cell k {per_cell_k} not supported "
                         f"(cell size 1..{MAX_CELL}, k 1..{MAX_K} and at most the cell's values)")
    rows, keys, slots = [], 0, 0
    for (h, w), off, budget in zip(shapes, offsets, budgets):
        cy, cx = -(-h // cell_size), -(-w // cell_size)
        n = cy * cx * per_cell_k if budget else 0
        rows.append((off, h, w, cy, cx, keys, slots, budget))
        keys += n
        slots += budget
    flat = [x for row in rows for x in row]
    return SelectPlan(tuple(rows), keys, slots, (ctypes.c_int * len(flat))(*flat))


def select_keypoints(maps: torch.Tensor, table: LevelTable, budgets, cell_size: int, per_cell_k: int):
    """K1's (3, total) float32 buffer (blurred, nms_hi, nms_lo laid out by
    `table`) -> ((px, py) (2, capacity) int32 level coordinates, response
    (capacity,) float32, valid (capacity,) bool), each level's
    `budgets[l]` slots in turn."""
    if tuple(maps.shape) != (3, table.total):
        raise ValueError(f"select_keypoints: maps {tuple(maps.shape)} vs table total {table.total}")
    if maps.device.type == "cpu":
        return select_plain(maps, table, budgets, cell_size, per_cell_k)
    _check_cuda("select_keypoints", maps, 2)
    plan = select_plan(table.shapes, table.offsets, tuple(budgets), cell_size, per_cell_k)
    dev = maps.device
    pxy = torch.empty((2, plan.capacity), dtype=torch.int32, device=dev)
    response = torch.empty(plan.capacity, dtype=torch.float32, device=dev)
    valid = torch.empty(plan.capacity, dtype=torch.bool, device=dev)
    scratch = torch.empty(3 * plan.n_keys, dtype=torch.int32, device=dev)  # keys, in-cell indices, values
    err = kernels.library().orb_select(
        maps.data_ptr(), table.total, plan.c_table, len(table.shapes), cell_size, per_cell_k, MARGIN,
        scratch.data_ptr(), plan.n_keys, pxy.data_ptr(), response.data_ptr(), valid.data_ptr(), plan.capacity,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "orb_select")
    select_keypoints.launches += 1
    return pxy, response, valid


select_keypoints.launches = 0
