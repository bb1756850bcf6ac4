"""Wrapper of the describe kernel (csrc/describe.cu): orientation and
rotated BRIEF descriptors of every selected keypoint of the pyramid in one
launch.

Replaces XLA code of the JAX package, not a Pallas kernel:
orbslam2commentedbyxcm_tpu/ops/descriptors.py:40-134 with the patch
gathers of ops/orb.py:443-449. `describe_keypoints` reads the patches
straight from K1's flat blurred buffer. For a CPU tensor it runs the plain
twin (ops/descriptors.py `describe_plain`); for a CUDA tensor it makes one
launch or raises. Both compute the same bits: one stated order of float32
operations for the moments, atan2 and the rotations.
`describe_keypoints.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import DescriptorTables, describe_plain
from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import LevelTable, _check_cuda


@functools.lru_cache(maxsize=64)
def _c_tables(shapes: tuple, offsets: tuple, budgets: tuple, scales: tuple):
    """(offset, h, w, slot_off, budget) per level and the float32 scales, as
    C arrays for the launcher."""
    if len(budgets) != len(shapes) or len(scales) != len(shapes):
        raise ValueError(f"describe_keypoints: {len(budgets)} budgets and {len(scales)} scales for "
                         f"{len(shapes)} levels")
    rows, slots = [], 0
    for (h, w), off, budget in zip(shapes, offsets, budgets):
        rows += (off, h, w, slots, budget)
        slots += budget
    c_scales = (ctypes.c_float * len(scales))(*np.asarray(scales, np.float32).tolist())
    return (ctypes.c_int * len(rows))(*rows), c_scales, slots


def describe_keypoints(blurred: torch.Tensor, table: LevelTable, pxy: torch.Tensor, budgets, scales,
                       tables: DescriptorTables):
    """The flat (total,) float32 blurred buffer laid out by `table` and the
    (2, capacity) int32 level coordinates of every slot (each level's
    `budgets[l]` slots in turn) -> (uv (capacity, 2) float32 level-0
    coordinates, angle (capacity,) float32, level (capacity,) int32, desc
    (capacity, 8) int32)."""
    if tuple(blurred.shape) != (table.total,):
        raise ValueError(f"describe_keypoints: blurred {tuple(blurred.shape)} vs table total {table.total}")
    if blurred.device.type == "cpu":
        return describe_plain(blurred, table, pxy, budgets, scales, tables)
    _check_cuda("describe_keypoints", blurred, 1)
    c_table, c_scales, cap = _c_tables(table.shapes, table.offsets, tuple(budgets), tuple(scales))
    dev = blurred.device
    if (pxy.device != dev or pxy.dtype != torch.int32 or tuple(pxy.shape) != (2, cap) or not pxy.is_contiguous()
            or tables.pattern.device != dev or tables.moments.device != dev):
        raise ValueError(f"describe_keypoints: needs contiguous int32 (2, {cap}) coordinates and tables on {dev}")
    uv = torch.empty((cap, 2), dtype=torch.float32, device=dev)
    angle = torch.empty(cap, dtype=torch.float32, device=dev)
    level = torch.empty(cap, dtype=torch.int32, device=dev)
    desc = torch.empty((cap, 8), dtype=torch.int32, device=dev)
    err = kernels.library().orb_describe(
        blurred.data_ptr(), table.total, c_table, c_scales, len(table.shapes), pxy.data_ptr(), cap,
        tables.pattern.data_ptr(), tables.moments.data_ptr(), uv.data_ptr(), angle.data_ptr(), level.data_ptr(),
        desc.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "orb_describe")
    describe_keypoints.launches += 1
    return uv, angle, level, desc


describe_keypoints.launches = 0
