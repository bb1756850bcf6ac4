"""Wrappers of the fused frontend kernel (csrc/frontend.cu): 9-tap separable
blur + dual-threshold FAST-9 + 3x3 NMS over every level of an image pyramid
in one launch.

Replaces the Pallas kernel `fused_frontend` of
orbslam2commentedbyxcm_tpu/ops/pallas_frontend.py. The level images lie in
one flat float32 buffer, each on a 128-byte line, described by a `LevelTable`;
`fused_frontend_pyramid` maps it to one (3, total) buffer of blur, nms_hi and
nms_lo in the same layout. `fused_frontend` runs one (H, W) image as a
one-entry table through the same kernel. For a CPU tensor each wrapper runs
`fused_frontend_plain`, the torch twin built from ops/orb, level by level;
for a CUDA tensor it launches the kernel or raises. `.launches` on each
wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops.orb import _fast_maps, _gauss_kernel, _nms3, _separable_blur

_TAPS = _gauss_kernel(9, 3.0)  # sigma=3 blur, shared by orientation moments and descriptors
MAX_LEVELS = 16
ALIGN = 32  # floats: each level starts on a 128-byte line
_taps_set: set = set()  # CUDA device indices whose constant taps are loaded


class LevelTable(NamedTuple):
    """Where each level of a pyramid lies in the flat buffers. The kernel's
    launcher adds the tiles that cover each level (csrc/frontend.cu)."""

    shapes: tuple       # ((h, w), ...) per level
    offsets: tuple      # element offset of each level, a multiple of ALIGN
    total: int          # floats of one flat buffer, the padding between levels included
    c_rows: ctypes.Array  # (offset, h, w) per level as a C int array, handed to the launcher


@functools.lru_cache(maxsize=64)
def level_table(shapes: tuple) -> LevelTable:
    """Level table of the (h, w) level shapes, in order."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"level_table: {len(shapes)} levels, supported 1..{MAX_LEVELS}")
    rows, offsets = [], []
    off = 0
    for h, w in shapes:
        if h < 7 or w < 7:
            raise ValueError(f"level_table: level {h}x{w} is smaller than the FAST ring")
        rows += (off, h, w)
        offsets.append(off)
        off += -(-h * w // ALIGN) * ALIGN
    if off >= 2**31:
        raise ValueError(f"level_table: {off} floats exceed the kernel's 32-bit offsets")
    return LevelTable(tuple(shapes), tuple(offsets), off, (ctypes.c_int * len(rows))(*rows))


def level_views(buf: torch.Tensor, table: LevelTable):
    """(h, w) views of each level of a flat buffer laid out by `table`."""
    return [buf[o : o + h * w].view(h, w) for o, (h, w) in zip(table.offsets, table.shapes)]


def fused_frontend_plain(img: torch.Tensor, th_hi: float, th_lo: float):
    """Plain torch twin: (H, W) image -> (blurred, nms_hi, nms_lo)."""
    blurred = _separable_blur(img, _TAPS)
    s_hi, s_lo, _ = _fast_maps(img, th_hi, th_lo)
    return blurred, _nms3(s_hi), _nms3(s_lo)


def _launch(buf: torch.Tensor, table: LevelTable, th_hi: float, th_lo: float) -> torch.Tensor:
    """One kernel launch over `table` -> (3, total) blur, nms_hi, nms_lo."""
    lib = kernels.library()
    out = torch.empty((3, table.total), dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        if buf.device.index not in _taps_set:
            kernels.check(lib.orb_frontend_set_taps(_TAPS.ctypes.data),
                          "orb_frontend_set_taps")
            _taps_set.add(buf.device.index)
        err = lib.orb_frontend_pyramid(
            buf.data_ptr(), out.data_ptr(), table.total, table.c_rows, len(table.shapes),
            float(th_hi), float(th_lo), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "orb_frontend_pyramid")
    return out


def _check_cuda(name: str, t: torch.Tensor, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32 or t.dim() != dim or not t.is_contiguous():
        raise ValueError(
            f"{name}: needs a contiguous {dim}-D float32 tensor, got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def fused_frontend_pyramid(levels: torch.Tensor, table: LevelTable, th_hi: float, th_lo: float):
    """Flat float32 buffer of level images laid out by `table` -> one (3,
    total) float32 buffer: blurred, nms_hi, nms_lo, each in the same layout.

    Border semantics of the JAX package's XLA path, per level: replicate
    padding for both blur passes, FAST scores only on [3, H-3) x [3, W-3),
    NMS padding -inf."""
    if tuple(levels.shape) != (table.total,):
        raise ValueError(f"fused_frontend_pyramid: buffer {tuple(levels.shape)} vs table total {table.total}")
    if levels.device.type == "cpu":
        out = torch.empty((3, table.total), dtype=torch.float32)
        for img, *maps in zip(level_views(levels, table), *(level_views(o, table) for o in out)):
            for dst, src in zip(maps, fused_frontend_plain(img, th_hi, th_lo)):
                dst.copy_(src)
        return out
    _check_cuda("fused_frontend_pyramid", levels, 1)
    out = _launch(levels, table, th_hi, th_lo)
    fused_frontend_pyramid.launches += 1
    return out


def fused_frontend(img: torch.Tensor, th_hi: float, th_lo: float):
    """(H, W) float32 image -> (blurred, nms_hi, nms_lo), each (H, W)
    float32: one level through the pyramid kernel."""
    if img.device.type == "cpu":
        return fused_frontend_plain(img, th_hi, th_lo)
    _check_cuda("fused_frontend", img, 2)
    table = level_table((tuple(img.shape),))
    out = _launch(img, table, th_hi, th_lo)
    fused_frontend.launches += 1
    return tuple(level_views(o, table)[0] for o in out)


fused_frontend_pyramid.launches = 0
fused_frontend.launches = 0
