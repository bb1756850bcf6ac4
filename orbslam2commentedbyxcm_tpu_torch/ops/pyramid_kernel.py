"""Wrapper of the exposure-gain and image-pyramid kernel (csrc/pyramid.cu).

Replaces XLA code of the JAX package, not a Pallas kernel: the gain of
orbslam2commentedbyxcm_tpu/ops/orb.py:317-330 and the resize products
`wh @ img @ ww.T` at :337-339. `pyramid_resize` writes every level of the
extractor's pyramid into one flat float32 buffer laid out by a
`frontend_kernel.LevelTable`, the buffer the frontend kernel reads. For a
CPU tensor it runs the plain twin (ops/orb.py `_pyramid_plain`); for a CUDA
tensor it launches the kernels or raises. Both compute the same bits: every
sum has one fixed order (see csrc/pyramid.cu). `pyramid_resize.launches`
counts the kernel launches: the two gain sums when the gain is on, then the
resize, so 3 per call with the gain and 1 without.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import LevelTable, _check_cuda
from orbslam2commentedbyxcm_tpu_torch.ops.orb import _pyramid_plain, _resize_taps

TILE_COLS = 64  # CW in csrc/pyramid.cu: output columns of one resize tile
CHUNK = 1024    # values per block of the gain sums


@functools.lru_cache(maxsize=32)
def _tap_pack(h: int, w: int, shapes: tuple, offsets: tuple, device: str):
    """The tap tables of the levels of `shapes` at `offsets` (a LevelTable's)
    from an h x w image, packed for the kernel: (starts int32 and weights
    float32 on `device`, the C table of (out_offset, h, w, taps_v, taps_h,
    vstart, vweight, hstart, hweight) rows, the most input columns one
    tile's vertical pass reads)."""
    starts, weights, rows = [], [], []
    n_int = n_float = 0
    max_win = 1
    for lvl, (off, (hl, wl)) in enumerate(zip(offsets, shapes)):
        if lvl == 0:
            rows += (off, hl, wl, 0, 0, 0, 0, 0, 0)
            continue
        (vs, vw), (hs, hw) = _resize_taps(h, hl), _resize_taps(w, wl)
        rows += (off, hl, wl, vw.shape[1], hw.shape[1], n_int, n_float, n_int + hl, n_float + vw.size)
        starts += (vs, hs)
        weights += (vw.reshape(-1), hw.reshape(-1))
        n_int += hl + wl
        n_float += vw.size + hw.size
        j0 = np.arange(0, wl, TILE_COLS)
        max_win = max(max_win, int((hs[np.minimum(j0 + TILE_COLS, wl) - 1] + hw.shape[1] - hs[j0]).max()))
    as_tensor = lambda parts, dtype: torch.from_numpy(  # noqa: E731
        np.concatenate(parts) if parts else np.zeros(1, dtype)).to(device)
    return (as_tensor(starts, np.int32), as_tensor(weights, np.float32),
            (ctypes.c_int * len(rows))(*rows), max_win)


def pyramid_resize(img: torch.Tensor, table: LevelTable, exposure_target: float | None = None) -> torch.Tensor:
    """(H, W) float32 image -> the flat float32 buffer (table.total,) of
    every level of `table`: level 0 the image, rescaled to a mean absolute
    deviation of `exposure_target` when one is given (gain capped to
    [1/8, 8]), level l > 0 level 0 resized to table.shapes[l]."""
    if tuple(table.shapes[0]) != tuple(img.shape):
        raise ValueError(f"pyramid_resize: level 0 {table.shapes[0]} vs image {tuple(img.shape)}")
    if img.device.type == "cpu":
        return _pyramid_plain(img, table, exposure_target)
    _check_cuda("pyramid_resize", img, 2)
    h, w = img.shape
    starts, weights, rows, max_win = _tap_pack(h, w, table.shapes, table.offsets, str(img.device))
    lib = kernels.library()
    out = torch.empty(table.total, dtype=torch.float32, device=img.device)
    parts = None
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        if exposure_target is not None:
            parts = torch.empty((2, -(-h * w // CHUNK)), dtype=torch.float32, device=img.device)
            kernels.check(lib.orb_gain_stats(img.data_ptr(), h * w, parts[0].data_ptr(), parts[1].data_ptr(),
                                             stream), "orb_gain_stats")
            pyramid_resize.launches += 2
        err = lib.orb_pyramid_resize(
            img.data_ptr(), h, w, None if parts is None else parts[0].data_ptr(),
            None if parts is None else parts[1].data_ptr(), float(exposure_target or 0.0),
            starts.data_ptr(), weights.data_ptr(), out.data_ptr(), table.total, rows, len(table.shapes),
            max_win, stream,
        )
    kernels.check(err, "orb_pyramid_resize")
    pyramid_resize.launches += 1
    return out


pyramid_resize.launches = 0
