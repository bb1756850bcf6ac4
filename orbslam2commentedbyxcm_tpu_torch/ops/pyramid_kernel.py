"""Wrapper of the exposure-gain and image-pyramid kernel (csrc/pyramid.cu).

Replaces XLA code of the JAX package, not a Pallas kernel: the gain of
orbslam2commentedbyxcm_tpu/ops/orb.py:317-330 and the resize products
`wh @ img @ ww.T` at :337-339. `pyramid_resize` writes every level of the
extractor's pyramid into one flat float32 buffer laid out by a
`frontend_kernel.LevelTable`, the buffer the frontend kernel reads. For a
CPU tensor it runs the plain twin (ops/orb.py `_pyramid_plain`); for a CUDA
tensor it makes one launch, gain on or off, or raises. Both compute the
same bits: every sum has one fixed order (see csrc/pyramid.cu).
`pyramid_resize.launches` counts the kernel launches, 1 per CUDA call.

The host plans the kernel's work once per image and level shape
(`_plan`): the image boxes the kernel's blocks stage, and the tap records
of every row band and column band of boxes, packed so that a block fetches
all it needs for a box in one copy. The kernel's design choices (threads,
box and buffer shapes, record and vertical-pass words) are compiled into
the library, which exports them as `orb_pyramid_geometry`; `GEOMETRY`
mirrors the source's defaults for code that plans without a library (the
CPU tests).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import LevelTable, _check_cuda
from orbslam2commentedbyxcm_tpu_torch.ops.orb import _pyramid_plain, _resize_taps

CHUNK = 1024  # values per partial of the gain sums


class Geometry(NamedTuple):
    """The kernel's compiled design choices (csrc/pyramid.cu PYR_*)."""

    threads: int
    box_rows: int   # image rows a box owns, at most
    box_cols: int   # image columns a box owns, at most
    buf_rows: int   # image rows a box stages (its own and the taps' halo), at most
    buf_cols: int   # image columns a box stages, at most
    rec_words: int  # words of one box's tap records, at most
    t_words: int    # words of all levels' vertical passes in a box, at most
    items: int      # (level, output row) items of a box, at most
    copies: int     # copies of the gain's partials in the scratch


GEOMETRY = Geometry(256, 16, 64, 24, 64, 2048, 4608, 256, 8)
HEAD = 8  # words of the box plan before the level rows in the launcher's table


class Plan(NamedTuple):
    """How the kernel covers a pyramid: image boxes of bh x bw values (the
    last row and column of boxes ragged), each staged with a halo of the
    most taps - 1; every output of a level > 0 belongs to the box where its
    taps start. `records` holds per row band and level the first and end
    output row whose vertical taps start in the band, their starts and
    weights (rmax rows, zero-padded); then per column band and level the
    same for the columns, the weights tap-major (tw, cmax)."""

    records: torch.Tensor  # int32 words (the weights' float32 bits)
    head: tuple            # (bh, bw, halo_r, halo_c, n_rb, n_cb, v_words, h_words)
    levels: tuple          # per level (out_offset, h, w, tv, tw, v_at, rmax, h_at, cmax, t_at, t_cols); level 0 has no taps
    c_table: ctypes.Array  # head + levels as a C int array for the launcher


def _band_records(start: np.ndarray, wts: np.ndarray, core: int, n_bands: int, tap_major: bool):
    """One axis of one level: per band of `core` inputs, the outputs whose
    taps start in it -> (records (n_bands, 2 + most * (1 + taps)) int32,
    most outputs a band starts, the most inputs one band's outputs read)."""
    first = np.searchsorted(start, np.arange(n_bands + 1) * core, side="left")
    most = int(np.diff(first).max())
    taps = wts.shape[1]
    rec = np.zeros((n_bands, 2 + most * (1 + taps)), np.int32)
    reach = 0
    for b in range(n_bands):
        lo, hi = int(first[b]), int(first[b + 1])
        rec[b, :2] = lo, hi
        rec[b, 2 : 2 + hi - lo] = start[lo:hi]
        block = np.zeros((most, taps), np.float32)
        block[: hi - lo] = wts[lo:hi]
        rec[b, 2 + most :] = (block.T if tap_major else block).reshape(-1).view(np.int32)
        if hi > lo:
            reach = max(reach, int(start[hi - 1]) + taps - int(start[lo]))
    return rec, most, reach


def _fit(h, w, taps, geometry: Geometry):
    """The box plan for an h x w image with these levels' taps: the largest
    box (at most the geometry's) whose halo, records and vertical pass fit
    the kernel's buffers -> (bh, bw, halo_r, halo_c, per level ((v records,
    rmax), (h records, cmax))). Raises ValueError when none does."""
    halo_r = max((vw.shape[1] for (_, vw), _ in taps), default=1) - 1
    halo_c = max((hw.shape[1] for _, (_, hw) in taps), default=1) - 1
    bh, bw = min(geometry.box_rows, geometry.buf_rows - halo_r), min(geometry.box_cols, geometry.buf_cols - halo_c)
    while bh >= 1 and bw >= 1:
        n_rb, n_cb = -(-h // bh), -(-w // bw)
        per_level = [(_band_records(vs, vw, bh, n_rb, False), _band_records(hs, hw, bw, n_cb, True))
                     for (vs, vw), (hs, hw) in taps]
        words = sum(-(-v[0].shape[1] // 4) * 4 + -(-c[0].shape[1] // 4) * 4 for v, c in per_level)
        t_words = sum(v[1] * c[2] for v, c in per_level)
        cols = max((c[1] for _, c in per_level), default=0)
        items = sum(v[1] for v, _ in per_level)
        if (words <= geometry.rec_words and t_words <= geometry.t_words and items <= geometry.items
                and cols <= -(-geometry.box_cols // 32) * 32):
            return bh, bw, halo_r, halo_c, per_level
        bh, bw = (bh - 1, bw) if bh * 4 > bw else (bh, bw - 8)
    raise ValueError(f"pyramid_resize: taps up to {halo_r + 1} x {halo_c + 1} do not fit the kernel's boxes")


def _pack(per_band, n_bands):
    """Concatenate one axis's level records band by band, each level's
    block padded to 16 bytes -> (words (n_bands, total), each level's offset)."""
    blocks, at, off = [], [], 0
    for rec in per_band:
        pad = -rec.shape[1] % 4
        blocks.append(np.pad(rec, ((0, 0), (0, pad))))
        at.append(off)
        off += rec.shape[1] + pad
    return (np.concatenate(blocks, 1) if blocks else np.zeros((n_bands, 0), np.int32)), at


@functools.lru_cache(maxsize=32)
def _plan(h: int, w: int, shapes: tuple, offsets: tuple, device: str, geometry: Geometry) -> Plan:
    """The kernel's plan for the levels of `shapes` at `offsets` (a
    LevelTable's) from an h x w image, the records on `device`."""
    taps = [(_resize_taps(h, hl), _resize_taps(w, wl)) for hl, wl in shapes[1:]]
    bh, bw, halo_r, halo_c, per_level = _fit(h, w, taps, geometry)
    n_rb, n_cb = -(-h // bh), -(-w // bw)
    v_words, v_at = _pack([v[0] for v, _ in per_level], n_rb)
    h_words, h_at = _pack([c[0] for _, c in per_level], n_cb)
    head = (bh, bw, halo_r, halo_c, n_rb, n_cb, v_words.shape[1], h_words.shape[1])
    levels, t_at = [(offsets[0], h, w) + (0,) * 8], 0
    for lvl, ((v, c), ((_, vw), (_, hw))) in enumerate(zip(per_level, taps), 1):
        hl, wl = shapes[lvl]
        levels.append((offsets[lvl], hl, wl, vw.shape[1], hw.shape[1], v_at[lvl - 1], v[1], h_at[lvl - 1], c[1],
                       t_at, max(c[2], 1)))
        t_at += v[1] * max(c[2], 1)
    records = np.concatenate([v_words.reshape(-1), h_words.reshape(-1), np.zeros(4, np.int32)])
    flat = list(head) + [x for row in levels for x in row]
    return Plan(torch.from_numpy(records).to(device), head, tuple(levels), (ctypes.c_int * len(flat))(*flat))


_geometries: dict = {}  # id(library) -> Geometry


def _geometry(lib) -> Geometry:
    """The design choices compiled into `lib`."""
    found = _geometries.get(id(lib))
    if found is None:
        found = _geometries[id(lib)] = Geometry(*(ctypes.c_int * 9).in_dll(lib, "orb_pyramid_geometry"))
    return found


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
    lib = kernels.library()
    geometry = _geometry(lib)
    plan = _plan(h, w, table.shapes, table.offsets, str(img.device), geometry)
    # the gain's partials ride behind the levels in one allocation: two sums,
    # each in `copies` copies of one partial per 1024 pixels, 128-byte lines apart
    n_part = 2 * geometry.copies * (-(-h * w // CHUNK // 32) * 32 + 32) if exposure_target is not None else 0
    buf = torch.empty(table.total + n_part, dtype=torch.float32, device=img.device)
    device = img.device.index
    err = lib.orb_pyramid(
        img.data_ptr(), h, w, buf.data_ptr() + 4 * table.total if n_part else None, n_part,
        float(exposure_target or 0.0), plan.records.data_ptr(), plan.records.numel(), buf.data_ptr(), table.total,
        plan.c_table, len(table.shapes), device, torch.cuda.current_stream(device).cuda_stream,
    )
    kernels.check(err, "orb_pyramid")
    pyramid_resize.launches += 1
    return buf[: table.total] if n_part else buf


pyramid_resize.launches = 0
