"""PNG reading and writing with zlib and numpy: the port's replacement for
`cv2.imread` / `cv2.imwrite`, which the dataset readers and writers of the
JAX package call (utils/datasets.py, utils/dataset_writers.py).

    img = imread_gray(path)        # uint8 (H, W), as cv2.IMREAD_GRAYSCALE
    depth = read_png(path)         # samples as stored, as cv2.IMREAD_UNCHANGED
    write_png(path, img)           # uint8 or uint16 (H, W), filter None

Decodes 8-bit gray, gray + alpha, RGB and RGBA (color types 0, 4, 2, 6) and
16-bit gray (big-endian samples, as TUM RGB-D depth is stored), with all five
row filters. The row filters are undone by a small C++ routine
(csrc/png_unfilter.cpp, built at first use by `kernels.host_library`): the
Average and Paeth filters read the reconstructed byte to their left, which a
numpy expression cannot. Interlaced (Adam7), palette and other bit depths
raise ValueError naming what is not supported. Chunk CRCs are checked.

Gray conversion is libpng's as OpenCV sets it up: alpha dropped, then
(9797 R + 19234 G + 3737 B) >> 15 for color (png_set_rgb_to_gray with 0.299
and 0.587), and the high byte of a 16-bit sample. Nothing here falls back to
cv2 or PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> samples as stored: (H, W) for gray, (H, W, C) with C = 2
    (gray, alpha), 3 (R, G, B) or 4 (R, G, B, A); uint8, or uint16 for 16-bit
    gray. Color channels stay in file order (cv2 returns BGR)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG color type {color} ({_COLOR_NAMES.get(color, 'unknown')}) is not supported")
    if not (depth == 8 or (depth == 16 and color == 0)):
        raise ValueError(f"PNG bit depth {depth} with color type {color} ({_COLOR_NAMES[color]}) is not "
                         "supported (8-bit gray, gray + alpha, RGB, RGBA and 16-bit gray are)")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"PNG compression method {compression} / filter method {filter_method} is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, {height * (stride + 1)} expected")
    out = np.empty(height * stride, np.uint8)
    _unfilter(raw, out, height, stride, bpp)
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    shape = (height, width) if channels == 1 else (height, width, channels)
    return img.reshape(shape)


def _unfilter(raw: bytes, out: np.ndarray, height: int, stride: int, bpp: int) -> None:
    from orbslam2commentedbyxcm_tpu_torch import kernels

    src = np.frombuffer(raw, np.uint8)
    err = kernels.host_library().png_unfilter(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if err != 0:
        row = -err - 1
        raise ValueError(f"PNG row {row} has filter type {raw[row * (stride + 1)]} (0-4 are defined)")


def read_png(path: str) -> np.ndarray:
    """The file's samples as stored (cv2.IMREAD_UNCHANGED, up to channel
    order); raises FileNotFoundError when the file does not exist."""
    with open(path, "rb") as f:
        return decode(f.read())


def imread_gray(path: str) -> np.ndarray:
    """uint8 (H, W) gray image of a PNG file, as cv2.IMREAD_GRAYSCALE gives it."""
    img = read_png(path)
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:  # gray + alpha: the alpha is dropped
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2]) >> 15).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode(img: np.ndarray) -> bytes:
    """uint8 or uint16 (H, W) gray image -> PNG bytes, every row filter None,
    zlib level 1 (OpenCV's default: speed over size)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes a uint8 or uint16 (H, W) image, not {img.dtype} {img.shape}")
    height, width = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    rows = img.astype(">u2").view(np.uint8).reshape(height, -1) if depth == 16 else img
    filtered = np.zeros((height, rows.shape[1] + 1), np.uint8)
    filtered[:, 1:] = rows
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
