"""The port's PNG codec (utils/png) against cv2, which the JAX package's
dataset readers and writers use: bit-equal on 8-bit gray and 16-bit depth
files, every row filter on hand-built files, libpng's color-to-gray, the
round trip of the encoder and the errors for what it does not decode."""

import struct
import zlib

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.utils import png

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(row, prior, f, bpp):
    """One scanline filtered with type f (PNG spec section 9), from the
    unfiltered bytes: the encoder's side, written independently of the
    decoder's C++."""
    x = row.astype(np.int64)
    up = prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, upleft)}[f]
    return ((x - pred) % 256).astype(np.uint8)


def _hand_png(img, color, filters, depth=8, interlace=0):
    """A PNG file of `img` (uint8, or uint16 for depth 16) written with zlib,
    row y filtered with filters[y % len(filters)]."""
    h, w = img.shape[:2]
    rows = img.astype(">u2").view(np.uint8).reshape(h, -1) if depth == 16 else img.reshape(h, -1)
    bpp = CHANNELS.get(color, 1) * depth // 8
    out, prior = b"", np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        f = filters[y % len(filters)]
        out += bytes([f]) + _filter_row(rows[y], prior, f, bpp).tobytes()
        prior = rows[y]
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(out)) + _chunk(b"IEND", b""))


def _smooth(rng, h, w, c=None):
    """Smooth content (what Average / Paeth are for), with noise."""
    shape = (h, w) if c is None else (h, w, c)
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 90 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    if c is not None:
        base = base[..., None] + np.arange(c) * 20
    return np.clip(base + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)


def test_gray_and_depth_bit_equal_to_cv2(tmp_path):
    rng = np.random.default_rng(0)
    for name, img in (("noise", rng.integers(0, 256, (61, 83), dtype=np.uint8)),
                      ("smooth", _smooth(rng, 96, 131))):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img)
        got = png.imread_gray(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    depth = rng.integers(0, 65536, (48, 64), dtype=np.uint16)
    depth[::7] = 0
    path = str(tmp_path / "depth.png")
    cv2.imwrite(path, depth)
    got = png.read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    # 16-bit read as gray: the high byte, as cv2 gives it
    np.testing.assert_array_equal(png.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 2, 1, 0, 3)])
@pytest.mark.parametrize("color,depth", [(0, 8), (0, 16), (2, 8), (4, 8), (6, 8)])
def test_every_filter_type(tmp_path, filters, color, depth):
    rng = np.random.default_rng(len(filters) * 10 + color)
    c = CHANNELS[color]
    if depth == 16:
        img = (_smooth(rng, 23, 37).astype(np.uint16) * 257 + rng.integers(0, 200, (23, 37))).astype(np.uint16)
    else:
        img = _smooth(rng, 23, 37, None if c == 1 else c)
    path = tmp_path / "f.png"
    path.write_bytes(_hand_png(img, color, filters, depth))
    got = png.read_png(str(path))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == img.dtype
    # cv2 reads the same file to the same samples (it returns BGR(A))
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if c >= 3:
        ref = ref[..., [2, 1, 0, 3][:c]]
    if c != 2:  # cv2 expands gray + alpha to BGRA
        np.testing.assert_array_equal(ref, img)
    np.testing.assert_array_equal(png.imread_gray(str(path)), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_color_to_gray_matches_cv2(tmp_path):
    """cv2's IMREAD_GRAYSCALE goes through libpng's rgb_to_gray with OpenCV's
    0.299 / 0.587 weights: (9797 R + 19234 G + 3737 B) >> 15 after the alpha
    is dropped. The codec differs from it on 0.0% of pixels (asserted: within
    1 level, and the share that differs is 0)."""
    rng = np.random.default_rng(3)
    for c, color in ((3, 2), (4, 6), (2, 4)):
        img = rng.integers(0, 256, (64, 80, c), dtype=np.uint8)
        path = tmp_path / f"c{c}.png"
        path.write_bytes(_hand_png(img, color, (4, 1)))
        got = png.imread_gray(str(path)).astype(np.int64)
        ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE).astype(np.int64)
        assert np.abs(got - ref).max() <= 1
        share = float(np.mean(got != ref))
        assert share == 0.0, f"{share:.4%} of pixels differ by 1 for {c} channels"


def test_encode_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    img8 = _smooth(rng, 37, 53)
    img16 = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    for img in (img8, img16):
        path = str(tmp_path / f"w{img.dtype}.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(png.read_png(path), img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.encode(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.encode(np.zeros((4, 4, 3), np.uint8))


def test_unsupported_and_corrupt_files_raise(tmp_path):
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    with pytest.raises(ValueError, match="Adam7"):
        png.decode(_hand_png(img, 0, (0,), interlace=1))
    with pytest.raises(ValueError, match="palette"):
        png.decode(_hand_png(img, 3, (0,)))
    with pytest.raises(ValueError, match="bit depth 16 with color type 2"):
        png.decode(_hand_png(np.zeros((2, 2, 3), np.uint16), 2, (0,), depth=16))
    data = bytearray(_hand_png(img, 0, (0,)))
    data[40] ^= 0xFF  # inside the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    raw = b"".join(bytes([5 if y == 3 else 0]) + img[y].tobytes() for y in range(6))
    bad = (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 6, 8, 0, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="row 3 has filter type 5"):
        png.decode(bad)
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + bytes(20))
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))
