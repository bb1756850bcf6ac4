"""The extractor's exposure gain and pyramid resize on the CPU: the tap
tables, the float32 fused multiply-add the twin emulates, the fixed-order
tree sums of the gain, the persistent grid's sums and work list of
csrc/pyramid.cu, and the twin's distance from the JAX package's level
images.

The twin (ops/orb.py `_pyramid_plain`) is the function the CUDA kernel
computes bit for bit; tests/test_torch_kernels_cuda.py holds the kernel to
it on the card. Against the JAX package no order of the twin's can match
XLA's dot and mean, so that comparison counts differing pixels.
"""

import re
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.synth import default_camera as j_default_camera
from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
from orbslam2commentedbyxcm_tpu_torch.ops import pyramid_kernel as pk
from orbslam2commentedbyxcm_tpu_torch.ops.orb import (
    ORBExtractor,
    _exposure_gain,
    _fma_f32,
    _pyramid_plain,
    _resize_pass,
    _resize_taps,
    _resize_weights,
    _tree_sum,
)

torch.set_num_threads(1)

# TUM1, EuRoC and KITTI image sizes (width, height)
SIZES = [(640, 480), (752, 480), (1241, 376)]


def _shapes(h, w, n_levels=8, scale=1.2):
    return tuple((max(16, round(h / scale**l)), max(16, round(w / scale**l))) for l in range(n_levels))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("level", range(1, 8))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tap_tables_rebuild_resize_weights(size, level):
    """Each axis's tap table, scattered back into a dense matrix, is
    `_resize_weights` to the bit; every tap reads inside the input and the
    starts ascend (the kernel's tile windows rely on both)."""
    w, h = size
    hl, wl = _shapes(h, w)[level]
    for n_in, n_out in ((h, hl), (w, wl)):
        start, taps = _resize_taps(n_in, n_out)
        dense = np.zeros((n_out, n_in), np.float32)
        np.put_along_axis(dense, start[:, None] + np.arange(taps.shape[1]), taps, 1)
        assert np.array_equal(_bits(dense), _bits(_resize_weights(n_in, n_out)))
        assert start.dtype == np.int32 and taps.dtype == np.float32
        assert start.min() >= 0 and start.max() + taps.shape[1] <= n_in
        assert (np.diff(start) >= 0).all()
        assert taps.shape[1] <= 2 * int(np.ceil(n_in / n_out)) + 2


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the exact rational x, ties to even (normal
    and subnormal range)."""
    if x == 0:
        return np.float32(0.0)
    sign, a = (-1 if x < 0 else 1), abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    q, rem = divmod(a, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and q % 2 == 1):
        q += 1
    return np.float32(sign * float(q * ulp))


def _fma_cases(rng, n):
    """(a, b, c) float32 triples: random, cancelling, halfway and
    subnormal cases."""
    a = rng.standard_normal(n).astype(np.float32) * np.float32(2.0) ** rng.integers(-20, 20, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32) * np.float32(2.0) ** rng.integers(-20, 20, n).astype(np.float32)
    q = n // 5
    # cancellation: c = -RN(a * b)
    c[:q] = -(a[:q].astype(np.float64) * b[:q]).astype(np.float32)
    # halfway: a * b = half an ulp of c times (1 - 2^-2j), so the exact sum
    # lies just inside a rounding midpoint and the float64 sum lands on it
    cs = np.abs(c[q : 3 * q]).astype(np.float32)
    half = np.ldexp(1.0, np.frexp(cs)[1] - 25).astype(np.float32)
    j = rng.integers(12, 24, 2 * q)
    a[q : 3 * q] = (half * (1 + np.ldexp(1.0, -j))).astype(np.float32)
    b[q : 3 * q] = (1 - np.ldexp(1.0, -j)).astype(np.float32)
    c[q : 3 * q] = cs
    # just above the midpoint from the other side: c one ulp further, a negated
    a[2 * q : 3 * q] *= -1
    c[2 * q : 3 * q] = np.nextafter(cs[q:], np.float32(np.inf))
    sign = rng.choice([-1.0, 1.0], 2 * q).astype(np.float32)
    a[q : 3 * q] *= sign
    c[q : 3 * q] *= sign
    # subnormal results and signed zeros
    a[3 * q : 3 * q + 100] = np.float32(2.0**-70) * rng.uniform(1, 2, 100).astype(np.float32)
    b[3 * q : 3 * q + 100] = np.float32(2.0**-70) * rng.uniform(-2, 2, 100).astype(np.float32)
    c[3 * q : 3 * q + 100] = (rng.integers(-2**22, 2**22, 100) * 2.0**-149).astype(np.float32)
    a[3 * q + 100 : 3 * q + 104] = [0.0, 0.0, -0.0, 3.0]
    b[3 * q + 100 : 3 * q + 104] = [-1.0, 2.0, 5.0, 0.0]
    c[3 * q + 100 : 3 * q + 104] = [-0.0, -0.0, 0.0, -0.0]
    return a, b, c


def test_fma_emulation_equals_exact_oracle(rng):
    """`_fma_f32` is fmaf: the exact a * b + c rounded once to the nearest
    float32 (ties to even), sign of zero included, on 20k triples. Plain
    float64 arithmetic and one cast double-rounds on the halfway cases."""
    a, b, c = _fma_cases(rng, 20000)
    got = _fma_f32(torch.from_numpy(a).double(), torch.from_numpy(b).double(), torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    # an exact zero takes IEEE's sign rule, which float64 arithmetic follows too
    zero = a.astype(np.float64) * b + c == 0
    want[zero] = (a.astype(np.float64) * b + c)[zero].astype(np.float32)
    assert np.array_equal(_bits(got), _bits(want)), int((_bits(got) != _bits(want)).sum())
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    n_double_rounded = int((_bits(naive) != _bits(want)).sum())
    print(f"plain float64 and a cast: {n_double_rounded} of {len(a)} double-rounded")
    assert n_double_rounded > 100


def _level_image(kind, h, w, seed=0):
    if kind == "box":
        seq = JBoxSequence(camera=j_default_camera(w, h), seed=5, n_frames=100, turns=0.35)
        return seq.render(3).astype(np.float32)
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        return rng.integers(0, 256, (h, w)).astype(np.float32)
    return _exposure_gain(torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.float32) * 0.3 + 40), 18.0).numpy()


@pytest.mark.parametrize("kind", ["uint8", "gained"])
def test_first_pass_equals_dense_ascending_fma(kind):
    """The vertical pass over the tap table equals the fma chain over every
    entry of the dense matrix column, zeros included, in ascending order
    from +0.0, at every level of a 120x160 image."""
    h, w = 120, 160
    img = torch.from_numpy(_level_image(kind, h, w))
    for hl, _ in _shapes(h, w)[1:]:
        dense = torch.from_numpy(_resize_weights(h, hl)).double()
        acc = torch.zeros((hl, w))
        for j in range(h):
            acc = _fma_f32(dense[:, j, None], img[j].double()[None, :], acc)
        assert np.array_equal(_bits(_resize_pass(img, hl).T.numpy()), _bits(acc.numpy())), hl


def _jax_levels(img):
    """The JAX extractor's level images: `wh @ img @ ww.T` under jit, the
    weights constants of the traced function as in ORBExtractor._extract."""
    h, w = img.shape
    shapes = _shapes(h, w)

    def levels(x):
        return [jnp.asarray(_resize_weights(h, hl)) @ x @ jnp.asarray(_resize_weights(w, wl)).T
                for hl, wl in shapes[1:]]

    return [np.asarray(a) for a in jax.jit(levels)(jnp.asarray(img))]


# percentage points of a level's pixels by which the twin may differ from
# JAX more often than the matmul path did (0.24 read at levels 5 and 6)
JAX_SHARE_MARGIN = 0.5


@pytest.mark.parametrize("kind", ["uint8", "box"])
def test_twin_at_least_as_close_to_jax_as_matmul(kind):
    """At 640x480, the share of each level's pixels that differ from the
    JAX package's level image: the twin's against that of the torch.matmul
    path the extractor ran before (CPU BLAS), on a random image and a
    rendered frame. At levels 2-4 and 7 the twin's ascending fma chain
    reproduces XLA's first product on nearly every pixel and the matmul path
    does not: the twin differs on fewer pixels there. At levels 1, 5 and 6
    neither order reproduces XLA's products and both differ on 17-43% of
    the pixels, the twin on up to 0.24 percentage points more than the
    matmul path (level 5 on both images, level 6 on the frame; readings on
    x86 CPUs). So every level is held to the matmul path's share plus
    JAX_SHARE_MARGIN points, levels 2-4 and 7 to strictly fewer pixels, and
    the whole pyramid to no more pixels."""
    h, w = 480, 640
    img = _level_image(kind, h, w)
    t = torch.from_numpy(img)
    shares, n_twin, n_matmul = [], 0, 0
    for (hl, wl), ref in zip(_shapes(h, w)[1:], _jax_levels(img)):
        twin = _resize_pass(_resize_pass(t, hl), wl).numpy()
        matmul = (torch.from_numpy(_resize_weights(h, hl)) @ t @ torch.from_numpy(_resize_weights(w, wl)).T).numpy()
        d_twin, d_matmul = int((twin != ref).sum()), int((matmul != ref).sum())
        assert np.abs(twin - ref).max() < 1e-3
        shares.append((100 * d_twin / ref.size, 100 * d_matmul / ref.size))
        n_twin += d_twin
        n_matmul += d_matmul
    print(f"{kind}: % of pixels that differ from JAX per level 1-7, twin / matmul: "
          + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in shares) + f"; whole pyramid {n_twin} / {n_matmul}")
    assert n_twin <= n_matmul
    for level, (twin_share, matmul_share) in enumerate(shares, 1):
        assert twin_share <= matmul_share + JAX_SHARE_MARGIN, (level, shares)
    for level in (2, 3, 4, 7):
        assert shares[level - 1][0] < shares[level - 1][1], (level, shares)


def _pair_tree(values):
    """The pairing as a pure-Python model: float32 adds of neighbours,
    zero-padded to a power of two, until one value is left."""
    x = [np.float32(v) for v in values]
    while len(x) & (len(x) - 1):
        x.append(np.float32(0.0))
    while len(x) > 1:
        x = [np.float32(x[i] + x[i + 1]) for i in range(0, len(x), 2)]
    return x[0]


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1024, 1025, 19200])
def test_tree_sum_equals_pairing_model(rng, n):
    x = rng.standard_normal(n).astype(np.float32) * 100
    assert _bits(_tree_sum(torch.from_numpy(x)).numpy()) == _bits(_pair_tree(x))


@pytest.mark.parametrize("kind", ["uint8", "box"])
def test_gain_mean_and_mad_within_two_ulps_of_float64(kind):
    """The gain's mean and MAD over a 640x480 image (the trees, divided by
    the pixel count) against float64 sums; the MAD's reference is taken
    about the float32 mean the gain uses."""
    img = torch.from_numpy(_level_image(kind, 480, 640))
    n = img.new_tensor(img.numel())
    mu = _tree_sum(img) / n
    mad = _tree_sum((img - mu).abs()) / n
    x = img.double().numpy()
    mu64 = x.mean()
    mad64 = np.abs(x - float(mu)).mean()
    for got, ref in ((mu, mu64), (mad, mad64)):
        got = float(got)
        assert abs(got - ref) <= 2 * np.spacing(np.float32(ref)), (got, ref)
    gained = _exposure_gain(img, 18.0)
    assert float(_tree_sum((gained - _tree_sum(gained) / n).abs()) / n) == pytest.approx(18.0, rel=1e-4)


def test_pyramid_resize_on_cpu_runs_the_twin(rng):
    img = torch.from_numpy(rng.integers(0, 256, (120, 160)).astype(np.float32))
    table = fk.level_table(_shapes(120, 160))
    before = pk.pyramid_resize.launches
    for target in (None, 18.0):
        got = pk.pyramid_resize(img, table, target)
        for a, b in zip(fk.level_views(got, table), fk.level_views(_pyramid_plain(img, table, target), table)):
            assert torch.equal(a, b), target
    assert pk.pyramid_resize.launches == before
    level0 = fk.level_views(got, table)[0]
    assert torch.equal(level0, _exposure_gain(img, 18.0))
    with pytest.raises(ValueError):
        pk.pyramid_resize(img[:, :100], table)
    with pytest.raises(ValueError):
        pk.pyramid_resize(img.to("meta"), table)


def _pair_rows(x):
    """The adjacent-pair tree along the last axis (a power of two), float32."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _block_sum(chunk, threads):
    """One block's subtree of 1024 values (zero-padded) as csrc/pyramid.cu
    sums it: each thread its 1024 / threads consecutive values, then the
    warp shuffles over 32 threads, then warp 0 over the warp sums."""
    v = np.zeros(pk.CHUNK, np.float32)
    v[: len(chunk)] = chunk
    per_thread = _pair_rows(v.reshape(threads, -1))
    per_warp = _pair_rows(per_thread.reshape(-1, 32))
    return _pair_rows(np.pad(per_warp, (0, (1 << (len(per_warp) - 1).bit_length()) - len(per_warp))))


def _grid_sum(x, grid, threads, copies=pk.GEOMETRY.copies):
    """csrc/pyramid.cu's sum of the float32 values x on a persistent grid of
    `grid` blocks: block b takes chunks b, b + grid, ... of 1024 values, one
    partial each, written to every copy; each block then sums the partials
    of copy b % copies in chunks of 1024 and, past one chunk, the chunk sums
    the same way. Each chunk is taken once, and every block gets one total."""
    n_part = -(-len(x) // pk.CHUNK)
    part = np.zeros((copies, n_part), np.float32)
    taken = np.zeros(n_part, np.int64)
    for b in range(grid):
        for c in range(b, n_part, grid):
            part[:, c] = _block_sum(x[c * pk.CHUNK : (c + 1) * pk.CHUNK], threads)
            taken[c] += 1
    assert (taken == 1).all()
    totals = set()
    for b in range(min(grid, copies)):
        mine = part[b % copies]
        sums = np.array([_block_sum(mine[k : k + pk.CHUNK], threads) for k in range(0, n_part, pk.CHUNK)],
                        np.float32)
        totals.add(_bits(sums[0] if len(sums) == 1 else _block_sum(sums, threads)).item())
    assert len(totals) == 1
    return np.array(totals.pop(), np.uint32).view(np.float32)


def _grid_gain(img, target, grid, threads):
    """(mu, gain) as the kernel's phases compute them: float32 scalars."""
    x = img.reshape(-1)
    n = np.float32(x.size)
    mu = np.float32(_grid_sum(x, grid, threads) / n)
    mad = np.float32(_grid_sum(np.abs(x - mu), grid, threads) / n)
    return mu, np.float32(min(max(np.float32(target) / max(mad, np.float32(1e-3)), np.float32(0.125)), np.float32(8)))


# an H100's grid at 4 blocks per SM, and a grid smaller than the 640x480 image's 300 chunks
GRIDS = (132 * 4, 7)


@pytest.mark.parametrize("size", [(1241, 376), (1920, 1080)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_sums_equal_tree_sum(rng, size):
    """The persistent grid's chunk assignment and its chunked reduction of
    the partials give `_tree_sum`'s bits for the image and for |x - mu|, at
    KITTI's size (456 partials) and at 1920x1080 (2025 partials: two chunks
    of them, then their chunk sums), for two grid sizes and both thread
    counts the kernel may be built with."""
    w, h = size
    x = (rng.uniform(0, 255, h * w) * np.float32(1.37)).astype(np.float32)
    n_part = -(-x.size // pk.CHUNK)
    assert (n_part > pk.CHUNK) == (size == (1920, 1080))
    total = _tree_sum(torch.from_numpy(x))
    mu = total / torch.tensor(float(x.size))
    dev = _tree_sum((torch.from_numpy(x) - mu).abs())
    for grid in GRIDS:
        for threads in (pk.GEOMETRY.threads, 128):
            assert _bits(_grid_sum(x, grid, threads)) == _bits(total.numpy()), (grid, threads)
            assert _bits(_grid_sum(np.abs(x - mu.numpy()), grid, threads)) == _bits(dev.numpy()), (grid, threads)


def _kernel_on_cpu(img, table, plan, exposure_target, geometry, grid):
    """csrc/pyramid.cu's work walked in torch, from the plan: the gain's
    phases on the grid; block b's boxes b, b + grid, ...; each box staged
    once with its halo (inside the kernel's buffer) and gained per value,
    its row band's and column band's records decoded as the kernel reads
    them; level 0 from the box's own values; per level > 0 the vertical
    pass from the box over the rows whose taps start in it, then the
    horizontal pass with the tap-major weights over its columns. Returns
    the buffer and how often each value was written."""
    bh, bw, halo_r, halo_c, n_rb, n_cb, v_words, h_words = plan.head
    words = plan.records.numpy()
    h, w = img.shape
    src = img
    if exposure_target is not None:
        mu, gain = (torch.tensor(v) for v in _grid_gain(img.numpy(), exposure_target, grid, geometry.threads))
        src = (img - mu) * gain + mu  # each staged value gained once
    out = torch.zeros(table.total)
    written = torch.zeros(table.total, dtype=torch.int64)

    def put(off, wl, r, j, values):
        for i, y in enumerate(r.tolist()):
            out[off + y * wl + j] = values[i]
            written[off + y * wl + j] += 1

    for b in range(grid):
        for item in range(b, n_rb * n_cb, grid):
            rb, cb = divmod(item, n_cb)
            r0, c0 = rb * bh, cb * bw
            rows, cols = min(bh + halo_r, h - r0), min(bw + halo_c, w - c0)
            assert rows <= geometry.buf_rows and cols <= geometry.buf_cols
            box = src[r0 : r0 + rows, c0 : c0 + cols].double()
            v_rec = words[rb * v_words : (rb + 1) * v_words]
            h_rec = words[n_rb * v_words + cb * h_words : n_rb * v_words + (cb + 1) * h_words]
            assert v_words + h_words <= geometry.rec_words
            off0 = plan.levels[0][0]
            own = torch.arange(r0, min(r0 + bh, h))
            put(off0, w, own, torch.arange(c0, min(c0 + bw, w)), box[: len(own), : min(bw, w - c0)].float())
            for off, hl, wl, tv, tw, v_at, rmax, h_at, cmax, t_at, t_cols in plan.levels[1:]:
                v, hr = v_rec[v_at:], h_rec[h_at:]
                nr, nj = int(v[1] - v[0]), int(hr[1] - hr[0])
                if nr == 0 or nj == 0:
                    continue
                vs = torch.from_numpy(v[2 : 2 + nr].astype(np.int64))
                vw = torch.from_numpy(v[2 + rmax : 2 + rmax + rmax * tv].view(np.float32).reshape(rmax, tv)).double()
                hs = torch.from_numpy(hr[2 : 2 + nj].astype(np.int64))
                hw = torch.from_numpy(hr[2 + cmax : 2 + cmax + tw * cmax].view(np.float32).reshape(tw, cmax)).double()
                assert bool(((vs >= r0) & (vs < r0 + bh)).all() and ((hs >= c0) & (hs < c0 + bw)).all())
                cw = int(hs[-1]) + tw - int(hs[0])
                assert nr <= rmax and cw <= t_cols and nj <= cmax <= -(-geometry.box_cols // 32) * 32
                t = torch.zeros((nr, cw))
                for k in range(tv):
                    t = _fma_f32(vw[:nr, k, None], box[vs - r0 + k, int(hs[0]) - c0 : int(hs[0]) - c0 + cw], t)
                acc = torch.zeros((nr, nj))
                for k in range(tw):
                    acc = _fma_f32(hw[k, :nj][None, :], t[:, hs - hs[0] + k].double(), acc)
                put(off, wl, torch.arange(int(v[0]), int(v[1])), torch.arange(int(hr[0]), int(hr[1])), acc)
    return out, written


@pytest.mark.parametrize("geometry", [pk.GEOMETRY, pk.Geometry(128, 8, 32, 14, 48, 1024, 512, 32, 1)],
                         ids=["shipped", "small"])
@pytest.mark.parametrize("size", [(160, 120), (179, 134)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_tiling_equals_twin(rng, size, geometry):
    """The kernel's plan and work list, walked on the CPU, give the twin's
    pyramid bit for bit, gain on and off, and write every value of every
    level exactly once (179x134: ragged boxes at every level; the small
    geometry shrinks the boxes until records and vertical passes fit)."""
    w, h = size
    img = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.float32))
    table = fk.level_table(_shapes(h, w))
    plan = pk._plan(h, w, table.shapes, table.offsets, "cpu", geometry)
    assert len(plan.c_table) == pk.HEAD + 11 * len(table.shapes)
    bh, bw = plan.head[:2]
    assert 1 <= bh <= geometry.box_rows and 1 <= bw <= geometry.box_cols
    # the levels' vertical passes lie side by side in the box's buffer, one (level, row) item each
    ends = [t_at + rmax * t_cols for *_, rmax, _, _, t_at, t_cols in plan.levels[1:]]
    assert [row[9] for row in plan.levels[2:]] == ends[:-1] and ends[-1] <= geometry.t_words
    assert sum(row[6] for row in plan.levels[1:]) <= geometry.items
    if geometry != pk.GEOMETRY:
        assert (bh, bw) < (geometry.box_rows, geometry.box_cols), plan.head
    for target in (None, 18.0):
        for grid in GRIDS:
            got, written = _kernel_on_cpu(img, table, plan, target, geometry, grid)
            ref = _pyramid_plain(img, table, target)
            for lvl, (a, b, c) in enumerate(zip(fk.level_views(got, table), fk.level_views(ref, table),
                                                fk.level_views(written, table))):
                assert torch.equal(a, b), (lvl, target, grid)
                assert bool((c == 1).all()), (lvl, target, grid)


def test_geometry_mirrors_the_kernel_source():
    """`pyramid_kernel.GEOMETRY` (what the CPU plans with) is the shipped
    kernel's compiled default, read from csrc/pyramid.cu."""
    src = (kernels.CSRC / "pyramid.cu").read_text()
    defaults = dict(re.findall(r"#define PYR_(\w+) (\d+)", src))
    defaults["ITEMS"] = re.search(r"constexpr int ITEMS = (\d+);", src).group(1)
    names = ("THREADS", "BOX_ROWS", "BOX_COLS", "BUF_ROWS", "BUF_COLS", "REC_WORDS", "T_WORDS", "ITEMS", "PART_COPIES")
    assert pk.Geometry(*(int(defaults[k]) for k in names)) == pk.GEOMETRY


def test_extractor_pyramid_is_the_twin():
    """ORBExtractor._pyramid on the CPU: the gain when normalize_exposure is
    on, then the twin's levels, in the table the frontend reads."""
    img = torch.from_numpy(_level_image("box", 120, 160))
    for on in (False, True):
        ext = ORBExtractor(n_features=200, normalize_exposure=on)
        buf, table = ext._pyramid(img)
        assert table == fk.level_table(_shapes(120, 160))
        ref = _pyramid_plain(img, table, 18.0 if on else None)
        for a, b in zip(fk.level_views(buf, table), fk.level_views(ref, table)):
            assert torch.equal(a, b), on
