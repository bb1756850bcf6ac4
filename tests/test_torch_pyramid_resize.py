"""The extractor's exposure gain and pyramid resize on the CPU: the tap
tables, the float32 fused multiply-add the twin emulates, the fixed-order
tree sums of the gain, the tile arithmetic of csrc/pyramid.cu, and the
twin's distance from the JAX package's level images.

The twin (ops/orb.py `_pyramid_plain`) is the function the CUDA kernel
computes bit for bit; tests/test_torch_kernels_cuda.py holds the kernel to
it on the card. Against the JAX package no order of the twin's can match
XLA's dot and mean, so that comparison counts differing pixels.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.synth import default_camera as j_default_camera
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


def _kernel_on_cpu(img, table, pack, exposure_target):
    """csrc/pyramid.cu's tile loop in torch, from the packed tables: for each
    tile of RB x CW outputs, the vertical pass over the input columns its
    window covers, then the horizontal pass from that window."""
    starts, weights, rows, max_win = pack
    starts, weights = starts.long(), weights.double()
    rb, cw = 8, pk.TILE_COLS
    h, w = img.shape
    src = _exposure_gain(img, exposure_target) if exposure_target is not None else img
    out = torch.zeros(table.total)
    rows = np.asarray(list(rows)).reshape(-1, 9)
    for off, hl, wl, tv, tw, vs, vw, hs, hw in rows.tolist():
        dst = out[off : off + hl * wl].view(hl, wl)
        if tv == 0:
            dst.copy_(src)
            continue
        v_start, v_w = starts[vs : vs + hl], weights[vw : vw + hl * tv].view(hl, tv)
        h_start, h_w = starts[hs : hs + wl], weights[hw : hw + wl * tw].view(wl, tw)
        for r0 in range(0, hl, rb):
            r = torch.arange(r0, min(r0 + rb, hl))
            for j0 in range(0, wl, cw):
                j = torch.arange(j0, min(j0 + cw, wl))
                c_lo = int(h_start[j0])
                win = int(h_start[j[-1]]) + tw - c_lo
                assert win <= max_win
                t = torch.zeros((len(r), win))
                for k in range(tv):
                    x = src[v_start[r] + k][:, c_lo : c_lo + win].double()
                    t = _fma_f32(v_w[r, k, None], x, t)
                acc = torch.zeros((len(r), len(j)))
                for k in range(tw):
                    acc = _fma_f32(h_w[j, k][None, :], t[:, h_start[j] - c_lo + k].double(), acc)
                dst[r0 : r0 + len(r), j0 : j0 + len(j)] = acc
    return out


@pytest.mark.parametrize("size", [(160, 120), (179, 134)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_tiling_equals_twin(rng, size):
    """The packed tables and the kernel's tile windows, walked on the CPU,
    give the twin's pyramid bit for bit, gain on and off (179x134: ragged
    tiles at every level)."""
    w, h = size
    img = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.float32))
    table = fk.level_table(_shapes(h, w))
    pack = pk._tap_pack(h, w, table.shapes, table.offsets, "cpu")
    assert len(pack[2]) == 9 * len(table.shapes)
    for target in (None, 18.0):
        got = _kernel_on_cpu(img, table, pack, target)
        ref = _pyramid_plain(img, table, target)
        for lvl, (a, b) in enumerate(zip(fk.level_views(got, table), fk.level_views(ref, table))):
            assert torch.equal(a, b), (lvl, target)


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
