"""The port's describe twin (ops/descriptors.describe_plain: patches read
from the flat blurred buffer, moments in a stated order, the port's float32
atan2, rotated BRIEF) against the JAX package's gather_windows +
descriptors_from_windows on the same level image and keypoints, at the bars
of tests/test_torch_orb.py: >= 99% of descriptors bit-equal, angles within
1e-5. And its parts: the atan2 against torch.atan2 and float64, the moment
order against a float64 sum and a numpy float32 walk of the stated order,
the reflect index, the pack order, the tables cached per extractor and
device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import orb as jorb
from orbslam2commentedbyxcm_tpu.ops.descriptors import descriptors_from_windows as j_desc
from orbslam2commentedbyxcm_tpu.ops.descriptors import gather_windows as j_gather
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.synth import default_camera as j_default_camera
from orbslam2commentedbyxcm_tpu_torch.ops import descriptors as D
from orbslam2commentedbyxcm_tpu_torch.ops import describe_kernel as dk
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, select_level
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps (signed zeros are 0 apart)."""
    def ordinal(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordinal(a) - ordinal(b))


def _atan2_grid(rng):
    """Random pairs over 20 binades, a grid through the axes and diagonals,
    signed zeros and |y| = |x|."""
    n = 100_000
    y = rng.normal(size=n) * np.exp(rng.uniform(-10, 10, n))
    x = rng.normal(size=n) * np.exp(rng.uniform(-10, 10, n))
    v = np.linspace(-3, 3, 121)
    gy, gx = np.meshgrid(v, v)
    s = np.array([0.0, -0.0, 1.0, -1.0, 2.5e-3, -7.0])
    zy, zx = np.meshgrid(s, s)
    d = rng.uniform(0.1, 10, 1000)
    ys = np.concatenate([y, gy.ravel(), zy.ravel(), d, -d, d, -d])
    xs = np.concatenate([x, gx.ravel(), zx.ravel(), d, d, -d, -d])
    return ys.astype(np.float32), xs.astype(np.float32)


def test_atan2_f32_within_ulps(rng):
    """Within 4 float32 steps of torch.atan2 and 3 of float64 atan2
    rounded, with IEEE's signed zeros and atan2(0, 0) = 0."""
    y, x = _atan2_grid(rng)
    got = D.atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref64 = np.arctan2(y.astype(np.float64), x.astype(np.float64)).astype(np.float32)
    ref = torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert _ulps(got, ref).max() <= 4
    assert _ulps(got, ref64).max() <= 3
    np.testing.assert_array_equal(np.signbit(got), np.signbit(ref64))  # the sign of every zero and pi
    z = torch.tensor([0.0])
    assert D.atan2_f32(z, z).item() == 0.0 and not np.signbit(D.atan2_f32(z, z).item())


def test_moments_follow_the_stated_order(rng):
    """The twin's moments equal a numpy float32 walk of the stated order
    (terms, halving trees over the rows of each column, then over the
    columns) bit for bit, and a float64 sum within the pairwise bound."""
    ext = ORBExtractor()
    tables = ext._descriptor_tables("cpu")
    patch = torch.from_numpy(rng.integers(0, 256, (64, 48, 48)).astype(np.float32)).to(torch.bfloat16).float()
    m10, m01 = D.moments(patch, tables)
    win = patch.numpy()[:, 9:40, 9:40]
    for k, got, mask in ((0, m10, ext._kmx), (1, m01, ext._kmy)):
        t = np.zeros((64, 32, 32), np.float32)
        t[:, :31, :31] = win * tables.moments[k].numpy()
        for axis in (1, 1):  # rows of each column, then (now axis 1) the columns
            while t.shape[axis] > 1:
                h = t.shape[axis] // 2
                t = np.take(t, range(h), axis) + np.take(t, range(h, 2 * h), axis)
            t = t.squeeze(axis)
        np.testing.assert_array_equal(got.numpy(), t)
        terms = patch.numpy().astype(np.float64) * mask.astype(np.float64)
        exact = terms.sum((1, 2))
        bound = 11 * 2.0**-24 * np.abs(terms).sum((1, 2))  # the products, and log2(1024) levels of sums
        assert (np.abs(got.numpy() - exact) <= bound).all()


def test_reflect_index_is_numpys():
    for n in (16, 17, 133):
        i = torch.arange(-24, n + 24)
        np.testing.assert_array_equal(D.reflect(i, torch.tensor(n)).numpy(),
                                      np.pad(np.arange(n), 24, mode="reflect"))


def test_pack_order():
    """Bit 32 w + b of a descriptor is bit b of word w (uint32 patterns)."""
    for b in (0, 1, 31, 32, 100, 255):
        bits = torch.zeros((1, 256), dtype=torch.bool)
        bits[0, b] = True
        words = convert.desc_to_numpy(D.pack_bits(bits))[0]
        want = np.zeros(8, np.uint32)
        want[b // 32] = np.uint32(1) << np.uint32(b % 32)
        np.testing.assert_array_equal(words, want)


def _level(kind, w, h, rng):
    if kind == "uint8":
        return rng.integers(0, 256, (h, w)).astype(np.float32)
    return JBoxSequence(camera=j_default_camera(w, h), seed=5, n_frames=100, turns=0.35).render(3)


@pytest.mark.parametrize("kind,w,h,lvl", [("uint8", 160, 120, 0), ("frame", 160, 120, 0), ("frame", 133, 100, 1),
                                          ("frame", 241, 83, 3)])
def test_describe_twin_matches_jax(kind, w, h, lvl, rng):
    """The same blurred level and keypoints through both packages: every
    selected slot, and on the noise image 200 random interior positions
    (every one of them corner-like). Held over the valid keypoints and those
    positions: a slot that selected nothing may sit on a flat region, where
    the moments vanish and the angle is ill-conditioned."""
    je = jorb.ORBExtractor(n_features=300, use_pallas=False)
    pe = convert.extractor_from_jax(je)
    img = torch.from_numpy(_level(kind, w, h, rng))
    blurred, nms_hi, nms_lo = fk.fused_frontend_plain(img, pe.ini_th, pe.min_th)
    px, py, _, valid = select_level(nms_hi, nms_lo, pe.budgets[lvl], pe.cell_size, pe.per_cell_k)
    if kind == "uint8":
        extra = 200
        px = torch.cat([px, torch.from_numpy(rng.integers(16, w - 16, extra))])
        py = torch.cat([py, torch.from_numpy(rng.integers(16, h - 16, extra))])
        valid = torch.cat([valid, torch.ones(extra, dtype=torch.bool)])
    n = len(px)
    uv, ang, level, desc = D.describe_plain(blurred.reshape(-1), fk.level_table(((h, w),)),
                                            torch.stack([px, py]).int(), [n], [pe.scales[lvl]],
                                            pe._descriptor_tables("cpu"))
    padded = jnp.pad(jnp.asarray(blurred.numpy()), jorb.EDGE_PAD, mode="reflect").astype(jnp.bfloat16)
    rows, off = j_gather(padded, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
    desc_j, ang_j = j_desc(rows, off, je._pattern, je._kmx, je._kmy)
    v = valid.numpy()
    assert v.sum() >= 20
    assert np.abs(ang.numpy()[v] - np.asarray(ang_j)[v]).max() <= 1e-5
    rate = float(np.mean(np.all(convert.desc_to_numpy(desc)[v] == np.asarray(desc_j)[v], axis=1)))
    print(f"{kind} {w}x{h}: {int(v.sum())} keypoints, descriptor bit-equality {rate:.4f}")
    assert rate >= 0.99
    scale = np.float32(pe.scales[lvl])
    np.testing.assert_array_equal(uv.numpy(), np.stack([px.numpy(), py.numpy()], 1).astype(np.float32) * scale)
    assert (level.numpy() == 0).all()  # one-level table


def test_describe_plain_levels_and_wrapper(rng):
    """Slots take their level from the budgets, read their own level of the
    buffer, and the wrapper runs the twin for CPU tensors (no launch)."""
    shapes = ((60, 80), (50, 67))
    table = fk.level_table(shapes)
    buf = torch.from_numpy(rng.integers(0, 256, table.total).astype(np.float32))
    tables = ORBExtractor()._descriptor_tables("cpu")
    pxy = torch.tensor([[20, 30, 40, 17, 25], [20, 25, 30, 18, 22]], dtype=torch.int32)
    budgets, scales = [3, 2], [1.0, 1.2]
    uv, ang, level, desc = D.describe_plain(buf, table, pxy, budgets, scales, tables)
    np.testing.assert_array_equal(level.numpy(), [0, 0, 0, 1, 1])
    for lvl, sl in ((0, slice(0, 3)), (1, slice(3, 5))):
        view = fk.level_views(buf, table)[lvl].reshape(-1)
        _, a1, _, d1 = D.describe_plain(view, fk.level_table((shapes[lvl],)), pxy[:, sl].contiguous(),
                                        [sl.stop - sl.start], [scales[lvl]], tables)
        assert torch.equal(ang[sl], a1) and torch.equal(desc[sl], d1)
    np.testing.assert_array_equal(uv[3:].numpy(), pxy[:, 3:].T.float().numpy() * np.float32(1.2))
    before = dk.describe_keypoints.launches
    got = dk.describe_keypoints(buf, table, pxy, budgets, scales, tables)
    assert dk.describe_keypoints.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, (uv, ang, level, desc)))


def test_descriptor_tables_uploaded_once(monkeypatch):
    """The pattern and moment windows are built once per extractor and
    device and reused by every later extraction."""
    from orbslam2commentedbyxcm_tpu_torch.ops import orb as orb_mod

    calls = []
    real = orb_mod.descriptor_tables
    monkeypatch.setattr(orb_mod, "descriptor_tables", lambda *a: calls.append(a[-1]) or real(*a))
    ext = ORBExtractor(n_features=200)
    img = torch.from_numpy(JBoxSequence(camera=j_default_camera(160, 120), seed=5, n_frames=100,
                                        turns=0.35).render(0))
    first = ext._descriptor_tables("cpu")
    ext(img)
    ext(img)
    assert len(calls) == 1 and ext._descriptor_tables(torch.device("cpu")) is first
    assert first.pattern.shape == (256, 4) and first.moments.shape == (2, 31, 31)
    np.testing.assert_array_equal(first.moments[0].numpy(), ext._kmx[9:40, 9:40])
