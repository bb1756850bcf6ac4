"""The one-launch pyramid frontend on the CPU: the level table that lays the
levels out in one flat buffer, the pyramid wrapper's CPU path, and the
extractor built on them.

The CUDA kernel's launcher (csrc/frontend.cu) covers each level of the table
with its tiles; the kernel itself is held to the twin on the card, every
level at the TUM1, EuRoC and KITTI sizes (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, _exposure_gain, _resize_pass

torch.set_num_threads(1)

# TUM1, EuRoC and KITTI image sizes (width, height)
SIZES = [(640, 480), (752, 480), (1241, 376)]


@pytest.mark.parametrize("n_levels", [1, 2, 8])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_level_table_covers_every_pixel_once(size, n_levels):
    """Every pixel of every level has one place in the flat buffer, each
    level starts on a 128-byte line, and only the padding between levels
    lies outside them."""
    w, h = size
    shapes = tuple((max(16, round(h / 1.2**l)), max(16, round(w / 1.2**l))) for l in range(n_levels))
    table = fk.level_table(shapes)
    assert table.shapes == shapes and list(table.c_rows) == [v for o, s in zip(table.offsets, shapes) for v in (o, *s)]
    cover = np.zeros(table.total, np.int32)
    for o, (a, b) in zip(table.offsets, shapes):
        assert o % fk.ALIGN == 0
        cover[o : o + a * b] += 1
    assert cover.max() == 1 and cover.sum() == sum(a * b for a, b in shapes)
    assert table.total - (table.offsets[-1] + shapes[-1][0] * shapes[-1][1]) < fk.ALIGN
    assert (np.diff([*table.offsets, table.total]) - [a * b for a, b in shapes] < fk.ALIGN).all()
    if n_levels == 8:  # the extractor lays its pyramid out by the same table
        buf, ext_table = ORBExtractor(n_features=1000)._pyramid(torch.zeros(h, w))
        assert ext_table == table and buf.shape == (table.total,)


def test_level_table_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        fk.level_table(((6, 100),))
    with pytest.raises(ValueError):
        fk.level_table(((32, 32),) * (fk.MAX_LEVELS + 1))
    table = fk.level_table(((32, 32),))
    with pytest.raises(ValueError):
        fk.fused_frontend_pyramid(torch.zeros(table.total + 1), table, 20.0, 7.0)
    with pytest.raises(ValueError):
        fk.fused_frontend_pyramid(torch.zeros(table.total, device="meta"), table, 20.0, 7.0)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_pyramid_wrapper_on_cpu_equals_plain_per_level(rng, kind):
    img = rng.integers(0, 256, (120, 160)) if kind == "uint8" else rng.uniform(0, 255, (120, 160))
    buf, table = ORBExtractor(n_features=200)._pyramid(torch.from_numpy(img.astype(np.float32)))
    before = (fk.fused_frontend_pyramid.launches, fk.fused_frontend.launches)
    out = fk.fused_frontend_pyramid(buf, table, 20.0, 7.0)
    assert (fk.fused_frontend_pyramid.launches, fk.fused_frontend.launches) == before
    assert out.shape == (3, table.total)
    n_corners = 0
    for lvl, (level, *maps) in enumerate(zip(fk.level_views(buf, table), *(fk.level_views(o, table) for o in out))):
        for name, got, ref in zip(("blurred", "nms_hi", "nms_lo"), maps, fk.fused_frontend_plain(level, 20.0, 7.0)):
            assert torch.equal(got, ref), (lvl, name)
        n_corners += int((maps[1] > 0).sum())
    assert n_corners > 50


def _per_level_extract(ext, img):
    """The extractor as it ran before its pyramid buffer: each level image a
    separate tensor (level 0 the image itself, level l its two resize passes
    of ops/orb), run through the single-level frontend and the per-level
    selection."""
    from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import descriptors_from_windows
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import FrameFeatures

    h, w = img.shape
    if ext.normalize_exposure:
        img = _exposure_gain(img, ext.exposure_target_mad)
    outs = []
    for lvl, s in enumerate(ext.scales):
        hl, wl = max(16, round(h / s)), max(16, round(w / s))
        level = img if lvl == 0 else _resize_pass(_resize_pass(img, hl), wl).contiguous()
        outs.append(ext._select_level(*fk.fused_frontend(level, ext.ini_th, ext.min_th), lvl))
    uv, resp, level, patches, valid = (torch.cat([o[i] for o in outs]) for i in range(5))
    desc, ang = descriptors_from_windows(patches, ext._pattern, ext._kmx, ext._kmy)
    return FrameFeatures(uv, resp, ang, level, desc, valid)


@pytest.mark.parametrize("normalize_exposure", [False, True])
def test_extractor_returns_the_per_level_features(rng, normalize_exposure):
    """Building the levels into one buffer and running the frontend once over
    it gives bit for bit the FrameFeatures of the per-level extractor."""
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    img = torch.from_numpy(BoxSequence(camera=default_camera(160, 120), seed=5, n_frames=100, turns=0.35).render(2))
    ext = ORBExtractor(n_features=300, normalize_exposure=normalize_exposure)
    got, ref = ext(img), _per_level_extract(ext, img.float())
    assert int(got.valid.sum()) > 100
    for name, a, b in zip(got._fields, got, ref):
        assert torch.equal(a, b), name
