"""The frozen bound arithmetic (bounds.py) against chip_smoke.py's, from
which it was copied, on chip_smoke's 640x480 kernel frame: BoxSequence seed 5, frame 0,
1000 features, gain on."""

import numpy as np
import pytest
import torch

import chip_smoke
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, select_plain
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera
from slambench import bounds
from slambench.reference import orb


@pytest.fixture(scope="module")
def frame():
    img = BoxSequence(camera=default_camera(640, 480), seed=5, n_frames=100, turns=0.35).render(0)
    ext = ORBExtractor(n_features=1000, normalize_exposure=True)
    ref = orb.Extractor(1000, 1.2, 8, 20.0, 7.0, ext.exposure_target_mad)
    feats, stages = ref.extract(img)
    return img, ext, ref, stages


def test_stages_are_the_ports(frame):
    img, ext, _, stages = frame
    buf, table = ext._pyramid(torch.from_numpy(img))
    assert table.shapes == stages.table.shapes and table.offsets == stages.table.offsets
    for a, b in zip(fk.level_views(buf, table), stages.levels):
        assert torch.equal(a, b)
    maps = fk.fused_frontend_pyramid(buf, table, ext.ini_th, ext.min_th)
    for a, b in zip(maps, stages.maps):  # level by level: the padding between levels is never written
        for la, lb in zip(fk.level_views(a, table), orb.level_views(b, stages.table)):
            assert torch.equal(la, lb)
    pxy, _, _ = select_plain(maps, table, ext.budgets, ext.cell_size, ext.per_cell_k)
    assert torch.equal(pxy, stages.pxy)


def test_bounds_are_chip_smokes(frame):
    img, ext, _, st = frame
    buf, table = ext._pyramid(torch.from_numpy(img))
    levels = fk.level_views(buf, table)
    maps = fk.fused_frontend_pyramid(buf, table, ext.ini_th, ext.min_th)
    pxy, _, _ = select_plain(maps, table, ext.budgets, ext.cell_size, ext.per_cell_k)
    h, w = img.shape
    n_px = sum(a * b for a, b in table.shapes)
    want_pyr = chip_smoke._bound(chip_smoke.pyramid_ops(h, w, table, True), 4 * (h * w + n_px))[0] * 1e-3
    want_k1 = chip_smoke._bound(chip_smoke.k1_ops(levels, 7.0), 16 * n_px)[0] * 1e-3
    want_sel = chip_smoke.select_bound(table, maps, ext.budgets, ext.cell_size, ext.per_cell_k)[0] * 1e-3
    want_desc = chip_smoke.describe_bound(table, maps[0], pxy, ext.budgets)[0] * 1e-3
    assert bounds.pyramid(st, True) == pytest.approx(want_pyr, rel=1e-12)
    assert bounds.k1(st, 7.0) == pytest.approx(want_k1, rel=1e-12)
    assert bounds.select(st, ext.budgets) == pytest.approx(want_sel, rel=1e-12)
    assert bounds.describe(st, ext.budgets) == pytest.approx(want_desc, rel=1e-12)


def test_bounds_as_pr13_measured_them(frame):
    """PERF.md's kernel table: pyramid 1.50 us, select 0.98 us,
    describe 1.04 us on this frame, each bound by bytes."""
    _, ext, _, st = frame
    assert round(bounds.pyramid(st, True) * 1e6, 2) == 1.50
    assert round(bounds.select(st, ext.budgets) * 1e6, 2) == 0.98
    assert round(bounds.describe(st, ext.budgets) * 1e6, 2) == 1.04


def test_k2_bound_counts_the_problem_not_the_kernel():
    """4 rounds x (1 + 10) evaluations of every active edge, whatever the
    kernel did; bytes of every slot once."""
    one = bounds.k2(500, 1000)
    ops = 260 * 44 * 500 + 40 * 5 * 500 + 650 * 40
    assert one == pytest.approx(max(ops / 67e12, (64 + 29 * 1000 + 72 + 1000) / 3.35e12))
    assert bounds.k2(1000, 1000) > one
