"""The port's stereo search against the JAX package's on rectified BoxSequence
pairs at 320x240.

Both searches get the same features (the JAX extractor's, converted), so the
comparison isolates `stereo_match`. The images are rounded to integers, as
8-bit data are: the JAX package's SAD windows go through a bf16 one-hot
contraction that is exact only for integer-valued pixels, while the port sums
the unrounded float32 pixels."""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import orb as jorb
from orbslam2commentedbyxcm_tpu.ops import stereo as jstereo
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.ops import stereo as tstereo
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)


@pytest.fixture(scope="module")
def scene():
    return JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35), jorb.ORBExtractor(n_features=600, use_pallas=False)


@pytest.mark.parametrize("frame", [0, 13, 27])
def test_stereo_match_equals_jax(scene, frame):
    seq, ext = scene
    left, right = np.round(seq.render(frame)), np.round(seq.render_right(frame))
    lf, rf = ext(left.astype(np.float32)), ext(right.astype(np.float32))
    scales = (1.2 ** np.arange(8)).astype(np.float32)
    ur_j, disp_j, ok_j = (np.asarray(a) for a in jstereo.stereo_match(
        lf.uv, lf.desc, lf.level, lf.valid, rf.uv, rf.desc, rf.level, rf.valid,
        left.astype(np.float32), right.astype(np.float32), scales, 0.0, CAM.fx))
    tl, tr = convert.features_from_numpy(lf), convert.features_from_numpy(rf)
    ur_t, disp_t, ok_t = (a.numpy() for a in tstereo.stereo_match(
        tl.uv, tl.desc, tl.level, tl.valid, tr.uv, tr.desc, tr.level, tr.valid,
        torch.from_numpy(left.astype(np.float32)), torch.from_numpy(right.astype(np.float32)),
        torch.from_numpy(scales), 0.0, CAM.fx))
    print(f"frame {frame}: {ok_j.sum()} stereo matches of {int(np.asarray(lf.valid).sum())}")
    assert ok_j.sum() > 150
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(ur_t[ok_j], ur_j[ok_j], atol=1e-4, rtol=0)
    np.testing.assert_allclose(disp_t[ok_j], disp_j[ok_j], atol=1e-4, rtol=0)
    # the matched disparities put the walls 6-10 m away (b = 8 cm)
    depth = CAM.bf / disp_t[ok_t]
    assert np.median(depth) > 4.0 and np.median(depth) < 12.0


def test_median_filter_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 8, 100):
        x = rng.integers(0, 500, 120).astype(np.float32)
        keep = np.zeros(120, bool)
        keep[rng.choice(120, n, replace=False)] = True
        got = float(tstereo._median(torch.from_numpy(x), torch.from_numpy(keep)))
        assert got == (float(np.median(x[keep])) if n else 0.0)
