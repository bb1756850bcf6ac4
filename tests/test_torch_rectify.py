"""The port's rectification (utils/rectify) against the JAX package's, bit
for bit, and against cv2 with tests/test_rectify.py's tolerances; the
shipped EuRoC.yaml builds its rectifier."""

import os

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.utils import rectify as jrect
from orbslam2commentedbyxcm_tpu.utils.config import load_settings as jload_settings
from orbslam2commentedbyxcm_tpu_torch.utils import rectify as trect
from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings, parse_opencv_yaml

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")

K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0, 0, 1.0]])
D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
P = np.array([[435.2, 0, 367.45, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0.0]])
SIZE = (188, 120)
EUROC = os.path.join(os.path.dirname(__file__), "..", "examples", "settings", "EuRoC.yaml")


def test_maps_and_remap_bit_equal_to_jax():
    mx, my = trect.build_undistort_rectify_map(K, D, R, P, SIZE)
    jx, jy = jrect.build_undistort_rectify_map(K, D, R, P, SIZE)
    np.testing.assert_array_equal(mx, jx)
    np.testing.assert_array_equal(my, jy)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (120, 188)).astype(np.float32)
    for fill in (0.0, 64.0):
        np.testing.assert_array_equal(trect.remap_bilinear(img, mx, my, fill),
                                      jrect.remap_bilinear(img, jx, jy, fill))
    xy = rng.uniform(-0.5, 0.5, (500, 2))
    np.testing.assert_array_equal(trect.distort_normalized(xy, D), jrect.distort_normalized(xy, D))
    np.testing.assert_array_equal(trect.undistort_normalized(xy, D), jrect.undistort_normalized(xy, D))
    assert np.allclose(trect.undistort_normalized(trect.distort_normalized(xy, D), D), xy, atol=1e-6)


def test_maps_and_remap_match_cv2():
    mx, my = trect.build_undistort_rectify_map(K, D, R, P, SIZE)
    cx, cy = cv2.initUndistortRectifyMap(K, D, R, P, SIZE, cv2.CV_32FC1)
    assert np.allclose(mx, cx, atol=2e-3) and np.allclose(my, cy, atol=2e-3)
    img = np.random.default_rng(0).uniform(0, 255, (120, 188)).astype(np.float32)
    ours = trect.remap_bilinear(img, mx, my)
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
    interior = (mx >= 1) & (mx < 187) & (my >= 1) & (my < 119)
    assert np.allclose(ours[interior], ref[interior], atol=0.51)


def test_shipped_euroc_yaml_builds_the_jax_rectifier():
    cam, _, raw = load_settings(EUROC)
    rect = trect.StereoRectifier.from_settings(raw)
    jrect_ = jrect.StereoRectifier.from_settings(jload_settings(EUROC)[2])
    assert rect is not None and rect.map_lx.shape == (480, 752)
    for name in ("map_lx", "map_ly", "map_rx", "map_ry"):
        np.testing.assert_array_equal(getattr(rect, name), getattr(jrect_, name), err_msg=name)
    assert np.isclose(raw["LEFT.P"][0, 0], cam.fx) and np.isclose(-raw["RIGHT.P"][0, 3], cam.bf)
    img = np.random.default_rng(1).uniform(0, 255, (480, 752)).astype(np.float32)
    np.testing.assert_array_equal(rect.rectify_left(img), jrect_.rectify_left(img))
    np.testing.assert_array_equal(rect.rectify_right(img), jrect_.rectify_right(img))
    assert trect.StereoRectifier.from_settings({"Camera.fx": 400.0}) is None
    with pytest.raises(ValueError, match="LEFT.width"):
        trect.StereoRectifier.from_settings({k: v for k, v in parse_opencv_yaml(EUROC).items()
                                             if not k.endswith(("width", "height"))})
