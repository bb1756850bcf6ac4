"""The port's settings loader (utils/config) against the JAX package's on
every shipped settings file: the same raw dict (matrices array_equal), the
same Camera and the same TrackingConfig fields."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.utils import config as jconfig
from orbslam2commentedbyxcm_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

SETTINGS = sorted((Path(__file__).resolve().parent.parent / "examples" / "settings").glob("*.yaml"))


def _assert_same_dict(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert isinstance(b[key], np.ndarray) and a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert type(a[key]) is type(b[key]) and a[key] == b[key], key


def test_every_settings_file_is_found():
    assert len(SETTINGS) >= 7, SETTINGS


@pytest.mark.parametrize("path", SETTINGS, ids=lambda p: p.name)
def test_settings_match_jax(path):
    _assert_same_dict(jconfig.parse_opencv_yaml(str(path)), tconfig.parse_opencv_yaml(str(path)))
    jcam, jcfg, jraw = jconfig.load_settings(str(path))
    tcam, tcfg, traw = tconfig.load_settings(str(path))
    _assert_same_dict(jraw, traw)
    assert dataclasses.asdict(jcam) == dataclasses.asdict(tcam)
    jfields = dataclasses.asdict(jcfg)
    tfields = dataclasses.asdict(tcfg)
    shared = jfields.keys() & tfields.keys()
    assert {"n_features", "scale_factor", "n_levels", "max_frames_between_kf", "depth_th",
            "normalize_exposure", "exposure_target_mad"} <= shared
    assert {k: jfields[k] for k in shared} == {k: tfields[k] for k in shared}


def test_extension_keys_and_matrix_blocks(tmp_path):
    """The boolean spellings of normalizeExposure, exposureTargetMAD and an
    !!opencv-matrix block split over lines, in both loaders."""
    text = """%YAML:1.0
Camera.fx: 400.0
Camera.width: 320
Camera.height: 240
ORBextractor.normalizeExposure: {flag}
ORBextractor.exposureTargetMAD: 24.5
M.K: !!opencv-matrix
   rows: 2
   cols: 3
   dt: d
   data: [1.0, -2.5e-3, 3,
          4, 5.25, 6e2]
"""
    for flag, want in (("false", False), ("on", True), ("0", False), ("1.0", True)):
        path = tmp_path / f"s_{flag}.yaml"
        path.write_text(text.format(flag=flag))
        jcam, jcfg, jraw = jconfig.load_settings(str(path))
        tcam, tcfg, traw = tconfig.load_settings(str(path))
        assert tcfg.normalize_exposure is want and jcfg.normalize_exposure is want
        assert tcfg.exposure_target_mad == 24.5
        _assert_same_dict(jraw, traw)
        np.testing.assert_array_equal(traw["M.K"], [[1.0, -2.5e-3, 3], [4, 5.25, 6e2]])
        assert dataclasses.asdict(jcam) == dataclasses.asdict(tcam)
