"""Settings loader compatible with the reference's OpenCV-YAML files.

Counterpart of orbslam2commentedbyxcm_tpu/utils/config.py: the same keys,
defaults and `!!opencv-matrix` blocks, mapped onto the port's Camera and
TrackingConfig.

The reference reads camera/extractor/viewer settings via cv::FileStorage
(src/Tracking.cc:62-171). This loader accepts those exact files (they start
with a `%YAML:1.0` directive that standard YAML parsers reject) and maps the
keys — Camera.fx/fy/cx/cy/k1..k3/p1/p2/bf/fps/width/height, ThDepth,
DepthMapFactor, ORBextractor.nFeatures/scaleFactor/nLevels/iniThFAST/
minThFAST — onto (Camera, TrackingConfig).
"""

from __future__ import annotations

import re

import numpy as np

from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera


def parse_opencv_yaml(path: str) -> dict:
    """Minimal parser for flat `Key.Sub: value` OpenCV YAML settings files.

    Also handles `!!opencv-matrix` blocks (rows/cols/dt/data) as emitted by
    cv::FileStorage — the reference's stereo_euroc settings carry the
    LEFT.*/RIGHT.* rectification matrices in this form
    (README.md:207); they parse to (rows, cols) numpy arrays.
    """
    out: dict = {}
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].strip()
        i += 1
        if not line or line.startswith("%") or line.startswith("---"):
            continue
        m = re.match(r"([A-Za-z0-9_.]+)\s*:\s*(.+)", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip().strip('"')
        if val.startswith("!!opencv-matrix"):
            rows = cols = None
            data: list[float] = []
            in_data = False
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].strip()
                if in_data or sub.startswith("data"):
                    seg = sub.split(":", 1)[1] if ":" in sub and not in_data else sub
                    data.extend(
                        float(x) for x in re.findall(r"[-+0-9.eE]+", seg)
                    )
                    in_data = "]" not in sub
                    i += 1
                    if not in_data:
                        break
                elif sub.startswith("rows"):
                    rows = int(float(sub.split(":", 1)[1]))
                    i += 1
                elif sub.startswith("cols"):
                    cols = int(float(sub.split(":", 1)[1]))
                    i += 1
                elif sub.startswith("dt"):
                    i += 1
                else:
                    break
            if rows and cols and len(data) == rows * cols:
                out[key] = np.asarray(data, np.float64).reshape(rows, cols)
            continue
        try:
            out[key] = float(val)
        except ValueError:
            out[key] = val
    return out


def load_settings(path: str):
    """-> (Camera, TrackingConfig, raw dict)."""
    d = parse_opencv_yaml(path)

    def g(key, default=0.0):
        return float(d.get(key, default))

    def gb(key, default):
        """Boolean-flavored keys: accept true/false/on/off/yes/no strings
        (stored verbatim by parse_opencv_yaml) as well as 0/1 numbers."""
        v = d.get(key, default)
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "on", "yes")
        return bool(float(v))

    camera = Camera(
        fx=g("Camera.fx", 500.0), fy=g("Camera.fy", 500.0),
        cx=g("Camera.cx", 320.0), cy=g("Camera.cy", 240.0),
        k1=g("Camera.k1"), k2=g("Camera.k2"),
        p1=g("Camera.p1"), p2=g("Camera.p2"), k3=g("Camera.k3"),
        width=int(g("Camera.width", 640)), height=int(g("Camera.height", 480)),
        bf=g("Camera.bf"), fps=g("Camera.fps", 30.0),
        th_depth=g("ThDepth", 35.0),
    )
    cfg = TrackingConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        max_frames_between_kf=int(g("Camera.fps", 30.0)),
        depth_th=g("ThDepth", 35.0),
        # extension keys (not in reference YAMLs, default on): gain-normalize
        # images before FAST so exposure drift / contrast collapse does not
        # churn detection (ops/orb.py); exposureTargetMAD tunes the contrast
        # the frame is rescaled to (gain capped to [1/8, 8] in the extractor)
        normalize_exposure=gb("ORBextractor.normalizeExposure", 1.0),
        exposure_target_mad=g("ORBextractor.exposureTargetMAD", 18.0),
    )
    extra = {
        "depth_map_factor": g("DepthMapFactor", 5000.0),
        "ini_th_fast": g("ORBextractor.iniThFAST", 20.0),
        "min_th_fast": g("ORBextractor.minThFAST", 7.0),
        "rgb": int(g("Camera.RGB", 1)),
    }
    return camera, cfg, {**d, **extra}
