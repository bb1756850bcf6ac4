"""Tests of the benchmark harness, on the CPU at small sizes; `cuda`-marked
tests run the harness on the card and skip without one.

    python -m pytest slambench/tests -q
"""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

# the cells at a size a test run holds: half the published widths, 10 Hz,
# 400 features, 512-texel walls
SMALL = {"tum3_rgbd": (320, 240, 0.5)}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make_small_root(dst: Path) -> Path:
    """A checkout-shaped directory holding BENCHMARK.json and the
    benchmark's data files, the configurations cut to a CPU test's size."""
    (dst / "slambench").mkdir(parents=True)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "slambench" / d, dst / "slambench" / d)
    shutil.copy(ROOT / "slambench" / "limits.json", dst / "slambench" / "limits.json")
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, (w, h, scale) in SMALL.items():
        yaml = dst / "slambench" / "configs" / f"{name}.yaml"
        text = yaml.read_text()
        for key in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.bf"):
            value = float(re.search(rf"^{re.escape(key)}:\s*([-0-9.e]+)", text, re.M).group(1))
            text = re.sub(rf"^{re.escape(key)}:.*$", f"{key}: {value * scale}", text, flags=re.M)
        for key, value in (("Camera.width", w), ("Camera.height", h), ("Camera.fps", 10.0),
                           ("ORBextractor.nFeatures", 400)):
            text = re.sub(rf"^{re.escape(key)}:.*$", f"{key}: {value}", text, flags=re.M)
        yaml.write_text(text)
        conf = yaml.with_suffix(".json")
        c = json.loads(conf.read_text())
        c["scene"].update(tex_size=512, n_blobs=1000)
        conf.write_text(json.dumps(c))
    for mix in (dst / "slambench" / "traffic").glob("*.json"):
        t = json.loads(mix.read_text())
        t.update(warmup_s=1.0, sample_frames=1000)  # every frame of a short window on the CPU
        if "premap_s" in t:
            t["premap_s"] = 2.0
        mix.write_text(json.dumps(t))
    return dst


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(tmp_path / "checkout")
