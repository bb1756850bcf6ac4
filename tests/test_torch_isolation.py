"""The port never imports JAX: every module of the package, one CPU tracking
step, three RGB-D frames through the System, the shipped vocabulary and three
monocular frames with place recognition, in a fresh interpreter."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import orbslam2commentedbyxcm_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
step, args = pkg.flagship(device="cpu", h=96, w=128, n_features=120, point_cap=128)
t_cw, n_inl = step(*args)
assert t_cw.shape == (4, 4) and bool(torch.isfinite(t_cw).all()), t_cw
from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence
cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35, tex_size=256)
slam = System(cam, Sensor.RGBD, config=TrackingConfig(n_features=300), enable_loop_closing=False,
              device="cpu")
poses = [slam.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) for i in range(3)]
assert all(p is not None and p.shape == (4, 4) for p in poses), poses
from orbslam2commentedbyxcm_tpu_torch.ops import bow
from orbslam2commentedbyxcm_tpu_torch.utils.synth import SyntheticSequence
voc = bow.bootstrap_vocabulary()
assert voc.n_words > 700000
mono = System(cam, Sensor.MONOCULAR, config=TrackingConfig(n_features=300), enable_loop_closing=False,
              device="cpu", vocabulary=voc)
mseq = SyntheticSequence(camera=cam, n_frames=30, trajectory="sideways", tex_size=256)
states = [(mono.track_monocular(mseq.render(i), i / 30.0), mono.get_tracking_state()) for i in range(3)]
assert states[-1][1].name in ("OK", "NOT_INITIALIZED"), states
bad = sorted(m for m in sys.modules if m in ("jax", "orbslam2commentedbyxcm_tpu")
             or m.startswith(("jax.", "jaxlib", "orbslam2commentedbyxcm_tpu.")))
print("JAX-MODULES:", bad)
assert not bad, bad
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX-MODULES: []" in proc.stdout
