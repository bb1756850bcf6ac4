"""The port never imports JAX: every module of the package, one CPU tracking
step, three RGB-D frames through the System, the shipped vocabulary and three
monocular frames with place recognition, a loop-closing RGB-D System, a
small trained vocabulary and a TUM dataset on disk through
cli.run_dataset, in a fresh interpreter. The dataset path (settings, PNG
codec, rectification, readers, CLI) loads no cv2, PIL or matplotlib either:
the port decodes images itself and depends on none of them."""

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
loop = System(cam, Sensor.RGBD, config=TrackingConfig(n_features=300), device="cpu", vocabulary=voc)
poses = [loop.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) for i in range(2)]
assert all(p is not None for p in poses) and loop.local_mapping.loop_closer is loop.loop_closing
loop.shutdown()
import numpy as np
small = bow.train_vocabulary(np.random.default_rng(0).integers(0, 2**32, (600, 8), dtype=np.uint32), k=4, depth=2,
                             device="cpu")
assert small.n_words > 4
import tempfile
from orbslam2commentedbyxcm_tpu_torch.cli import run_dataset
from orbslam2commentedbyxcm_tpu_torch.utils import dataset_writers
root = tempfile.mkdtemp()
tiny = Camera(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120, bf=40.0)
settings = dataset_writers.write_tum_rgbd(root, BoxSequence(camera=tiny, seed=11, n_frames=90, turns=0.35,
                                                            tex_size=256), 3)
assert run_dataset.main(["tum", root, settings, "--device", "cpu", "--no-loop-closing",
                         "--out-prefix", root + "/"]) == 0
assert len(np.loadtxt(root + "/CameraTrajectory.txt", ndmin=2)) == 3
bad = sorted(m for m in sys.modules if m in ("jax", "orbslam2commentedbyxcm_tpu")
             or m.startswith(("jax.", "jaxlib", "orbslam2commentedbyxcm_tpu.")))
print("JAX-MODULES:", bad)
assert not bad, bad
image_libs = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL", "matplotlib"))
print("IMAGE-MODULES:", image_libs)
assert not image_libs, image_libs
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX-MODULES: []" in proc.stdout
    assert "IMAGE-MODULES: []" in proc.stdout
