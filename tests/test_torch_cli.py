"""The port's command-line entry points (cli/run_dataset, run_synthetic,
run_video), driven in-process on the CPU: a dataset on disk through the
readers, the Prefetcher, the System, the trajectory writers and the ATE;
the synthetic run; video through cv2. The three 90-frame dataset runs of
tests/test_datasets_e2e.py are held to the JAX CLI's ATE on the same files
(slow, as their JAX counterparts: ~2-2.5 min each on one CPU thread)."""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.cli import run_dataset, run_synthetic, run_video
from orbslam2commentedbyxcm_tpu_torch.utils import dataset_writers
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, SyntheticSequence

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _camera(bf=80.0):
    # tests/test_datasets_e2e.py's camera: bf puts the box's walls inside
    # ThDepth x baseline, so the close-point keyframe rule can fire
    return Camera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=bf, fps=30.0)


def _main(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    assert rc == 0, buf.getvalue()[-3000:]
    return buf.getvalue()


def _ate_cm(stdout: str) -> float:
    m = re.search(r"ATE RMSE: ([0-9.]+) cm", stdout)
    assert m, "no ATE printed:\n" + stdout[-2000:]
    return float(m.group(1))


def _tracked(stdout: str):
    m = re.search(r"tracked (\d+)/(\d+) frames", stdout)
    assert m, stdout[-2000:]
    return int(m.group(1)), int(m.group(2))


def test_run_dataset_tum_on_cpu(tmp_path):
    """20 frames of tests/test_datasets_e2e.py's TUM sequence, with the
    tracer: tracked count, the ATE gate of that test, both TUM trajectory
    files and the trace."""
    seq = BoxSequence(camera=_camera(), n_frames=90, seed=11, turns=0.35, tex_size=512)
    settings = dataset_writers.write_tum_rgbd(str(tmp_path), seq, 20)
    trace = str(tmp_path / "trace.jsonl")
    out = _main(run_dataset.main, ["tum", str(tmp_path), settings, "--device", "cpu", "--no-loop-closing",
                                   "--out-prefix", str(tmp_path) + "/", "--trace", trace])
    tracked, total = _tracked(out)
    assert total == 20 and tracked >= total - 2, out[-1500:]
    assert _ate_cm(out) < 8.0, out[-1500:]
    traj = np.loadtxt(str(tmp_path / "CameraTrajectory.txt"))
    assert traj.shape[1] == 8 and len(traj) >= tracked - 5
    kf = np.loadtxt(str(tmp_path / "KeyFrameTrajectory.txt"), ndmin=2)
    assert kf.shape[1] == 8 and len(kf) >= 1
    assert "trace written to" in out and sum(1 for _ in open(trace)) == total + 1


def test_run_dataset_defaults_to_the_card(tmp_path):
    """Without --device the System is asked for cuda, which raises where no
    card is present (no CPU fallback)."""
    seq = BoxSequence(camera=_camera(), n_frames=90, seed=11, turns=0.35, tex_size=256)
    settings = dataset_writers.write_tum_rgbd(str(tmp_path), seq, 1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_dataset.main(["tum", str(tmp_path), settings])


def test_run_synthetic_rgbd_on_cpu(tmp_path):
    out = _main(run_synthetic.main, ["--sensor", "rgbd", "--frames", "8", "--n-features", "300",
                                     "--device", "cpu", "--save-traj", str(tmp_path / "t.txt"),
                                     "--viewer", str(tmp_path / "map.png")])
    m = re.search(r"tracked (\d+)/8 frames \| ATE RMSE ([0-9.]+) cm \(SE3 aligned\)", out)
    assert m and int(m.group(1)) == 8 and float(m.group(2)) < 5.0, out[-1500:]
    assert np.loadtxt(str(tmp_path / "t.txt")).shape == (8, 8)
    assert os.path.getsize(tmp_path / "map.png") > 1000


SETTINGS = """%YAML:1.0
Camera.fx: 250.0
Camera.fy: 250.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 30.0
Camera.bf: 20.0
Camera.RGB: 1
ThDepth: 40.0
ORBextractor.nFeatures: 400
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_run_video_tracks_and_saves_trajectory(tmp_path):
    """tests/test_video_example.py's run through the port, in-process (the
    JAX test is slow for its subprocess and JAX's compiles; this takes a few
    seconds)."""
    cv2 = pytest.importorskip("cv2")
    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
    seq = SyntheticSequence(camera=cam, n_frames=14, trajectory="sideways")
    video = str(tmp_path / "seq.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (320, 240), isColor=False)
    if not wr.isOpened():
        pytest.skip("cv2 VideoWriter unavailable (no MJPG codec)")
    for i in range(seq.n_frames):
        wr.write(seq.render(i).astype(np.uint8))
    wr.release()
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS)
    _main(run_video.main, [video, str(settings), "--no-loop-closing", "--device", "cpu",
                           "--out-prefix", str(tmp_path) + os.sep])
    traj = np.loadtxt(tmp_path / "CameraTrajectory.txt")
    assert traj.shape[0] >= 6 and traj.shape[1] == 8
    assert np.loadtxt(tmp_path / "KeyFrameTrajectory.txt").size >= 8


def test_run_video_names_cv2_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    with pytest.raises(ImportError, match="cv2"):
        run_video.main([str(tmp_path / "v.avi"), str(tmp_path / "s.yaml"), "--device", "cpu"])


# -- the three 90-frame runs of tests/test_datasets_e2e.py, port vs JAX CLI --

N_FRAMES = 90


def _jax_cli(args) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples", "run_dataset.py"), *args],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _port_vs_jax(tmp_path, fmt, seq, write, args, gate_cm):
    settings = write(str(tmp_path), seq, N_FRAMES)
    argv = [fmt, str(tmp_path), *args, settings]
    jax_out = _jax_cli([*argv, "--out-prefix", str(tmp_path) + "/jax_"])
    out = _main(run_dataset.main, [*argv, "--device", "cpu", "--out-prefix", str(tmp_path) + "/"])
    tracked, total = _tracked(out)
    assert tracked >= total - 2, out[-1500:]
    ate, jax_ate = _ate_cm(out), _ate_cm(jax_out)
    assert ate < gate_cm, out[-1500:]
    # the port's accuracy bound: 1.5 x the JAX package's ATE + 1 cm
    assert ate <= 1.5 * jax_ate + 1.0, (ate, jax_ate)
    traj = np.loadtxt(str(tmp_path / "CameraTrajectory.txt"))
    assert traj.shape[1] == 8 and len(traj) >= tracked - 5
    return out


@pytest.mark.slow
def test_tum_rgbd_on_disk_vs_jax(tmp_path):
    seq = BoxSequence(camera=_camera(), n_frames=N_FRAMES, seed=11, turns=0.35)
    _port_vs_jax(tmp_path, "tum", seq, dataset_writers.write_tum_rgbd, [], 8.0)


@pytest.mark.slow
def test_kitti_stereo_on_disk_vs_jax(tmp_path):
    seq = BoxSequence(camera=_camera(), n_frames=N_FRAMES, seed=12, trajectory="line")
    _port_vs_jax(tmp_path, "kitti", seq, dataset_writers.write_kitti, ["00"], 16.0)


@pytest.mark.slow
def test_euroc_unrectified_stereo_on_disk_vs_jax(tmp_path):
    seq = BoxSequence(camera=_camera(), n_frames=N_FRAMES, seed=13, turns=0.3)
    out = _port_vs_jax(tmp_path, "euroc", seq,
                       lambda root, s, n: dataset_writers.write_euroc(root, s, n, distorted=True), [], 20.0)
    assert "rectification maps built" in out
