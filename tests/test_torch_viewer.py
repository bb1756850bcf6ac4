"""The port's viewer (utils/viewer): FrameDrawer / MapDrawer / Viewer
renders over the port's System, as tests/test_viewer.py does for the JAX
package, plus the threaded viewer beside the async pipeline, which reads the
trajectory under the map lock without draining it (the stated divergence)."""

import os

import torch

from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import SyntheticSequence
from orbslam2commentedbyxcm_tpu_torch.utils.viewer import Viewer, save_frame_overlay, save_map_plot

torch.set_num_threads(1)

CAM = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=25.0, th_depth=40.0)


def _run(tmp_path, threaded: bool, async_mapping: bool = False, n: int = 4):
    seq = SyntheticSequence(camera=CAM, n_frames=n, trajectory="sideways", tex_size=512)
    system = System(CAM, Sensor.RGBD, config=TrackingConfig(n_features=300), enable_loop_closing=False,
                    async_mapping=async_mapping, device="cpu")
    viewer = Viewer(system, str(tmp_path), every=2, threaded=threaded)
    for i in range(n):
        img = seq.render(i)
        system.track_rgbd(img, seq.depth_map(i), i / 30.0)
        viewer.update(system.tracking.last_frame, image=img)
    return system, viewer


def test_viewer_emits_renders(tmp_path):
    system, viewer = _run(tmp_path, threaded=False)
    pngs = sorted(os.listdir(tmp_path))
    assert any(p.startswith("map_") for p in pngs), pngs
    assert any(p.startswith("frame_") for p in pngs), pngs
    info = viewer.frame_drawer.text_info()
    assert "KFs:" in info and "MPs:" in info and info.startswith("OK")
    save_map_plot(system, str(tmp_path / "final.png"))
    save_frame_overlay(system.tracking.last_frame, str(tmp_path / "overlay.png"))
    assert os.path.getsize(tmp_path / "final.png") > 1000 and os.path.getsize(tmp_path / "overlay.png") > 1000
    system.shutdown()


def test_threaded_viewer_renders_off_thread(tmp_path):
    """Reference Viewer thread parity (src/System.cc:121): rendering runs on
    its own worker; update() never blocks, shutdown() drains."""
    system, viewer = _run(tmp_path, threaded=True)
    assert viewer._thread.is_alive()
    viewer.shutdown()
    assert not viewer._thread.is_alive()
    pngs = sorted(os.listdir(tmp_path))
    assert any(p.startswith("map_") for p in pngs), pngs
    system.shutdown()


def test_threaded_viewer_beside_async_pipeline(tmp_path):
    """The render worker holds the map lock; the mapping worker needs it, so
    a render that drained the pipeline under the lock would wait forever."""
    system, viewer = _run(tmp_path, threaded=True, async_mapping=True, n=6)
    viewer.shutdown()
    assert not viewer._thread.is_alive()
    system.shutdown()
    assert sum(p.startswith("map_") for p in os.listdir(tmp_path)) >= 1
