"""The port's gauntlet pieces (utils/gauntlet, utils/synth) against the JAX
package's (benchmarks/gauntlet.py, utils/synth.py).

BoxSequence's line, sway and eight trajectories give the JAX package's poses
bit for bit and its renders within a mean |d| < 1 gray level (the port warps
without cv2); `augment` is bit-equal to the JAX runner's `_augment` on the
same generator; `adjudicate_loops` classifies a stub map's keyframe pairs as
the JAX runner's does.

The mini-gauntlet (slow, as its JAX counterpart tests/test_mini_gauntlet.py)
runs the same perturbed sequences through the port's run_sequence with the
JAX tests' gates: orbit, forward and sway drift, and the figure-eight loop
closed with no false and no missed closure under both the synchronous and
the async pipeline (the JAX package gates the eight synchronously only). It
runs on the GPU when there is one, else on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks import gauntlet as jgauntlet
from orbslam2commentedbyxcm_tpu.utils import synth as jsynth
from orbslam2commentedbyxcm_tpu_torch.utils import gauntlet
from orbslam2commentedbyxcm_tpu_torch.utils import synth as tsynth
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera

torch.set_num_threads(1)

KW = {"line": dict(half_size=12.0), "sway": dict(turns=0.6, half_size=8.0, radius=2.0),
      "eight": dict(half_size=8.0, radius=2.0)}


@pytest.mark.parametrize("trajectory", ["line", "sway", "eight"])
def test_trajectories_match_jax(trajectory):
    cam_j, cam_t = jsynth.default_camera(160, 120), tsynth.default_camera(160, 120)
    n = 420 if trajectory == "eight" else 200
    seq_j = jsynth.BoxSequence(camera=cam_j, n_frames=n, trajectory=trajectory, **KW[trajectory])
    seq_t = tsynth.BoxSequence(camera=cam_t, n_frames=n, trajectory=trajectory, **KW[trajectory])
    for i in range(n):
        np.testing.assert_array_equal(seq_t.pose(i), seq_j.pose(i))
    for i in (0, n // 3, n - 1):
        diff = np.abs(seq_t.render(i) - seq_j.render(i))
        print(f"{trajectory} frame {i}: mean |d| {diff.mean():.4f}")
        assert diff.mean() < 1.0
        np.testing.assert_array_equal(seq_t.depth_map(i), seq_j.depth_map(i))


def test_unknown_trajectory_raises():
    with pytest.raises(ValueError, match="unknown trajectory"):
        tsynth.BoxSequence(camera=tsynth.default_camera(160, 120), trajectory="spiral")


@pytest.mark.parametrize("mode", ["full", "exposure", "occluder"])
def test_augment_matches_jax(mode):
    img = tsynth.BoxSequence(camera=tsynth.default_camera(160, 120), n_frames=50).render(7)
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    for i in (0, 13, 141, 777):
        got, ref = gauntlet.augment(img, i, rng_t, mode), jgauntlet._augment(img, i, rng_j, mode)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_adjudicate_loops_matches_jax():
    """A stub map on the figure-eight: a keyframe every 10 frames, chained by
    parent links and covisibility to the next two, plus one true loop edge
    (the re-entry into the first lobe) and one false one."""
    cam = tsynth.default_camera(160, 120)
    seq = tsynth.BoxSequence(camera=cam, n_frames=420, trajectory="eight", **KW["eight"])
    kfs = [SimpleNamespace(kf_id=k, timestamp=10 * k / 30.0, loop_edges=set(), covis={}, parent=k - 1 if k else None)
           for k in range(42)]
    for a in kfs:
        for b in kfs[a.kf_id + 1:a.kf_id + 3]:
            a.covis[b.kf_id] = b.covis[a.kf_id] = 50
    centers = np.stack([-seq.pose(10 * k)[:3, :3].T @ seq.pose(10 * k)[:3, 3] for k in range(42)])
    late = 38
    early = int(np.argmin(np.linalg.norm(centers[:10] - centers[late], axis=1)))
    for a, b in ((late, early), (30, 12)):
        kfs[a].loop_edges.add(b)
        kfs[b].loop_edges.add(a)
    system = SimpleNamespace(map=SimpleNamespace(good_keyframes=lambda: list(kfs)))
    got, ref = gauntlet.adjudicate_loops(system, seq), jgauntlet.adjudicate_loops(system, seq)
    print(got)
    assert got == ref
    assert got["loop_edge_hits"] == 1 and got["false_closures"] == 1 and got["missed"] > 0


def _cam():
    return Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0, th_depth=50.0)


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.fixture(scope="module")
def orbit_rec():
    return gauntlet.run_sequence("orbit", 250, augment=True, async_mapping=True, camera=_cam(), n_features=600,
                                 device=_device())


@pytest.fixture(scope="module")
def forward_rec():
    return gauntlet.run_sequence("forward", 200, augment=True, async_mapping=True, camera=_cam(), n_features=600,
                                 device=_device())


@pytest.fixture(scope="module")
def sway_rec():
    return gauntlet.run_sequence("sway", 250, augment=True, async_mapping=True, camera=_cam(), n_features=600,
                                 device=_device())


@pytest.fixture(scope="module", params=[False, True], ids=["sync", "async"])
def eight_rec(request):
    cam = Camera(fx=312.0, fy=312.0, cx=200.0, cy=150.0, width=400, height=300, bf=25.0, th_depth=50.0)
    return gauntlet.run_sequence("eight", 420, augment=True, async_mapping=request.param, camera=cam,
                                 n_features=900, device=_device())


@pytest.mark.slow
def test_orbit_tracks_closes_loop_and_drift_gate(orbit_rec):
    assert orbit_rec["tracked"] >= orbit_rec["frames"] - 5, orbit_rec
    assert orbit_rec["loops_closed"] >= 1, orbit_rec["loop_stats"]
    assert orbit_rec["drift_pct"] < 2.5, orbit_rec


@pytest.mark.slow
def test_forward_tracks_and_drift_gate(forward_rec):
    assert forward_rec["tracked"] >= forward_rec["frames"] - 5, forward_rec
    assert forward_rec["drift_pct"] < 3.0, forward_rec


@pytest.mark.slow
def test_sway_drift_gate_and_no_closure_needed(sway_rec):
    assert sway_rec["drift_pct"] < 3.5, sway_rec
    assert sway_rec["ate_rmse_m"] < 1.4, sway_rec
    gt = sway_rec["gt_loops"]
    assert gt["false_closures"] == 0 and gt["missed"] == 0, gt


@pytest.mark.slow
def test_eight_closes_loop_and_drift_gate(eight_rec):
    assert eight_rec["tracked"] >= eight_rec["frames"] - 5, eight_rec
    assert eight_rec["loops_closed"] >= 1, eight_rec["loop_stats"]
    gt = eight_rec["gt_loops"]
    assert gt["false_closures"] == 0 and gt["missed"] == 0, gt
    assert eight_rec["drift_pct"] < 0.8, eight_rec
