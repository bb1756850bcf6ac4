"""The benchmark's renderer against the port's numpy BoxSequence (the scene
it copies), on the same textures and poses, at a small size."""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence
from slambench import scene

CAM = Camera(fx=200.0, fy=201.0, cx=80.3, cy=60.1, width=160, height=120, bf=20.0)
K = np.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1.0]])
PATHS = {
    "orbit": {"trajectory": "orbit", "radius_m": 1.0, "speed_m_s": 0.25, "bob_m": 0.1, "bob_period_s": 12.566},
    "eight": {"trajectory": "eight", "radius_m": 0.75, "speed_m_s": 0.4, "bob_m": 0.1, "bob_period_s": 11.781},
    "sweep": {"trajectory": "sweep", "radius_m": 1.0, "center_deg": 45.0, "amplitude_deg": 30.0,
              "peak_rate_deg_s": 14.324, "bob_m": 0.1, "bob_period_s": 13.1595},
}


@pytest.fixture(scope="module")
def twins():
    sc = scene.Scene(3.0, 256, 300, seed=2**31 + 17, device="cpu")
    seq = BoxSequence(camera=CAM, half_size=3.0, tex_size=256, seed=0)
    seq.walls = [(c, e1, e2, sc.textures[i].numpy()) for i, (c, e1, e2, _) in enumerate(seq.walls)]
    return sc, seq


@pytest.mark.parametrize("kind", sorted(PATHS))
@pytest.mark.parametrize("t", [0.0, 3.7, 11.0, 26.5])
def test_render_matches_box_sequence(twins, kind, t):
    sc, seq = twins
    pose = scene.Path(PATHS[kind]).pose(t)
    img, depth = sc.render(torch.as_tensor(pose[None]), K, CAM.width, CAM.height)
    ref = seq.render_pose(pose)
    diff = np.abs(img[0].numpy() - ref)
    # both sample the texture on OpenCV's 1/32 grid; the homography and the
    # ray give the position by different float64 roundings, which can put
    # a pixel on the next grid step
    assert (diff < 1e-3).mean() > 0.995
    assert diff.max() < 16.0
    seq.pose = lambda i: pose.astype(np.float32)
    ref_d = seq.depth_map(0)
    got_d = depth[0].numpy()
    assert np.array_equal(np.isfinite(got_d), np.isfinite(ref_d))
    fin = np.isfinite(ref_d)
    np.testing.assert_allclose(got_d[fin], ref_d[fin], rtol=2e-5)


def test_textures_come_from_the_seed_alone():
    a = scene.make_textures(4, 128, 200, 2**31 + 5, "cpu")
    b = scene.make_textures(4, 128, 200, 2**31 + 5, "cpu")
    c = scene.make_textures(4, 128, 200, 2**31 + 6, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 10.0 and float(a.max()) <= 250.0
    assert float((a == 96.0).float().mean()) > 0.05  # the base grey shows between blobs


def test_last_blob_wins_and_the_seed_deals_the_values():
    """The blobs are painted in order, a texel covered by several taking the
    last one's value (BoxSequence's _make_texture loop); the seed only
    permutes which blob gets which value."""
    tex = scene.make_textures(1, 64, 30, 3, "cpu")[0]
    g = torch.Generator().manual_seed(scene.BLOB_SEED)
    ys = torch.randint(0, 48, (1, 30), generator=g)
    xs = torch.randint(0, 48, (1, 30), generator=g)
    hs = torch.randint(3, 14, (1, 30), generator=g)
    ws = torch.randint(3, 14, (1, 30), generator=g)
    vals = 10.0 + 240.0 * torch.rand((1, 30), generator=g)
    g.manual_seed(3)
    vals = vals[0, torch.argsort(torch.rand((1, 30), generator=g), dim=1)[0]]
    ref = torch.full((64, 64), 96.0, dtype=torch.float64)
    for y, x, h, w, v in zip(ys[0], xs[0], hs[0], ws[0], vals):
        ref[y:y + h, x:x + w] = float(v)
    assert torch.equal(tex, ref.float())
    other = scene.make_textures(1, 64, 30, 4, "cpu")[0]
    assert torch.equal(tex == 96.0, other == 96.0)  # the same rectangles
    assert not torch.equal(tex, other)


@pytest.mark.parametrize("kind", sorted(PATHS))
def test_paths_keep_their_speed(kind):
    p = scene.Path(PATHS[kind])
    dt = 1.0 / 30
    ts = np.arange(0.0, 12.0, dt)
    c = np.stack([-p.pose(t)[:3, :3].T @ p.pose(t)[:3, 3] for t in ts])
    speed = np.linalg.norm(np.diff(c[:, [0, 2]], axis=0), axis=1) / dt
    if kind == "sweep":
        assert speed.max() == pytest.approx(np.radians(14.324) * 1.0, rel=0.01)
    else:
        assert np.median(speed) == pytest.approx(PATHS[kind]["speed_m_s"], rel=0.01)


@pytest.mark.parametrize("kind", sorted(PATHS))
def test_a_path_repeats_after_its_period(kind):
    p = scene.Path(PATHS[kind])
    period = p.period_s()
    for t in (0.0, 1.3, 7.9):
        np.testing.assert_allclose(p.pose(t + period), p.pose(t), atol=2e-4)
    assert not np.allclose(p.pose(period / 3), p.pose(0.0), atol=1e-3)


def test_a_bob_that_does_not_repeat_with_the_path_is_refused():
    with pytest.raises(ValueError, match="does not divide"):
        scene.Path(dict(PATHS["orbit"], bob_period_s=10.0)).period_s()
