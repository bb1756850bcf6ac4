"""The port's Schur bundle adjustment against the JAX package's on the
problems of tests/test_optim.py: local BA with a fixed ring, stereo global BA
with 10% outliers, and `active_init` re-admission of excluded edges. Plus the
closed-form 3x3 inverse and the DLT triangulation local mapping uses.

Limits: poses within 1e-3, points within 1e-3 relative to their distance from
the origin, at most max(3, 1%) inlier flips. Both solvers run the same f32
arithmetic in different summation orders (segment sums here, one-hot matmuls
in the JAX package)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import optim as joptim
from orbslam2commentedbyxcm_tpu.ops import twoview as jtwoview
from orbslam2commentedbyxcm_tpu.utils import geometry as jgeo
from orbslam2commentedbyxcm_tpu_torch.ops import optim as toptim
from orbslam2commentedbyxcm_tpu_torch.ops import twoview as ttwoview

torch.set_num_threads(1)

FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 40.0


def _exp(xi):
    return np.array(jgeo.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _project(t_cw, pts, stereo):
    pc = pts @ t_cw[:3, :3].T + t_cw[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    return np.stack([u, v, u - BF / pc[:, 2] if stereo else np.full_like(u, -1.0)], -1)


def _problem(rng, n_poses=6, n_pts=120, stereo=False, noise=0.5):
    """tests/test_optim.make_ba_problem."""
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 12, n_pts)],
                   -1).astype(np.float32)
    poses = np.stack([_exp([0.25 * k, 0.02 * k, 0.01 * k, 0.0, 0.03 * k, 0.0]) for k in range(n_poses)])
    obs = []
    for k in range(n_poses):
        o = _project(poses[k], pts, stereo)
        o[:, :2] += rng.normal(0, noise, (n_pts, 2))
        if stereo:
            o[:, 2] += rng.normal(0, noise, n_pts)
        obs.append(o)
    op = np.repeat(np.arange(n_poses), n_pts).astype(np.int32)
    opt_ = np.tile(np.arange(n_pts), n_poses).astype(np.int32)
    return poses, pts, op, opt_, np.concatenate(obs).astype(np.float32)


def _local_ba(rng):
    poses, pts, op, opt_, ouv = _problem(rng)
    poses_0 = poses.copy()
    for i in range(2, len(poses)):
        poses_0[i] = _exp(rng.normal(0, 0.03, 6)) @ poses[i]
    pts_0 = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    fixed = np.arange(len(poses)) < 2
    return dict(args=(poses_0, fixed, pts_0, np.ones(len(pts), bool), op, opt_, ouv,
                      np.ones(len(op), bool), np.ones(len(op), np.float32)), kw={})


def _stereo_outliers(rng):
    poses, pts, op, opt_, ouv = _problem(rng, n_poses=5, n_pts=100, stereo=True)
    e = len(op)
    idx = rng.choice(e, e // 10, replace=False)
    ouv[idx, :2] = rng.uniform([0, 0], [640, 480], (len(idx), 2))
    poses_0 = poses.copy()
    for i in range(1, len(poses)):
        poses_0[i] = _exp(rng.normal(0, 0.02, 6)) @ poses[i]
    pts_0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    fixed = np.arange(len(poses)) < 1
    return dict(args=(poses_0, fixed, pts_0, np.ones(len(pts), bool), op, opt_, ouv,
                      np.ones(e, bool), np.ones(e, np.float32)), kw=dict(schedule=((5, True), (10, True))))


def _active_init(rng):
    poses, pts, op, opt_, ouv = _problem(rng, noise=0.3)
    fixed = np.arange(len(poses)) < 2
    active0 = np.ones(len(op), bool)
    active0[:40] = False  # 40 good edges left out of the first phase
    return dict(args=(poses, fixed, pts, np.ones(len(pts), bool), op, opt_, ouv,
                      np.ones(len(op), bool), np.ones(len(op), np.float32)),
                kw=dict(schedule=((5, True),)), active0=active0)


@pytest.mark.parametrize("make", [_local_ba, _stereo_outliers, _active_init],
                         ids=["local_fixed_ring", "stereo_outliers", "active_init"])
def test_bundle_adjustment_matches_jax(make):
    prob = make(np.random.default_rng(0))
    args, kw = prob["args"], prob["kw"]
    active0 = prob.get("active0")
    rj = joptim.bundle_adjustment(
        *[jnp.asarray(a) for a in args], FX, FY, CX, CY, BF, **kw,
        **({} if active0 is None else {"active_init": jnp.asarray(active0)}))
    rt = toptim.bundle_adjustment(
        *[torch.from_numpy(np.asarray(a)) for a in args], FX, FY, CX, CY, BF, **kw,
        **({} if active0 is None else {"active_init": torch.from_numpy(active0)}))
    pj, pt = np.asarray(rj.poses), rt.poses.numpy()
    xj, xt = np.asarray(rj.points), rt.points.numpy()
    ij, it = np.asarray(rj.obs_inliers), rt.obs_inliers.numpy()
    print(f"{make.__name__}: max|d pose| {np.abs(pt - pj).max():.2e}, "
          f"max|d point| {np.abs(xt - xj).max():.2e}, flips {(ij != it).sum()} of {len(ij)}")
    np.testing.assert_allclose(pt, pj, atol=1e-3, rtol=0)
    rel = np.linalg.norm(xt - xj, axis=-1) / np.linalg.norm(xj, axis=-1)
    assert rel.max() < 1e-3
    assert (ij != it).sum() <= max(3, len(ij) // 100)
    assert abs(float(rt.chi2) - float(rj.chi2)) <= 1e-3 * float(rj.chi2) + 1e-3
    # fixed poses stay put
    fixed = args[1]
    np.testing.assert_array_equal(pt[fixed], args[0][fixed])
    if active0 is not None:  # the excluded good edges come back as inliers
        assert it[:40].mean() > 0.9


def test_inv3x3_and_triangulate_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(toptim.inv3x3(torch.from_numpy(m)).numpy(),
                               np.asarray(joptim.inv3x3(jnp.asarray(m))), rtol=1e-5, atol=1e-5)
    pts = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(4, 10, 200)], -1)
    t1, t2 = np.eye(4, dtype=np.float32), _exp([-0.3, 0.02, 0.05, 0.01, 0.05, -0.02])
    uvn = [((pts @ t[:3, :3].T + t[:3, 3]) / (pts @ t[:3, :3].T + t[:3, 3])[:, 2:])[:, :2].astype(np.float32)
           for t in (t1, t2)]
    got = ttwoview.triangulate(torch.from_numpy(t1[:3]), torch.from_numpy(t2[:3]),
                               torch.from_numpy(uvn[0]), torch.from_numpy(uvn[1])).numpy()
    ref = np.asarray(jtwoview.triangulate(jnp.asarray(t1[:3]), jnp.asarray(t2[:3]),
                                          jnp.asarray(uvn[0]), jnp.asarray(uvn[1])))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pts, rtol=1e-3, atol=1e-3)


def test_segment_sum_matches_numpy():
    """BA's block sums: on the CPU `segment_sum` is `index_add_` (row order),
    and equals numpy's float64 np.add.at within float32 rounding."""
    rng = np.random.default_rng(2)
    values = rng.normal(size=(3000, 6, 3)).astype(np.float32)
    index = rng.integers(0, 40, 3000)
    got = toptim.segment_sum(torch.from_numpy(values), torch.from_numpy(index), 41)
    same = torch.zeros(41, 6, 3).index_add_(0, torch.from_numpy(index), torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), same.numpy())
    ref = np.zeros((41, 6, 3))
    np.add.at(ref, index, values.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    assert not got[40].any()  # a segment with no rows sums to zero
