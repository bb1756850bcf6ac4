"""Kernel K2's plain twin (motion-only LM pose optimization) and the
Gauss-Newton and dogleg solves vs the JAX package's XLA path, on the problem
construction of test_pallas_poseopt and test_optim.

The twin is the same algorithm with f32 sums in another order, so an LM
accept/reject can go the other way on near-equal errors: the bars are those of
tests/test_pallas_poseopt.py (pose within 5e-3 of truth and 2e-3 of JAX, at
most max(3, N/100) inlier flips, n_inliers within 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_optim import make_problem, pose_err
from test_pallas_poseopt import BF, CX, CY, FX, FY, _make_problem

from orbslam2commentedbyxcm_tpu.ops import optim as joptim
from orbslam2commentedbyxcm_tpu.utils import geometry as geo
from orbslam2commentedbyxcm_tpu_torch.ops import optim as toptim
from orbslam2commentedbyxcm_tpu_torch.ops import poseopt_kernel

torch.set_num_threads(1)

CAM = (FX, FY, CX, CY, BF)


def _args(rng, n, stereo_frac):
    t0, pts, obs, mask, t_true = _make_problem(rng, n=n, stereo_frac=stereo_frac)
    return tuple(np.array(a) for a in (t0, pts, obs, mask, np.ones(n, np.float32))), t_true


def _check_close(res_t, res_j, t_true, n):
    tt, tj = res_t.t_cw.cpu().numpy(), np.asarray(res_j.t_cw)
    assert np.abs(tt - t_true).max() < 5e-3
    assert np.abs(tj - t_true).max() < 5e-3
    assert np.abs(tt - tj).max() < 2e-3
    assert (res_t.inliers.cpu().numpy() != np.asarray(res_j.inliers)).sum() <= max(3, n // 100)
    assert abs(int(res_t.n_inliers) - int(res_j.n_inliers)) <= 3
    assert int(res_t.n_inliers) == int(res_t.inliers.sum())


@pytest.mark.parametrize("n,stereo_frac", [(400, 0.0), (400, 0.5), (400, 1.0), (300, 0.5)])
def test_twin_matches_xla(rng, n, stereo_frac):
    args, t_true = _args(rng, n, stereo_frac)
    res_j = joptim.pose_optimization(*[jnp.asarray(a) for a in args], *CAM, impl="xla")
    res_t = toptim.pose_optimization_plain(*[torch.from_numpy(a) for a in args], *CAM)
    _check_close(res_t, res_j, t_true, n)
    chi2_j = float(res_j.chi2)
    assert abs(float(res_t.chi2) - chi2_j) <= 1e-2 * chi2_j + 1.0


def test_wrapper_runs_twin_on_cpu(rng):
    args, _ = _args(rng, 300, 0.5)
    targs = [torch.from_numpy(a) for a in args]
    before = poseopt_kernel.pose_optimization_fused.launches
    routed = toptim.pose_optimization(*targs, *CAM)
    plain = toptim.pose_optimization_plain(*targs, *CAM)
    for a, b in zip(routed, plain):
        assert torch.equal(a, b)
    assert poseopt_kernel.pose_optimization_fused.launches == before
    assert routed.inliers.shape == (300,) and routed.n_inliers.dtype == torch.int32


@pytest.mark.parametrize("algorithm", ["gn", "dogleg"])
@pytest.mark.parametrize("n,stereo_frac", [(400, 0.0), (400, 0.5), (300, 1.0)])
def test_gn_dogleg_match_xla(rng, algorithm, n, stereo_frac):
    """Gauss-Newton and dogleg on K2's problems (10% outliers) against the
    JAX package's XLA solve of the same algorithm, with K2's bars; they run
    in the plain solve, so the kernel's counter does not move."""
    args, t_true = _args(rng, n, stereo_frac)
    res_j = joptim._pose_optimization_xla(*[jnp.asarray(a) for a in args], *CAM, algorithm=algorithm)
    before = poseopt_kernel.pose_optimization_fused.launches
    res_t = toptim.pose_optimization(*[torch.from_numpy(a) for a in args], *CAM, algorithm=algorithm)
    assert poseopt_kernel.pose_optimization_fused.launches == before
    _check_close(res_t, res_j, t_true, n)


def test_gn_dogleg_reach_lm_optimum(rng):
    """tests/test_optim.py's well-conditioned variant problem: each
    algorithm within 1e-2 of the truth and within 2e-3 of LM's pose (the
    JAX package's bars), and within 1e-4 of the JAX package's own solve."""
    pts, t_gt, obs = make_problem(rng, n=200, noise=0.3)
    t0 = np.asarray(geo.se3_exp(jnp.asarray([0.25, -0.1, 0.15, 0.08, -0.06, 0.1]))) @ t_gt
    args = (t0.astype(np.float32), pts, obs, np.ones(len(pts), bool), np.ones(len(pts), np.float32))
    out = {}
    for alg in toptim.ALGORITHMS:
        res = toptim.pose_optimization(*[torch.from_numpy(a) for a in args], *CAM, algorithm=alg)
        res_j = joptim._pose_optimization_xla(*[jnp.asarray(a) for a in args], *CAM, algorithm=alg)
        out[alg] = res.t_cw.numpy()
        assert pose_err(out[alg], t_gt) < 0.01, alg
        assert int(res.n_inliers) > 0.9 * len(pts), alg
        assert np.abs(out[alg] - np.asarray(res_j.t_cw)).max() < 1e-4, alg
    assert pose_err(out["gn"], out["lm"]) < 2e-3
    assert pose_err(out["dogleg"], out["lm"]) < 2e-3


def test_dogleg_with_outliers(rng):
    """tests/test_optim.py's dogleg case with 50 of 200 gross outliers: the
    pose within 2e-2 of the truth and 1e-4 of the JAX package's, the
    outliers rejected, the inlier set the JAX package's."""
    pts, t_gt, obs = make_problem(rng, n=200)
    obs = obs.copy()
    obs[:50, :2] += rng.uniform(30, 80, (50, 2))
    t0 = np.asarray(geo.se3_exp(jnp.asarray([0.15, 0.1, -0.05, 0.05, 0.02, -0.04]))) @ t_gt
    args = (t0.astype(np.float32), pts, obs.astype(np.float32), np.ones(200, bool), np.ones(200, np.float32))
    res = toptim.pose_optimization(*[torch.from_numpy(a) for a in args], *CAM, algorithm="dogleg")
    res_j = joptim._pose_optimization_xla(*[jnp.asarray(a) for a in args], *CAM, algorithm="dogleg")
    assert pose_err(res.t_cw.numpy(), t_gt) < 0.02
    assert np.abs(res.t_cw.numpy() - np.asarray(res_j.t_cw)).max() < 1e-4
    inl = res.inliers.numpy()
    assert inl[50:].mean() > 0.9 and inl[:50].mean() < 0.2
    np.testing.assert_array_equal(inl, np.asarray(res_j.inliers))


def test_unknown_algorithm_raises(rng):
    args = [torch.from_numpy(a) for a in _args(rng, 50, 0.5)[0]]
    for fn in (toptim.pose_optimization, toptim.pose_optimization_plain):
        with pytest.raises(ValueError, match="unknown algorithm"):
            fn(*args, *CAM, algorithm="newton")
