"""Sim3 math, Horn's closed form, the Sim3 RANSAC and SearchBySim3: the port
against the JAX package on the same seeded inputs.

Bars: exp / log / inverse / product within 1e-5; Horn's rotation,
translation and scale within 1e-5; RANSAC with the JAX package's own draws
handed over (jax.random cannot be reproduced in torch): the same success,
an equal inlier mask, S12 within 1e-4, for a batch of two candidates of
different lengths (one padded) against the JAX solver run per candidate;
search_by_sim3 on tests/test_search_by_sim3.py's scenes: equal match indices
and agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_search_by_sim3 import _make_scene
from test_torch_twoview import jax_samples

from orbslam2commentedbyxcm_tpu.ops import sim3solver as jsim3
from orbslam2commentedbyxcm_tpu.utils import geometry as jgeo
from orbslam2commentedbyxcm_tpu_torch.ops import sim3solver as tsim3
from orbslam2commentedbyxcm_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _tangents(rng, n=64):
    """sim3 tangents over both branches of the W series: tiny and large
    rotation / scale, mixed."""
    xi = rng.normal(0, 0.6, (n, 7)).astype(np.float32)
    xi[: n // 4, 3:6] *= 1e-3    # theta < 0.05
    xi[n // 4: n // 2, 6] *= 1e-3  # |sigma| < 0.05
    xi[n // 2: 5 * n // 8, 3:] *= 1e-4
    return xi


def test_sim3_exp_log_inverse_mul_match_jax(rng):
    xi = _tangents(rng)
    xi2 = _tangents(np.random.default_rng(7))
    m_j = np.asarray(jgeo.sim3_exp(jnp.asarray(xi)))
    m_t = tgeo.sim3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(m_t, m_j, atol=1e-5)
    np.testing.assert_allclose(tgeo.sim3_log(torch.from_numpy(m_j)).numpy(),
                               np.asarray(jgeo.sim3_log(jnp.asarray(m_j))), atol=1e-5)
    np.testing.assert_allclose(tgeo.sim3_log(torch.from_numpy(m_j)).numpy(), xi, atol=1e-4)
    np.testing.assert_allclose(tgeo.sim3_inverse(torch.from_numpy(m_j)).numpy(),
                               np.asarray(jgeo.sim3_inverse(jnp.asarray(m_j))), atol=1e-5)
    m2 = np.asarray(jgeo.sim3_exp(jnp.asarray(xi2)))
    np.testing.assert_allclose(tgeo.sim3_mul(torch.from_numpy(m_j), torch.from_numpy(m2)).numpy(),
                               np.asarray(jgeo.sim3_mul(jnp.asarray(m_j), jnp.asarray(m2))), atol=1e-5)
    pts = rng.normal(0, 2, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.sim3_apply(torch.from_numpy(m_j), torch.from_numpy(pts)).numpy(),
                               np.asarray(jgeo.sim3_apply(jnp.asarray(m_j), jnp.asarray(pts))), atol=1e-5)
    q = rng.normal(0, 1, (16, 4)).astype(np.float32)
    np.testing.assert_allclose(tgeo.quat_mul(torch.from_numpy(q), torch.from_numpy(q[::-1].copy())).numpy(),
                               np.asarray(jgeo.quat_mul(jnp.asarray(q), jnp.asarray(q[::-1].copy()))), atol=1e-5)
    np.testing.assert_allclose(tgeo.sim3_scale(torch.from_numpy(m_j)).numpy(), np.exp(xi[:, 6]), rtol=1e-5)


def _sim3_pair(rng, n, s=1.3, outliers=0.3, noise=0.005):
    """Points in camera 2, the same points in camera 1 through a known S12,
    a share of them replaced by outliers."""
    p2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], -1).astype(np.float32)
    s12 = np.asarray(jgeo.sim3_exp(jnp.asarray([0.2, -0.1, 0.3, 0.05, 0.1, -0.02, np.log(s)], jnp.float32)))
    p1 = p2 @ s12[:3, :3].T + s12[:3, 3] + rng.normal(0, noise, (n, 3))
    bad = rng.random(n) < outliers
    p1[bad] += rng.normal(0, 1.5, (int(bad.sum()), 3))
    return p1.astype(np.float32), p2, s12


def test_horn_matches_jax(rng):
    p1, p2, _ = _sim3_pair(rng, 40, outliers=0.0)
    p1b = np.stack([p1, p1[::-1]])
    p2b = np.stack([p2, p2[::-1]])
    for fix_scale in (False, True):
        rj, tj, sj = (np.asarray(a) for a in jsim3.horn_sim3(jnp.asarray(p2b), jnp.asarray(p1b), fix_scale))
        rt, tt, st = (a.numpy() for a in tsim3.horn_sim3(torch.from_numpy(p2b), torch.from_numpy(p1b), fix_scale))
        np.testing.assert_allclose(rt, rj, atol=1e-5)
        np.testing.assert_allclose(tt, tj, atol=1e-5)
        np.testing.assert_allclose(st, sj, rtol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True], ids=["sim3", "fixed-scale"])
def test_ransac_sim3_matches_jax(rng, fix_scale):
    s = 1.0 if fix_scale else 1.3
    lanes = [_sim3_pair(rng, 90, s=s), _sim3_pair(rng, 60, s=s)]
    n = 96  # padded, as the JAX loop closer buckets a candidate batch
    c = len(lanes)
    p1b, p2b = np.zeros((c, n, 3), np.float32), np.zeros((c, n, 3), np.float32)
    mask = np.zeros((c, n), bool)
    sig1 = np.ones((c, n), np.float32)
    sig2 = (1.2 ** (2 * rng.integers(0, 3, (c, n)))).astype(np.float32)
    for i, (p1, p2, _) in enumerate(lanes):
        p1b[i, : len(p1)], p2b[i, : len(p2)], mask[i, : len(p1)] = p1, p2, True
    keys = jax.random.split(jax.random.PRNGKey(13), c)
    samples = np.stack([jax_samples(keys[i], mask[i], 128, 3) for i in range(c)])
    res_t = tsim3.ransac_sim3(
        torch.from_numpy(p1b), torch.from_numpy(p2b), torch.from_numpy(mask), torch.from_numpy(K),
        torch.from_numpy(sig1), torch.from_numpy(sig2), fix_scale=fix_scale, samples=torch.from_numpy(samples))
    for i, (_, _, s12_true) in enumerate(lanes):
        res_j = jsim3.ransac_sim3(keys[i], jnp.asarray(p1b[i]), jnp.asarray(p2b[i]), jnp.asarray(mask[i]),
                                  jnp.asarray(K), jnp.asarray(sig1[i]), jnp.asarray(sig2[i]), fix_scale=fix_scale)
        assert bool(res_j.success) and bool(res_t.success[i])
        np.testing.assert_array_equal(res_t.inliers[i].numpy(), np.asarray(res_j.inliers))
        assert int(res_t.n_inliers[i]) == int(res_j.n_inliers)
        np.testing.assert_allclose(res_t.s12[i].numpy(), np.asarray(res_j.s12), atol=1e-4)
        np.testing.assert_allclose(res_t.s12[i].numpy(), s12_true, atol=0.05)
    # the draws from a torch generator: uniform over the masked rows only
    g = torch.Generator().manual_seed(13)
    drawn = tsim3.draw_samples(torch.from_numpy(mask), 128, 3, g)
    assert drawn.shape == (c, 128, 3)
    for i, (p1, _, _) in enumerate(lanes):
        assert int(drawn[i].max()) < len(p1)


@pytest.mark.parametrize("wrong", [False, True], ids=["true-sim3", "wrong-sim3"])
def test_search_by_sim3_matches_jax(rng, wrong):
    n = 48
    p1, p2, s12 = _make_scene(rng, n, s=1.0)
    if wrong:
        s12 = np.eye(4, dtype=np.float32)
        s12[:3, 3] = (8.0, 5.0, -3.0)

    def project(p):
        uv = p[:, :2] / p[:, 2:3]
        return (uv * [400.0, 400.0] + [320.0, 240.0]).astype(np.float32)

    k = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1]], np.float32)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lvl = rng.integers(0, 2, n).astype(np.int32)
    dmax1 = (np.linalg.norm(p1, axis=1) * 1.05).astype(np.float32)
    dmax2 = (np.linalg.norm(p2, axis=1) * 1.05).astype(np.float32)
    mask = rng.random(n) < 0.95
    already = np.zeros(n, bool)
    already[:10] = True
    side1 = (p1, desc, dmax1, project(p1), desc, lvl, mask, already)
    side2 = (p2, desc, dmax2, project(p2), desc, lvl, mask, already)
    m_j, a_j = jsim3.search_by_sim3(jnp.asarray(s12), *[jnp.asarray(a) for a in side1],
                                    *[jnp.asarray(a) for a in side2], jnp.asarray(k), 640.0, 480.0,
                                    float(np.log(1.2)), 8)

    def t(a):
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)

    m_t, a_t = tsim3.search_by_sim3(t(s12), *[t(a) for a in side1], *[t(a) for a in side2], t(k), 640.0, 480.0,
                                    float(np.log(1.2)), 8)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    if not wrong:
        assert a_t.sum() >= 25
