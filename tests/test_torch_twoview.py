"""Monocular two-view initialization: the port against the JAX package.

Both packages get the same correspondences and the same RANSAC samples (the
JAX package's own draw, computed with its key and handed to the port, since
torch cannot reproduce jax.random), so they score the very same 200 H and
200 F hypotheses. A planar scene must select the homography, a scene of two
depths the fundamental matrix. Bars: success and model equal, rotation within
1e-3 rad, translation direction within 1e-3 (1 - cos), triangulation flags
equal on >= 98% of the pairs, points within 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import twoview as jtv
from orbslam2commentedbyxcm_tpu.utils import geometry as jgeo
from orbslam2commentedbyxcm_tpu_torch.ops import twoview as ttv

torch.set_num_threads(1)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _scene(planar: bool, seed: int = 3, n: int = 300):
    rng = np.random.default_rng(seed)
    if planar:
        z = np.full(n, 8.0)
    else:
        z = np.where(rng.random(n) < 0.5, 5.0, 10.0) + rng.uniform(-0.5, 0.5, n)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), z], -1).astype(np.float32)
    t21 = np.asarray(jgeo.se3_exp(jnp.asarray([0.4, 0.05, 0.1, 0.01, -0.03, 0.02], jnp.float32)))

    def proj(p):
        u = p @ K.T
        return u[:, :2] / u[:, 2:3]

    uv1 = proj(pts) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(pts @ t21[:3, :3].T + t21[:3, 3]) + rng.normal(0, 0.5, (n, 2))
    mask = rng.random(n) < 0.9
    return uv1.astype(np.float32), uv2.astype(np.float32), mask, t21


def jax_samples(key, mask, n_hypotheses, size):
    """The draw of jax.random.choice(key, n, (S, size), p=mask / sum), as
    initialize_two_view / ransac_epnp make it."""
    w = jnp.asarray(mask, jnp.float32)
    return np.asarray(jax.random.choice(key, len(mask), shape=(n_hypotheses, size), p=w / jnp.maximum(w.sum(), 1.0)))


def _rot_angle(r1, r2):
    return float(np.arccos(np.clip((np.trace(r1 @ r2.T) - 1.0) / 2.0, -1.0, 1.0)))


@pytest.mark.parametrize("planar", [True, False], ids=["planar-H", "two-depth-F"])
def test_initialize_two_view_matches_jax(planar):
    uv1, uv2, mask, t_true = _scene(planar)
    key = jax.random.PRNGKey(1)
    jr = jtv.initialize_two_view(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), jnp.asarray(K))
    jr = jax.tree.map(np.asarray, jr)
    tr = ttv.initialize_two_view(None, torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(mask),
                                 torch.from_numpy(K), samples=torch.from_numpy(jax_samples(key, mask, 200, 8)))
    assert bool(jr.success) and bool(tr.success)
    assert bool(jr.used_homography) == bool(tr.used_homography) == planar
    t21 = tr.t21.numpy()
    assert _rot_angle(t21[:3, :3], jr.t21[:3, :3]) < 1e-3
    tj, tt = jr.t21[:3, 3], t21[:3, 3]
    assert 1.0 - tj @ tt / (np.linalg.norm(tj) * np.linalg.norm(tt)) < 1e-3
    # and both found the true motion's direction
    assert 1.0 - tt @ t_true[:3, 3] / (np.linalg.norm(tt) * np.linalg.norm(t_true[:3, 3])) < 0.02
    tri_t = tr.is_triangulated.numpy()
    assert (tri_t == jr.is_triangulated).mean() >= 0.98
    both = tri_t & jr.is_triangulated
    assert both.sum() >= 200
    pts_t, pts_j = tr.points.numpy()[both], jr.points[both]
    rel = np.linalg.norm(pts_t - pts_j, axis=1) / np.linalg.norm(pts_j, axis=1)
    assert rel.max() < 1e-3, rel.max()
    assert abs(int(tr.n_inliers) - int(jr.n_inliers)) <= 0.02 * int(jr.n_inliers)


def _up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max()) < atol


def test_smallest_eigvec_psd_matches_jax(rng):
    # rank 8 of 9 columns (a DLT system of 8 correspondences): one null vector
    a = (rng.normal(size=(64, 16, 8)) @ rng.normal(size=(64, 8, 9))).astype(np.float32)
    a += rng.normal(0, 1e-3, a.shape).astype(np.float32)
    a[:8, :, 3] = a[:8, :, 1]  # a two-dimensional null space: any unit vector in it
    g = np.einsum("bki,bkj->bij", a, a).astype(np.float32)
    j = np.asarray(jtv.smallest_eigvec_psd(jnp.asarray(g)))
    t = ttv.smallest_eigvec_psd(torch.from_numpy(g)).numpy()
    for x, y in zip(j, t):
        assert _up_to_sign(x, y, 2e-4)
    ref = np.linalg.eigh(g.astype(np.float64))[1][..., 0]
    for x, y in zip(t[8:], ref[8:]):
        assert _up_to_sign(x, y, 1e-2)


def test_decompositions_match_jax(rng):
    r = np.asarray(jgeo.so3_exp(jnp.asarray([0.05, -0.1, 0.03], jnp.float32)))
    t = np.array([0.3, 0.02, 0.05], np.float32)
    n = np.array([0.0, 0.0, 1.0], np.float32)
    h = (r + np.outer(t, n) / 8.0).astype(np.float32)
    e = (np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32) @ r).astype(np.float32)
    for jf, tf, m in ((jtv._decompose_h, ttv._decompose_h, h), (jtv._decompose_e, ttv._decompose_e, e)):
        jr, jt = (np.asarray(x) for x in jf(jnp.asarray(m)))
        tr, tt = (x.numpy() for x in tf(torch.from_numpy(m)))
        assert tr.shape == jr.shape and tt.shape == jt.shape
        for i in range(len(jr)):
            assert _up_to_sign(tr[i], jr[i], 1e-4), i
            assert _up_to_sign(tt[i], jt[i], 1e-4), i
        # the true motion is one of the candidates
        assert min(_rot_angle(x, r) for x in tr) < 2e-3


def test_check_rt_matches_jax():
    uv1, uv2, mask, t21 = _scene(False)
    kinv = np.linalg.inv(K)

    def norm(uv):
        x = np.concatenate([uv, np.ones((len(uv), 1), np.float32)], 1) @ kinv.T
        return (x[:, :2] / x[:, 2:3]).astype(np.float32)

    u1, u2 = norm(uv1), norm(uv2)
    tn = t21[:3, 3] / np.linalg.norm(t21[:3, 3])
    rs = np.stack([t21[:3, :3], t21[:3, :3], t21[:3, :3].T]).astype(np.float32)
    ts = np.stack([tn, -tn, tn]).astype(np.float32)
    th = 4.0 * (1.0 / 500.0) ** 2
    for c in range(3):
        jg, jn, jp, jpts = (np.asarray(x) for x in jtv._check_rt(jnp.asarray(rs[c]), jnp.asarray(ts[c]), jnp.asarray(u1),
                                                                jnp.asarray(u2), jnp.asarray(mask), th))
        tg, tn_, tp, tpts = ttv._check_rt(torch.from_numpy(rs[c:c + 1]), torch.from_numpy(ts[c:c + 1]),
                                          torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(mask), th)
        assert (tg.numpy()[0] == jg).mean() >= 0.99
        assert abs(int(tn_[0]) - int(jn)) <= 2
        assert abs(float(tp[0]) - float(jp)) < 1e-5
        if c == 0:  # the true motion: nearly every pair passes
            assert int(tn_[0]) > 0.8 * mask.sum()


def test_draw_samples_follow_mask():
    mask = np.zeros(100, bool)
    mask[[3, 50, 77]] = True
    gen = torch.Generator().manual_seed(0)
    s = ttv.draw_samples(torch.from_numpy(mask), 200, 8, gen)
    assert s.shape == (200, 8) and set(s.unique().tolist()) <= {3, 50, 77}
