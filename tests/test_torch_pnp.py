"""RANSAC PnP: the port against the JAX package on the cases of
tests/test_place_recognition.py (clean, outliers, the minimal 6-point EPnP
lane, degenerate), with the JAX package's own samples handed to the port.
Bars: pose within 1e-3 of the JAX package's, at most max(3, N / 100) inlier
flips, success equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import pnp as jp
from orbslam2commentedbyxcm_tpu.utils import geometry as geo
from orbslam2commentedbyxcm_tpu_torch.ops import pnp as tp
from test_torch_twoview import jax_samples

torch.set_num_threads(1)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def make(rng, n=100, outliers=0.0, noise=0.5):
    """tests/test_place_recognition.TestPnP.make."""
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    t_gt = np.asarray(geo.se3_exp(jnp.asarray([0.2, -0.1, 0.3, 0.1, -0.2, 0.15])))
    pc = pts @ t_gt[:3, :3].T + t_gt[:3, 3]
    uv = pc @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + rng.normal(0, noise, (n, 2))
    n_out = int(outliers * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return pts, uv.astype(np.float32), t_gt


CASES = {
    "epnp-clean": (jp.ransac_epnp, tp.ransac_epnp, {}, 0, True),
    "epnp-outliers": (jp.ransac_epnp, tp.ransac_epnp, dict(n=150, outliers=0.4), 1, True),
    "dlt-clean": (jp.ransac_pnp, tp.ransac_pnp, {}, 0, True),
    "dlt-outliers": (jp.ransac_pnp, tp.ransac_pnp, dict(n=150, outliers=0.3), 1, True),
    "dlt-degenerate": (jp.ransac_pnp, tp.ransac_pnp, dict(n=20), 2, False),
    "epnp-degenerate": (jp.ransac_epnp, tp.ransac_epnp, dict(n=20), 2, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ransac_matches_jax(case, rng):
    jfn, tfn, kw, key_id, valid = CASES[case]
    pts, uv, t_gt = make(rng, **kw)
    n = len(pts)
    mask = np.full(n, valid)
    sigma2 = np.ones(n, np.float32)
    key = jax.random.PRNGKey(key_id)
    jr = jfn(key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(K), jnp.asarray(sigma2))
    tr = tfn(None, torch.from_numpy(pts), torch.from_numpy(uv), torch.from_numpy(mask), torch.from_numpy(K),
             torch.from_numpy(sigma2), samples=torch.from_numpy(jax_samples(key, mask, 256, 6)))
    assert bool(tr.success) == bool(jr.success)
    if not valid:
        assert int(tr.n_inliers) == 0
        return
    flips = int((tr.inliers.numpy() != np.asarray(jr.inliers)).sum())
    assert flips <= max(3, n // 100), flips
    if bool(jr.success):
        assert np.abs(tr.t_cw.numpy() - np.asarray(jr.t_cw)).max() < 1e-3
    if case.startswith("epnp"):  # the bar of test_place_recognition
        err = np.linalg.norm(np.asarray(geo.se3_log(jnp.asarray(tr.t_cw.numpy() @ np.linalg.inv(t_gt)))))
        assert err < 0.05, err


def test_epnp_minimal_6pt_lane(rng):
    pts, uv, t_gt = make(rng, n=6, noise=0.0)
    uvn = (np.concatenate([uv, np.ones((6, 1), np.float32)], 1) @ np.linalg.inv(K).T)[:, :2].astype(np.float32)
    jr, jt, jerr = jp._epnp_pose(jnp.asarray(pts), jnp.asarray(uvn), jnp.ones(6, jnp.float32))
    r, t, err = tp.epnp_pose(torch.from_numpy(pts), torch.from_numpy(uvn), torch.ones(6))
    assert float(err) < 1e-6
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(r.numpy(), t_gt[:3, :3], atol=1e-3)
    np.testing.assert_allclose(t.numpy(), t_gt[:3, 3], atol=1e-3)


def test_block_eigvecs_and_quaternion_match_jax(rng):
    a = rng.normal(size=(32, 12, 12)).astype(np.float32)
    g = np.einsum("bki,bkj->bij", a, a).astype(np.float32)
    j = np.asarray(jp._smallest_eigvecs_block(jnp.asarray(g), k=4))
    t = tp.smallest_eigvecs_block(torch.from_numpy(g), k=4).numpy()
    np.testing.assert_allclose(t, j, atol=2e-3)
    corr = rng.normal(size=(16, 3, 3)).astype(np.float32)
    n = np.asarray(jp._horn_n_matrix(jnp.asarray(corr)))
    np.testing.assert_array_equal(tp.horn_n_matrix(torch.from_numpy(corr)).numpy(), n)
    np.testing.assert_allclose(tp.dominant_quat(torch.from_numpy(n)).numpy(),
                               np.asarray(jp._dominant_quat(jnp.asarray(n))), atol=1e-5)
    m = rng.normal(size=(6, 6)).astype(np.float32)
    spd = m @ m.T + 6 * np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(tp.inv_small(torch.from_numpy(spd)).numpy(), np.linalg.inv(spd), atol=1e-5)
