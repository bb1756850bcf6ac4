"""Port ORBExtractor vs the JAX ORBExtractor (XLA path), same images.

What must agree exactly: the keypoint selection (valid mask, uv, level,
response), including the top-k tie order, whenever both packages see the same
level image. What cannot: the JAX pyramid resize is an f32 matrix product in
XLA's CPU dot order, and the port's (ops/orb `_pyramid_plain`, the same bits
on the CPU and on the card) sums each output's nonzero taps in ascending
order with fused multiply-adds; so levels >= 1 differ by f32 ulps (XLA's
first product is mostly reproduced, its second is not: see
tests/test_torch_pyramid_resize.py), and on images with flat regions (many
tied FAST scores) that moves a few keypoints there. The exposure gain's mean
and MAD are trees of the port's own, so the gain differs from JAX's in its
last bits. Descriptors are held bit-equal on >= 99% of common keypoints: the
orientation moments are an f32 reduction in another order, which can flip the
rounding of a rotated sample position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import orb as jorb
from orbslam2commentedbyxcm_tpu.ops.descriptors import descriptors_from_windows as j_desc
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.synth import default_camera as j_default_camera
from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import descriptors_from_windows as t_desc
from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import fused_frontend
from orbslam2commentedbyxcm_tpu_torch.ops.orb import _resize_pass
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)

H, W, NF = 120, 160, 200


def _pair(**kw):
    je = jorb.ORBExtractor(n_features=NF, use_pallas=False, **kw)
    return je, convert.extractor_from_jax(je)


def _jax_feats(je, img):
    f = je(img)
    return {k: np.asarray(getattr(f, k)) for k in ("uv", "response", "angle", "level", "desc", "valid")}


def _desc_rate(dj, dp):
    return float(np.mean(np.all(dj == dp, axis=1))) if len(dj) else 1.0


def _box_frame(i=0):
    return JBoxSequence(camera=j_default_camera(W, H), seed=5, n_frames=100, turns=0.35).render(i)


def test_extractor_matches_jax_uint8_image(rng):
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    je, pe = _pair()
    fj = _jax_feats(je, img)
    fp = convert.features_to_numpy(pe(torch.from_numpy(img)))
    v = fj["valid"]
    np.testing.assert_array_equal(fp["valid"], v)
    np.testing.assert_array_equal(fp["uv"][v], fj["uv"][v])
    np.testing.assert_array_equal(fp["level"], fj["level"])
    assert np.abs(fp["angle"][v] - fj["angle"][v]).max() <= 1e-5
    lvl0 = v & (fj["level"] == 0)  # level 0 sees the very same image: exact scores
    np.testing.assert_array_equal(fp["response"][lvl0], fj["response"][lvl0])
    rate = _desc_rate(fj["desc"][v], fp["desc"][v])
    print(f"descriptor bit-equality: {rate:.4f} of {v.sum()} keypoints")
    assert rate >= 0.99


def _level_images(img, ext):
    """The pyramid as the port computes it, as numpy (fed to both packages)."""
    t = torch.from_numpy(img)
    out = []
    for lvl in range(ext.n_levels):
        hl, wl = max(16, round(H / ext.scales[lvl])), max(16, round(W / ext.scales[lvl]))
        if lvl == 0:
            out.append((img, hl, wl))
        else:
            out.append((_resize_pass(_resize_pass(t, hl), wl).contiguous().numpy(), hl, wl))
    return out


def _port_level(pe, level_img, lvl):
    """One level image through the port's frontend and per-level selection."""
    maps = fused_frontend(torch.from_numpy(level_img), pe.ini_th, pe.min_th)
    return pe._select_level(*maps, lvl)


def _compare_level(je, pe, level_img, lvl, hl, wl, desc_bar=0.99):
    def jax_level(x):
        uv, resp, lev, rows, off, valid = je._extract_level(x, lvl, hl, wl)
        return (uv, resp, lev, valid) + j_desc(rows, off, je._pattern, je._kmx, je._kmy)

    uv_j, resp_j, lev_j, valid_j, desc_j, ang_j = jax.jit(jax_level)(jnp.asarray(level_img))
    uv_p, resp_p, lev_p, patches, valid_p = _port_level(pe, level_img, lvl)
    desc_p, ang_p = t_desc(patches, pe._pattern, pe._kmx, pe._kmy)
    v = np.asarray(valid_j)
    np.testing.assert_array_equal(valid_p.numpy(), v)
    np.testing.assert_array_equal(uv_p.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(resp_p.numpy(), np.asarray(resp_j))
    np.testing.assert_array_equal(lev_p.numpy(), np.asarray(lev_j))
    assert np.abs(ang_p.numpy()[v] - np.asarray(ang_j)[v]).max(initial=0) <= 1e-5
    rate = _desc_rate(np.asarray(desc_j)[v], convert.desc_to_numpy(desc_p)[v])
    print(f"level {lvl}: {v.sum()} keypoints, descriptor bit-equality {rate:.4f}")
    assert rate >= desc_bar
    return int(v.sum())


@pytest.mark.parametrize("lvl", range(8))
def test_level_matches_jax_on_same_level_image(lvl):
    """Each pyramid level of a BoxSequence frame, both packages fed the same
    level image: selection exact, descriptors >= 99% bit-equal."""
    je, pe = _pair()
    level_img, hl, wl = _level_images(_box_frame(), je)[lvl]
    _compare_level(je, pe, level_img, lvl, hl, wl)


def test_topk_tie_order_matches_jax(rng):
    """A tiled texture repeats every FAST score in many cells: the global
    selection has many equal keys, and lax.top_k's lower-index-first order
    must be reproduced (stable sort, not torch.topk)."""
    tile = rng.integers(0, 256, (32, 32)).astype(np.float32)
    img = np.tile(tile, (H // 32 + 1, W // 32 + 1))[:H, :W].copy()
    je, pe = _pair()
    # fewer slots than candidates, so ties decide which keypoints are taken
    assert _compare_level(je, pe, img, 0, H, W, desc_bar=1.0) == je.budgets[0]
    resp = _port_level(pe, img, 0)[1].numpy()
    assert len(resp) - len(np.unique(resp)) > 10  # the selection really had ties


def test_extractor_on_box_frame():
    """Whole extractor on a frame with flat texture regions: the keypoint
    sets agree on >= 95% (levels >= 1 differ by the resize rounding, see the
    module docstring), descriptors >= 99% bit-equal on common keypoints."""
    img = _box_frame(3)
    je, pe = _pair()
    fj = _jax_feats(je, img)
    fp = convert.features_to_numpy(pe(torch.from_numpy(img)))
    kj = {(tuple(u), l): k for k, (u, l) in enumerate(zip(fj["uv"], fj["level"])) if fj["valid"][k]}
    kp = {(tuple(u), l): k for k, (u, l) in enumerate(zip(fp["uv"], fp["level"])) if fp["valid"][k]}
    common = sorted(set(kj) & set(kp))
    agree = len(common) / max(len(kj), len(kp))
    rate = _desc_rate(fj["desc"][[kj[c] for c in common]], fp["desc"][[kp[c] for c in common]])
    print(f"keypoints: jax {len(kj)} port {len(kp)} common {len(common)} ({agree:.4f}); "
          f"descriptor bit-equality {rate:.4f}")
    assert abs(len(kj) - len(kp)) <= 0.02 * len(kj)
    assert agree >= 0.95
    assert rate >= 0.99
    # level 0 is computed from the same image: exact there
    lvl0 = fj["valid"] & (fj["level"] == 0)
    np.testing.assert_array_equal(fp["uv"][lvl0], fj["uv"][lvl0])


def test_exposure_normalization_close_to_jax(rng):
    """normalize_exposure: the mean/MAD reductions run in another order, so
    the gain differs in its last bits and every level is perturbed; the
    keypoint sets agree within a tolerance."""
    img = (rng.integers(0, 256, (H, W)) * 0.3 + 40).astype(np.float32)
    je, pe = _pair(normalize_exposure=True)
    fj = _jax_feats(je, img)
    fp = convert.features_to_numpy(pe(torch.from_numpy(img)))
    sj = {(tuple(u), l) for u, l, ok in zip(fj["uv"], fj["level"], fj["valid"]) if ok}
    sp = {(tuple(u), l) for u, l, ok in zip(fp["uv"], fp["level"], fp["valid"]) if ok}
    assert len(sj & sp) >= 0.9 * max(len(sj), len(sp))
