"""Port matching and the projection search vs the JAX package: exact.

Hamming distances are integers and the search's argmin, histogram and
uniqueness pass are exact operations, so distances, indices and masks must be
identical. The problem below is built to have ties: duplicated descriptors
(equal distances to several points, so the first-minimum rule decides) and
several features near the same point (so the uniqueness pass decides).
"""

import jax.numpy as jnp
import numpy as np
import torch

from orbslam2commentedbyxcm_tpu.models import tracking as jtr
from orbslam2commentedbyxcm_tpu.ops import matching as jm
from orbslam2commentedbyxcm_tpu_torch.models import tracking as ttr
from orbslam2commentedbyxcm_tpu_torch.ops import matching as tm
from orbslam2commentedbyxcm_tpu_torch.utils.convert import desc_to_torch

torch.set_num_threads(1)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def test_hamming_matrix_exact(rng):
    a, b = _desc(rng, 300), _desc(rng, 500)
    b[:50] = a[:50]                      # distance 0
    b[50:60] = a[60:70]
    b[50:60, 0] ^= np.uint32(1 << 31)  # distance 1, through the int32 sign bit
    j = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    t = tm.hamming_matrix(desc_to_torch(a), desc_to_torch(b)).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t == 0).sum() >= 50 and (t == 1).sum() >= 10


def test_unpack_bits_exact(rng):
    d = _desc(rng, 40)
    np.testing.assert_array_equal(tm.unpack_bits(desc_to_torch(d)).numpy(), np.asarray(jm.unpack_bits(jnp.asarray(d))))


def test_remainder_is_jnp_mod(rng):
    x = (rng.normal(size=2000) * 10).astype(np.float32)
    x[:4] = [-0.0, -2 * np.pi, 2 * np.pi, -1e-7]
    j = np.asarray(jnp.mod(jnp.asarray(x), 2.0 * np.pi))
    t = torch.remainder(torch.from_numpy(x), 2.0 * np.pi).numpy()
    np.testing.assert_array_equal(t, j)


def test_rotation_consistency_exact(rng):
    n, m = 400, 300
    ang_a = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    # two bins of equal height tie for third place
    ang_a[:60] = ang_b[idx[:60]] + 0.05
    ang_a[60:100] = ang_b[idx[60:100]] - 1.0
    ang_a[100:120] = ang_b[idx[100:120]] + 2.0
    ang_a[120:140] = ang_b[idx[120:140]] - 2.5
    ok = rng.random(n) < 0.9
    j = np.asarray(jm.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx), jnp.asarray(ok)))
    t = tm.rotation_consistency(torch.from_numpy(ang_a), torch.from_numpy(ang_b), torch.from_numpy(idx),
                                torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < t.sum() < ok.sum()


def make_search_problem(rng, n_pts=512, n_feat=300, w=160.0, h=120.0):
    fx = fy = 150.0
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(3, 9, n_pts)], -1).astype(np.float32)
    t_cw = np.eye(4, dtype=np.float32)
    t_cw[:3, 3] = [0.05, -0.02, 0.1]
    pc = pts + t_cw[:3, 3]
    uv_true = np.stack([fx * pc[:, 0] / pc[:, 2] + w / 2, fy * pc[:, 1] / pc[:, 2] + h / 2], -1)
    pt_desc = _desc(rng, n_pts)
    pt_desc[1::7] = pt_desc[::7][: len(pt_desc[1::7])]  # duplicate descriptors: distance ties
    src = rng.integers(0, n_pts, n_feat)
    feat_uv = (uv_true[src] + rng.normal(0, 1.5, (n_feat, 2))).astype(np.float32)
    feat_desc = pt_desc[src].copy()
    flip = rng.integers(0, 256, (n_feat, 6))
    for k in range(6):  # up to 6 flipped bits per feature
        feat_desc[np.arange(n_feat), flip[:, k] // 32] ^= (np.uint32(1) << (flip[:, k] % 32).astype(np.uint32))
    feat_desc[rng.random(n_feat) < 0.2] = _desc(rng, 1)[0]  # some unmatched features
    normal = pts - (-t_cw[:3, 3])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    pt_level = rng.integers(0, 8, n_pts)
    dist = np.linalg.norm(pts - (-t_cw[:3, 3]), axis=-1)
    levels = np.clip(pt_level[src] + rng.integers(-1, 2, n_feat), 0, 7).astype(np.int32)
    return dict(
        pt_xyz=pts, pt_desc=pt_desc, pt_normal=normal.astype(np.float32),
        pt_dmin=np.full(n_pts, 0.5, np.float32),
        # half a level off the ceil() boundary: at exact powers of 1.2 the
        # predicted level turns on the last ulp of log(), where XLA's and
        # torch's log differ on ~8% of inputs
        pt_dmax=(dist * 1.2 ** (pt_level + 0.5)).astype(np.float32), pt_mask=rng.random(n_pts) < 0.95,
        t_cw=t_cw, feat_uv=feat_uv, feat_desc=feat_desc, feat_level=levels,
        feat_valid=rng.random(n_feat) < 0.95,
        pt_angle=rng.uniform(-np.pi, np.pi, n_pts).astype(np.float32),
        feat_angle=rng.uniform(-0.2, 0.2, n_feat).astype(np.float32),
        cam=(fx, fy, w / 2, h / 2, w, h),
    )


def _run_search(p, with_angle):
    order = ("pt_xyz", "pt_desc", "pt_normal", "pt_dmin", "pt_dmax", "pt_mask",
             "t_cw", "feat_uv", "feat_desc", "feat_level", "feat_valid")
    tail = (15.0, 100.0, float(np.log(1.2)), 8)
    kw_j = dict(pt_angle=jnp.asarray(p["pt_angle"]), feat_angle=jnp.asarray(p["feat_angle"])) if with_angle else {}
    kw_t = dict(pt_angle=torch.from_numpy(p["pt_angle"]), feat_angle=torch.from_numpy(p["feat_angle"])) if with_angle else {}
    j = jtr.project_and_match(*[jnp.asarray(p[k]) for k in order], *p["cam"], *tail, **kw_j)
    args_t = [desc_to_torch(p[k]) if "desc" in k else torch.from_numpy(p[k]) for k in order]
    t = ttr.project_and_match(*args_t, *p["cam"], *tail, **kw_t)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_project_and_match_exact(rng):
    p = make_search_problem(rng)
    for with_angle in (False, True):
        (bj, dj, okj, vj), (bt, dt, okt, vt) = _run_search(p, with_angle)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(okt, okj)
        assert okt.sum() > (20 if with_angle else 50)
    # the problem really exercises the tie rules
    raw = tm.hamming_matrix(desc_to_torch(p["pt_desc"]), desc_to_torch(p["feat_desc"]))
    assert int((raw == raw.min(dim=0).values).sum(dim=0).gt(1).sum()) > 10
    assert len(np.unique(bt[okj])) == okj.sum()  # uniqueness held


def _tied_distances(rng, n=200, m=260):
    """Integer distances with many ties: duplicated columns and rows."""
    a, b = _desc(rng, n), _desc(rng, m)
    b[:40] = a[:40]
    b[40:80] = a[:40]                 # two equal best columns per row: the first wins
    b[80:100, :] = a[40:60]
    b[80:100, 1] ^= np.uint32(0x00FF0000)  # distance 8
    a[60:70] = a[40:50]               # equal rows: mutual ties
    return a, b


def test_hamming_pairs_exact(rng):
    a, b = _desc(rng, 300), _desc(rng, 300)
    b[:30] = a[:30]
    j = np.asarray(jm.hamming_pairs(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tm.hamming_pairs(desc_to_torch(a), desc_to_torch(b)).numpy(), j)


def test_match_nn_exact_with_ties(rng):
    a, b = _tied_distances(rng)
    d = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    valid_a, valid_b = rng.random(len(a)) < 0.9, rng.random(len(b)) < 0.9
    mask = rng.random(d.shape) < 0.8
    for kw in (dict(), dict(ratio=0.9), dict(ratio=0.75, mutual=True), dict(max_dist=100, mutual=True)):
        for va, vb, mk in ((None, None, None), (valid_a, valid_b, mask)):
            j = jm.match_nn(jnp.asarray(d), None if va is None else jnp.asarray(va),
                            None if vb is None else jnp.asarray(vb), None if mk is None else jnp.asarray(mk), **kw)
            t = tm.match_nn(torch.from_numpy(d), None if va is None else torch.from_numpy(va),
                            None if vb is None else torch.from_numpy(vb), None if mk is None else torch.from_numpy(mk),
                            **kw)
            for x, y in zip(t, j):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert t[2].sum() > 0


def test_window_mask_exact(rng):
    uv_a = rng.uniform(0, 320, (150, 2)).astype(np.float32)
    uv_b = np.round(uv_a[rng.integers(0, 150, 170)] + rng.normal(0, 6, (170, 2))).astype(np.float32)
    la, lb = rng.integers(0, 8, 150).astype(np.int32), rng.integers(0, 8, 170).astype(np.int32)
    radius = rng.uniform(2, 10, 150).astype(np.float32)
    for r in (5.0, radius):
        j = jm.window_mask(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(r) if np.ndim(r) else r,
                           jnp.asarray(la), jnp.asarray(lb), 1)
        t = tm.window_mask(torch.from_numpy(uv_a), torch.from_numpy(uv_b), torch.from_numpy(r) if np.ndim(r) else r,
                           torch.from_numpy(la), torch.from_numpy(lb), 1)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


class _Feats:
    def __init__(self, lib, **arrays):
        for k, v in arrays.items():
            setattr(self, k, lib(v))


def test_search_for_initialization_exact(rng):
    n = 300
    uv = rng.uniform(20, 300, (n, 2)).astype(np.float32)
    desc = _desc(rng, n)
    level = rng.integers(0, 3, n).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    perm = rng.permutation(n)
    uv2 = (uv[perm] + rng.normal(0, 4, (n, 2))).astype(np.float32)
    desc2 = desc[perm].copy()
    desc2[::3, 2] ^= np.uint32(0xF0F0)  # distance 8 on a third
    desc2[1::9] = desc2[0::9][: len(desc2[1::9])]  # duplicated descriptors: ties
    angle2 = (angle[perm] + 0.2 + rng.normal(0, 0.02, n)).astype(np.float32)
    valid = rng.random(n) < 0.95
    fa = dict(uv=uv, desc=desc, level=level, angle=angle, valid=valid)
    fb = dict(uv=uv2, desc=desc2, level=level[perm], angle=angle2, valid=valid[perm])
    j = jm.search_for_initialization(_Feats(jnp.asarray, **fa), _Feats(jnp.asarray, **fb), window=30.0)
    def to_torch(v):
        return desc_to_torch(v) if v.dtype == np.uint32 else torch.from_numpy(v)

    t = tm.search_for_initialization(_Feats(to_torch, **fa), _Feats(to_torch, **fb), window=30.0)
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert t[2].sum() > 50


def test_search_by_bow_exact(rng):
    a, b = _tied_distances(rng)
    ga = rng.integers(-1, 12, len(a)).astype(np.int32)
    gb = rng.integers(0, 12, len(b)).astype(np.int32)
    gb[:100] = np.concatenate([ga[:40], ga[:40], ga[40:60]]).clip(0)
    va, vb = rng.random(len(a)) < 0.95, rng.random(len(b)) < 0.95
    ang_a = rng.uniform(-np.pi, np.pi, len(a)).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, len(b)).astype(np.float32)
    for kw in (dict(), dict(mutual=False), dict(ratio=0.7)):
        for angles in (False, True):
            extra_j = dict(angle_a=jnp.asarray(ang_a), angle_b=jnp.asarray(ang_b)) if angles else {}
            extra_t = dict(angle_a=torch.from_numpy(ang_a), angle_b=torch.from_numpy(ang_b)) if angles else {}
            j = jm.search_by_bow(jnp.asarray(a), jnp.asarray(ga), jnp.asarray(va), jnp.asarray(b), jnp.asarray(gb),
                                 jnp.asarray(vb), **extra_j, **kw)
            t = tm.search_by_bow(desc_to_torch(a), torch.from_numpy(ga), torch.from_numpy(va), desc_to_torch(b),
                                 torch.from_numpy(gb), torch.from_numpy(vb), **extra_t, **kw)
            for x, y in zip(t, j):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert t[2].sum() > 5
