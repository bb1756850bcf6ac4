"""Bag of words and the keyframe database: the port against the JAX package.

Over one 640x480 frame's 1000 descriptors and the shipped vocabulary (k = 10,
depth 6, 785,724 words): words and grouping nodes bit-equal, BoW vector ids
equal and values within 1e-6, the six scorings equal. The port's
KeyFrameDatabase returns the same candidate lists, in the same order, and
bit-equal scores as the JAX database on its Python backend
(`use_native=False`) for the same adds, erases and queries: on the port's C++
inverted file (`index="native"`, the default) and on its Python twin
(`index="python"`). The JAX package's own C++ inverted file returns its
candidates in hash order; tests/test_torch_native.py holds the port's native
index to its Python twin in detail.
"""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models.keyframe_database import KeyFrameDatabase as JDatabase
from orbslam2commentedbyxcm_tpu.ops import bow as jb
from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase as TDatabase
from orbslam2commentedbyxcm_tpu_torch.ops import bow as tb
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vocs():
    return jb.bootstrap_vocabulary(), tb.bootstrap_vocabulary()


@pytest.fixture(scope="module")
def frames():
    """Descriptors of 8 frames of BoxSequence seed 5 at 640x480, 1000 features."""
    seq = BoxSequence(camera=default_camera(640, 480), seed=5, n_frames=100, turns=0.35)
    ext = ORBExtractor(n_features=1000)
    out = []
    for i in range(0, 40, 5):
        f = ext(seq.render(i))
        out.append((f.desc.numpy().view(np.uint32), f.valid.numpy()))
    return out


def test_vocabulary_is_the_shipped_tree(vocs):
    jv, tv = vocs
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words) == (10, 6, 785724)
    assert tv.device_bytes() == 873546 * (8 + 10) * 4
    a, b = tv.device_tree("cpu")
    assert tv.device_tree("cpu")[0] is a  # uploaded once per device


def test_transform_bit_equal(vocs, frames):
    jv, tv = vocs
    desc, valid = frames[0]
    assert valid.sum() == 1000
    valid = valid.copy()
    valid[::17] = False
    jw, jg, jwt = jb.transform(jv, desc, valid)
    for inp in (desc, torch.from_numpy(desc.view(np.int32))):  # numpy or a tensor
        tw, tg, twt = tb.transform(tv, inp, valid)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tg, np.asarray(jg))
        np.testing.assert_array_equal(twt, jwt)
    assert (tw[::17] == -1).all() and len(np.unique(tg)) > 20


def test_bow_vector_and_scores(vocs, frames):
    jv, tv = vocs
    vecs = []
    for desc, valid in frames[:3]:
        jw, _, jwt = jb.transform(jv, desc, valid)
        tw, _, twt = tb.transform(tv, desc, valid)
        for norm in ("l1", "l2"):
            ji, jval = jb.bow_vector(jw, jwt, jv.n_words, norm=norm)
            ti, tval = tb.bow_vector(tw, twt, tv.n_words, norm=norm)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(tval, jval, atol=1e-6)
        vecs.append(tb.bow_vector(tw, twt, tv.n_words))
    for a, b in ((0, 1), (0, 2), (1, 1)):
        assert tb.l1_score(*vecs[a], *vecs[b]) == jb.l1_score(*vecs[a], *vecs[b])
        for method in ("l1", "l2", "chi_square", "kl", "bhattacharyya", "dot_product"):
            assert tb.score(*vecs[a], *vecs[b], method) == jb.score(*vecs[a], *vecs[b], method)
    assert tb.l1_score(*vecs[0], *vecs[1]) > tb.l1_score(*vecs[0], *vecs[2]) > 0


class _StubKF:
    def __init__(self, covis):
        self.bad = False
        self._covis = covis

    def best_covisible(self, n):
        return self._covis[:n]


class _StubMap:
    def __init__(self, ids, covis):
        self.keyframes = {i: _StubKF(covis.get(i, [])) for i in ids}


def test_keyframe_database_candidates_equal(vocs, frames, rng):
    _database_candidates_equal(vocs, frames, rng, "native")


def test_keyframe_database_python_index_candidates_equal(vocs, frames, rng):
    _database_candidates_equal(vocs, frames, rng, "python")


def _database_candidates_equal(vocs, frames, rng, index):
    jv, tv = vocs
    vecs = []
    for desc, valid in frames:
        w, _, wt = tb.transform(tv, desc, valid)
        vecs.append(tb.bow_vector(w, wt, tv.n_words))
    # 24 keyframes: the 8 frames, each also with two perturbed copies
    kf_vecs = {}
    for i, (ids, vals) in enumerate(vecs):
        for c in range(3):
            keep = rng.random(len(ids)) < (1.0 if c == 0 else 0.7)
            v = vals[keep] * rng.uniform(0.5, 1.5, keep.sum()).astype(np.float32)
            kf_vecs[3 * i + c] = (ids[keep], (v / v.sum()).astype(np.float32))
    covis = {k: [j for j in (k - 3, k + 3, k + 1, k - 1) if 0 <= j < 24] for k in kf_vecs}
    jdb, tdb = JDatabase(jv, use_native=False), TDatabase(tv, index=index)
    assert not jdb.is_native and tdb.index == index
    for k, (ids, vals) in kf_vecs.items():
        jdb.add(k, ids, vals)
        tdb.add(k, ids, vals)
    for k in (4, 13):
        jdb.erase(k)
        tdb.erase(k)
    world = _StubMap([k for k in kf_vecs if k not in (4, 13)], covis)
    assert len(jdb) == len(tdb) == 22
    n_nonempty = 0
    for q in range(8):
        ids, vals = vecs[q]
        j = jdb.detect_relocalization_candidates(ids, vals, world)
        t = tdb.detect_relocalization_candidates(ids, vals, world)
        assert t == j
        n_nonempty += bool(t)
        jl = jdb.detect_loop_candidates(3 * q, ids, vals, 0.01, {3 * q + 1}, world)
        tl = tdb.detect_loop_candidates(3 * q, ids, vals, 0.01, {3 * q + 1}, world)
        assert tl == jl
        assert tdb.score(3 * q, 3 * q + 1) == jdb.score(3 * q, 3 * q + 1)
        assert tdb.score_vec((ids, vals), 3 * q + 2) == jdb.score_vec((ids, vals), 3 * q + 2)
    assert n_nonempty == 8
    tdb.clear()
    assert len(tdb) == 0 and tdb.detect_relocalization_candidates(*vecs[0], world) == []
