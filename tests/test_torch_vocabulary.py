"""Vocabulary training and the lazy trainer: the port against the JAX package.

`train_vocabulary` must give the JAX package's tree bit for bit from the same
descriptors and seed: node descriptors, children, parents, levels, word ids,
word nodes and idf weights all equal. Cases: clustered descriptors (k = 8,
depth 3, the lazy trainer's tree), a corpus above `max_train` (the seeded
subsample), and the chunked k-means path forced with a small chunk (the
statistics summed chunk by chunk are exact integers, so the tree cannot
change). The System's lazy trainer wires loop closing once the map holds 5
keyframes, with the tree `train_vocabulary_from_map` gives.
"""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import bow as jbow
from orbslam2commentedbyxcm_tpu_torch.ops import bow as tbow

torch.set_num_threads(1)

FIELDS = ("node_desc", "node_children", "node_parent", "node_level", "word_id", "word_weight", "word_node")


def _clustered(rng, n=3000, n_centers=40, flips=12):
    base = rng.integers(0, 2**32, (n_centers, 8), dtype=np.uint32)
    d = base[rng.integers(0, n_centers, n)].copy()
    bits = rng.integers(0, 256, (n, flips))
    for i in range(n):
        for b in bits[i]:
            d[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return d


def _assert_same_tree(vt, vj):
    assert (vt.k, vt.depth) == (vj.k, vj.depth)
    for f in FIELDS:
        a, b = getattr(vt, f), getattr(vj, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", ["k8-depth3", "subsampled", "chunked"])
def test_train_vocabulary_bit_equal(rng, case, monkeypatch):
    d = _clustered(rng)
    kw = dict(k=8, depth=3, seed=0)
    if case == "subsampled":
        kw = dict(k=6, depth=3, seed=3, max_train=2000)
    if case == "chunked":
        monkeypatch.setattr(tbow, "_KMEANS_CHUNK", 256)
    vj = jbow.train_vocabulary(d, **kw)
    vt = tbow.train_vocabulary(d, **kw, device="cpu")
    _assert_same_tree(vt, vj)
    assert vt.n_words > 50
    words_t, groups_t, _ = tbow.transform(vt, d[:200], np.ones(200, bool))
    words_j, groups_j, _ = jbow.transform(vj, d[:200], np.ones(200, bool))
    np.testing.assert_array_equal(words_t, words_j)
    np.testing.assert_array_equal(groups_t, np.asarray(groups_j))


def test_lazy_trainer_wires_loop_closing():
    """vocabulary=None with loop closing on: nothing until 5 keyframes, then
    the tree of train_vocabulary_from_map (k 8, depth 3) over the keyframes'
    descriptors, every keyframe registered and loop closing wired."""
    from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35, tex_size=256)
    s = tsystem.System(cam, tsystem.Sensor.RGBD, config=TrackingConfig(n_features=300, max_frames_between_kf=2),
                       device="cpu")
    i = 0
    while s.vocabulary is None and i < 20:
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
        i += 1
    assert s.vocabulary is not None and s.loop_closing is not None
    assert s.local_mapping.loop_closer is s.loop_closing and s.tracking.vocabulary is s.vocabulary
    kfs = sorted(s.map.good_keyframes(), key=lambda k: k.kf_id)
    assert len(kfs) >= 5
    descs = np.concatenate([kf.desc[kf.valid] for kf in kfs])
    _assert_same_tree(s.vocabulary, jbow.train_vocabulary(descs, k=8, depth=3))
    assert set(s.keyframe_db.kf_ids()) == {kf.kf_id for kf in kfs}
    assert all(kf.bow_feat_nodes is not None for kf in kfs)
    assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
