"""The port's vocabulary tools (utils/vocab_tools) against the JAX
package's: the DBoW2 text importer gives the same tree arrays, training from
PNG images gives the tree bow.train_vocabulary gives on the same
descriptors, and the `train` / `convert` commands round-trip through .npz.

Chosen divergence: the port parses the DBoW2 text in Python only; the JAX
package prefers its prebuilt C++ scanner (native/libvocloader.so, built for
another host), and its test holds that scanner to the same Python parser."""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.utils import vocab_tools as jvocab_tools
from orbslam2commentedbyxcm_tpu_torch.ops import bow
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.utils import png, vocab_tools
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

torch.set_num_threads(1)

TREE = ("node_desc", "node_children", "node_parent", "node_level", "word_id", "word_weight", "word_node")


def _write_synthetic_voc(path, k=3, depth=2, seed=0):
    """Full k-ary tree in BFS order, leaves at the last level (the JAX
    test's writer). Returns the number of non-root nodes."""
    rng = np.random.default_rng(seed)
    lines = [f"{k} {depth} 0 0"]
    level_start = [0, 1]
    for lv in range(1, depth + 1):
        level_start.append(level_start[-1] + k**lv)
    n_nodes = level_start[-1]
    for nid in range(1, n_nodes):
        lvl = next(lv for lv in range(1, depth + 1) if level_start[lv] <= nid < level_start[lv + 1])
        off = nid - level_start[lvl]
        parent = 0 if lvl == 1 else level_start[lvl - 1] + off // k
        is_leaf = 1 if lvl == depth else 0
        d = rng.integers(0, 256, 32)
        w = float(rng.uniform(0, 1e-3)) if is_leaf else 0.0
        lines.append(f"{parent} {is_leaf} " + " ".join(str(int(x)) for x in d) + f" {w:.6e}")
    path.write_text("\n".join(lines) + "\n")
    return n_nodes - 1


def _assert_same_tree(a, b):
    assert (a.k, a.depth, a.n_words) == (b.k, b.depth, b.n_words)
    for name in TREE:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("k,depth,seed", [(3, 2, 2), (3, 3, 1), (5, 2, 7)])
def test_import_matches_jax(tmp_path, k, depth, seed):
    voc_file = tmp_path / "voc.txt"
    n = _write_synthetic_voc(voc_file, k=k, depth=depth, seed=seed)
    voc = vocab_tools.import_dbow2_text(str(voc_file))
    _assert_same_tree(voc, jvocab_tools.import_dbow2_text(str(voc_file)))
    assert voc.n_words == k**depth and len(voc.node_parent) == n + 1
    # levels consistent with parents, children round-trip parents
    lv, par, ch = voc.node_level, voc.node_parent, voc.node_children
    np.testing.assert_array_equal(lv[1:], lv[np.maximum(par[1:], 0)] + 1)
    for nid in range(len(par)):
        assert all(par[c] == nid for c in ch[nid] if c >= 0)
    desc = np.random.default_rng(0).integers(0, 2**32, (16, 8), dtype=np.uint32)
    words, _, _ = bow.transform(voc, desc, np.ones(16, bool))
    assert ((0 <= words) & (words < voc.n_words)).all()


def test_import_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("this is not a vocabulary\n1 2 3\n")
    with pytest.raises(ValueError, match="not a DBoW2 text vocabulary"):
        vocab_tools.import_dbow2_text(str(bad))


def test_train_from_images_and_commands(tmp_path):
    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    seq = BoxSequence(camera=cam, n_frames=40, seed=3, tex_size=512)
    paths = []
    for i in (0, 10, 20):
        paths.append(str(tmp_path / f"{i:06d}.png"))
        png.write_png(paths[-1], seq.render(i).astype(np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    voc = vocab_tools.train_from_images(paths + [str(tmp_path / "notes.txt")], n_features=300, k=4, depth=2,
                                        device="cpu")
    ext = ORBExtractor(n_features=300)
    descs = []
    for p in paths:
        f = ext(torch.from_numpy(png.imread_gray(p).astype(np.float32)))
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    _assert_same_tree(voc, bow.train_vocabulary(np.concatenate(descs), k=4, depth=2, device="cpu"))
    with pytest.raises(ValueError, match="no descriptors"):
        vocab_tools.train_from_images([str(tmp_path / "notes.txt")], device="cpu")

    out = tmp_path / "trained.npz"
    assert vocab_tools.main(["train", str(out), str(tmp_path), "--device", "cpu"]) == 0
    trained = bow.Vocabulary.load(str(out))
    assert trained.k == 10 and trained.depth == 4 and trained.n_words > 10
    voc_file = tmp_path / "voc.txt"
    _write_synthetic_voc(voc_file, k=3, depth=2, seed=2)
    assert vocab_tools.main(["convert", str(voc_file), str(tmp_path / "c.npz")]) == 0
    _assert_same_tree(bow.Vocabulary.load(str(tmp_path / "c.npz")), vocab_tools.import_dbow2_text(str(voc_file)))
    assert vocab_tools.main([]) == 1 and vocab_tools.main(["nope"]) == 1
