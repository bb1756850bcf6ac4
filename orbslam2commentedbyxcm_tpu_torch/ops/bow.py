"""Binary bag of words on torch tensors: the vocabulary tree, its batched
descent and the BoW vectors and scores (DBoW2, Thirdparty/DBoW2).

Counterpart of `Vocabulary`, `transform`, `bootstrap_vocabulary`,
`bow_vector`, `l1_score` and `score` in orbslam2commentedbyxcm_tpu/ops/bow.py.
The tree is packed arrays (per-node descriptors, children), uploaded once per
device; `transform` descends it for all descriptors at once, one gather of
the k children plus XOR and a SWAR popcount per level (TemplatedVocabulary
transform, levelsup 4), on the device of the tree. Word and grouping-node ids
are bit-equal to the JAX package's for the same descriptors.

Vocabulary training (the JAX package's `train_vocabulary`) is not ported:
`bootstrap_vocabulary` loads the tree the JAX package ships, by path.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

BOOTSTRAP_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              "orbslam2commentedbyxcm_tpu", "assets", "bootstrap_vocab.npz")


@dataclasses.dataclass
class Vocabulary:
    """Packed vocabulary tree; nodes in BFS order, node 0 the root, leaves
    are words."""

    k: int                      # branching factor
    depth: int                  # number of levels below the root
    node_desc: np.ndarray       # (n_nodes, 8) uint32
    node_children: np.ndarray   # (n_nodes, k) int32, -1 = none
    node_parent: np.ndarray     # (n_nodes,) int32
    node_level: np.ndarray      # (n_nodes,) int32 (root = 0)
    word_id: np.ndarray         # (n_nodes,) int32, -1 unless a leaf
    word_weight: np.ndarray     # (n_words,) float32, idf
    word_node: np.ndarray       # (n_words,) int32, node of each word

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    def device_tree(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(node_desc int32, node_children int32) on `device`, uploaded once
        per device and cached on the instance."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dev_trees", {})
        if device not in cache:
            cache[device] = (
                torch.from_numpy(np.ascontiguousarray(self.node_desc, np.uint32).view(np.int32)).to(device),
                torch.from_numpy(np.ascontiguousarray(self.node_children, np.int32)).to(device),
            )
        return cache[device]

    def device_bytes(self) -> int:
        """Bytes of one device copy of the tree."""
        return self.node_desc.size * 4 + self.node_children.size * 4

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        z = np.load(path)
        return cls(
            k=int(z["k"]), depth=int(z["depth"]), node_desc=z["node_desc"],
            node_children=z["node_children"], node_parent=z["node_parent"],
            node_level=z["node_level"], word_id=z["word_id"],
            word_weight=z["word_weight"], word_node=z["word_node"],
        )


def bootstrap_vocabulary(path: str = BOOTSTRAP_PATH) -> Vocabulary:
    """The vocabulary the JAX package ships (assets/bootstrap_vocab.npz,
    trained offline on this engine's own descriptors; k = 10, depth 6)."""
    return Vocabulary.load(path)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (read as uint32) by the SWAR bit count,
    in int64 so that the shifts are logical."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def descend(desc: torch.Tensor, node_desc: torch.Tensor, children: torch.Tensor, depth: int, levelsup: int):
    """Tree descent of (N, 8) int32 descriptors: at each level the child with
    the least Hamming distance (first on ties, as jnp.argmin); a node without
    children is kept. Returns (leaf node (N,), node `levelsup` levels above
    the leaves (N,))."""
    n = desc.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=desc.device)
    node_at_levelsup = node
    for lvl in range(depth):
        ch = children[node].long()                      # (N, k)
        has_child = ch >= 0
        ch_safe = torch.clamp(ch, min=0)
        x = desc[:, None, :] ^ node_desc[ch_safe]        # (N, k, 8)
        d = popcount32(x).sum(-1)
        d = torch.where(has_child, d, 1 << 20)
        nxt = torch.gather(ch_safe, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
        node = torch.where(has_child.any(dim=1), nxt, node)
        if lvl + 1 == depth - levelsup:
            node_at_levelsup = node
    return node, node_at_levelsup


_TRANSFORM_CHUNK = 1 << 16


def transform(voc: Vocabulary, descriptors, valid, levelsup: int = 4, device=None):
    """Word (leaf) and grouping node `levelsup` levels above the leaves for
    each descriptor (DBoW2 FeatureVector grouping, levelsup 4 as the
    reference's ORBvoc transform, src/Frame.cc:573-583).

    `descriptors` is an (N, 8) uint32 array or int32 tensor; the descent runs
    on `device` (default: the tensor's, else the CPU). Returns numpy
    (word (N,), group node (N,), weight (N,)), word -1 for invalid slots."""
    levelsup = min(levelsup, voc.depth - 1)
    if isinstance(descriptors, torch.Tensor):
        desc = descriptors.to(device) if device is not None else descriptors
    else:
        desc = torch.from_numpy(np.array(descriptors, np.uint32).view(np.int32))
        desc = desc.to(device if device is not None else "cpu")
    nd, nc = voc.device_tree(desc.device)
    nodes, groups = [], []
    for s in range(0, max(len(desc), 1), _TRANSFORM_CHUNK):
        no, gr = descend(desc[s:s + _TRANSFORM_CHUNK], nd, nc, voc.depth, levelsup)
        nodes.append(no)
        groups.append(gr)
    node = torch.cat(nodes).cpu().numpy()
    group = torch.cat(groups).cpu().numpy().astype(np.int32)
    valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else np.asarray(valid)
    words = np.where(valid, voc.word_id[node], -1)
    weights = np.where(words >= 0, voc.word_weight[np.maximum(words, 0)], 0.0)
    return words, group, weights.astype(np.float32)


def bow_vector(words: np.ndarray, weights: np.ndarray, n_words: int, norm: str = "l1"):
    """Normalized sparse BoW vector (word_ids int32, values float32); 'l1'
    pairs with the L1 / chi2 / KL / Bhattacharyya scorings, 'l2' with L2 /
    dot product (DBoW2 BowVector::normalize)."""
    m = words >= 0
    vec = np.bincount(words[m], weights=weights[m], minlength=n_words)
    ids = np.nonzero(vec)[0]
    vals = vec[ids]
    s = vals.sum() if norm == "l1" else np.sqrt((vals * vals).sum())
    if s > 0:
        vals = vals / s
    return ids.astype(np.int32), vals.astype(np.float32)


def l1_score(ids1, vals1, ids2, vals2) -> float:
    """DBoW2 L1 scoring of L1-normalized vectors: sum_i min(v1_i, v2_i)
    (= 1 - 0.5 |v1 - v2|_1)."""
    common, i1, i2 = np.intersect1d(ids1, ids2, return_indices=True)
    if len(common) == 0:
        return 0.0
    return float(2.0 * np.minimum(vals1[i1], vals2[i2]).sum()) * 0.5


_LOG_EPS = float(np.log(np.finfo(np.float64).eps))


def score(ids1, vals1, ids2, vals2, method: str = "l1") -> float:
    """The six DBoW2 scorings (ScoringObject.cpp): l1, l2, chi_square, kl
    (lower is closer), bhattacharyya, dot_product."""
    common, i1, i2 = np.intersect1d(ids1, ids2, return_indices=True)
    a = np.asarray(vals1, np.float64)
    b = np.asarray(vals2, np.float64)
    ca, cb = a[i1], b[i2]
    if method == "l1":
        return float(np.minimum(ca, cb).sum())
    if method == "l2":
        s = float((ca * cb).sum())
        return 1.0 if s >= 1.0 else 1.0 - np.sqrt(1.0 - s)
    if method == "chi_square":
        denom = ca + cb
        ok = denom != 0.0
        return float(2.0 * (ca[ok] * cb[ok] / denom[ok]).sum())
    if method == "kl":
        ok = (ca != 0) & (cb != 0)
        s = float((ca[ok] * np.log(ca[ok] / cb[ok])).sum())
        only1 = np.setdiff1d(np.arange(len(a)), i1, assume_unique=False)
        v = a[only1]
        v = v[v != 0]
        return s + float((v * (np.log(v) - _LOG_EPS)).sum())
    if method == "bhattacharyya":
        return float(np.sqrt(ca * cb).sum())
    if method == "dot_product":
        return float((ca * cb).sum())
    raise ValueError(f"unknown scoring method: {method}")
