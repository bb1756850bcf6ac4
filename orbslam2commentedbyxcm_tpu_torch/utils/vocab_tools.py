"""Offline vocabulary tools: train/save/load, plus a DBoW2-text importer.

Counterpart of orbslam2commentedbyxcm_tpu/utils/vocab_tools.py. The
reference ships a pre-trained ORBvoc.txt (~1M nodes, loaded at startup,
src/System.cc:65-75 / TemplatedVocabulary::loadFromTextFile :1338). This
engine trains vocabularies for its own descriptors (ops/bow.train_vocabulary,
here on a torch device) and stores them as .npz; `import_dbow2_text` also
converts a DBoW2 text vocabulary into the packed format (tree topology and
weights are format-compatible; descriptor semantics are not, so a converted
ORBvoc quantizes but is suboptimal for this pattern). Images are read with
the port's PNG codec (utils/png). The DBoW2 text is parsed in Python only:
the JAX package's prebuilt C++ scanner is not used.

CLI:
  python -m orbslam2commentedbyxcm_tpu_torch.utils.vocab_tools train OUT.npz IMG_DIR_OR_PNG... [--device cuda]
  python -m orbslam2commentedbyxcm_tpu_torch.utils.vocab_tools convert ORBvoc.txt OUT.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops import bow


def train_from_images(image_paths, n_features=1000, k=10, depth=4, *, device, **kw) -> bow.Vocabulary:
    """Extract ORB features from each PNG on `device` and train a vocabulary
    from their descriptors there (bow.train_vocabulary's keywords pass on).
    Files that do not decode are skipped, as cv2.imread's None was."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu_torch.utils import png

    ext = ORBExtractor(n_features=n_features)
    descs = []
    for p in image_paths:
        try:
            img = png.imread_gray(p)
        except (OSError, ValueError):
            continue
        f = ext(torch.from_numpy(img.astype(np.float32)).to(device))
        descs.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
    if not descs:
        raise ValueError("no descriptors extracted")
    return bow.train_vocabulary(np.concatenate(descs), k=k, depth=depth, device=device, **kw)


def _parse_dbow2_text_py(path: str):
    """Parser for the DBoW2 text format: (k, depth, parents, leaves, descs,
    weights)."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            vals = line.split()
            if len(vals) < 35:
                continue
            parents.append(int(vals[0]))
            leaves.append(int(vals[1]) != 0)
            descs.append([int(v) for v in vals[2:34]])
            weights.append(float(vals[34]))
    return (
        k, depth, np.asarray(parents, np.int32), np.asarray(leaves, np.uint8),
        np.asarray(descs, np.uint8), np.asarray(weights, np.float32),
    )


def import_dbow2_text(path: str) -> bow.Vocabulary:
    """Convert a DBoW2 text vocabulary (ORBvoc.txt format) to packed arrays.

    Format (TemplatedVocabulary::loadFromTextFile,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338): header `k L s1 s2`,
    then one line per node: parent_id is_leaf d0..d31 weight. Tree assembly
    is vectorized numpy. A file that is not such a vocabulary raises
    ValueError."""
    try:
        k, depth, parents, leaves, desc_u8, weights = _parse_dbow2_text_py(path)
    except (ValueError, IndexError) as e:
        raise ValueError(f"{path}: not a DBoW2 text vocabulary ({e})") from e
    if len(parents) == 0 or k < 1 or depth < 1:
        raise ValueError(f"{path}: not a DBoW2 text vocabulary (no node lines)")

    n = len(parents) + 1  # +1 root
    idx = np.arange(1, n, dtype=np.int32)
    par = np.where(parents >= 0, parents, 0).astype(np.int32)
    node_parent = np.full(n, -1, np.int32)
    node_parent[1:] = par
    node_desc = np.zeros((n, 8), np.uint32)
    node_desc[1:] = np.ascontiguousarray(desc_u8.reshape(n - 1, 32)).view(np.uint32)
    w = np.zeros(n, np.float32)
    w[1:] = weights

    # Levels: parents precede children in the file, so level[i] =
    # level[parent]+1 reaches a fixed point within `depth`+1 relaxation passes.
    node_level = np.zeros(n, np.int32)
    for _ in range(depth + 2):
        new = node_level[np.maximum(node_parent, 0)] + 1
        new[0] = 0
        if np.array_equal(new, node_level):
            break
        node_level = new

    # Children table: rank of each node within its parent (file order).
    order = np.argsort(par, kind="stable")
    sp = par[order]
    starts = np.flatnonzero(np.r_[True, sp[1:] != sp[:-1]])
    group_start = np.repeat(starts, np.diff(np.r_[starts, len(sp)]))
    rank = np.empty(n - 1, np.int64)
    rank[order] = np.arange(len(sp)) - group_start
    children_arr = np.full((n, k), -1, np.int32)
    m = rank < k
    children_arr[par[m], rank[m]] = idx[m]

    child_count = np.bincount(par, minlength=n)
    leaf_mask = leaves.astype(bool) | (child_count[1:] == 0)
    leaf_ids = idx[leaf_mask]
    word_id = np.full(n, -1, np.int32)
    word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    return bow.Vocabulary(
        k=k, depth=depth, node_desc=node_desc, node_children=children_arr,
        node_parent=node_parent, node_level=node_level, word_id=word_id,
        word_weight=w[leaf_ids].astype(np.float32), word_node=leaf_ids,
    )


def _image_paths(items) -> list[str]:
    paths = []
    for d in items:
        if os.path.isdir(d):
            paths.extend(
                os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.lower().endswith(".png")
            )
        else:
            paths.append(d)
    return paths


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] not in ("train", "convert"):
        print(__doc__)
        return 1
    ap = argparse.ArgumentParser(prog="python -m orbslam2commentedbyxcm_tpu_torch.utils.vocab_tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    train = sub.add_parser("train", help="train a vocabulary from PNG images")
    train.add_argument("out")
    train.add_argument("images", nargs="+", help="PNG files or directories of them")
    train.add_argument("--device", default="cuda", help="torch device to extract and train on (default cuda)")
    convert = sub.add_parser("convert", help="convert a DBoW2 text vocabulary to .npz")
    convert.add_argument("src")
    convert.add_argument("out")
    args = ap.parse_args(argv)
    if args.cmd == "train":
        voc = train_from_images(_image_paths(args.images), device=args.device)
        voc.save(args.out)
        print(f"trained vocabulary: {voc.n_words} words -> {args.out}")
    else:
        voc = import_dbow2_text(args.src)
        voc.save(args.out)
        print(f"converted: {voc.n_words} words -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
