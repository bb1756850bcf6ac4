"""The host C++ runtime: the Map's observation and covisibility index, the
keyframe database's inverted file and the DBoW2 text parser.

Counterpart of orbslam2commentedbyxcm_tpu/native (its ctypes classes of the
same names), over the port's own sources csrc/mapgraph.cpp,
csrc/invindex.cpp and csrc/vocloader.cpp, which `kernels.host_library()`
builds with g++ into build/kernels/ at first use. Arrays go in and out as
numpy buffers. A missing compiler or a failed build raises: nothing falls
back to the Python index here, which runs only where a caller names it
(`Map(index="python")`, `KeyFrameDatabase(index="python")`,
`import_dbow2_text(parser="python")`).

Each object holds a reader-writer lock in C++ (queries shared, mutations
exclusive): a ctypes call releases the interpreter lock, and tracking, the
mapping worker and the loop worker use these objects at once.

Chosen differences from the JAX package's native index, whose outputs follow
its hash containers: covisibility counts come out in first-seen order over
the keyframe's `map_pt` (so ties between equal weights break as the dict
path breaks them), `points_seen_by` returns sorted ids, and the inverted
file returns candidates in first-shared-word order with scores bit-equal to
`ops/bow.l1_score` (numpy's pairwise float32 sum; JAX's C++ sums in
sequence). A Map on either of the port's indexes makes the same decisions.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from orbslam2commentedbyxcm_tpu_torch import kernels


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _rows(fn, args, dtypes, cap: int):
    """Call `fn(*args, *buffers, cap)`, which returns its row count and
    writes nothing when that exceeds `cap`; grow and call again until the
    rows fit. -> (arrays cut to the count, count)."""
    while True:
        outs = [np.empty(max(cap, 1), d) for d in dtypes]
        n = fn(*args, *(_ptr(o) for o in outs), cap)
        if n <= cap:
            return [o[:n] for o in outs], n
        cap = n


class _Handle:
    """A C++ object owned by this Python one (freed with it, never copied)."""

    _new = _free = ""

    def __init__(self):
        self._lib = kernels.host_library()
        self._h = getattr(self._lib, self._new)()
        self._caps: dict[str, int] = {}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            getattr(self._lib, self._free)(h)

    def __copy__(self, *_):
        raise TypeError(f"{type(self).__name__} owns a C++ object and cannot be copied")

    __deepcopy__ = __reduce__ = __copy__

    def _grow(self, key: str, n: int) -> None:
        self._caps[key] = max(self._caps.get(key, 0), n)


class MapGraph(_Handle):
    """Observation index (point -> observers in insertion order) and
    covisibility counting, the mirror of `Map.obs` (csrc/mapgraph.cpp)."""

    _new, _free = "mg_new", "mg_free"

    def clear(self) -> None:
        self._lib.mg_clear(self._h)

    def add(self, pid: int, kf_id: int, feat: int) -> None:
        if self._lib.mg_add(self._h, pid, kf_id, feat) != 0:
            raise ValueError(f"MapGraph.add: negative id (point {pid}, keyframe {kf_id})")

    def erase(self, pid: int, kf_id: int) -> int:
        """Drop the observation; -> the feature it had, or -1."""
        return self._lib.mg_erase(self._h, pid, kf_id)

    def erase_point(self, pid: int) -> None:
        self._lib.mg_erase_point(self._h, pid)

    def covisibility(self, kf_id: int, map_pt: np.ndarray):
        """Shared-point counts of keyframe `kf_id` (whose feature -> point
        array is `map_pt`) with every other keyframe, in first-seen order:
        (kf ids int64, weights int64)."""
        pts = np.ascontiguousarray(map_pt, np.int64)
        (kfs, w), n = _rows(self._lib.mg_covisibility, (self._h, kf_id, _ptr(pts), len(pts)),
                            (np.int64, np.int64), self._caps.get("covis", 64))
        self._grow("covis", n)
        return kfs, w

    def points_seen_by(self, kf_ids) -> np.ndarray:
        """Ascending ids of the points any of `kf_ids` observes (int64)."""
        kfs = np.ascontiguousarray(np.fromiter(kf_ids, np.int64))
        (out,), n = _rows(self._lib.mg_points_seen_by, (self._h, _ptr(kfs), len(kfs)), (np.int64,),
                          self._caps.get("seen", 4096))
        self._grow("seen", n)
        return out

    def export_observers(self, pids: np.ndarray):
        """Rows (index into `pids`, kf id, feature) of every observation of
        `pids`, in `pids` order and then each point's observer order (int64)."""
        p = np.ascontiguousarray(pids, np.int64)
        (idx, kfs, feats), n = _rows(self._lib.mg_export_observers, (self._h, _ptr(p), len(p)),
                                     (np.int64, np.int64, np.int64), self._caps.get("export", 4096))
        self._grow("export", n)
        return idx, kfs, feats


class InvertedIndex(_Handle):
    """BoW inverted file with the database's query prefilters
    (csrc/invindex.cpp); vectors are (word ids, float32 values)."""

    _new, _free = "ii_new", "ii_free"

    @staticmethod
    def _vector(word_ids, values):
        w = np.ascontiguousarray(np.asarray(word_ids).ravel(), np.int32)
        v = np.ascontiguousarray(np.asarray(values).ravel(), np.float32)
        if len(w) != len(v):
            raise ValueError(f"BoW vector with {len(w)} words and {len(v)} values")
        return w, v

    def add(self, kf_id: int, word_ids, values) -> None:
        w, v = self._vector(word_ids, values)
        if self._lib.ii_add(self._h, kf_id, _ptr(w), _ptr(v), len(w)) != 0:
            raise ValueError(f"InvertedIndex.add: negative keyframe or word id (keyframe {kf_id})")

    def erase(self, kf_id: int) -> None:
        self._lib.ii_erase(self._h, kf_id)

    def clear(self) -> None:
        self._lib.ii_clear(self._h)

    def __len__(self) -> int:
        return self._lib.ii_size(self._h)

    def kf_ids(self) -> list[int]:
        """The registered keyframe ids, ascending."""
        (out,), _ = _rows(self._lib.ii_keyframes, (self._h,), (np.int64,), len(self))
        return out.tolist()

    def score(self, kf1: int, kf2: int) -> float:
        out = ctypes.c_double()
        self._lib.ii_score(self._h, kf1, kf2, ctypes.addressof(out))
        return out.value

    def score_vec(self, word_ids, values, kf_id: int) -> float:
        w, v = self._vector(word_ids, values)
        out = ctypes.c_double()
        self._lib.ii_score_vec(self._h, _ptr(w), _ptr(v), len(w), kf_id, ctypes.addressof(out))
        return out.value

    def query(self, word_ids, values, exclude, min_score: float):
        """Keyframes sharing more than 0.8 x the most shared words (those in
        `exclude` left out) with an L1 score >= min_score, in
        first-shared-word order: ([kf id], [score])."""
        w, v = self._vector(word_ids, values)
        ex = np.ascontiguousarray(np.fromiter(exclude, np.int64))
        (kfs, scores), n = _rows(self._lib.ii_query,
                                 (self._h, _ptr(w), _ptr(v), len(w), _ptr(ex), len(ex), float(min_score)),
                                 (np.int64, np.float64), self._caps.get("query", 256))
        self._grow("query", n)
        return kfs.tolist(), scores.tolist()


_PARSE_REASONS = {1: "no 'k L' header", 2: "not an integer", 3: "integer out of range", 4: "not a number"}


def parse_dbow2_text(path: str):
    """Parse a DBoW2 text vocabulary (ORBvoc.txt format) as
    utils/vocab_tools._parse_dbow2_text_py does, bit for bit: -> (k, depth,
    parents int32[n], leaves uint8[n], descs uint8[n, 32], weights
    float32[n]) for the n node lines in file order. Raises ValueError for a
    file that is not such a vocabulary, OSError where it cannot be read."""
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    lib = kernels.host_library()
    info = np.zeros(5, np.int64)
    h = lib.voc_parse(_ptr(buf), len(buf), _ptr(info))
    if not h:
        reason = _PARSE_REASONS.get(int(info[3]), f"error {int(info[3])}")
        raise ValueError(f"{os.fspath(path)}: not a DBoW2 text vocabulary (line {int(info[4])}: {reason})")
    try:
        n = int(info[2])
        parents = np.empty(n, np.int32)
        leaves = np.empty(n, np.uint8)
        descs = np.empty((n, 32), np.uint8)
        weights = np.empty(n, np.float32)
        lib.voc_fill(h, _ptr(parents), _ptr(leaves), _ptr(descs), _ptr(weights))
    finally:
        lib.voc_free(h)
    return int(info[0]), int(info[1]), parents, leaves, descs, weights
