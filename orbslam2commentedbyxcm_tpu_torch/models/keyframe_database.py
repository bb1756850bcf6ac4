"""BoW inverted-file keyframe database (reference src/KeyFrameDatabase.cc).

Counterpart of orbslam2commentedbyxcm_tpu/models/keyframe_database.py. Word
id -> keyframe ids; loop candidates use shared-word counting, the 0.8 x max
common words filter, a minimum score and covisibility-group accumulated
scoring with 0.75 x best-group retention (DetectLoopCandidates, :79-198);
relocalization candidates are the same query without the minimum score and
the connected exclusion (:206-309), returned best group first.

`KeyFrameDatabase(vocabulary, index="native")`, the default, keeps the
inverted file and runs its query prefilters in the host C++ index
(native.InvertedIndex, csrc/invindex.cpp), as the JAX package does when its
library builds; `index="python"` runs `_PyInvertedFile`, the dict twin with
the same surface. There is no silent fallback between them. Both return the
same candidates in the same (first-shared-word) order with bit-equal scores.
The covisibility-group stage stays here: it reads the live covisibility
graph.
"""

from __future__ import annotations

import numpy as np

from orbslam2commentedbyxcm_tpu_torch import native
from orbslam2commentedbyxcm_tpu_torch.models.map import INDEXES
from orbslam2commentedbyxcm_tpu_torch.ops import bow


class _PyInvertedFile:
    """Inverted file in dicts: word -> keyframe ids, and each keyframe's BoW
    vector (the surface of native.InvertedIndex)."""

    def __init__(self):
        self.inverted: dict[int, list[int]] = {}
        self.vectors: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def add(self, kf_id: int, word_ids: np.ndarray, values: np.ndarray):
        self.vectors[kf_id] = (np.asarray(word_ids), np.asarray(values))
        for w in word_ids:
            self.inverted.setdefault(int(w), []).append(kf_id)

    def erase(self, kf_id: int):
        vec = self.vectors.pop(kf_id, None)
        if vec is None:
            return
        for w in vec[0]:
            lst = self.inverted.get(int(w))
            if lst is not None and kf_id in lst:
                lst.remove(kf_id)

    def clear(self):
        self.inverted.clear()
        self.vectors.clear()

    def __len__(self):
        return len(self.vectors)

    def kf_ids(self) -> list[int]:
        return sorted(self.vectors)

    def score(self, kf1: int, kf2: int) -> float:
        a, b = self.vectors.get(kf1), self.vectors.get(kf2)
        if a is None or b is None:
            return 0.0
        return bow.l1_score(a[0], a[1], b[0], b[1])

    def score_vec(self, word_ids, values, kf_id: int) -> float:
        b = self.vectors.get(kf_id)
        if b is None:
            return 0.0
        return bow.l1_score(word_ids, values, b[0], b[1])

    def query(self, word_ids, values, exclude, min_score):
        """Keyframes sharing more than 0.8 x the most shared words, scored
        (L1) and kept at >= min_score, in first-shared-word order."""
        counts: dict[int, int] = {}
        for w in word_ids:
            for kf_id in self.inverted.get(int(w), ()):
                if kf_id not in exclude:
                    counts[kf_id] = counts.get(kf_id, 0) + 1
        if not counts:
            return [], []
        min_common = 0.8 * max(counts.values())
        kfs, scores = [], []
        for kf_id, c in counts.items():
            if c <= min_common:
                continue
            vec = self.vectors.get(kf_id)
            if vec is None:
                continue
            s = bow.l1_score(word_ids, values, vec[0], vec[1])
            if s >= min_score:
                kfs.append(kf_id)
                scores.append(s)
        return kfs, scores


class KeyFrameDatabase:
    """The inverted file (native or Python, by `index`) and the candidate
    queries over it."""

    def __init__(self, vocabulary: bow.Vocabulary | None, index: str = "native"):
        if index not in INDEXES:
            raise ValueError(f"KeyFrameDatabase(index={index!r}): one of {INDEXES}")
        self.voc = vocabulary
        self.index = index
        self._file = native.InvertedIndex() if index == "native" else _PyInvertedFile()

    def add(self, kf_id: int, word_ids: np.ndarray, values: np.ndarray):
        self._file.add(kf_id, word_ids, values)

    def erase(self, kf_id: int):
        self._file.erase(kf_id)

    def clear(self):
        self._file.clear()

    def __len__(self):
        return len(self._file)

    def kf_ids(self) -> list[int]:
        """The registered keyframe ids, ascending."""
        return self._file.kf_ids()

    def score(self, kf1: int, kf2: int) -> float:
        return self._file.score(kf1, kf2)

    def score_vec(self, vec, kf_id: int) -> float:
        """Score an unregistered BoW vector against a stored keyframe."""
        return 0.0 if vec is None else self._file.score_vec(vec[0], vec[1], kf_id)

    @staticmethod
    def _group_accumulate(scored, world_map) -> list[int]:
        """Covisibility-group accumulated scoring with 0.75 x best retention
        (src/KeyFrameDatabase.cc:139-198); the best group first."""
        by_id = dict(scored)
        group_scores = []
        for kf_id, s in scored:
            kf = world_map.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            acc, best_id, best_s = s, kf_id, s
            for nb in kf.best_covisible(10):
                pair = by_id.get(nb)
                if pair is not None:
                    acc += pair
                    if pair > best_s:
                        best_s, best_id = pair, nb
            group_scores.append((acc, best_id))
        if not group_scores:
            return []
        th = 0.75 * max(g[0] for g in group_scores)
        out, seen = [], set()
        for acc, kf_id in sorted(group_scores, key=lambda g: -g[0]):
            if acc > th and kf_id not in seen:
                seen.add(kf_id)
                out.append(kf_id)
        return out

    def _live(self, kfs, scores, world_map):
        return [(kf_id, s) for kf_id, s in zip(kfs, scores)
                if (kf := world_map.keyframes.get(kf_id)) is not None and not kf.bad]

    def detect_loop_candidates(self, query_kf_id: int, word_ids, values, min_score: float,
                               connected: set[int], world_map) -> list[int]:
        """Loop candidates for the query keyframe, its covisible set excluded
        (DetectLoopCandidates)."""
        kfs, scores = self._file.query(word_ids, values, set(connected) | {query_kf_id}, min_score)
        scored = self._live(kfs, scores, world_map)
        return self._group_accumulate(scored, world_map) if scored else []

    def detect_relocalization_candidates(self, word_ids, values, world_map) -> list[int]:
        """Relocalization candidates for a frame's BoW vector
        (DetectRelocalizationCandidates)."""
        kfs, scores = self._file.query(word_ids, values, set(), -np.inf)
        scored = self._live(kfs, scores, world_map)
        return self._group_accumulate(scored, world_map) if scored else []
