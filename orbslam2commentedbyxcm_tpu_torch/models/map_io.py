"""Map checkpoint and restore (the reference left SaveMap/LoadMap as a TODO,
include/System.h:104-106).

Counterpart of orbslam2commentedbyxcm_tpu/models/map_io.py with the same
compressed npz keys, so a checkpoint written by either package loads in the
other: the landmark arrays, per-keyframe feature arrays, poses and graph
(parent, loop edges, the stored pose relative to the parent of an erased
keyframe), the observation index as flat triples, the frame trajectory and
the vocabulary. Loading recomputes covisibility from the observations; the
System re-registers the keyframes' BoW vectors.
"""

from __future__ import annotations

import numpy as np

from orbslam2commentedbyxcm_tpu_torch.models.frame import KeyFrame
from orbslam2commentedbyxcm_tpu_torch.models.map import _POINT_ARRAYS, Map
from orbslam2commentedbyxcm_tpu_torch.ops.bow import Vocabulary

_KF_ARRAYS = ("uv", "uv_und", "angle", "level", "desc", "valid", "u_right", "depth", "map_pt")
_VOC_ARRAYS = ("node_desc", "node_children", "node_parent", "node_level", "word_id", "word_weight", "word_node")


def save_map(world_map: Map, path: str, vocabulary=None, trajectory=None):
    m = world_map
    n = m.n_points
    kfs = sorted(m.keyframes.values(), key=lambda k: k.kf_id)
    data = {name: getattr(m, name)[:n] for name in _POINT_ARRAYS}
    data.update({
        "origin_kf_id": m.origin_kf_id, "next_kf_id": m.next_kf_id,
        "kf_ids": np.array([kf.kf_id for kf in kfs], np.int64),
        "kf_bad": np.array([kf.bad for kf in kfs], bool),
        "kf_timestamps": np.array([kf.timestamp for kf in kfs]),
        "kf_poses": np.stack([kf.t_cw for kf in kfs]) if kfs else np.zeros((0, 4, 4), np.float32),
        "kf_parent": np.array([-1 if kf.parent is None else kf.parent for kf in kfs], np.int64),
    })
    if kfs:
        for name in _KF_ARRAYS:
            data[f"kf_{name}"] = np.stack([getattr(kf, name) for kf in kfs])
        data["kf_tcp"] = np.stack([np.eye(4, dtype=np.float32) if kf.t_child_parent is None
                                   else kf.t_child_parent for kf in kfs])
        data["kf_has_tcp"] = np.array([kf.t_child_parent is not None for kf in kfs], bool)
        data["kf_loop_edges"] = np.array([",".join(map(str, sorted(kf.loop_edges))) for kf in kfs], object)
    triples = [(pid, kf_id, feat) for pid, o in m.obs.items() for kf_id, feat in o.items()]
    data["obs_pid"] = np.array([t[0] for t in triples], np.int64)
    data["obs_kf"] = np.array([t[1] for t in triples], np.int64)
    data["obs_feat"] = np.array([t[2] for t in triples], np.int32)
    if trajectory is not None:
        data["traj_ts"] = np.array([t[0] for t in trajectory])
        data["traj_ref"] = np.array([t[1] for t in trajectory], np.int64)
        data["traj_rel"] = np.stack([t[2] for t in trajectory]) if trajectory else np.zeros((0, 4, 4), np.float32)
    if vocabulary is not None:
        for f in _VOC_ARRAYS:
            data[f"voc_{f}"] = getattr(vocabulary, f)
        data["voc_k"] = vocabulary.k
        data["voc_depth"] = vocabulary.depth
    np.savez_compressed(path, **data)


def load_map(path: str, scale_factor: float = 1.2, n_levels: int = 8, camera=None, *, device):
    """-> (Map on `device`, Vocabulary or None, trajectory). Keyframes come
    back with their frozen feature arrays, poses and graph; covisibility is
    recomputed from the observations."""
    z = np.load(path, allow_pickle=True)
    m = Map(device=device)
    n = len(z["pt_xyz"])
    m._ensure_capacity(n)
    m.n_points = n
    for name in _POINT_ARRAYS:
        getattr(m, name)[:n] = z[name]
    m.origin_kf_id = int(z["origin_kf_id"])
    m.next_kf_id = int(z["next_kf_id"])

    for i, kf_id in enumerate(z["kf_ids"]):
        kf = object.__new__(KeyFrame)
        kf.kf_id, kf.frame_id, kf.timestamp = int(kf_id), -1, float(z["kf_timestamps"][i])
        kf.camera, kf.n_levels, kf.scale_factor = camera, n_levels, scale_factor
        for name in _KF_ARRAYS:
            setattr(kf, name, z[f"kf_{name}"][i].copy())
        kf.t_cw = z["kf_poses"][i].copy()
        p = int(z["kf_parent"][i])
        kf.parent = None if p < 0 else p
        kf.children = set()
        kf.loop_edges = {int(x) for x in str(z["kf_loop_edges"][i]).split(",") if x}
        kf.bad = bool(z["kf_bad"][i])
        kf.not_erase = False
        kf.t_child_parent = z["kf_tcp"][i].copy() if z["kf_has_tcp"][i] else None
        kf.covis = {}
        kf._inv_sigma2 = None
        kf.bow_vec = None
        kf.bow_feat_nodes = None
        m.keyframes[kf.kf_id] = kf
    for kf in m.keyframes.values():
        if kf.parent is not None and kf.parent in m.keyframes:
            m.keyframes[kf.parent].children.add(kf.kf_id)

    m.obs = {}
    for pid, kf_id, feat in zip(z["obs_pid"], z["obs_kf"], z["obs_feat"]):
        m.obs.setdefault(int(pid), {})[int(kf_id)] = int(feat)
    for kf in m.keyframes.values():
        if not kf.bad:
            m.update_connections(kf)

    vocabulary = None
    if "voc_k" in z:
        vocabulary = Vocabulary(k=int(z["voc_k"]), depth=int(z["voc_depth"]),
                                **{f: z[f"voc_{f}"] for f in _VOC_ARRAYS})
    trajectory = []
    if "traj_ts" in z:
        trajectory = [(float(ts), int(ref), rel) for ts, ref, rel in zip(z["traj_ts"], z["traj_ref"], z["traj_rel"])]
    return m, vocabulary, trajectory
