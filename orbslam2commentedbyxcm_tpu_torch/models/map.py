"""The global map: struct-of-arrays landmark store + keyframe graph.

Counterpart of orbslam2commentedbyxcm_tpu/models/map.py (reference src/Map.cc,
src/MapPoint.cc, src/KeyFrame.cc:324-...). Landmarks live in flat numpy
arrays, observations in a (point -> {kf: feat_idx}) dict index, and the
covisibility graph / spanning tree are maintained per keyframe. The JAX
package can mirror the observation index in a C++ library; the port keeps the
dict path of that class (the path it takes without the library).

One deliberate difference: `points_seen_by` returns sorted ids, where the JAX
package's C++ index returns hash-set order. The order decides the local
pack's slot order, argmin ties between points and which points fall past the
4096-point local cap, so the port's runs are deterministic and its tests
compare such sets as sets.

`Map.pack_points` packs points into fixed-capacity tensors on a device;
`pack_points` and `map_pack_from_rgbd_frame` do the same for tensors that are
already on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.frame import KeyFrame
from orbslam2commentedbyxcm_tpu_torch.ops.orb import FrameFeatures
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import se3_inverse

_POINT_ARRAYS = (
    "pt_xyz", "pt_desc", "pt_normal", "pt_dmin", "pt_dmax", "pt_valid",
    "pt_ref_kf", "pt_first_kf", "pt_visible", "pt_found", "pt_replaced_by",
)
_MINUS_ONE = ("pt_ref_kf", "pt_first_kf", "pt_replaced_by")


class Map:
    def __init__(self, device, point_capacity: int = 1 << 14):
        cap = point_capacity
        self.device = torch.device(device)  # where pack_points puts its tensors
        self.pt_xyz = np.zeros((cap, 3), np.float32)
        self.pt_desc = np.zeros((cap, 8), np.uint32)
        self.pt_normal = np.zeros((cap, 3), np.float32)
        self.pt_dmin = np.zeros(cap, np.float32)
        self.pt_dmax = np.zeros(cap, np.float32)
        self.pt_valid = np.zeros(cap, bool)
        self.pt_ref_kf = np.full(cap, -1, np.int64)
        self.pt_first_kf = np.full(cap, -1, np.int64)
        self.pt_visible = np.zeros(cap, np.int32)   # tracking visibility counter
        self.pt_found = np.zeros(cap, np.int32)     # tracking found counter
        self.pt_replaced_by = np.full(cap, -1, np.int64)
        self.n_points = 0
        # bumped on every mutation of the packed point attributes (xyz, desc,
        # normal, dmin/dmax, valid): Tracking keys its device-side pack cache
        # on it. Writers of pt_* arrays (BA write-back) bump it themselves.
        self.pt_version = 0

        self.obs: dict[int, dict[int, int]] = {}    # pid -> {kf_id: feat_idx}
        self.keyframes: dict[int, KeyFrame] = {}
        self.next_kf_id = 0
        self.origin_kf_id = 0
        self.big_change_idx = 0
        self.erase_hooks: list = []  # called with kf_id when a keyframe is erased

    # -- capacity ---------------------------------------------------------

    def _ensure_capacity(self, n_new: int):
        cap = len(self.pt_valid)
        if self.n_points + n_new <= cap:
            return
        new_cap = cap
        while new_cap < self.n_points + n_new:
            new_cap *= 2
        for name in _POINT_ARRAYS:
            arr = getattr(self, name)
            grown = np.full((new_cap,) + arr.shape[1:], -1 if name in _MINUS_ONE else 0, arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)

    # -- keyframes --------------------------------------------------------

    def add_keyframe(self, frame) -> KeyFrame:
        kf = KeyFrame(frame, self.next_kf_id)
        self.keyframes[kf.kf_id] = kf
        self.next_kf_id += 1
        return kf

    def good_keyframes(self) -> list[KeyFrame]:
        return [kf for kf in self.keyframes.values() if not kf.bad]

    # -- map points -------------------------------------------------------

    def add_point(self, xyz, desc, ref_kf_id: int, normal=None, dmin=0.0, dmax=1e9) -> int:
        self._ensure_capacity(1)
        pid = self.n_points
        self.n_points += 1
        self.pt_xyz[pid] = xyz
        self.pt_desc[pid] = desc
        self.pt_normal[pid] = normal if normal is not None else (0, 0, 1)
        self.pt_dmin[pid] = dmin
        self.pt_dmax[pid] = dmax
        self.pt_valid[pid] = True
        self.pt_ref_kf[pid] = ref_kf_id
        self.pt_first_kf[pid] = ref_kf_id
        self.obs[pid] = {}
        self.pt_version += 1
        return pid

    def add_observation(self, pid: int, kf_id: int, feat_idx: int):
        self.obs[pid][kf_id] = feat_idx
        self.keyframes[kf_id].map_pt[feat_idx] = pid

    def erase_observation(self, pid: int, kf_id: int):
        o = self.obs.get(pid)
        if o is None or kf_id not in o:
            return
        idx = o.pop(kf_id)
        kf = self.keyframes.get(kf_id)
        if kf is not None and kf.map_pt[idx] == pid:
            kf.map_pt[idx] = -1
        if self.pt_ref_kf[pid] == kf_id and o:
            self.pt_ref_kf[pid] = next(iter(o))
        # reference: a point dies below 2 observations (src/MapPoint.cc:153-183)
        if len(o) <= 1:
            self.erase_point(pid)

    def erase_point(self, pid: int):
        if not self.pt_valid[pid]:
            return
        self.pt_valid[pid] = False
        self.pt_version += 1
        for kf_id, idx in list(self.obs.get(pid, {}).items()):
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.map_pt[idx] == pid:
                kf.map_pt[idx] = -1
        self.obs.pop(pid, None)

    def replace_point(self, old_pid: int, new_pid: int):
        """MapPoint::Replace: merge old into new."""
        if old_pid == new_pid or not self.pt_valid[old_pid]:
            return
        for kf_id, idx in list(self.obs.get(old_pid, {}).items()):
            kf = self.keyframes.get(kf_id)
            if kf_id not in self.obs.get(new_pid, {}):
                self.obs[new_pid][kf_id] = idx
                if kf is not None:
                    kf.map_pt[idx] = new_pid
            elif kf is not None and kf.map_pt[idx] == old_pid:
                kf.map_pt[idx] = -1
        self.pt_found[new_pid] += self.pt_found[old_pid]
        self.pt_visible[new_pid] += self.pt_visible[old_pid]
        self.pt_valid[old_pid] = False
        self.pt_version += 1
        self.pt_replaced_by[old_pid] = new_pid
        self.obs.pop(old_pid, None)
        self.update_point_descriptor(new_pid)

    def resolve_replaced(self, pid: int) -> int:
        """Follow one point's Replace chain to a valid point, or -1."""
        return int(self.resolve_replaced_batch(np.array([pid]))[0])

    def resolve_replaced_batch(self, pids: np.ndarray) -> np.ndarray:
        """Follow Replace chains over an int array (negative entries pass
        through) until valid, or -1 when dead (CheckReplacedInLastFrame)."""
        cur = np.asarray(pids, np.int64).copy()
        for _ in range(32):
            stale = (cur >= 0) & ~self.pt_valid[np.maximum(cur, 0)]
            if not stale.any():
                break
            cur[stale] = self.pt_replaced_by[cur[stale]]
        cur[(cur >= 0) & ~self.pt_valid[np.maximum(cur, 0)]] = -1
        return cur

    def n_observations(self, pid: int) -> int:
        return len(self.obs.get(pid, {}))

    # -- derived point attributes ----------------------------------------

    def update_point_descriptor(self, pid: int):
        """Distinctive descriptor = min-median-Hamming over observations
        (MapPoint::ComputeDistinctiveDescriptors, src/MapPoint.cc:295)."""
        o = self.obs.get(pid)
        if not o:
            return
        descs = np.stack([self.keyframes[k].desc[i] for k, i in o.items() if k in self.keyframes])
        self.pt_version += 1
        if len(descs) == 1:
            self.pt_desc[pid] = descs[0]
            return
        bits = np.unpackbits(descs.view(np.uint8), axis=1)
        d = (bits[:, None, :] != bits[None, :, :]).sum(-1)
        self.pt_desc[pid] = descs[np.argmin(np.median(d, axis=1))]

    def update_point_normal_depth(self, pid: int):
        """Mean viewing direction + scale-invariance band
        (MapPoint::UpdateNormalAndDepth, src/MapPoint.cc:386)."""
        o = self.obs.get(pid)
        if not o:
            return
        xyz = self.pt_xyz[pid]
        normals = []
        for kf_id in o:
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            v = xyz - kf.center
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
        if not normals:
            return
        self.pt_version += 1
        self.pt_normal[pid] = np.mean(normals, axis=0)
        ref_id = int(self.pt_ref_kf[pid])
        ref = self.keyframes.get(ref_id)
        if ref is None or ref_id not in o:
            return
        dist = np.linalg.norm(xyz - ref.center)
        sf = ref.scale_factor
        self.pt_dmax[pid] = dist * (sf ** int(ref.level[o[ref_id]]))
        self.pt_dmin[pid] = self.pt_dmax[pid] / (sf ** (ref.n_levels - 1))

    def _observer_csr(self, pids: np.ndarray):
        """(pid_idx, kf_id, feat_idx) rows for all observations of `pids`."""
        rows = [(i, k, f) for i, p in enumerate(pids) for k, f in self.obs.get(int(p), {}).items()]
        if not rows:
            return (np.zeros(0, np.int64),) * 3
        a = np.asarray(rows, np.int64)
        return a[:, 0], a[:, 1], a[:, 2]

    def update_points_batch(self, pids):
        """Vectorized MapPoint::UpdateNormalAndDepth over many points."""
        pids = np.unique(np.asarray(pids, np.int64))
        pids = pids[self.pt_valid[pids]] if len(pids) else pids
        if len(pids) == 0:
            return
        pid_idx, kf_arr, ft_arr = self._observer_csr(pids)
        if len(pid_idx) == 0:
            return
        self.pt_version += 1
        kf_ids = np.unique(kf_arr)
        live = np.array([int(k) in self.keyframes for k in kf_ids])
        centers = np.stack([
            self.keyframes[int(k)].center if ok else np.zeros(3, np.float32)
            for k, ok in zip(kf_ids, live)
        ])
        rows = np.searchsorted(kf_ids, kf_arr)
        good = live[rows]

        xyz = self.pt_xyz[pids]
        v = xyz[pid_idx] - centers[rows]
        nv = np.linalg.norm(v, axis=1)
        ok = good & (nv > 1e-9)
        vn = np.where(ok[:, None], v / np.maximum(nv, 1e-9)[:, None], 0.0)
        nsum = np.zeros((len(pids), 3))
        np.add.at(nsum, pid_idx, vn)
        cnt = np.zeros(len(pids))
        np.add.at(cnt, pid_idx, ok.astype(np.float64))
        has = cnt > 0
        self.pt_normal[pids[has]] = (nsum[has] / cnt[has, None]).astype(np.float32)

        # scale band from the reference keyframe's observing feature level
        ref = self.pt_ref_kf[pids]
        sel = np.nonzero((kf_arr == ref[pid_idx]) & good)[0]
        if len(sel) == 0:
            return
        lv = np.fromiter((self.keyframes[int(kf_arr[s])].level[ft_arr[s]] for s in sel),
                         np.int64, count=len(sel))
        any_kf = self.keyframes[int(kf_ids[live][0])]
        sf, n_levels = any_kf.scale_factor, any_kf.n_levels
        tgt = pid_idx[sel]
        dist = np.linalg.norm(xyz[tgt] - centers[rows[sel]], axis=1)
        dmax = dist * sf ** lv
        self.pt_dmax[pids[tgt]] = dmax.astype(np.float32)
        self.pt_dmin[pids[tgt]] = (dmax / sf ** (n_levels - 1)).astype(np.float32)

    def update_point_descriptors_batch(self, pids):
        """Vectorized ComputeDistinctiveDescriptors, points grouped by
        observation count (pairwise Hamming via unpacked bits)."""
        pids = np.unique(np.asarray(pids, np.int64))
        pids = pids[self.pt_valid[pids]] if len(pids) else pids
        if len(pids) == 0:
            return
        pid_idx, kf_arr, ft_arr = self._observer_csr(pids)
        if len(pid_idx) == 0:
            return
        self.pt_version += 1
        live = np.fromiter((int(k) in self.keyframes for k in kf_arr), bool, count=len(kf_arr))
        pid_idx, kf_arr, ft_arr = pid_idx[live], kf_arr[live], ft_arr[live]
        descs = np.zeros((len(pid_idx), 8), np.uint32)
        for k in np.unique(kf_arr):
            sel = kf_arr == k
            descs[sel] = self.keyframes[int(k)].desc[ft_arr[sel]]
        counts = np.bincount(pid_idx, minlength=len(pids))
        descs = descs[np.argsort(pid_idx, kind="stable")]
        starts = np.zeros(len(pids) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        for c in np.unique(counts):
            if c == 0:
                continue
            which = np.nonzero(counts == c)[0]
            if c == 1:
                self.pt_desc[pids[which]] = descs[starts[which]]
                continue
            d = descs[starts[which][:, None] + np.arange(c)[None, :]]   # (n, c, 8)
            bits = np.unpackbits(d.view(np.uint8), axis=-1).reshape(len(which), c, 256)
            ham = (bits[:, :, None, :] != bits[:, None, :, :]).sum(-1)
            best = np.argmin(np.median(ham, axis=2), axis=1)
            self.pt_desc[pids[which]] = d[np.arange(len(which)), best]

    # -- covisibility graph / spanning tree ------------------------------

    def update_connections(self, kf: KeyFrame, min_weight: int = 15):
        """Rebuild kf's covisibility edges from shared map points and update
        the spanning tree (KeyFrame::UpdateConnections, src/KeyFrame.cc:324)."""
        counter: dict[int, int] = {}
        for pid in kf.map_pt[kf.map_pt >= 0]:
            for other_id in self.obs.get(int(pid), {}):
                if other_id != kf.kf_id:
                    counter[other_id] = counter.get(other_id, 0) + 1
        counter = {k: v for k, v in counter.items() if k in self.keyframes}
        if not counter:
            return
        best_id, best_w = max(counter.items(), key=lambda kv: kv[1])
        new_covis = {k: w for k, w in counter.items() if w >= min_weight}
        if not new_covis:
            new_covis = {best_id: best_w}  # always keep the strongest link
        for other_id in set(kf.covis) - set(new_covis):
            other = self.keyframes.get(other_id)
            if other is not None:
                other.covis.pop(kf.kf_id, None)
        kf.covis = new_covis
        for other_id, w in new_covis.items():
            other = self.keyframes.get(other_id)
            if other is not None:
                other.covis[kf.kf_id] = w
        # spanning tree: the first connection parents to the strongest covisible
        if kf.parent is None and kf.kf_id != self.origin_kf_id:
            kf.parent = best_id
            self.keyframes[best_id].children.add(kf.kf_id)

    def erase_keyframe(self, kf_id: int):
        """KeyFrame::SetBadFlag: re-parent children over covisibility
        (src/KeyFrame.cc:492)."""
        kf = self.keyframes.get(kf_id)
        if kf is None or kf.kf_id == self.origin_kf_id or kf.not_erase:
            return
        for other_id in list(kf.covis):
            other = self.keyframes.get(other_id)
            if other is not None:
                other.covis.pop(kf_id, None)
        for pid in kf.map_pt[kf.map_pt >= 0]:
            self.erase_observation(int(pid), kf_id)

        # re-parent children: candidate parents = kf's parent + already re-parented
        candidates = {kf.parent} if kf.parent is not None else set()
        children = set(kf.children)
        while children:
            best = None  # (weight, child, parent)
            for c in children:
                ckf = self.keyframes.get(c)
                if ckf is None:
                    continue
                for cand in candidates:
                    w = ckf.covis.get(cand)
                    if w is not None and (best is None or w > best[0]):
                        best = (w, c, cand)
            if best is None:
                break
            _, c, p = best
            self.keyframes[c].parent = p
            self.keyframes[p].children.add(c)
            candidates.add(c)
            children.remove(c)
        # orphans attach to the deleted node's parent
        for c in children:
            ckf = self.keyframes.get(c)
            if ckf is not None and kf.parent is not None:
                ckf.parent = kf.parent
                self.keyframes[kf.parent].children.add(c)
        if kf.parent is not None:
            parent = self.keyframes.get(kf.parent)
            if parent is not None:
                parent.children.discard(kf_id)
            kf.t_child_parent = kf.t_cw @ np.linalg.inv(self.keyframes[kf.parent].t_cw)
        kf.bad = True
        for hook in self.erase_hooks:
            hook(kf_id)

    # -- queries ----------------------------------------------------------

    def points_seen_by(self, kf_ids) -> np.ndarray:
        """Valid points observed by any of `kf_ids`, as sorted ids."""
        pids: set[int] = set()
        for kf_id in kf_ids:
            kf = self.keyframes.get(kf_id)
            if kf is not None:
                pids.update(int(p) for p in kf.map_pt[kf.map_pt >= 0])
        out = np.array(sorted(pids), np.int64)
        return out[self.pt_valid[out]] if len(out) else out

    def pack_points(self, pids: np.ndarray, cap: int, device=None):
        """Point attributes for `pids` in capacity-`cap` tensors on `device`
        (default: the map's) for the projection search: (xyz, desc int32,
        normal, dmin, dmax, mask); empty slots have dmax = 1e9, mask False."""
        n = min(len(pids), cap)
        pids = np.asarray(pids[:n], np.int64)
        xyz = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        normal = np.zeros((cap, 3), np.float32)
        dmin = np.zeros(cap, np.float32)
        dmax = np.full(cap, 1e9, np.float32)
        mask = np.zeros(cap, bool)
        xyz[:n] = self.pt_xyz[pids]
        desc[:n] = self.pt_desc[pids]
        normal[:n] = self.pt_normal[pids]
        dmin[:n] = self.pt_dmin[pids]
        dmax[:n] = self.pt_dmax[pids]
        mask[:n] = True
        dev = self.device if device is None else device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (xyz, desc.view(np.int32), normal, dmin, dmax, mask))

    def n_valid_points(self) -> int:
        return int(self.pt_valid[: self.n_points].sum())

    def all_point_ids(self) -> np.ndarray:
        return np.nonzero(self.pt_valid[: self.n_points])[0]


def pack_points(pt_xyz, pt_desc, pt_normal, pt_dmin, pt_dmax, pids: torch.Tensor, cap: int):
    """Gather points `pids` of device tensors into capacity-`cap` arrays ->
    (xyz, desc, normal, dmin, dmax, mask); empty slots have dmax = 1e9 and
    mask False."""
    dev = pt_xyz.device
    n = min(len(pids), cap)
    pids = pids[:n].long()
    xyz = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    desc = torch.zeros((cap, 8), dtype=torch.int32, device=dev)
    normal = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    dmin = torch.zeros(cap, dtype=torch.float32, device=dev)
    dmax = torch.full((cap,), 1e9, dtype=torch.float32, device=dev)
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    xyz[:n] = pt_xyz[pids]
    desc[:n] = pt_desc[pids]
    normal[:n] = pt_normal[pids]
    dmin[:n] = pt_dmin[pids]
    dmax[:n] = pt_dmax[pids]
    mask[:n] = True
    return xyz, desc, normal, dmin, dmax, mask


def map_pack_from_rgbd_frame(feats: FrameFeatures, depth: torch.Tensor, t_cw: torch.Tensor,
                             camera: Camera, cap: int, scale_factor: float = 1.2,
                             n_levels: int = 8):
    """One map point per valid feature with depth > 0, in feature order, as a
    stereo/RGB-D initialization creates them from a single keyframe at pose
    `t_cw`: the backprojected world point, the feature's descriptor, the unit
    viewing direction from the keyframe center, dmax = dist * scale^level and
    dmin = dmax / scale^(n_levels-1).

    `depth` is the per-feature depth (models/frame.rgbd_observations).
    Returns (xyz, desc, normal, dmin, dmax, mask, angle), each with `cap` rows;
    `angle` is the observing feature's orientation (the motion stage's
    rotation-consistency input)."""
    idx = torch.nonzero((depth > 0) & feats.valid)[:, 0]
    z = depth[idx]
    pc = camera.backproject(camera.undistort_points(feats.uv[idx]), z)
    t_wc = se3_inverse(t_cw.float())
    pw = pc @ t_wc[:3, :3].T + t_wc[:3, 3]
    view = pw - t_wc[:3, 3]
    dist = torch.sqrt(torch.sum(view * view, dim=-1))
    normal = view / dist[:, None]
    level_scale = torch.tensor([scale_factor ** l for l in range(n_levels)],
                               dtype=torch.float32, device=pw.device)
    dmax = dist * level_scale[feats.level[idx].long()]
    dmin = dmax / level_scale[n_levels - 1]
    all_ids = torch.arange(len(idx), device=pw.device)
    pack = pack_points(pw, feats.desc[idx], normal, dmin, dmax, all_ids, cap)
    angle = torch.zeros(cap, dtype=torch.float32, device=pw.device)
    n = min(len(idx), cap)
    angle[:n] = feats.angle[idx[:n]]
    return (*pack, angle)
