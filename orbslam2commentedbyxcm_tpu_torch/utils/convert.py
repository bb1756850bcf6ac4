"""State carried between the JAX package and the port.

A SLAM engine has no weights; what crosses over is the extractor's constants
(BRIEF pattern, moment masks, blur taps, level budgets and scales: bit-equal
descriptors keep the shipped vocabulary valid), per-frame state (features,
map-point packs) and the map itself (`map_from_jax`). Everything arrives as
numpy arrays, so this module never imports JAX. Descriptors are uint32 words
in the JAX package and are stored bit-identically as int32 in torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.frame import KeyFrame
from orbslam2commentedbyxcm_tpu_torch.models.map import _POINT_ARRAYS, Map
from orbslam2commentedbyxcm_tpu_torch.ops.frontend_kernel import _TAPS
from orbslam2commentedbyxcm_tpu_torch.ops.orb import FrameFeatures, ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera


def desc_to_torch(desc, device=None) -> torch.Tensor:
    """uint32 (..., 8) descriptor words -> int32 tensor with the same bits."""
    return torch.from_numpy(np.array(desc, np.uint32).view(np.int32)).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor tensor -> uint32 numpy array with the same bits."""
    return desc.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def features_from_numpy(feats, device=None) -> FrameFeatures:
    """Any object with uv/response/angle/level/desc/valid arrays (e.g. the JAX
    package's FrameFeatures) -> torch FrameFeatures on `device`."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return FrameFeatures(
        uv=t(feats.uv, np.float32), response=t(feats.response, np.float32),
        angle=t(feats.angle, np.float32), level=t(feats.level, np.int32),
        desc=desc_to_torch(feats.desc, device), valid=t(feats.valid, bool),
    )


def features_to_numpy(feats: FrameFeatures) -> dict:
    """torch FrameFeatures -> dict of numpy arrays, descriptors as uint32."""
    out = {k: getattr(feats, k).detach().cpu().numpy() for k in ("uv", "response", "angle", "level", "valid")}
    out["desc"] = desc_to_numpy(feats.desc)
    return out


def map_pack_from_numpy(pack, device=None) -> tuple:
    """`Map.pack_points` output (xyz, desc uint32, normal, dmin, dmax, mask)
    -> the same tuple of tensors on `device`."""
    xyz, desc, normal, dmin, dmax, mask = pack
    f32 = [torch.from_numpy(np.array(a, np.float32)).to(device)
           for a in (xyz, normal, dmin, dmax)]
    return (f32[0], desc_to_torch(desc, device), f32[1], f32[2], f32[3],
            torch.from_numpy(np.array(mask, bool)).to(device))


def camera_from_jax(cam) -> Camera:
    """The JAX package's Camera -> the port's, field by field."""
    return Camera(**{f.name: getattr(cam, f.name) for f in dataclasses.fields(Camera)})


def map_from_jax(jmap, device="cpu") -> Map:
    """A port Map holding a copy of the JAX Map `jmap`'s state: point arrays
    and counters, observations, keyframes with their features, poses,
    map-point links, covisibility, spanning tree and loop edges. Nothing is shared, so
    both packages can go on from the same map state."""
    m = Map(point_capacity=len(jmap.pt_valid), device=device)
    for name in _POINT_ARRAYS:
        setattr(m, name, np.array(getattr(jmap, name), copy=True))
    for name in ("n_points", "pt_version", "next_kf_id", "origin_kf_id", "big_change_idx"):
        setattr(m, name, int(getattr(jmap, name)))
    m.obs = {int(p): {int(k): int(f) for k, f in o.items()} for p, o in jmap.obs.items()}
    m.reindex()
    for kf_id, jkf in jmap.keyframes.items():
        kf = object.__new__(KeyFrame)
        for name in ("kf_id", "frame_id", "timestamp", "n_levels", "scale_factor", "bad",
                     "not_erase", "parent"):
            setattr(kf, name, getattr(jkf, name))
        kf.camera = camera_from_jax(jkf.camera)
        for name in (*KeyFrame._FEATURES, "t_cw", "map_pt"):
            setattr(kf, name, np.array(getattr(jkf, name), copy=True))
        kf.covis = dict(jkf.covis)
        kf.children = set(jkf.children)
        kf.loop_edges = set(jkf.loop_edges)
        kf.t_child_parent = None if jkf.t_child_parent is None else np.array(jkf.t_child_parent)
        kf._inv_sigma2 = None
        kf.bow_vec = None if jkf.bow_vec is None else tuple(np.array(a) for a in jkf.bow_vec)
        kf.bow_feat_nodes = None if jkf.bow_feat_nodes is None else np.array(jkf.bow_feat_nodes)
        m.keyframes[int(kf_id)] = kf
    return m


def extractor_from_jax(ext) -> ORBExtractor:
    """A port ORBExtractor configured like the JAX ORBExtractor `ext`,
    asserting that every constant the port derives itself is equal."""
    port = ORBExtractor(
        n_features=ext.n_features, scale_factor=ext.scale_factor, n_levels=ext.n_levels,
        ini_th_fast=ext.ini_th, min_th_fast=ext.min_th, cell_size=ext.cell_size,
        per_cell_k=ext.per_cell_k, normalize_exposure=ext.normalize_exposure,
        exposure_target_mad=ext.exposure_target_mad,
    )
    for name, b in (("_pattern", port._pattern), ("_kmx", port._kmx), ("_kmy", port._kmy),
                    ("_blur", _TAPS)):
        a = np.asarray(getattr(ext, name))
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"extractor constant {name} differs from the JAX extractor's")
    for name in ("budgets", "scales", "capacity"):
        if getattr(ext, name) != getattr(port, name):
            raise AssertionError(f"extractor {name} differs from the JAX extractor's")
    return port
