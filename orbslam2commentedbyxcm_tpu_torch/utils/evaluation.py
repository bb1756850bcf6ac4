"""Trajectory evaluation: ATE RMSE after Umeyama alignment (numpy only).

Counterpart of orbslam2commentedbyxcm_tpu/utils/evaluation.py (the TUM
benchmark's evaluate_ate conventions).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning x -> y, both (N, 3).
    Returns (s, R, t) with y ~ s R x + t (Umeyama 1991)."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    u, d, vt = np.linalg.svd(yc.T @ xc / len(x))
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    r = u @ s_fix @ vt
    s = np.trace(np.diag(d) @ s_fix) / ((xc**2).sum() / len(x)) if with_scale else 1.0
    return s, r, my - s * r @ mx


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after alignment: `with_scale=True`
    (Sim3) for monocular, False (SE3) for stereo/RGB-D."""
    s, r, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    aligned = (s * (r @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=-1)
    return float(np.sqrt((err**2).mean()))


def positions_from_tcw(poses_tcw: np.ndarray) -> np.ndarray:
    """Camera centers from world->camera poses: c = -R^T t."""
    return -np.einsum("nji,nj->ni", poses_tcw[:, :3, :3], poses_tcw[:, :3, 3])
