"""Absolute trajectory error (a frozen copy of the TUM benchmark's
evaluate_ate arithmetic: Umeyama's least-squares alignment, then the RMSE
of the aligned positions). numpy only."""

from __future__ import annotations

import numpy as np


def umeyama(x: np.ndarray, y: np.ndarray, with_scale: bool):
    """(s, R, t) with y ~ s R x + t, both (N, 3)."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    u, d, vt = np.linalg.svd(yc.T @ xc / len(x))
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    r = u @ s_fix @ vt
    s = np.trace(np.diag(d) @ s_fix) / ((xc**2).sum() / len(x)) if with_scale else 1.0
    return s, r, my - s * r @ mx


def centers(poses_tcw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) world->camera poses -> (N, 3) camera centers -R^T t."""
    return -np.einsum("nji,nj->ni", poses_tcw[:, :3, :3], poses_tcw[:, :3, 3])


def ate_rmse(est_tcw: np.ndarray, gt_tcw: np.ndarray, with_scale: bool = False) -> float:
    """RMSE (metres) of the estimated camera centers after alignment (SE3
    unless with_scale)."""
    x, y = centers(np.asarray(est_tcw, np.float64)), centers(np.asarray(gt_tcw, np.float64))
    s, r, t = umeyama(x, y, with_scale)
    err = np.linalg.norm((s * (r @ x.T)).T + t - y, axis=-1)
    return float(np.sqrt((err**2).mean()))
