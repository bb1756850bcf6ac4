"""Wrapper of the single-launch motion-only BA kernel (csrc/poseopt.cu).

Replaces the Pallas kernel `pose_optimization_fused` of
orbslam2commentedbyxcm_tpu/ops/pallas_poseopt.py: the whole 4-round x <= 10
iteration LM solve runs in one launch, on one block of 128 threads up to
128 edges and on a cluster of 8 such blocks above, and nothing is read back
to the host during the solve. For CPU tensors the wrapper runs the plain twin
(ops/optim.pose_optimization_plain); for CUDA tensors it launches the kernel
or raises. `pose_optimization_fused.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from orbslam2commentedbyxcm_tpu_torch import kernels

_MAX_EDGES = 200_000  # per-edge flags live in shared memory (1 byte each)


def _check(name, t, shape, dtype):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"pose_optimization_fused: {name} must be contiguous {dtype} {shape}, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def pose_optimization_fused(
    t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
    n_rounds: int = 4, n_iters: int = 10,
):
    """Same contract as ops/optim.pose_optimization (algorithm='lm'); returns
    (t_cw (4, 4) f32, inliers (N,) bool, n_inliers () int32, chi2 () f32).

    After a launch, `pose_optimization_fused.last_counts` is a (3,) int32
    device tensor: n_inliers, then the evaluations (H, g and error passes)
    and the edge evaluations that solve ran. The outputs are allocated one
    by one: as typed views of one byte buffer they cost more host time."""
    if pts_w.device.type == "cpu":
        from orbslam2commentedbyxcm_tpu_torch.ops.optim import pose_optimization_plain

        return tuple(pose_optimization_plain(
            t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
            n_rounds=n_rounds, n_iters=n_iters,
        ))
    if pts_w.device.type != "cuda":
        raise ValueError(f"pose_optimization_fused: unsupported device {pts_w.device}")
    n = pts_w.shape[0]
    if not 0 < n <= _MAX_EDGES:
        raise ValueError(f"pose_optimization_fused: {n} edges, supported 1..{_MAX_EDGES}")
    for name, t, shape, dtype in (
        ("t_cw", t_cw, (4, 4), torch.float32), ("pts_w", pts_w, (n, 3), torch.float32),
        ("obs", obs, (n, 3), torch.float32), ("mask", mask, (n,), torch.bool),
        ("inv_sigma2", inv_sigma2, (n,), torch.float32),
    ):
        if t.device != pts_w.device:
            raise ValueError(f"pose_optimization_fused: {name} on {t.device}, edges on {pts_w.device}")
        _check(name, t, shape, dtype)
    lib = kernels.library()
    dev = pts_w.device
    t_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    chi2 = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pose_opt(
            t_cw.data_ptr(), pts_w.data_ptr(), obs.data_ptr(), mask.data_ptr(),
            inv_sigma2.data_ptr(), n, float(fx), float(fy), float(cx), float(cy), float(bf),
            int(n_rounds), int(n_iters),
            t_out.data_ptr(), inliers.data_ptr(), counts.data_ptr(), chi2.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "pose_opt")
    pose_optimization_fused.launches += 1
    pose_optimization_fused.last_counts = counts
    return t_out, inliers, counts[0], chi2


pose_optimization_fused.launches = 0
pose_optimization_fused.last_counts = None
