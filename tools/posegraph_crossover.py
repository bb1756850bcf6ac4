"""The port's dense / CG crossover of the essential-graph solve on a CUDA GPU.

    python3 tools/posegraph_crossover.py    # from the repository root, one GPU, ~2 min

ops/posegraph.solve_pose_graph hands graphs of more than DENSE_VERTEX_LIMIT
(192, the JAX package's value) vertices to the block-Jacobi CG solver. This
times both solvers on the same graphs for K = 32 to 1024 vertices: K Sim3
poses on a circle, odometry edges with noise and scale drift, covisibility
edges to the next 2 and 3 vertices measured from the drifted poses, and one
loop edge from ground truth (about 3 edges per vertex; phase 12 of
chip_smoke.py gives 3-4.5). Each solve runs to convergence with the loop
closer's 20 LM iterations at most; the time is the median of 3 solves after
one warm-up (host clock between two device synchronizations, which is what
the loop keyframe pays). Prints the card's name and power limit and one
line per K.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam2commentedbyxcm_tpu_torch.ops import posegraph  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import sim3_exp  # noqa: E402

DEV = torch.device("cuda", 0)
SIZES = (32, 64, 128, 192, 256, 384, 512, 768, 1024)


def ring_graph(k: int, seed: int = 0):
    """(poses, fixed, edge_i, edge_j, meas, mask) on the CPU: a drifted
    circle of k Sim3 poses with odometry, covisibility and one loop edge."""
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(k):
        a = 2 * np.pi * i / k
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)  # yaw a
        center = np.array([3 * s, 0.0, 3 - 3 * c], np.float32)
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, :3] = r.T
        t_cw[:3, 3] = -r.T @ center
        gt.append(t_cw)
    noise = sim3_exp(torch.from_numpy(np.concatenate(
        [rng.normal(0, 0.005, (k, 6)), np.full((k, 1), 0.002)], axis=1).astype(np.float32))).numpy()
    est = [gt[0]]
    for i in range(1, k):
        est.append((noise[i] @ gt[i] @ np.linalg.inv(gt[i - 1]) @ est[-1]).astype(np.float32))
    edges = [(i, i + d) for d in (1, 2, 3) for i in range(k - d)]
    meas = [est[j] @ np.linalg.inv(est[i]) for i, j in edges]
    edges.append((k - 1, 0))
    meas.append(gt[0] @ np.linalg.inv(gt[k - 1]))
    fixed = np.zeros(k, bool)
    fixed[0] = True
    ei, ej = (np.array(x, np.int64) for x in zip(*edges))
    return (torch.from_numpy(np.stack(est)), torch.from_numpy(fixed), torch.from_numpy(ei), torch.from_numpy(ej),
            torch.from_numpy(np.stack(meas).astype(np.float32)), torch.ones(len(ei), dtype=torch.bool))


def timed(fn, args, reps: int = 3):
    """(median ms, result) of `reps` solves after one warm-up."""
    fn(*args, n_iters=20)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, n_iters=20)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), res


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    faster = []
    for k in SIZES:
        args = tuple(a.to(DEV) for a in ring_graph(k))
        dense_ms, dense = timed(posegraph.optimize_pose_graph, args)
        cg_ms, cg = timed(posegraph.optimize_pose_graph_cg, args)
        if cg_ms < dense_ms:
            faster.append(k)
        print(f"K {k:5d}, {int(args[2].shape[0]):5d} edges: dense {dense_ms:9.3f} ms ({dense.iterations} LM "
              f"iterations, cost {float(dense.cost):.4g}), CG {cg_ms:9.3f} ms ({cg.iterations}, cost "
              f"{float(cg.cost):.4g}), poses within {float((dense.poses - cg.poses).abs().max()):.2e}, dense / CG "
              f"{dense_ms / cg_ms:.3f}", flush=True)
    print(f"CG faster at K = {faster} (solve_pose_graph switches above {posegraph.DENSE_VERTEX_LIMIT})")


if __name__ == "__main__":
    main()
