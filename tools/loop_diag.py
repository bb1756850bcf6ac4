"""Where a loop closure's accuracy goes, against ground truth.

    python3 tools/loop_diag.py [--device cuda] [--eight] [--out FILE]

Runs chip_smoke.py's phase 12 System (RGB-D, vocabulary="bootstrap", loop
closing on) over its 130-frame BoxSequence orbit at 640x480 and prints one
JSON line with:
  * the keyframe ATE (SE3 alignment) before the first loop correction,
    after its essential graph, after global BA and at the end; and the
    frame trajectory's ATE, all frames and frames 0 to the loop;
  * the accepted loop's Sim3 against the ground-truth relative pose of its
    two keyframes (cm, deg), the RANSAC Sim3's and the refinement's (and
    the refinement started at the ground truth: the optimum of its own
    objective), the matches, the RANSAC and refinement inliers, and how
    many of them are correct (the two features' ground-truth depth
    back-projected to within 3 cm of each other);
  * the matched map points against the ground-truth camera points of their
    features on each side (median and max, cm).

`--eight` runs phase 14's synchronous figure-eight instead (400x300, 900
features, exposure drift and an occluder) and prints one line per loop
attempt: the keyframe's frame, each candidate's frame, its BoW matches and
how many are correct by ground truth, the matches with valid points on
both sides, the RANSAC inliers and the inliers the ground-truth relative
pose would have (`gt_pose_inliers`), then
the run's record. `--out` appends the lines to FILE. Runs on the card by
default; `--device cpu` runs the plain twins (a different map: the sums of
BA and the pose graph differ between the devices).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_error(s, g):
    """(cm, deg) of the Sim3 `s` (scale taken out) against the SE3 `g`."""
    s = np.asarray(s, np.float64)
    r = s[:3, :3] / np.cbrt(np.linalg.det(s[:3, :3]))
    e = np.eye(4)
    e[:3, :3], e[:3, 3] = r, s[:3, 3]
    e = e @ np.linalg.inv(g)
    ang = math.degrees(math.acos(max(-1.0, min(1.0, (float(np.trace(e[:3, :3])) - 1.0) / 2.0))))
    return round(100 * float(np.linalg.norm(e[:3, 3])), 2), round(ang, 3)


def _gt_camera_points(seq, frame, uv, k_mat):
    """Ground-truth camera points of pixels `uv` of `frame` (nearest depth)."""
    depth = seq.depth_map(frame)
    h, w = depth.shape
    u = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
    v = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
    z = depth[v, u]
    return np.stack([(uv[:, 0] - k_mat[0, 2]) / k_mat[0, 0] * z, (uv[:, 1] - k_mat[1, 2]) / k_mat[1, 1] * z, z], 1)


def _gt_inliers(p1, p2, s1, s2, k_mat, g12, chi2_th=9.21) -> int:
    """Matches whose points pass Sim3 RANSAC's bidirectional reprojection
    test (ops/sim3solver.ransac_sim3) under the SE3 `g12` (frame 2 -> 1)."""
    def project(p):
        return np.stack([k_mat[0, 0] * p[:, 0] / p[:, 2] + k_mat[0, 2], k_mat[1, 1] * p[:, 1] / p[:, 2] + k_mat[1, 2]], 1)

    g21 = np.linalg.inv(g12)
    e1 = ((project(p2 @ g12[:3, :3].T + g12[:3, 3]) - project(p1)) ** 2).sum(1)
    e2 = ((project(p1 @ g21[:3, :3].T + g21[:3, 3]) - project(p2)) ** 2).sum(1)
    return int(((e1 < chi2_th * s1) & (e2 < chi2_th * s2)).sum())


def orbit(smoke, torch, dev) -> dict:
    from orbslam2commentedbyxcm_tpu_torch.models import gba as gbam
    from orbslam2commentedbyxcm_tpu_torch.models import loop_closing as lcm
    from orbslam2commentedbyxcm_tpu_torch.ops import posegraph
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, n_frames=smoke.N_LOOP, turns=1.3)
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(smoke.N_LOOP)]
    stages, sim3, refined = [], {}, []

    def kf_ate(m, tag):
        kfs = m.good_keyframes()
        est = positions_from_tcw(np.stack([np.asarray(k.t_cw, np.float64) for k in kfs]))
        gt = positions_from_tcw(np.stack([seq.pose(int(round(k.timestamp * 30.0))) for k in kfs]))
        stages.append((tag, len(kfs), round(100 * float(ate_rmse(est, gt, with_scale=False)), 3)))

    correct, eg, solve = lcm.LoopClosing._correct_loop, lcm.LoopClosing._optimize_essential_graph, \
        gbam.GlobalBA._solve_and_write
    grow, refine = lcm.LoopClosing._grow_and_refine, posegraph.optimize_sim3

    def correct_hook(self, kf, loop_kf_id, *a, **k):
        kf_ate(self.map, f"before correction (keyframe {kf.kf_id} to {loop_kf_id})")
        return correct(self, kf, loop_kf_id, *a, **k)

    def eg_hook(self, *a, **k):
        out = eg(self, *a, **k)
        kf_ate(self.map, "after the essential graph")
        return out

    def solve_hook(self, *a, **k):
        out = solve(self, *a, **k)
        kf_ate(self.map, "after global BA")
        return out

    def grow_hook(self, m, kf, ckf, cand_id, my, their, my_feat, their_feat, s12, ransac_inliers, lvl_sig):
        sim3.clear()
        sim3.update(frames=(int(round(kf.timestamp * 30.0)), int(round(ckf.timestamp * 30.0))),
                    s12_ransac=np.asarray(s12), n_bow=len(my_feat), ransac_inliers=np.asarray(ransac_inliers).copy())
        out = grow(self, m, kf, ckf, cand_id, my, their, my_feat, their_feat, s12, ransac_inliers, lvl_sig)
        if out is not None:
            refined.append(dict(sim3))
        return out

    def refine_hook(s12, p1, p2, uv1, uv2, mask, k_mat, is1, is2, **k):
        res = refine(s12, p1, p2, uv1, uv2, mask, k_mat, is1, is2, **k)
        if "frames" not in sim3:
            return res
        a, b = sim3["frames"]
        g12 = seq.pose(a) @ np.linalg.inv(seq.pose(b))
        at_gt = refine(torch.as_tensor(g12, dtype=torch.float32, device=s12.device), p1, p2, uv1, uv2, mask, k_mat,
                       is1, is2, **k)
        sim3.update(p1=p1.cpu().numpy(), p2=p2.cpu().numpy(), uv1=uv1.cpu().numpy(), uv2=uv2.cpu().numpy(),
                    s12_refined=res.s12.cpu().numpy(), inliers=res.inliers.cpu().numpy(),
                    s12_from_gt=at_gt.s12.cpu().numpy(), k_mat=k_mat.cpu().numpy())
        return res

    lcm.LoopClosing._correct_loop = correct_hook
    lcm.LoopClosing._optimize_essential_graph = eg_hook
    gbam.GlobalBA._solve_and_write = solve_hook
    lcm.LoopClosing._grow_and_refine = grow_hook
    posegraph.optimize_sim3 = refine_hook

    class Timer:
        def start(self):
            self.t = time.perf_counter()

        def stop(self):
            return 1e3 * (time.perf_counter() - self.t)

    slam, _, _, loops, gba_frames = smoke._loop_run(torch, dev, cam, seq, frames, True, Timer())
    kf_ate(slam.map, "end")
    poses = smoke._frame_poses(slam)
    loop = loops[0] if loops else smoke.N_LOOP - 1
    out = {"run": "orbit", "loops": loops, "gba_after": gba_frames, "keyframes": len(slam.map.good_keyframes()),
           "ate_cm": round(100 * smoke._ate(poses, seq, range(smoke.N_LOOP)), 3),
           "ate_to_loop_cm": round(100 * smoke._ate(poses, seq, range(loop + 1)), 3),
           "keyframe_ate_cm": stages}
    acc = next((r for r in refined if loops and r["frames"][0] == loops[0]), None)
    if acc:
        a, b = acc["frames"]
        g12 = seq.pose(a) @ np.linalg.inv(seq.pose(b))
        c1 = _gt_camera_points(seq, a, acc["uv1"], acc["k_mat"])
        c2 = _gt_camera_points(seq, b, acc["uv2"], acc["k_mat"])
        right = np.linalg.norm(c1 - (c2 @ g12[:3, :3].T + g12[:3, 3]), axis=1) < 0.03
        inl, n_bow = acc["inliers"].astype(bool), acc["n_bow"]
        r_inl = acc["ransac_inliers"][:n_bow].astype(bool)
        e1 = 100 * np.linalg.norm(acc["p1"] - c1, axis=1)[right]
        e2 = 100 * np.linalg.norm(acc["p2"] - c2, axis=1)[right]
        out["loop_sim3"] = {
            "frames": [a, b], "gt_relative": _rel_error(np.eye(4), np.linalg.inv(g12)),
            "ransac_err": _rel_error(acc["s12_ransac"], g12), "refined_err": _rel_error(acc["s12_refined"], g12),
            "refined_from_gt_err": _rel_error(acc["s12_from_gt"], g12),
            "matches": [n_bow, len(inl) - n_bow], "correct": [int(right[:n_bow].sum()), int(right[n_bow:].sum())],
            "ransac_inliers": [int(r_inl.sum()), int(right[:n_bow][r_inl].sum())],
            "refined_inliers": [int(inl.sum()), int(right[inl].sum())],
            "depth_m": [round(float(x), 2) for x in np.percentile(c1[:, 2], [0, 50, 100])],
            "point_err_cm": {"current": [round(float(np.median(e1)), 1), round(float(e1.max()), 1)],
                             "loop": [round(float(np.median(e2)), 1), round(float(e2.max()), 1)]},
        }
    return out


def eight(smoke, torch, dev) -> list:
    from orbslam2commentedbyxcm_tpu_torch.models import loop_closing as lcm
    from orbslam2commentedbyxcm_tpu_torch.ops import sim3solver
    from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import make_sequence, run_sequence

    cam = smoke._eight_camera()
    seq, _ = make_sequence("eight", smoke.EIGHT_FRAMES, cam)
    attempts, cur = [], {}
    geom, match, ransac = lcm.LoopClosing._compute_sim3_geom, lcm.LoopClosing._match_candidates_batched, \
        sim3solver.ransac_sim3

    def geom_hook(self, m, kf, cand_views, candidates):
        cur.clear()
        cur.update(run="eight attempt", frame=int(round(kf.timestamp * cam.fps)),
                   candidates=[int(round(cand_views[c].timestamp * cam.fps)) for c in candidates if c in cand_views])
        out = geom(self, m, kf, cand_views, candidates)
        cur["accepted"] = out is not None
        attempts.append(dict(cur))
        return out

    def match_hook(self, kf, my, batch):
        out = match(self, kf, my, batch)
        cur["bow_matches"] = [int(ok.sum()) for _, ok in out]
        # matches whose two features' ground-truth points lie within 3 cm
        a = int(round(kf.timestamp * cam.fps))
        right = []
        for (_, ckf, their), (idx, ok) in zip(batch, out):
            b = int(round(ckf.timestamp * cam.fps))
            g12 = seq.pose(a) @ np.linalg.inv(seq.pose(b))
            c1 = _gt_camera_points(seq, a, kf.uv_und[my[ok]], cam.K)
            c2 = _gt_camera_points(seq, b, ckf.uv_und[their[idx[ok]]], cam.K)
            right.append(int((np.linalg.norm(c1 - (c2 @ g12[:3, :3].T + g12[:3, 3]), axis=1) < 0.03).sum()))
        cur["bow_correct"] = right
        return out

    def ransac_hook(p1, p2, mask, k_mat, s1, s2, *a, **k):
        res = ransac(p1, p2, mask, k_mat, s1, s2, *a, **k)
        cur["valid_matches"], cur["ransac_inliers"] = mask.sum(1).tolist(), res.n_inliers.tolist()
        # the inliers under the ground-truth relative pose (RANSAC's own
        # reprojection test), the best over the attempt's candidates
        frame = cur["frame"]
        gt = []
        for i in range(p1.shape[0]):
            lane = [x[i].cpu().numpy().astype(np.float64) for x in (p1, p2, s1, s2)]
            keep = mask[i].cpu().numpy()
            gt.append(max(_gt_inliers(*(x[keep] for x in lane), k_mat.cpu().numpy(),
                                      seq.pose(frame) @ np.linalg.inv(seq.pose(b))) for b in cur["candidates"]))
        cur["gt_pose_inliers"] = gt
        return res

    lcm.LoopClosing._compute_sim3_geom = geom_hook
    lcm.LoopClosing._match_candidates_batched = match_hook
    sim3solver.ransac_sim3 = ransac_hook
    rec = run_sequence("eight", smoke.EIGHT_FRAMES, augment=True, async_mapping=False, camera=cam, n_features=900,
                       device=dev)
    return attempts + [{"run": "eight", **{k: rec[k] for k in ("tracked", "loops_closed", "keyframes", "ate_rmse_m",
                                                                 "drift_pct", "loop_stats", "gt_loops")}}]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eight", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("loop_diag: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    smoke = _smoke()
    lines = eight(smoke, torch, args.device) if args.eight else [orbit(smoke, torch, args.device)]
    for line in lines:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
