"""Where the port's map parts from the JAX package's before phase 12's loop.

    python3 tools/drift_localize.py jax  --out J.json [--features F.npz] [--sorted-seen] [--points-at-1]
    python3 tools/drift_localize.py port --out P.json [--features F.npz] [--counters-before-gate]
                                         [--unfiltered-pack] [--points-at-1]
    python3 tools/drift_localize.py compare A.json B.json [...]

Runs chip_smoke.py's phase 12 System on the CPU (RGB-D, 640x480, 1000
features, TrackingConfig(max_frames_between_kf=4, kf_tracked_ratio=0.95,
motion_search_radius=20.0), BoxSequence seed 0 spread over 130 frames and
1.3 turns) over frames 0-100, the frames before the loop, with no place
recognition in either package (the mapper hands no keyframe on), and writes
one record per frame: tracked, keyframe inserted, good keyframes and valid
map points after the frame, and the ATE of frames 0-100 (SE3 alignment) on
the frame trajectory with each keyframe frame recorded as its own keyframe
(the port's rule) and as the JAX package records it.

`jax --features F` saves the JAX extractor's features of every frame;
`port --features F` feeds them to the port instead of its own extractor,
which takes away the ulp differences of the two extractors (pyramid levels
>= 1). The switches each take one chosen divergence or candidate fault away:

  --sorted-seen          (jax)  Map.points_seen_by returns sorted ids, as the port's does
  --counters-before-gate (port) the fused step bumps the visible/found counters before its
                                min_localmap_inliers gate, as JAX tracking.py:725-745 does
  --unfiltered-pack      (port) the fused step packs its previous local set as is (replaced and
                                erased points included), as JAX tracking.py:691 does
  --points-at-1          (both) a new map point starts with visible = found = 1 (the reference's
                                MapPoint constructor) instead of 0

`compare` prints, for each file after the first, the first frame whose
keyframe decision or map size differs from the first file's. Needs the JAX
package for `jax`; `port` imports only the port.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import textwrap
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_SEQ, TURNS, N_RUN = 130, 1.3, 101
CONFIG = dict(max_frames_between_kf=4, kf_tracked_ratio=0.95, motion_search_radius=20.0)


def _points_at_1(map_cls):
    add = map_cls.add_point

    def add_point(self, *a, **k):
        pid = add(self, *a, **k)
        self.pt_visible[pid] = 1
        self.pt_found[pid] = 1
        return pid

    map_cls.add_point = add_point


def _patch_method(cls, name, edits):
    """Re-define cls.name from its own source with the text edits applied."""
    src = inspect.getsource(getattr(cls, name))
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{cls.__name__}.{name}: the text to switch is gone: {old!r}")
        src = src.replace(old, new)
    src = textwrap.dedent(src)
    scope = dict(vars(sys.modules[cls.__module__]))
    exec(compile(src, f"<{cls.__name__}.{name} switched>", "exec"), scope)
    setattr(cls, name, scope[name])


def _record(s, seq, poses_own, poses_recorded, rows, seconds):
    from_frames = range(N_RUN)

    def ate(traj):
        f = [i for i in from_frames if i in traj]
        est = np.stack([np.linalg.inv(traj[i])[:3, 3] for i in f])
        gt = np.stack([np.linalg.inv(seq.pose(i))[:3, 3] for i in f])
        # SE3 (no scale) Horn alignment
        mu_e, mu_g = est.mean(0), gt.mean(0)
        u, _, vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
        d = np.eye(3)
        d[2, 2] = np.sign(np.linalg.det(u @ vt))
        r = u @ d @ vt
        err = gt - ((est - mu_e) @ r.T + mu_g)
        return float(np.sqrt((err ** 2).sum(1).mean()))

    return {"rows": rows, "keyframes": len(s.map.good_keyframes()), "points": int(s.map.n_valid_points()),
            "ate_own": ate(poses_own), "ate_recorded": ate(poses_recorded), "seconds": seconds}


def _own_and_recorded(s):
    """{frame: Tcw} with keyframe frames at their keyframe, and as recorded."""
    recorded = list(s.tracking.trajectory)
    kfs = s.map.keyframes
    own = [(ts, ref, np.eye(4, dtype=np.float32) if ref in kfs and kfs[ref].timestamp == ts else rel)
           for ts, ref, rel in recorded]
    out = []
    for traj in (own, recorded):
        s.tracking.trajectory = traj
        out.append({int(round(ts * 30)): np.asarray(t) for ts, t in s.frame_trajectory()})
    s.tracking.trajectory = recorded
    return out


def _drive(s, seq, extract_hook=None):
    rows = []
    t0 = time.perf_counter()
    for i in range(N_RUN):
        if extract_hook is not None:
            extract_hook(i)
        before = s.map.next_kf_id
        pose = s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
        rows.append({"frame": i, "tracked": pose is not None, "kf": s.map.next_kf_id > before,
                     "keyframes": len(s.map.good_keyframes()), "points": int(s.map.n_valid_points())})
    return rows, time.perf_counter() - t0


def run_jax(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orbslam2commentedbyxcm_tpu.models import map as jmap
    from orbslam2commentedbyxcm_tpu.models import system as jsystem
    from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence, default_camera

    if args.sorted_seen:
        seen = jmap.Map.points_seen_by
        jmap.Map.points_seen_by = lambda self, kf_ids: np.sort(seen(self, kf_ids))
    if args.points_at_1:
        _points_at_1(jmap.Map)
    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, n_frames=N_SEQ, turns=TURNS)
    s = jsystem.System(cam, jsystem.Sensor.RGBD, config=TrackingConfig(**CONFIG), enable_loop_closing=False)
    s.local_mapping.loop_closer = None
    feats = []
    if args.features:
        ext = s.extractor

        def keep(img):
            f = ext(img)
            feats.append({k: np.asarray(getattr(f, k)) for k in ("uv", "response", "angle", "level", "desc",
                                                                 "valid")})
            return f

        s.extractor = keep
    rows, secs = _drive(s, seq)
    if args.features:
        np.savez_compressed(args.features, **{f"{i}_{k}": v for i, f in enumerate(feats) for k, v in f.items()})
    return _record(s, seq, *_own_and_recorded(s), rows, secs)


def run_port(args):
    import torch

    torch.set_num_threads(int(os.environ.get("DRIFT_THREADS", "4")))
    from orbslam2commentedbyxcm_tpu_torch.models import map as tmap
    from orbslam2commentedbyxcm_tpu_torch.models import tracking as ttracking
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.utils import convert
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    if args.counters_before_gate:
        _patch_method(ttracking.Tracking, "_track_fused", [(
            "        self.n_last_inliers = int(n2)\n"
            "        if int(n2) < cfg.min_localmap_inliers:\n"
            "            return False  # the staged path retries with a fresh local set\n", ""), (
            "        self._last_n_map = int((frame.map_pt >= 0).sum())\n",
            "        self._last_n_map = int((frame.map_pt >= 0).sum())\n"
            "        self.n_last_inliers = int(n2)\n"
            "        if int(n2) < cfg.min_localmap_inliers:\n"
            "            frame.map_pt = np.full(frame.capacity, -1, np.int64)\n"
            "            frame.is_outlier[:] = False\n"
            "            return False\n")])
    if args.unfiltered_pack:
        _patch_method(ttracking.Tracking, "_track_fused", [(
            "        local = self.map.resolve_replaced_batch(self._prev_local_pids)\n"
            "        local = np.unique(local[local >= 0])\n", "        local = self._prev_local_pids\n")])
    if args.points_at_1:
        _points_at_1(tmap.Map)
    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, n_frames=N_SEQ, turns=TURNS)
    s = System(cam, Sensor.RGBD, config=ttracking.TrackingConfig(**CONFIG), enable_loop_closing=False,
               device="cpu")
    s.local_mapping.loop_closer = None
    hook = None
    if args.features:
        store = np.load(args.features)
        current = {}

        def hook(i):
            current["f"] = convert.features_from_numpy(
                type("F", (), {k: store[f"{i}_{k}"] for k in ("uv", "response", "angle", "level", "desc", "valid")}))

        s.extractor = lambda img: current["f"]
    rows, secs = _drive(s, seq, hook)
    return _record(s, seq, *_own_and_recorded(s), rows, secs)


def compare(paths):
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
    for p, r in zip(paths, runs):
        kf_frames = [row["frame"] for row in r["rows"] if row["kf"]]
        sizes = [(row["frame"], row["points"]) for row in r["rows"] if row["kf"]]
        print(f"{os.path.basename(p)}: {r['keyframes']} keyframes, {r['points']} points after frame "
              f"{N_RUN - 1}; ATE frames 0-{N_RUN - 1} {r['ate_own']:.6f} m (keyframe frames at their keyframe), "
              f"{r['ate_recorded']:.6f} m (as recorded); {r['seconds']:.1f} s\n  keyframes inserted on frames "
              f"{kf_frames}\n  map points at each insertion {sizes}")
    base = runs[0]["rows"]
    for p, r in zip(paths[1:], runs[1:]):
        first_kf = next((a["frame"] for a, b in zip(base, r["rows"]) if a["kf"] != b["kf"]), None)
        first_pts = next((a["frame"] for a, b in zip(base, r["rows"]) if a["points"] != b["points"]), None)
        print(f"{os.path.basename(p)} against {os.path.basename(paths[0])}: first keyframe decision that "
              f"differs on frame {first_kf}, first map size that differs on frame {first_pts}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=("jax", "port", "compare"))
    ap.add_argument("files", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--features")
    ap.add_argument("--sorted-seen", action="store_true")
    ap.add_argument("--counters-before-gate", action="store_true")
    ap.add_argument("--unfiltered-pack", action="store_true")
    ap.add_argument("--points-at-1", action="store_true")
    args = ap.parse_args()
    if args.which == "compare":
        compare(args.files)
        return 0
    rec = run_jax(args) if args.which == "jax" else run_port(args)
    rec["switches"] = {k: v for k, v in vars(args).items() if k not in ("which", "files", "out")}
    print(json.dumps({k: v for k, v in rec.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
