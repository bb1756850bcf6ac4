"""Phase 12's loop-closing run, repeated: how far its result spreads between
runs of one build, and how two builds compare on the same card.

    python3 tools/loop_runs.py [--runs N] [--tree DIR] [--out FILE]
                               [--deterministic] [--gba-after K]
                               [--async] [--eight] [--eight-runs M]
                               [--no-handoff]

Runs chip_smoke.py's phase 12 System (RGB-D, vocabulary="bootstrap", loop
closing on) over its 130-frame BoxSequence orbit at 640x480 N times (default
3) on the card, and prints one line per run: the frame of each closed loop,
the frame on which global BA wrote back (its thread ends while tracking goes
on), the keyframes and points, and the ATE of the frame trajectory after
global BA over all frames, frames 0 to the first loop and the frames after
it, with the drift between the loop edge's two frames. `--tree DIR` imports
the port package from another checkout (unpacked with `git archive`), so a
parent and a change can be run in one call; the code that runs them (this file and
chip_smoke.py) is always this checkout's. `--out` appends the runs as JSON
lines. Two switches take the run's two sources of spread away, one each:
`--deterministic` runs torch's deterministic algorithms (on the card
`index_add_` otherwise sums in no fixed order), and `--gba-after K` holds the
first global BA until K frames after the loop and then waits for it, so it
writes back between frames loop + K and loop + K + 1 whatever the timing.

`--async` runs phase 13's System instead: the same orbit with
async_mapping=True (mapping and loop closing on worker threads), whose map
depends on thread timing; each line adds the keyframes the queue cap
deferred, the local BAs stopped early and the deepest mapping queue. Each run
is held to chip_smoke's gates for that phase (every frame tracked, a loop
closed, no false closure by ground truth, ATE within 1.5 x JAX_ATE_LOOP +
1 cm) and the line says which gate failed. `--eight` then runs phase 14's
async figure-eight (utils/gauntlet.run_sequence) M times (`--eight-runs`,
default N; `--runs 0` runs the eight alone), one line each with its record
and the mini-gauntlet's gates. Every async run also reports `lags`: for
each keyframe the mapping stage queued, the frames whose tracking began
between its queueing and the worker taking it up under the map lock, as
(lag, keyframes) pairs: 0 is the order the synchronous System keeps (taken
before the next frame is tracked), 1 or more that frames were tracked in
between.
`--no-handoff` stops the tracker waiting for the worker to take up a queued
keyframe (AsyncMapping.wait_taken does nothing): the order before that
hand-off, a race between the worker and the next frame. Needs an NVIDIA GPU.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def watch_lags(handoff: bool) -> list:
    """Record each queued keyframe's lag (the frames whose tracking began
    between its queueing and the mapping worker taking it up) into the list
    returned; with handoff=False, AsyncMapping.wait_taken no longer waits."""
    from orbslam2commentedbyxcm_tpu_torch.models import async_pipeline, local_mapping, tracking

    lags, queued, tracked = [], {}, [0]
    queue, take = async_pipeline.AsyncMapping.insert_keyframe, local_mapping.LocalMapping.insert_keyframe
    track = tracking.Tracking.track_frame

    def track_frame(self, frame):  # called under the map lock
        tracked[0] += 1
        return track(self, frame)

    def queue_kf(self, kf_id):
        queued[kf_id] = tracked[0]
        queue(self, kf_id)

    def take_kf(self, kf_id):  # called by the worker under the map lock
        if kf_id in queued:
            lags.append(tracked[0] - queued.pop(kf_id))
        take(self, kf_id)

    tracking.Tracking.track_frame = track_frame
    async_pipeline.AsyncMapping.insert_keyframe = queue_kf
    local_mapping.LocalMapping.insert_keyframe = take_kf
    if not handoff:
        async_pipeline.AsyncMapping.wait_taken = lambda self: None
    return lags


def lag_counts(lags: list) -> list:
    """(lag, keyframes) pairs of a run, by lag."""
    return sorted((lag, lags.count(lag)) for lag in set(lags))


def one_run(smoke, torch, dev, cam, seq, frames, gba_after=None, async_mapping=False) -> dict:
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import adjudicate_loops

    slam = System(cam, Sensor.RGBD, config=smoke._loop_config(), vocabulary="bootstrap",
                  enable_loop_closing=True, async_mapping=async_mapping, device=dev)
    lc = slam.loop_closing
    release = threading.Event()
    if gba_after is not None:
        solve = lc.gba._solve_and_write

        def held(*a):
            release.wait()
            solve(*a)

        lc.gba._solve_and_write = held
    else:
        release.set()
    loops, gba_frames, lost = [], [], 0
    t0 = time.perf_counter()
    for i, (img, depth) in enumerate(frames):
        n_loops, n_gba = lc.n_loops_closed, lc.gba.n_completed
        lost += slam.track_rgbd(img, depth, i / 30.0) is None
        if lc.n_loops_closed > n_loops:
            loops.append(i)
        if not release.is_set() and loops and i >= loops[0] + gba_after:
            release.set()
            lc.gba.wait()
        if lc.gba.n_completed > n_gba:
            gba_frames.append(i)
    release.set()
    n_loops = lc.n_loops_closed
    slam.shutdown()
    if lc.n_loops_closed > n_loops:
        loops.append(len(frames))  # closed while shutdown drained the queues
    if lc.gba.n_completed > len(gba_frames):
        gba_frames.append(len(frames))  # wrote back after the last frame
    seconds = time.perf_counter() - t0
    poses = smoke._frame_poses(slam)
    n = len(frames)
    adj = adjudicate_loops(slam, seq)
    out = {"loops": loops, "gba_write_back_frames": gba_frames, "gba_aborted": lc.gba.n_aborted,
           "lost_frames": lost, "keyframes": len(slam.map.good_keyframes()), "points": slam.map.n_valid_points(),
           "ate": smoke._ate(poses, seq, range(n)), "seconds": seconds, "false_closures": adj["false_closures"],
           "async": async_mapping}
    if async_mapping:
        lm = slam.local_mapping
        out.update(kf_deferred=slam.tracking.n_kf_deferred, ba_aborted=lm.n_ba_aborted,
                   ba_skipped=lm.n_ba_deferred, max_queue=lm.max_depth)
    bound = 1.5 * smoke.JAX_ATE_LOOP + 0.01
    failed = [name for name, ok in (("tracked", lost == 0), ("loop", bool(loops)),
                                    ("false_closure", adj["false_closures"] == 0), ("ate", out["ate"] <= bound))
              if not ok]
    out["gates_failed"] = failed
    if loops:
        first = loops[0]
        split = lc.closure_splits[0]
        edge = tuple(int(round(slam.map.keyframes[k].timestamp * 30.0)) for k in (split["kf_id"], split["loop_kf_id"]))
        out.update(ate_to_loop=smoke._ate(poses, seq, range(first + 1)),
                   ate_after_loop=smoke._ate(poses, seq, range(first + 1, n)),
                   edge_frames=list(edge), drift_m=smoke._drift(poses, seq, *edge)[0],
                   eg_vertices=split["eg_vertices"], eg_iterations=split["eg_iterations"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--gba-after", type=int, default=None)
    ap.add_argument("--async", dest="async_mapping", action="store_true")
    ap.add_argument("--eight", action="store_true")
    ap.add_argument("--eight-runs", type=int, default=None)
    ap.add_argument("--no-handoff", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before CUDA starts
    import torch

    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)

    if not torch.cuda.is_available():
        print("loop_runs: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree) if args.tree else ROOT
    sys.path.insert(0, tree)
    smoke = _smoke()
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, n_frames=smoke.N_LOOP, turns=1.3)
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(smoke.N_LOOP if args.runs else 0)]
    label = os.path.relpath(tree, ROOT)
    lags = watch_lags(handoff=not args.no_handoff)
    for r in range(args.runs):
        lags.clear()
        res = one_run(smoke, torch, dev, cam, seq, frames, args.gba_after, args.async_mapping)
        res.update(tree=label, run=r, card=card, deterministic=args.deterministic, gba_after=args.gba_after)
        if args.async_mapping:
            res.update(handoff=not args.no_handoff, lags=lag_counts(lags))
        _report(f"loop_runs {label} #{r}", card, res, args.out)
    if args.eight:
        from orbslam2commentedbyxcm_tpu_torch.utils.gauntlet import render_frames, run_sequence

        cam8 = smoke._eight_camera()
        images = render_frames("eight", smoke.EIGHT_FRAMES, cam8)
        for r in range(args.runs if args.eight_runs is None else args.eight_runs):
            lags.clear()
            rec = run_sequence("eight", smoke.EIGHT_FRAMES, augment=True, async_mapping=True, camera=cam8,
                               n_features=900, device=dev, images=images)
            gt = rec["gt_loops"]
            rec["gates_failed"] = [name for name, ok in (
                ("tracked", rec["tracked"] >= rec["frames"] - 5), ("loop", rec["loops_closed"] >= 1),
                ("false_closure", gt["false_closures"] == 0), ("missed", gt["missed"] == 0),
                ("drift", rec["drift_pct"] < 0.8)) if not ok]
            rec.update(tree=label, run=r, card=card, handoff=not args.no_handoff, lags=lag_counts(lags))
            _report(f"loop_runs eight {label} #{r}", card, rec, args.out)
    return 0


def _report(tag, card, res, out):
    print(f"[{tag}] {card} | " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                          for k, v in res.items() if k not in ("tree", "run", "card")), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    sys.exit(main())
