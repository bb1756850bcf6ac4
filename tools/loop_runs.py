"""Phase 12's loop-closing run, repeated: how far its result spreads between
runs of one build, and how two builds compare on the same card.

    python3 tools/loop_runs.py [--runs N] [--tree DIR] [--out FILE]
                               [--deterministic] [--gba-after K]

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
Needs an NVIDIA GPU.
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


def one_run(smoke, torch, dev, cam, seq, frames, gba_after=None) -> dict:
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System

    slam = System(cam, Sensor.RGBD, config=smoke._loop_config(), vocabulary="bootstrap",
                  enable_loop_closing=True, device=dev)
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
    slam.shutdown()
    if lc.gba.n_completed > len(gba_frames):
        gba_frames.append(len(frames))  # wrote back after the last frame
    seconds = time.perf_counter() - t0
    poses = smoke._frame_poses(slam)
    n = len(frames)
    out = {"loops": loops, "gba_write_back_frames": gba_frames, "gba_aborted": lc.gba.n_aborted,
           "lost_frames": lost, "keyframes": len(slam.map.good_keyframes()), "points": slam.map.n_valid_points(),
           "ate": smoke._ate(poses, seq, range(n)), "seconds": seconds}
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
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(smoke.N_LOOP)]
    label = os.path.relpath(tree, ROOT)
    for r in range(args.runs):
        res = one_run(smoke, torch, dev, cam, seq, frames, args.gba_after)
        res.update(tree=label, run=r, card=card, deterministic=args.deterministic, gba_after=args.gba_after)
        print(f"[loop_runs {label} #{r}] {card} | " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in res.items()
            if k not in ("tree", "run", "card")), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
