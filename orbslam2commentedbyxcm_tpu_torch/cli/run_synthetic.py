"""Run the full SLAM system on a synthetic sequence and report ATE.

Counterpart of examples/run_synthetic.py (the reference's example binaries,
mono_tum etc., CMakeLists.txt:84-123, for the built-in synthetic world):

  python -m orbslam2commentedbyxcm_tpu_torch.cli.run_synthetic [--sensor mono|stereo|rgbd]
      [--frames N] [--trajectory sideways|arc|forward|outback] [--loop-closing]
      [--width W --height H] [--save-traj out.txt] [--viewer out.png] [--device cuda|cpu]

`--device` (default cuda; a missing card raises) takes the place of the JAX
script's `--cpu`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam2commentedbyxcm_tpu_torch.cli.run_synthetic")
    ap.add_argument("--sensor", default="mono", choices=["mono", "stereo", "rgbd"])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--trajectory", default="sideways")
    ap.add_argument("--loop-closing", action="store_true")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--n-features", type=int, default=600)
    ap.add_argument("--save-traj", default=None)
    ap.add_argument("--viewer", default=None, help="save a map/trajectory plot to PNG")
    ap.add_argument("--device", default="cuda", help="torch device the System runs on (default cuda)")
    args = ap.parse_args(argv)

    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import SyntheticSequence

    cam = Camera(
        fx=args.width * 0.78, fy=args.width * 0.78,
        cx=args.width / 2, cy=args.height / 2,
        width=args.width, height=args.height,
        bf=args.width * 0.078, th_depth=40.0,
    )
    seq = SyntheticSequence(camera=cam, n_frames=args.frames, trajectory=args.trajectory)
    sensor = {"mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO, "rgbd": Sensor.RGBD}[args.sensor]
    cfg = TrackingConfig(n_features=args.n_features, max_frames_between_kf=6)
    system = System(cam, sensor, config=cfg, enable_loop_closing=args.loop_closing, device=args.device)

    results = []
    t0 = time.time()
    for i in range(seq.n_frames):
        img = seq.render(i)
        if sensor == Sensor.MONOCULAR:
            pose = system.track_monocular(img, i / cam.fps)
        elif sensor == Sensor.STEREO:
            pose = system.track_stereo(img, seq.render_right(i), i / cam.fps)
        else:
            pose = system.track_rgbd(img, seq.depth_map(i), i / cam.fps)
        results.append(pose)
        state = system.get_tracking_state().name
        print(
            f"frame {i:3d}: {state:<16} inliers={system.n_tracked_points():4d} "
            f"kfs={len(system.map.good_keyframes()):3d} pts={system.map.n_valid_points():5d}",
            flush=True,
        )
    dt = time.time() - t0

    idx = [i for i, p in enumerate(results) if p is not None]
    if len(idx) < 5:
        system.shutdown()
        print(f"TRACKING FAILED: only {len(idx)} frames tracked")
        return 1
    est = np.stack([results[i] for i in idx])
    gt = np.stack([seq.pose(i) for i in idx])
    with_scale = sensor == Sensor.MONOCULAR
    ate = ate_rmse(positions_from_tcw(est), positions_from_tcw(gt), with_scale=with_scale)
    system.shutdown()
    loops = system.loop_closing.n_loops_closed if system.loop_closing else 0
    print(
        f"\ntracked {len(idx)}/{seq.n_frames} frames | "
        f"ATE RMSE {ate * 100:.2f} cm ({'Sim3' if with_scale else 'SE3'} aligned) | "
        f"loops closed: {loops} | {seq.n_frames / dt:.2f} fps wall"
    )
    if args.save_traj:
        system.save_trajectory_tum(args.save_traj)
        print("trajectory saved to", args.save_traj)
    if args.viewer:
        from orbslam2commentedbyxcm_tpu_torch.utils.viewer import save_map_plot

        save_map_plot(system, args.viewer, gt_positions=positions_from_tcw(gt))
        print("map plot saved to", args.viewer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
