"""Run SLAM on a dataset on disk (TUM RGB-D / KITTI odometry / EuRoC MAV).

Counterpart of examples/run_dataset.py, which covers the reference's six
example binaries (rgbd_tum, stereo_kitti, stereo_euroc, mono_tum, mono_kitti,
mono_euroc; CMakeLists.txt:84-123):

  python -m orbslam2commentedbyxcm_tpu_torch.cli.run_dataset tum   SEQ_DIR SETTINGS.yaml [--mono] [...]
  python -m orbslam2commentedbyxcm_tpu_torch.cli.run_dataset kitti DATA_ROOT SEQ SETTINGS.yaml [--mono]
  python -m orbslam2commentedbyxcm_tpu_torch.cli.run_dataset euroc SEQ_DIR SETTINGS.yaml [--mono]

SETTINGS.yaml uses the reference's OpenCV-YAML schema (Camera.*,
ORBextractor.*, ThDepth, DepthMapFactor, and for EuRoC the LEFT.*/RIGHT.*
rectification blocks). Frames are read and decoded (and rectified) on a
prefetch thread as numpy arrays; the System copies each to `--device`
(default cuda; a missing card raises) on the tracking thread. Writes
CameraTrajectory.txt / KeyFrameTrajectory.txt (TUM format) and prints ATE
when ground truth exists.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam2commentedbyxcm_tpu_torch.cli.run_dataset")
    ap.add_argument("dataset", choices=["tum", "kitti", "euroc"])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--mono", action="store_true", help="force monocular mode")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping and loop closing on worker threads (reference thread pipeline)")
    ap.add_argument("--vocabulary", default=None, help=".npz vocabulary (else trained lazily)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out-prefix", default="")
    ap.add_argument("--trace", default=None, metavar="TRACE.jsonl",
                    help="record per-frame stage timings and dump JSONL")
    ap.add_argument("--device", default="cuda", help="torch device the System runs on (default cuda)")
    args = ap.parse_args(argv)

    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.utils import datasets
    from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw

    if args.dataset == "tum":
        seq_dir, settings = args.paths[0], args.paths[1]
        camera, cfg, extra = load_settings(settings)
        data = datasets.TumRgbdDataset(seq_dir, depth_factor=extra["depth_map_factor"])
        sensor = Sensor.MONOCULAR if args.mono else Sensor.RGBD
    elif args.dataset == "kitti":
        root, seq, settings = args.paths[0], args.paths[1], args.paths[2]
        camera, cfg, extra = load_settings(settings)
        data = datasets.KittiOdometryDataset(root, seq)
        sensor = Sensor.MONOCULAR if args.mono else Sensor.STEREO
    else:
        seq_dir, settings = args.paths[0], args.paths[1]
        camera, cfg, extra = load_settings(settings)
        # EuRoC frames are raw distorted stereo: build rectification maps
        # from the LEFT.*/RIGHT.* K/D/R/P settings keys when present
        # (reference stereo_euroc contract, README.md:207); Camera.* must
        # then describe the RECTIFIED projection P.
        from orbslam2commentedbyxcm_tpu_torch.utils.rectify import StereoRectifier

        rectifier = StereoRectifier.from_settings(extra)
        if rectifier is not None:
            print("stereo rectification maps built from LEFT.*/RIGHT.*")
        data = datasets.EurocDataset(seq_dir, rectifier=rectifier)
        sensor = Sensor.MONOCULAR if args.mono else Sensor.STEREO

    vocabulary = None
    if args.vocabulary:
        from orbslam2commentedbyxcm_tpu_torch.ops.bow import Vocabulary

        vocabulary = Vocabulary.load(args.vocabulary)

    tracer = None
    if args.trace:
        from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

        tracer = Tracer()
    system = System(camera, sensor, config=cfg, vocabulary=vocabulary,
                    enable_loop_closing=not args.no_loop_closing,
                    async_mapping=args.async_mapping, tracer=tracer, device=args.device)

    n = len(data) if args.max_frames is None else min(len(data), args.max_frames)
    results, stamps = [], []
    t0 = time.time()
    # disk IO + decode (+ rectification) overlap tracking on a prefetch thread
    for i, (ts, img, aux) in enumerate(datasets.Prefetcher(data, depth=4, stop=n)):
        if sensor == Sensor.MONOCULAR:
            pose = system.track_monocular(img, ts)
        elif sensor == Sensor.RGBD:
            pose = system.track_rgbd(img, aux, ts)
        else:
            pose = system.track_stereo(img, aux, ts)
        results.append(pose)
        stamps.append(ts)
        if i % 50 == 0:
            print(
                f"frame {i}/{n}: {system.get_tracking_state().name} "
                f"kfs={len(system.map.good_keyframes())} pts={system.map.n_valid_points()}",
                flush=True,
            )
    dt = time.time() - t0
    system.shutdown()
    if tracer is not None:
        print(tracer.summary_table())
        tracer.dump_jsonl(args.trace)
        print(f"trace written to {args.trace}")

    system.save_trajectory_tum(args.out_prefix + "CameraTrajectory.txt")
    system.save_keyframe_trajectory_tum(args.out_prefix + "KeyFrameTrajectory.txt")
    tracked = [i for i, p in enumerate(results) if p is not None]
    print(f"\ntracked {len(tracked)}/{n} frames at {n / dt:.2f} fps wall")

    gt = data.groundtruth()
    if gt is not None and len(tracked) > 10:
        gt_ts, gt_pos = gt
        est = np.stack([results[i] for i in tracked])
        est_pos = positions_from_tcw(est)
        # associate by timestamp
        sel = [int(np.argmin(np.abs(gt_ts - stamps[i]))) for i in tracked]
        ate = ate_rmse(est_pos, gt_pos[sel], with_scale=sensor == Sensor.MONOCULAR)
        print(f"ATE RMSE: {ate * 100:.2f} cm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
