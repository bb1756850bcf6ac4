"""Monocular SLAM from a video file or a live camera.

Counterpart of examples/run_video.py (the fork-added example targets
`myvideo` and `myslam`, reference CMakeLists.txt:117-123: the standard
"cv::VideoCapture -> TrackMonocular" loop):

  python -m orbslam2commentedbyxcm_tpu_torch.cli.run_video VIDEO.mp4 SETTINGS.yaml   # == myvideo
  python -m orbslam2commentedbyxcm_tpu_torch.cli.run_video --camera 0 SETTINGS.yaml  # == myslam

Reading video needs OpenCV (cv2.VideoCapture), imported when `main` runs:
without it `main` raises ImportError naming cv2. The frame loop is the
System's `track_monocular` on `--device` (default cuda). Frames are
timestamped from the container FPS (or Camera.fps for live input). Writes
CameraTrajectory.txt / KeyFrameTrajectory.txt in TUM format on shutdown, like
the reference's System::SaveTrajectoryTUM (src/System.cc:347).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam2commentedbyxcm_tpu_torch.cli.run_video")
    ap.add_argument("paths", nargs="+", help="VIDEO SETTINGS.yaml | SETTINGS.yaml (with --camera)")
    ap.add_argument("--camera", type=int, default=None, help="live camera index (myslam mode)")
    ap.add_argument("--vocabulary", default=None, help=".npz vocabulary (else trained lazily)")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping and loop closing on worker threads (reference thread pipeline)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--stride", type=int, default=1, help="process every Nth frame")
    ap.add_argument("--out-prefix", default="")
    ap.add_argument("--localization-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device the System runs on (default cuda)")
    args = ap.parse_args(argv)

    try:
        import cv2
    except ImportError as exc:
        raise ImportError("run_video reads video with OpenCV's cv2.VideoCapture, and cv2 is not installed") from exc

    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings

    if args.camera is not None:
        settings = args.paths[0]
        cap = cv2.VideoCapture(args.camera)
        src = f"camera {args.camera}"
    else:
        video, settings = args.paths[0], args.paths[1]
        cap = cv2.VideoCapture(video)
        src = video
    if not cap.isOpened():
        print(f"cannot open {src}", file=sys.stderr)
        return 1

    camera, cfg, extra = load_settings(settings)
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    if fps <= 0:
        fps = extra.get("fps", 30.0) or 30.0

    vocabulary = None
    if args.vocabulary:
        from orbslam2commentedbyxcm_tpu_torch.ops.bow import Vocabulary

        vocabulary = Vocabulary.load(args.vocabulary)

    system = System(camera, Sensor.MONOCULAR, config=cfg, vocabulary=vocabulary,
                    enable_loop_closing=not args.no_loop_closing,
                    async_mapping=args.async_mapping, device=args.device)
    if args.localization_only:
        system.activate_localization_mode()

    i = kept = 0
    wall0 = time.time()
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % args.stride == 0:
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
            ts = i / fps
            system.track_monocular(gray.astype(np.float32), ts)
            kept += 1
            if kept % 30 == 1:
                st = system.get_tracking_state().name
                print(f"frame {i}: state={st} tracked={system.n_tracked_points()}")
        i += 1
        if args.max_frames is not None and kept >= args.max_frames:
            break
    cap.release()

    wall = time.time() - wall0
    print(f"processed {kept} frames in {wall:.1f}s ({kept / max(wall, 1e-9):.1f} fps)")
    system.shutdown()
    system.save_trajectory_tum(args.out_prefix + "CameraTrajectory.txt")
    system.save_keyframe_trajectory_tum(args.out_prefix + "KeyFrameTrajectory.txt")
    print(f"saved {args.out_prefix}CameraTrajectory.txt / KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
