"""The JAX package's ATE on the CPU over chip_smoke.py's SLAM runs: the
references behind chip_smoke's JAX_ATE_RGBD, JAX_ATE_STEREO, JAX_ATE_MONO and
JAX_ATE_LOOP (each port bound is 1.5 x that + 1 cm).

    python3 tools/jax_reference_ate.py mono      # ~75 s on 2 CPU threads
    python3 tools/jax_reference_ate.py rgbd stereo
    python3 tools/jax_reference_ate.py loop      # several minutes per frame count
    python3 tools/jax_reference_ate.py dataset [tum kitti euroc]   # ~1-1.5 min each
    python3 tools/jax_reference_ate.py mesh      # several minutes

Runs the JAX System at 640x480 with default_camera(640, 480) and 1000
features. rgbd / stereo / mono use chip_smoke's keyframe policy and no loop
closing (no lazy vocabulary trainer): RGB-D over BoxSequence seed 5 frames
0-59 (SE3 alignment), stereo over rounded pairs 0-29 (SE3), mono over
SyntheticSequence("sideways") frames 0-59 (Sim3).

loop is chip_smoke's phase 12: System(RGBD, vocabulary="bootstrap",
enable_loop_closing=True) over a BoxSequence orbit (seed 0, turns 1.3) with
TrackingConfig(max_frames_between_kf=4, kf_tracked_ratio=0.95,
motion_search_radius=20.0). The orbit is spread over the run's frame count,
so each count is its own trajectory: starting at 130 it adds 10 frames until
the System closes a loop, then prints that count, the frame of the loop, the
ATE of the loop-corrected frame trajectory (after global BA) and the ATE of
the same frames tracked with loop closing off (SE3 alignment both). For each
run it also splits the ATE into frames 0 to the loop frame and the frames
after (each aligned on its own), and gives the drift at the loop: the error of
the relative pose between the two frames the first loop edge joins. Each
figure is given twice: on the JAX package's frame trajectory as it records
it, and with every keyframe frame recorded as its own keyframe's pose, as the
port records it (the JAX package records the frame's pose from before the
synchronous local BA and loop correction against the keyframe moved by
them). `loop N` runs one count only.

dataset is chip_smoke's phase 15 (JAX_ATE_DATASET): each format's fixture
(chip_smoke.DATASET_FIXTURES, written by chip_smoke.write_dataset_fixture)
rendered by the JAX package's writer into a temporary directory, then run
through the JAX CLI, examples/run_dataset.py, on the CPU with
chip_smoke.DATASET_FLAGS; prints the CLI's tracked frames and ATE (SE3).

mesh is chip_smoke's phase 16 (JAX_ATE_MESH): phase 12's 130-frame run with
System(mesh=make_mesh(8)) over 8 virtual CPU devices, the essential graph's
gate lowered to 0 vertices (LoopClosing.dist_min_vertices) and global BA's
left at its default of 2048 points; prints the tracked frames, the loops,
how many solves went through the mesh and the ATE both ways, as loop does.

Needs the JAX package; the port is not imported.
"""

import os
import sys
import time

if sys.argv[1:2] == ["mesh"]:  # 8 virtual CPU devices, set before jax is imported
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam2commentedbyxcm_tpu.models import system as jsystem  # noqa: E402
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig  # noqa: E402
from orbslam2commentedbyxcm_tpu.utils.evaluation import ate_rmse, positions_from_tcw  # noqa: E402
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence, SyntheticSequence, default_camera  # noqa: E402

RUNS = {"rgbd": 60, "stereo": 30, "mono": 60}
LOOP_FIRST, LOOP_STEP, LOOP_LAST = 130, 10, 200


def run(which: str):
    cam = default_camera(640, 480)
    n = RUNS[which]
    sensor = {"rgbd": jsystem.Sensor.RGBD, "stereo": jsystem.Sensor.STEREO, "mono": jsystem.Sensor.MONOCULAR}[which]
    if which == "mono":
        seq = SyntheticSequence(camera=cam, n_frames=n, trajectory="sideways")
    else:
        seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    s = jsystem.System(cam, sensor, config=TrackingConfig(max_frames_between_kf=8, kf_tracked_ratio=0.95),
                       enable_loop_closing=False)
    s.local_mapping.loop_closer = None
    t0 = time.perf_counter()
    est, gt = [], []
    for i in range(n):
        if which == "rgbd":
            p = s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
        elif which == "stereo":
            p = s.track_stereo(np.round(seq.render(i)), np.round(seq.render_right(i)), i / 30.0)
        else:
            p = s.track_monocular(seq.render(i), i / 30.0)
        if p is not None:
            est.append(p)
            gt.append(seq.pose(i))
    ate = ate_rmse(positions_from_tcw(np.stack(est)), positions_from_tcw(np.stack(gt)), with_scale=which == "mono")
    print(f"{which}: JAX CPU {len(est)}/{n} tracked, ATE {ate:.6f} m ({'Sim3' if which == 'mono' else 'SE3'}), "
          f"{len(s.map.good_keyframes())} keyframes, {s.map.n_valid_points()} points, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


LOOP_CONFIG = dict(max_frames_between_kf=4, kf_tracked_ratio=0.95, motion_search_radius=20.0)


def loop_run(n: int, loop_closing: bool, mesh=None):
    """One pass of phase 12's run over an n-frame orbit -> (System, frames
    tracked, frame of the first closed loop or None, frame trajectory as
    {frame index: Tcw}, ground truth). With a mesh, the essential graph's
    gate is lowered to 0 vertices (phase 16)."""
    cam = default_camera(640, 480)
    seq = BoxSequence(camera=cam, n_frames=n, turns=1.3)
    s = jsystem.System(cam, jsystem.Sensor.RGBD, config=TrackingConfig(**LOOP_CONFIG), vocabulary="bootstrap",
                       enable_loop_closing=loop_closing, mesh=mesh)
    if mesh is not None:
        s.loop_closing.dist_min_vertices = 0
    tracked, loop_frame = 0, None
    for i in range(n):
        tracked += s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
        if loop_frame is None and s.loop_closing is not None and s.loop_closing.n_loops_closed:
            loop_frame = i
    traj = {int(round(ts * 30)): t for ts, t in s.frame_trajectory()}  # waits for a running global BA
    return s, tracked, loop_frame, traj, repaired_trajectory(s), seq


def repaired_trajectory(s):
    """{frame index: Tcw} with each keyframe frame at its keyframe's pose
    (relative pose I to its reference keyframe, as the port records it)."""
    recorded = s.tracking.trajectory
    kfs = s.map.keyframes
    s.tracking.trajectory = [(ts, ref, np.eye(4, dtype=np.float32) if ref in kfs and kfs[ref].timestamp == ts else rel)
                             for ts, ref, rel in recorded]
    try:
        return {int(round(ts * 30)): t for ts, t in s.frame_trajectory()}
    finally:
        s.tracking.trajectory = recorded


def ate_of(traj, seq, frames) -> float:
    """SE3-aligned ATE (m) of the trajectory's poses at `frames`."""
    frames = [f for f in frames if f in traj]
    return ate_rmse(positions_from_tcw(np.stack([traj[f] for f in frames])),
                    positions_from_tcw(np.stack([seq.pose(f) for f in frames])), with_scale=False)


def loop_edge_drift(traj, seq, a: int, b: int) -> tuple[float, float]:
    """(m, deg) error of the relative pose T_a T_b^-1 between frames a and b
    against ground truth: the drift a loop edge between them corrects."""
    ta, tb = (np.asarray(traj[f], np.float64) for f in (a, b))
    err = (ta @ np.linalg.inv(tb)) @ np.linalg.inv(seq.pose(a) @ np.linalg.inv(seq.pose(b)))
    ang = np.degrees(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(err[:3, 3])), float(ang)


def _loop_report(tag, n, trajs, seq, loop_frame, edge):
    for how, traj in zip(("as recorded", "keyframe frames at their keyframe"), trajs):
        full = ate_of(traj, seq, range(n))
        before = ate_of(traj, seq, range(loop_frame + 1))
        after = ate_of(traj, seq, range(loop_frame + 1, n))
        drift = loop_edge_drift(traj, seq, *edge)
        print(f"{tag} ({how}): ATE {full:.6f} m (SE3); frames 0-{loop_frame} {before:.6f} m, {loop_frame + 1}-"
              f"{n - 1} {after:.6f} m; drift between frames {edge[0]} and {edge[1]}: {drift[0]:.6f} m, "
              f"{drift[1]:.4f} deg", flush=True)


def run_loop(counts):
    for n in counts:
        t0 = time.perf_counter()
        s, tracked, loop_frame, traj, fixed, seq = loop_run(n, True)
        lc = s.loop_closing
        print(f"loop: {n} frames, JAX CPU {tracked}/{n} tracked, {lc.n_loops_closed} loops closed "
              f"(first at frame {loop_frame}), {len(s.map.good_keyframes())} keyframes, "
              f"stats {lc.stats}, {time.perf_counter() - t0:.1f} s", flush=True)
        if lc.n_loops_closed:
            m = s.map
            kf_id, loop_kf_id = min((kf.kf_id, le) for kf in m.keyframes.values() for le in kf.loop_edges
                                    if le < kf.kf_id)
            edge = tuple(int(round(m.keyframes[k].timestamp * 30)) for k in (kf_id, loop_kf_id))
            _loop_report("loop on", n, (traj, fixed), seq, loop_frame, edge)
            t0 = time.perf_counter()
            _, tracked_off, _, traj_off, fixed_off, _ = loop_run(n, False)
            print(f"loop off: {n} frames, JAX CPU {tracked_off}/{n} tracked, {time.perf_counter() - t0:.1f} s",
                  flush=True)
            _loop_report("loop off", n, (traj_off, fixed_off), seq, loop_frame, edge)
            return


def run_mesh(n: int = 130):
    from orbslam2commentedbyxcm_tpu.parallel.dist_ba import make_mesh

    t0 = time.perf_counter()
    s, tracked, loop_frame, traj, fixed, seq = loop_run(n, True, mesh=make_mesh(8))
    lc = s.loop_closing
    print(f"mesh: {n} frames, make_mesh(8) on {len(jax.devices())} CPU devices, JAX CPU {tracked}/{n} tracked, "
          f"{lc.n_loops_closed} loops closed (first at frame {loop_frame}), {len(s.map.good_keyframes())} "
          f"keyframes, essential graphs through the mesh {lc.stats['posegraph_distributed']}, global BAs through "
          f"the mesh {lc.gba.n_distributed} of {lc.gba.n_completed} completed, {time.perf_counter() - t0:.1f} s",
          flush=True)
    if lc.n_loops_closed:
        m = s.map
        kf_id, loop_kf_id = min((kf.kf_id, le) for kf in m.keyframes.values() for le in kf.loop_edges
                                if le < kf.kf_id)
        edge = tuple(int(round(m.keyframes[k].timestamp * 30)) for k in (kf_id, loop_kf_id))
        _loop_report("mesh", n, (traj, fixed), seq, loop_frame, edge)


def run_dataset(formats):
    import re
    import subprocess
    import tempfile

    import chip_smoke
    from orbslam2commentedbyxcm_tpu.utils import dataset_writers
    from orbslam2commentedbyxcm_tpu.utils.config import load_settings

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for fmt in formats:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            args = chip_smoke.write_dataset_fixture(fmt, tmp, dataset_writers, BoxSequence, load_settings)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            out = subprocess.run([sys.executable, os.path.join(repo, "examples", "run_dataset.py"), *args,
                                  *chip_smoke.DATASET_FLAGS, "--out-prefix", tmp + "/"],
                                 cwd=repo, env=env, capture_output=True, text=True)
            if out.returncode != 0:
                raise SystemExit(f"{fmt}: the JAX CLI failed:\n{out.stdout[-2000:]}{out.stderr[-2000:]}")
            tracked = re.search(r"tracked (\d+/\d+) frames", out.stdout).group(1)
            ate = float(re.search(r"ATE RMSE: ([0-9.]+) cm", out.stdout).group(1))
            print(f"dataset {fmt}: {chip_smoke.DATASET_FIXTURES[fmt]}, JAX CLI CPU {tracked} tracked, ATE "
                  f"{ate:.2f} cm = {ate / 100:.4f} m (SE3); written in {write_s:.1f} s, run "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:] or ["mono"]
    if args[0] == "dataset":
        run_dataset(args[1:] or ["tum", "kitti", "euroc"])
    elif args[0] == "mesh":
        run_mesh()
    elif args[0] == "loop":
        run_loop([int(args[1])] if len(args) > 1 else range(LOOP_FIRST, LOOP_LAST + 1, LOOP_STEP))
    else:
        for which in args:
            run(which)
