"""The port's benchmark: one cell, one run.

    python3 slambench/run.py --workload tum3_rgbd.office_loop --seed 7 --seconds 35 --trace 0

A run builds the port's System (orbslam2commentedbyxcm_tpu_torch) from the
cell's settings file, with the async pipeline, the bootstrap vocabulary and
loop closing on, and feeds it the cell's frames by `track_rgbd` /
`track_stereo` for `--seconds`, flat out or at the camera's rate as the
traffic mix says (pacing.py). The frames are one period of the cell's
camera path (traffic/<mix>.json), rendered on the card during set-up
(scene.py) and cycled; the seed draws the order of the walls' blob values
only.

Set-up (`setup_s`, from the process start to the window's start): the
kernels (built into build/kernels/ on a checkout's first run), the frames,
a throwaway System over the path's first seconds, the linear-algebra
libraries the port calls, and for a mix with `premap_s` the measured
System's own mapping of the path's first seconds. After the window,
`shutdown()` drains the workers and global BA; a sample of the window's
frames and the map are held to the plain reference and the ground truth
(checks.py). `--trace 1` runs the same window, then a traced one of at most
TRACED_S seconds (the port's Tracer and torch.profiler) and prints the
per-layer metrics instead of the end-to-end ones: the host-clock ones from
the untraced window, the rest from the traced one.

The last line of standard output is the result: correct, attempted (frames
sent in the window), failed (frames with no pose or that raised), metrics, device,
breakdown (with --trace 1) and checks (each number compared with its limit,
also printed last on standard error).
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam2commentedbyxcm_tpu")


def _env():
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its own kernels into build/kernels/; these hold whatever torch
    or Triton would build, so that a later run of the checkout finds it)."""
    cache = ROOT / "build" / "slambench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


class Run:
    """What the metric readers read (metrics/<name>.py)."""

    def __init__(self, settings: dict):
        self.settings = settings   # the settings file's numeric keys
        self.record = None         # pacing.Record of the window
        self.setup_s = None
        self.keyframes = None      # good keyframes in the map after shutdown()
        self.tracer_stats = None   # the port's Tracer.stats() over the traced window (trace runs)
        self.trace = None          # devtrace.Trace of the traced window (trace runs on the card)
        self.stages = []           # reference extraction stages of the checked frames
        self.k2_edges = []         # active edges of the checked frames' pose solves
        self.capacity = None       # keypoint slots of one extraction

    def span_p50(self, name: str):
        s = (self.tracer_stats or {}).get("spans", {}).get(name)
        return None if not s else s["p50_ms"]


def _render(scene_mod, cfg: dict, path, camera, n: int, device, stereo: bool, depth_factor: float):
    """Frames 0..n-1 as the dataset gives them, on the host: TUM RGB uint8
    (H, W, 3) and depth float32 (16-bit 1/factor m values, -1 where 0), or
    EuRoC rectified uint8 pairs. Rendered in batches on the device."""
    import numpy as np
    import torch

    sc = cfg["scene"]
    scene = scene_mod.Scene(sc["half_size"], sc["tex_size"], sc["n_blobs"], cfg["seed"], device)
    k = np.array([[camera.fx, 0, camera.cx], [0, camera.fy, camera.cy], [0, 0, 1]], np.float64)
    w, h = camera.width, camera.height
    poses = np.stack([path.pose(i / camera.fps) for i in range(n)])
    left, other = [], []
    batch = 8
    for b0 in range(0, n, batch):
        tcw = torch.as_tensor(poses[b0:b0 + batch], device=device)
        img, depth = scene.render(tcw, k, w, h)
        img8 = torch.round(img).clamp(0, 255).to(torch.uint8)
        if stereo:
            t_rl = torch.eye(4, dtype=torch.float64, device=device)
            t_rl[0, 3] = -camera.bf / camera.fx
            right, _ = scene.render(t_rl @ tcw, k, w, h)
            left += list(img8.cpu().numpy())
            other += list(torch.round(right).clamp(0, 255).to(torch.uint8).cpu().numpy())
        else:
            left += list(img8[..., None].expand(-1, h, w, 3).contiguous().cpu().numpy())
            raw = torch.where(torch.isfinite(depth), torch.round(depth * depth_factor), 0.0).clamp(0, 65535)
            raw = raw.to(torch.int32).float()
            d = torch.where(raw > 0, raw / torch.full_like(raw, depth_factor), -1.0)
            other += list(d.cpu().numpy())
    del scene
    return poses, left, other


def _warm_linalg(device):
    """The linear-algebra libraries the port calls, loaded before the
    window (their first call loads a library)."""
    import torch

    for dt in (torch.float32, torch.float64):
        a = torch.eye(6, dtype=dt, device=device).expand(4, 6, 6) * 2.0
        b = torch.ones((4, 6, 1), dtype=dt, device=device)
        torch.linalg.solve(a, b)
        torch.linalg.solve_ex(a, b)
        torch.linalg.inv(a)
        torch.linalg.det(a)
        torch.linalg.eigh(a)
        torch.linalg.svd(a)
        l_, _ = torch.linalg.cholesky_ex(a)
        torch.cholesky_solve(b, l_)
        torch.linalg.solve_triangular(l_, b, upper=False)
        torch.linalg.matrix_exp(a * 0.01)
        torch.linalg.norm(a)
    if device.type == "cuda":
        torch.cuda.synchronize()


class Cell:
    """A cell's entry, configuration, traffic mix and settings values."""

    def __init__(self, workload: str, root: Path, device: str):
        import torch

        from slambench import checks, spec

        self.workload, self.root = workload, root
        self.bench = spec.load_json(root / "BENCHMARK.json")
        c = spec.cell(self.bench, workload, root)
        self.entry, self.config, self.traffic = c["entry"], c["config"], c["traffic"]
        self.dev = torch.device(device)
        self.values = checks.settings_values(self.config["settings_path"])
        self.stereo = self.config["sensor"] == "stereo"

    def cards_missing(self) -> str | None:
        import torch

        if self.dev.type != "cuda":
            return None
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < self.entry["chips"]:
            return f"slambench: {self.workload} needs {self.entry['chips']} CUDA device(s); available: {have}"
        torch.cuda.set_device(0)
        return None


TRACED_S = 10.0  # the traced window of a --trace 1 run, after its untraced one


def execute(cell: Cell, seed: int, seconds: float, trace: bool, warm: bool = True) -> dict:
    """Set-up, the window, with --trace 1 the traced window after it, and
    the drain of one run -> what the checks and the readers need: the Run,
    the snapshots of the sampled frames, the map as shutdown() left it, the
    frames and the memory peak."""
    import numpy as np
    import torch

    from slambench import devtrace, pacing, scene as scene_mod

    from orbslam2commentedbyxcm_tpu_torch import kernels
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.ops import bow
    from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings
    from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

    dev, traffic, stereo = cell.dev, cell.traffic, cell.stereo
    camera, tcfg, extra = load_settings(cell.config["settings_path"])
    fps = camera.fps
    if traffic["pace"] not in pacing.PACES:
        raise SystemExit(f"slambench: pace {traffic['pace']!r}: one of {pacing.PACES}")
    period = 1.0 / fps if traffic["pace"] == "camera" else 0.0
    if dev.type == "cuda":
        kernels.library()
    kernels.host_library()

    # one period of the path, rendered once; frame k shows frame k % n_lap
    # at time stamp k / fps
    path = scene_mod.Path(traffic)
    n_lap = int(round(path.period_s() * fps))
    n_pre = int(round(traffic.get("premap_s", 0.0) * fps))
    n_cam = int(math.ceil(seconds * fps))  # the frames the camera sends in the window
    n_warm = int(round(traffic["warmup_s"] * fps)) if warm else 0
    poses, left, other = _render(scene_mod, dict(cell.config, seed=seed), path, camera, n_lap, dev, stereo,
                                 float(extra.get("depth_map_factor", 5000.0)))
    voc = bow.bootstrap_vocabulary()
    sensor = Sensor.STEREO if stereo else Sensor.RGBD

    def make_system(tracer=None):
        return System(camera, sensor, config=tcfg, vocabulary=voc, enable_loop_closing=True,
                      async_mapping=True, tracer=tracer, device=dev)

    def track(system, k):
        j = k % n_lap
        if stereo:
            return system.track_stereo(left[j], other[j], k / fps)
        return system.track_rgbd(left[j], other[j], k / fps)

    if warm:
        _warm_linalg(dev)
        throwaway = make_system()
        for k in range(n_warm):
            track(throwaway, k)
        throwaway.shutdown()
        del throwaway
        gc.collect()

    tracer = Tracer(enabled=False) if trace else None
    system = make_system(tracer)
    for k in range(n_pre):
        track(system, k)
    system.frame_trajectory()  # drains the premap's keyframes before the window
    rng = np.random.default_rng(seed)
    n_sample = min(traffic["sample_frames"], n_cam - 1)
    sample = set((n_pre + 1 + rng.choice(n_cam - 1, n_sample, replace=False)).tolist())
    snaps, versions, window = [], {}, {"next": n_pre}

    def snapshot(k):
        fr = system.tracking.last_frame
        if fr is None:
            return
        snap = {f: np.array(getattr(fr, f)) for f in ("uv", "level", "angle", "response", "desc", "valid")}
        snap.update(index=k % n_lap, depth=fr.depth.copy(), u_right=fr.u_right.copy(), t_cw=fr.t_cw.copy(),
                    map_pt=fr.map_pt.copy(), is_outlier=fr.is_outlier.copy(), pts=None)
        # the positions the frame's pose solve used: no point moved since
        # the call began (pt_version counts every change) and none is moving
        if system.map_lock.acquire(blocking=False):
            try:
                if system.map.pt_version == versions[k]:
                    snap["pts"] = system.map.pt_xyz[snap["map_pt"][snap["map_pt"] >= 0]].astype(np.float64)
            finally:
                system.map_lock.release()
        snaps.append(snap)

    def windowed(marked):
        base = window["next"]

        def call(i):
            k = base + i
            window["next"] = k + 1
            if k in sample:
                versions[k] = system.map.pt_version
            with marked():
                return track(system, k) is not None

        def after(i):
            if base + i in sample:
                snapshot(base + i)
        return call, after

    def on_start(_):
        window["t0"] = time.monotonic()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    run = Run(cell.values)
    call, after = windowed(contextlib.nullcontext)
    run.record = pacing.run_window(seconds, period, call, on_start=on_start, after=after)
    run.setup_s = window["t0"] - PROCESS_START
    if trace:
        tracer.enabled = True
        call, _ = windowed(lambda: torch.profiler.record_function(devtrace.TRACK_RANGE))
        with devtrace.profiled(dev.type == "cuda") as prof:
            pacing.run_window(min(seconds, TRACED_S), period, call)
        tracer.enabled = False
        run.tracer_stats = tracer.stats()
        run.trace = prof.trace
    system.shutdown()
    memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    with system.map_lock:
        m = system.map
        kfs = sorted(m.good_keyframes(), key=lambda kf: kf.kf_id)
        origin = next((i for i, kf in enumerate(kfs) if kf.kf_id == m.origin_kf_id), 0)
        kf_est = np.stack([kf.t_cw for kf in kfs]) if kfs else np.zeros((0, 4, 4))
        kf_gt = poses[[int(round(kf.timestamp * fps)) % n_lap for kf in kfs]]
        points = m.pt_xyz[m.all_point_ids()].astype(np.float64)
    loops = system.loop_closing.n_loops_closed if system.loop_closing is not None else 0
    run.keyframes = len(kfs)
    run.capacity = system.extractor.capacity
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.k2_edges = [int(((s["map_pt"] >= 0) | s["is_outlier"]).sum()) for s in snaps]

    def images(j):
        return (left[j] if stereo else left[j][..., 0]), other[j], cell.config["sensor"]

    return {"run": run, "snaps": snaps, "images": images, "memory_peak": memory_peak,
            "map": {"kf_est": kf_est, "kf_gt": kf_gt, "origin": origin, "points": points, "loops": loops}}


def judged(cell: Cell, done: dict, precision: str = "f32", keep_stages: bool = False, root: Path = ROOT):
    """-> (numbers, stages, correct, shown): every number checks.py compares,
    judged against limits.json and the mix's `min_loops`."""
    from slambench import checks

    numbers, stages = checks.measure(done["snaps"], done["images"], cell.values, precision, keep_stages=keep_stages)
    mp = done["map"]
    numbers.update(checks.map_numbers(mp["kf_est"], mp["kf_gt"], mp["origin"], mp["points"],
                                      cell.config["scene"]["half_size"], mp["loops"]))
    correct, shown = checks.judge(numbers, checks.limits(root), cell.traffic.get("min_loops"))
    return numbers, stages, correct, shown


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", root: Path = ROOT,
             out=sys.stdout, err=sys.stderr) -> int:
    """One run of a cell; prints the result line. `device="cpu"` and a
    `root` with small configurations rehearse a run without a card (the
    tests)."""
    import torch

    from slambench import spec

    cell = Cell(workload, root, device)
    missing = cell.cards_missing()
    if missing:
        print(missing, file=err)
        return 2
    done = execute(cell, seed, seconds, trace)
    run = done["run"]
    numbers, run.stages, correct, shown = judged(cell, done, keep_stages=trace, root=root)

    metrics = {}
    for m in spec.metrics_for(cell.bench, workload, trace):
        value = spec.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = cell.dev.type == "cuda"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(done["memory_peak"])}
    result = {"correct": bool(correct), "attempted": len(run.record.ok), "failed": run.record.ok.count(False),
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        ranked = sorted(run.trace.kernels().items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[n, t] for n, (t, _) in ranked],
                               "idle_gaps": run.trace.idle_gaps(10)}
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        print(f"slambench: the run loaded {loaded}; the port must run without them", file=err)
        return 3
    result["checks"] = shown
    print(f"window: {len(run.record.ok)} frames in {run.record.end[-1]:.3f} s; {run.keyframes} keyframes in the map; "
          f"{numbers['loops_closed']} loops closed; kf_drift_cm {numbers['kf_drift_cm']}, "
          f"map_gap_cm {numbers['map_gap_cm']} (read, not compared)", file=err)
    print("pose gaps of the checked frames (px, inlier points): "
          + "; ".join(f"{g:.6f} {n}" for g, n in numbers["pose_gaps"]), file=err)
    if run.tracer_stats is not None:
        spans = run.tracer_stats["spans"]
        print("tracer spans over the traced window (n, p50 ms, total s): " + "; ".join(
            f"{k} {v['n']} {v['p50_ms']:.3f} {v['total_s']:.3f}" for k, v in sorted(spans.items())), file=err)
    for name, c in shown.items():
        bound = f"<= {c['limit']}" if "limit" in c else f">= {c['least']}"
        print(f"check {name} {c['value']} {bound}", file=err)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
