"""Device and call times of the port's K1 and K2 CUDA kernels through their
public wrappers, and of a whole extraction, at the main path's shapes, on
one CUDA GPU: for this checkout's port, or for the port of another checkout
of the repository.

    python3 tools/time_wrappers.py [TREE]    # from the repository root

TREE is a checkout of the repository, for example an earlier commit
unpacked with `git archive` into a gitignored directory; its port is
imported and builds its kernels from its own sources. To compare two
designs on one card, run both in one call, in the order earlier, current,
current, earlier.

- K1: the 8 level images of one 640x480 extraction (BoxSequence frame 0):
  one `fused_frontend_pyramid` launch where the port has it, else one
  `fused_frontend` call per level;
- K2: one `pose_optimization_fused` solve at N = 32, 1000 and 2000 edges
  (stereo 0.5);
- the whole extraction: `ORBExtractor(1000, normalize_exposure=True)` on
  the same frame, already on the card (the tracker's extractor), with the
  number of CUDA kernels it launches.

Device time is the kernels' own time under torch.profiler per extraction or
solve; call time is the CUDA-event round trip of the wrappers.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TREE = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
sys.path.insert(0, str(TREE))
# this checkout's timing helpers, whichever port is timed
_spec = importlib.util.spec_from_file_location("smoke_helpers", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops import poseopt_kernel as pk  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor, _resize_weights  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera  # noqa: E402

DEV = torch.device("cuda", 0)
CAM = (cs.FX, cs.FY, cs.CX, cs.CY, cs.BF)


def level_images(ext, img):
    """The extractor's level images as separate tensors (level 0 the image)."""
    h, w = img.shape
    out = []
    for s in ext.scales:
        hl, wl = max(16, round(h / s)), max(16, round(w / s))
        wh, ww = (torch.from_numpy(_resize_weights(n, m)).to(DEV) for n, m in ((h, hl), (w, wl)))
        out.append(img if (hl, wl) == (h, w) else (wh @ img @ ww.T).contiguous())
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()} | torch {torch.__version__} cuda {torch.version.cuda} | port of {TREE}")
    ext = ORBExtractor(n_features=1000)
    seq = BoxSequence(camera=default_camera(640, 480), seed=5, n_frames=100, turns=0.35)
    img = torch.from_numpy(seq.render(0)).to(DEV)
    if hasattr(fk, "fused_frontend_pyramid"):
        buf, table = ext._pyramid(img)

        def k1():
            fk.fused_frontend_pyramid(buf, table, ext.ini_th, ext.min_th)

        how = "one pyramid launch"
    else:
        levels = level_images(ext, img)

        def k1():
            for lv in levels:
                fk.fused_frontend(lv, ext.ini_th, ext.min_th)

        how = f"{len(levels)} single-level launches"
    dev_ms, n = cs._device_ms(k1, 50, "frontend_kernel")
    print(f"K1 one 640x480 extraction, {how} ({n // 50} kernels): device {dev_ms:.4f} ms, "
          f"call {cs._cuda_ms(k1, 200):.4f} ms")
    for n in (32, 1000, 2000):
        t0, pts, obs, mask, _ = cs.make_pose_problem(np.random.default_rng(0), n, 0.5)
        args = [torch.from_numpy(a).to(DEV) for a in (t0, pts, obs, mask, np.ones(n, np.float32))]

        def k2():
            pk.pose_optimization_fused(*args, *CAM)

        dev_ms, _ = cs._device_ms(k2, 50, "pose_opt_kernel")
        print(f"K2 one solve, N={n}, stereo 0.5: device {dev_ms:.4f} ms, call {cs._cuda_ms(k2, 200):.4f} ms")
    tracker = ORBExtractor(n_features=1000, normalize_exposure=True)

    def extract():
        tracker(img)

    dev_ms, n = cs._device_ms(extract, 20, "")
    print(f"extraction, 640x480 frame, 1000 features, gain on: {n / 20:.1f} kernels per extraction, device "
          f"{dev_ms:.4f} ms, call {cs._cuda_ms(extract, 50):.4f} ms")


if __name__ == "__main__":
    main()
