"""How often torch.profiler loses K1 launches, with and without the idle
margin that chip_smoke's `_device_ms` keeps inside each profiling window,
on one CUDA GPU.

    python3 tools/profiler_margin.py [SESSIONS]    # from the repository root

First chip_smoke's phases 2-4 (build, K1, K2), so that the sessions follow
the same profiling history as chip_smoke's later ones. Then, for each of the
three level-0 sizes of phase 3 (640x480, 752x480, 1241x376) and each margin
(0 and `chip_smoke.PROFILE_MARGIN_S`), SESSIONS profiling sessions (default
100) of 50 pyramid launches each, the sizes and margins interleaved. Prints
one line per size and margin: the sessions that saw fewer than 50 frontend
kernels and how many each saw, and for each such session the device start
of its first kept kernel minus the host start of its first launch call
(negative: the kernel is stamped before the call that launched it), beside
the median of that difference over the full sessions.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor  # noqa: E402
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera  # noqa: E402

SIZES = ((640, 480), *cs.K1_DATASET_SIZES)


def session(fn, margin: float, reps: int = 50):
    """(kernels kept, first kept kernel's start - first launch call's start, us)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    events = prof.events()
    kernels = sorted(e.time_range.start for e in events if "frontend_kernel" in e.name)
    calls = sorted(e.time_range.start for e in events if e.name == "cudaLaunchKernel")
    lead = kernels[0] - calls[0] if kernels and calls else None
    return len(kernels), lead


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    n_sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()} | torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    cs.phase_build()
    cs.phase_k1(torch, dev)
    cs.phase_k2(torch, dev)
    ext = ORBExtractor(n_features=1000)
    fns = {}
    for w, h in SIZES:
        seq = BoxSequence(camera=default_camera(w, h), seed=5, n_frames=100, turns=0.35)
        buf, table = ext._pyramid(torch.from_numpy(seq.render(0)).to(dev))
        fns[f"{w}x{h}"] = lambda b=buf, t=table: fk.fused_frontend_pyramid(b, t, ext.ini_th, ext.min_th)
    margins = (0.0, cs.PROFILE_MARGIN_S)
    rows = {(m, name): {"short": [], "full_leads": []} for m in margins for name in fns}
    for _ in range(n_sessions):
        for m in margins:
            for name, fn in fns.items():
                kept, lead = session(fn, m)
                row = rows[m, name]
                if kept == 50:
                    row["full_leads"].append(lead)
                else:
                    row["short"].append((kept, lead))
    for (m, name), row in rows.items():
        med = statistics.median(row["full_leads"]) if row["full_leads"] else float("nan")
        short = ", ".join(f"{kept} kept (lead {'none' if lead is None else f'{lead:.1f} us'})"
                          for kept, lead in row["short"]) or "none"
        print(f"margin {1e3 * m:.0f} ms, {name}: {len(row['short'])} of {n_sessions} sessions short: {short} | "
              f"median lead of the full sessions {med:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
