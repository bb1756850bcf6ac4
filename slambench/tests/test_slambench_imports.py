"""A run of the harness loads neither JAX nor the JAX package (names
compared whole: the port's name begins with the JAX package's) and reads
nothing of the old benchmarks (benchmarks/, bench.py)."""

import json
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

SCRIPT = r'''
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and isinstance(args[0], str) else None)
sys.path.insert(0, sys.argv[1])
import io, torch
from pathlib import Path
torch.set_num_threads(2)
from slambench import run
out = io.StringIO()
rc = run.run_cell("tum3_rgbd.revisit", 2**31 + 3, 1.5, False, device="cpu", root=Path(sys.argv[2]), out=out)
json.dump({"rc": rc, "modules": sorted(sys.modules), "opened": opened, "result": out.getvalue()}, open(sys.argv[3], "w"))
'''


def test_a_run_loads_no_jax_and_reads_no_old_benchmark(small_root, tmp_path):
    report = tmp_path / "report.json"
    subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT), str(small_root), str(report)], check=True,
                   timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    r = json.loads(report.read_text())
    assert r["rc"] == 0 and json.loads(r["result"].splitlines()[-1])["metrics"]
    tops = {m.split(".")[0] for m in r["modules"]}
    assert "orbslam2commentedbyxcm_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "orbslam2commentedbyxcm_tpu"}
    old = (ROOT / "benchmarks").resolve(), (ROOT / "bench.py").resolve()
    for p in r["opened"]:
        rp = Path(p).resolve()
        assert rp != old[1] and old[0] not in rp.parents, p
