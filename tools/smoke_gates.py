"""chip_smoke.py with every gate reported, not only the first that fails.

    python3 tools/smoke_gates.py

Runs chip_smoke.main() on the card with its `_check` and `_fail` replaced
by a recorder: each failed gate is printed as `GATE FAILED: ...` and the
phases go on, so one run shows every phase's results and every gate that
failed, then the kernels line. Exits 1 if any gate failed (chip_smoke.py
itself stops at the first), and then prints no `{"ok": true, ...}` line.
Use it to see what a failing phase leaves behind; the chip check is
chip_smoke.py's own exit code.
"""

import os
import sys

# chip_smoke by its module name: phase 15's spawned workers unpickle its
# functions by name (and re-import this script, hence the __main__ guard)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"GATE FAILED: {msg}", flush=True)

    ok_line = smoke._ok_line
    smoke._check = check
    smoke._fail = lambda msg: check(False, msg)
    smoke._ok_line = lambda torch: f"gates failed: {len(failed)}" if failed else ok_line(torch)
    rc = smoke.main()
    print(f"gates failed: {len(failed)}")
    for msg in failed:
        print(f" - {msg}")
    return rc if rc else int(bool(failed))


if __name__ == "__main__":
    sys.exit(main())
