"""The kernel build (kernels.compile_library) on the CPU, with a stand-in for
nvcc: each source gets its own compiler process with the given defines,
the objects are linked into the library, nothing is left behind, and a
failed compile raises instead of falling back."""

import os
import stat

import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch import kernels

torch.set_num_threads(1)

# echoes its arguments and creates the file named by -o
FAKE_NVCC = """#!/bin/sh
echo "nvcc $@"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
"""


def _fake_nvcc(monkeypatch, tmp_path, script):
    exe = tmp_path / "bin" / "nvcc"
    exe.parent.mkdir()
    exe.write_text(script)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: str(exe))


def test_compile_library_builds_each_source_then_links(monkeypatch, tmp_path):
    _fake_nvcc(monkeypatch, tmp_path, FAKE_NVCC)
    sources = [kernels.CSRC / "frontend.cu", kernels.CSRC / "poseopt.cu"]
    lib = tmp_path / "out" / "libk.so"
    log = kernels.compile_library(lib, sources, ["-DK2_CLUSTER=1"])
    lines = log.splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    links = [ln for ln in lines if "-shared" in ln]
    assert len(compiles) == 2 and len(links) == 1
    for src, line in zip(sources, compiles):
        assert line.endswith(str(src)) and "-DK2_CLUSTER=1" in line and "sm_90a" in line
    assert "frontend.o" in links[0] and "poseopt.o" in links[0]
    assert os.listdir(lib.parent) == ["libk.so"]  # the objects' directory is gone


def test_compile_library_raises_on_a_failed_compile(monkeypatch, tmp_path):
    _fake_nvcc(monkeypatch, tmp_path, "#!/bin/sh\necho 'error: boom'\nexit 3\n")
    lib = tmp_path / "out" / "libk.so"
    with pytest.raises(RuntimeError, match="boom"):
        kernels.compile_library(lib, [kernels.CSRC / "frontend.cu"])
    assert os.listdir(lib.parent) == []
