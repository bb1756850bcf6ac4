"""Kernels: csrc/frontend.cu (`frontend_kernel`, K1), blur + FAST-9 + NMS over the pyramid, share of its roofline per launch."""

from slambench import bounds
from slambench.roofline import share


def read(run):
    th = min(run.settings["ORBextractor.iniThFAST"], run.settings["ORBextractor.minThFAST"])
    return share(run, "frontend_kernel", lambda r: [bounds.k1(s, th) for s in r.stages])
