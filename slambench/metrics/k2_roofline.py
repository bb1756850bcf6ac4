"""Kernels: csrc/poseopt.cu (`pose_opt_kernel`, K2), the 4 x 10 LM pose solve, share of its roofline per launch; the bound counted from the checked frames' problems (their active edges), never from the kernel's own count of its work."""

from slambench import bounds
from slambench.roofline import share


def read(run):
    return share(run, "pose_opt_kernel", lambda r: [bounds.k2(n, r.capacity) for n in r.k2_edges])
