"""Kernels: csrc/describe.cu (`describe_fused`), orientation and rotated BRIEF, share of its roofline per launch."""

from slambench import bounds
from slambench.roofline import budgets, share


def read(run):
    return share(run, "describe_fused", lambda r: [bounds.describe(s, budgets(r)) for s in r.stages])
