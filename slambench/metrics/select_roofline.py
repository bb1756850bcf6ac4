"""Kernels: csrc/select.cu (`select_fused`), the per-cell selection, share of its roofline per launch."""

from slambench import bounds
from slambench.roofline import budgets, share


def read(run):
    return share(run, "select_fused", lambda r: [bounds.select(s, budgets(r)) for s in r.stages])
