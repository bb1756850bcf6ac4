"""Kernels: csrc/pyramid.cu (`pyramid_fused`), the exposure gain and the 8 levels, share of its roofline per launch."""

from slambench import bounds
from slambench.roofline import extraction_gain, share


def read(run):
    return share(run, "pyramid_fused", lambda r: [bounds.pyramid(s, extraction_gain(r)) for s in r.stages])
