"""codec_roofline_pct.degraded (%): the degraded decodes' least time (k
inputs and one output of each interval, RS, or of its whole window,
Clay) over the kernels' time in the window."""

from ecbench import measures


def read(run):
    return measures.roofline_pct(run, "window")
