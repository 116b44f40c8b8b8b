"""codec_roofline_pct.encode (%): the encode's least time (k data and m
parity shards through HBM once) over the kernels' time inside the jobs."""

from ecbench import measures


def read(run):
    return measures.roofline_pct(run, "ops")
