"""codec_roofline_pct.rebuild (%): the Clay repair's least time (13
helpers' beta planes in, the lost shard out, once through HBM) over the
kernels' time inside the jobs."""

from ecbench import measures


def read(run):
    return measures.roofline_pct(run, "ops")
