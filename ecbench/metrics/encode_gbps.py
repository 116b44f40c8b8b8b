"""encode_gbps (GB/s): bytes of .dat encoded over the summed time of every
ec.encode job, each from its due time to its return."""

from ecbench import measures


def read(run):
    return measures.job_rate_gbps(run)
