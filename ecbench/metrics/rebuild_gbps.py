"""rebuild_gbps (GB/s): bytes of lost shards restored over the summed time
of every ec.rebuild job, each from its due time to its return."""

from ecbench import measures


def read(run):
    return measures.job_rate_gbps(run)
