"""degraded_read_p50_ms (ms): median latency of read_needle over every read
of the window."""

from ecbench import measures


def read(run):
    return measures.latency_ms(run, 50)
