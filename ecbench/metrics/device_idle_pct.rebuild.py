"""device_idle_pct.rebuild (%): share of the jobs' service intervals with
no kernel or copy running."""

from ecbench import measures


def read(run):
    return measures.idle_pct(run, "ops")
