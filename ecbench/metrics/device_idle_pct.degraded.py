"""device_idle_pct.degraded (%): share of the window with no kernel or copy
running."""

from ecbench import measures


def read(run):
    return measures.idle_pct(run, "window")
