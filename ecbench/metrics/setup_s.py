"""setup_s (s): process start to the first timed operation: imports, CUDA
init, the seeded volumes, the set-up encode and one warm-up operation."""

from ecbench import measures


def read(run):
    return run.setup_s
