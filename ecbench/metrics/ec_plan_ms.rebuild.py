"""ec_plan_ms.rebuild (ms): the LRC rebuild's repair planning (the read
set and decode matrix, and the opening of the shards it reads), per job:
seaweedfs_ec_plan_seconds{op=rebuild} over the window.  None where the
program has no such family."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_plan", "rebuild")
