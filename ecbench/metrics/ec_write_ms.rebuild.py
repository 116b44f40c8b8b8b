"""ec_write_ms.rebuild (ms): the restored shard's writes, one per window,
per job: seaweedfs_ec_write_seconds{op=rebuild} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_write", "rebuild")
