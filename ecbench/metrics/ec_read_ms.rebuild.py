"""ec_read_ms.rebuild (ms): rebuild_clay's plane gather: the beta repair
layers of each helper window read into the kernel's layout, per job:
seaweedfs_ec_read_seconds{op=rebuild} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_read", "rebuild")
