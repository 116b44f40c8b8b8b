"""ec_read_ms.degraded (ms): each interval's pread and each degraded
interval's survivor reads (with their stack, or Clay's layer transposes),
per read: seaweedfs_ec_read_seconds{op=read} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_read", "read")
