"""needle_parse_ms.degraded (ms): the needle's header, body and CRC32-C
parse, per read: seaweedfs_needle_parse_seconds{op=read} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "needle_parse", "read")
