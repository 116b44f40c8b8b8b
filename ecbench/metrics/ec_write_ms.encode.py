"""ec_write_ms.encode (ms): the writer thread's shard-file writes, data and
parity, less its waits for the parity, per job:
seaweedfs_ec_write_seconds{op=encode} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_write", "encode")
