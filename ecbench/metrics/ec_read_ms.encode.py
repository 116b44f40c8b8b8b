"""ec_read_ms.encode (ms): the encode jobs' gathers of .dat row blocks into
the codec's [k, width] batches, on the producer thread, per job:
seaweedfs_ec_read_seconds{op=encode} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_read", "encode")
