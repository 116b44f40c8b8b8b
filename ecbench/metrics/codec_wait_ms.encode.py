"""codec_wait_ms.encode (ms): the writer thread blocked on the device for
each batch's parity, per job: seaweedfs_codec_wait_seconds{op=encode} over
the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "codec_wait", "encode")
