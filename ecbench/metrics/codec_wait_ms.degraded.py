"""codec_wait_ms.degraded (ms): the reads blocked on the device for the
decoded bytes, per read: seaweedfs_codec_wait_seconds{op=reconstruct} over
the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "codec_wait", "reconstruct")
