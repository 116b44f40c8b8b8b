"""codec_submit_ms.encode (ms): the host part of the encode dispatches
(pinned staging, the copy into it, the h2d issue, the launch), on the
producer thread, per job: seaweedfs_codec_submit_seconds{op=encode} over the
window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "codec_submit", "encode")
