"""codec_submit_ms.rebuild (ms): the host part of the repair dispatches
(pinned staging, the copy into it, the h2d issue, the launch), per job:
seaweedfs_codec_submit_seconds{op=reconstruct} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "codec_submit", "reconstruct")
