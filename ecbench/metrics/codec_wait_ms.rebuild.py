"""codec_wait_ms.rebuild (ms): the rebuild blocked on the device for each
window's repaired shard, per job:
seaweedfs_codec_wait_seconds{op=reconstruct} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "codec_wait", "reconstruct")
