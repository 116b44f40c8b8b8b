"""codec_submit_ms.degraded (ms): the host part of the degraded intervals'
decode dispatches (RS: the stack, staging and launch; Clay: gf_apply's
upload and product issue), per read:
seaweedfs_codec_submit_seconds{op=reconstruct} over the window."""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "codec_submit", "reconstruct")
