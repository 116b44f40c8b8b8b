"""codec_call_ms.reconstruct (ms): mean span of the RS reconstruct calls in
the window (one synchronous call per degraded interval),
seaweedfs_codec_op_seconds{backend=rs_cuda, op=reconstruct}."""

from ecbench import measures


def read(run):
    return measures.codec_call_ms(run, "rs_cuda", "reconstruct")
