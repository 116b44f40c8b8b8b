"""codec_call_ms.encode (ms): mean span of the RS encode calls in the
window, seaweedfs_codec_op_seconds{backend=rs_cuda, op=encode} sum over
count; the span runs from issue to the return of fetch(), so it holds
the writer's data-shard writes too."""

from ecbench import measures


def read(run):
    return measures.codec_call_ms(run, "rs_cuda", "encode")
