"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu's erasure
coding for an NVIDIA H100.

It imports torch and never jax, and nothing of `seaweedfs_tpu`: the modules
it needs are its own copies.  The GF(2^8) codec runs on a hand-written
CUDA kernel (`csrc/gf2_matmul.cu`, wrapped by `ops/rs_cuda.py`) built on
first use; the entry points run on the GPU unless the caller passes
`device="cpu"`, where the kernel's plain torch version runs instead.

- `ops.codec.RSCodec`: encode / reconstruct / verify (numpy in and out);
  `ops.codec.codec_metrics()`: the codec calls' Prometheus families
- `storage.ec`: volume -> shard files, rebuild, degraded reads, decode, for
  RS, Clay and LRC geometries
- `serving`: the JAX package's volume server, store, shell and master run
  their EC paths on this package after `serving.install(device)`, with no
  jax loaded; nothing is installed on import
"""
