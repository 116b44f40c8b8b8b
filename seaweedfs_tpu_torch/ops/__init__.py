"""Codec math: GF(2^8) tables, RS matrices, the bit-plane matmul (plain
torch and the CUDA kernel) and the RSCodec API."""
