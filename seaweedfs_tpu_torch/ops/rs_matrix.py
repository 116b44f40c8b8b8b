"""Reed-Solomon generator / decode matrices over GF(2^8), parameterized (k, m).

The reference fixes RS(10, 4) (weed/storage/erasure_coding/ec_encoder.go:17-23)
and delegates matrix construction to klauspost/reedsolomon's default
`New(10, 4)` path, which builds a systematic matrix from a Vandermonde matrix
(vandermonde -> invert top square -> multiply; the Backblaze construction).
We reproduce that construction exactly so that parity shards are byte-identical
with the reference's `.ec10..ec13` outputs for the same data, and generalize it
to any (k, m) for wide stripes RS(28,4) / RS(16,8).

A second `cauchy` kind mirrors klauspost's WithCauchyMatrix option; any square
submatrix of a Cauchy matrix is invertible by construction, which makes it the
safer choice for very wide stripes.

The device codec consumes these matrices through `bit_matrix`, which expands
each GF(2^8) coefficient into its 8x8 GF(2) multiplication matrix: multiplying
by a constant c is GF(2)-linear, so the whole codec becomes a single
(8m x 8k) @ (8k x B) XOR-matmul (ops/rs_cuda.py runs it on the GPU).
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf256
from .gf256 import mat_inv, matmul

DEFAULT_DATA_SHARDS = 10  # ec_encoder.go:18
DEFAULT_PARITY_SHARDS = 4  # ec_encoder.go:19


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r, c] = r**c in GF(2^8) (klauspost galois.go galExp convention).

    rows <= 256: beyond that the evaluation points (the field elements) repeat
    and the matrix cannot be MDS.
    """
    if rows > 256:
        raise ValueError(f"at most 256 distinct evaluation points in GF(2^8), got rows={rows}")
    r = np.arange(rows, dtype=np.uint8)
    out = np.empty((rows, cols), dtype=np.uint8)
    for c in range(cols):
        out[:, c] = gf256.gf_pow(r, c)
    return out


@functools.lru_cache(maxsize=64)
def generator_matrix(k: int = DEFAULT_DATA_SHARDS, m: int = DEFAULT_PARITY_SHARDS,
                     kind: str = "vandermonde") -> np.ndarray:
    """(k+m, k) systematic generator: top k rows are the identity.

    kind="vandermonde" reproduces klauspost/reedsolomon's default buildMatrix;
    kind="cauchy" its buildMatrixCauchy.
    """
    if not (0 < k and 0 < m and k + m <= 256):
        raise ValueError(f"invalid RS geometry ({k}+{m})")
    if kind == "vandermonde":
        vm = vandermonde(k + m, k)
        top_inv = mat_inv(vm[:k])
        gen = matmul(vm, top_inv)
    elif kind == "cauchy":
        gen = np.zeros((k + m, k), dtype=np.uint8)
        gen[:k] = gf256.identity(k)
        r = np.arange(k, k + m, dtype=np.uint8)[:, None]
        c = np.arange(k, dtype=np.uint8)[None, :]
        gen[k:] = gf256.inv(r ^ c)
    else:
        raise ValueError(f"unknown matrix kind {kind!r}")
    assert np.array_equal(gen[:k], gf256.identity(k)), "generator not systematic"
    gen.setflags(write=False)
    return gen


def decode_matrix(gen: np.ndarray, present: list[int] | np.ndarray,
                  targets: list[int] | np.ndarray) -> np.ndarray:
    """Matrix D with shards[targets] = D @ shards[present[:k]].

    `present` must list >= k available shard indices (the first k are used —
    mirroring klauspost's Reconstruct, which picks the first k valid rows);
    `targets` are the shard indices to (re)produce.  Used for ec.rebuild
    (ec_encoder.go:270 enc.Reconstruct) and the degraded read path
    (weed/storage/store_ec.go:328 recoverOneRemoteEcShardInterval).
    """
    k = gen.shape[1]
    present = np.asarray(present, dtype=np.int64)
    if present.size < k:
        raise ValueError(f"need >= {k} shards to decode, have {present.size}")
    rows = present[:k]
    sub = gen[rows]  # (k, k)
    sub_inv = mat_inv(sub)
    return matmul(gen[np.asarray(targets, dtype=np.int64)], sub_inv)


def bit_matrix(M: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix (R, C) to its GF(2) action (8R, 8C), uint8 0/1.

    B[8r+i, 8c+j] = bit i of (M[r,c] * 2**j in GF(2^8)).  With data bytes
    unpacked into bit-planes (LSB-first), out_bits = B @ data_bits (mod 2)
    computes the exact GF(2^8) matmul.
    """
    M = np.asarray(M, dtype=np.uint8)
    R, C = M.shape
    basis = (np.uint8(1) << np.arange(8, dtype=np.uint8))  # 2**j
    prods = gf256.MUL_TABLE[M[:, :, None], basis[None, None, :]]  # (R, C, j)
    bits = (prods[:, :, :, None] >> np.arange(8, dtype=np.uint8)) & 1  # (R, C, j, i)
    return np.ascontiguousarray(
        bits.transpose(0, 3, 1, 2).reshape(8 * R, 8 * C).astype(np.uint8))


def parity_bit_matrix(k: int = DEFAULT_DATA_SHARDS, m: int = DEFAULT_PARITY_SHARDS,
                      kind: str = "vandermonde") -> np.ndarray:
    """(8m, 8k) bit-matrix of the parity rows — the encode kernel's weights."""
    return bit_matrix(generator_matrix(k, m, kind)[k:])
