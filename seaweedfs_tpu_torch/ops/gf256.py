"""GF(2^8) finite-field arithmetic, numpy-vectorized.

The reference's erasure codec (klauspost/reedsolomon, a port of Backblaze's
JavaReedSolomon; pulled in at /root/reference/go.mod:70 and driven from
weed/storage/erasure_coding/ec_encoder.go:198) works in the field GF(2^8)
defined by the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D) with
generator 2.  Shard interoperability requires the *same* field, so we generate
identical exp/log tables here.

Everything is numpy and operates on uint8 arrays elementwise; this module is
the host-side "scalar" reference.  The device path (ops/rs_torch.py,
ops/rs_cuda.py) never multiplies in GF(2^8) directly — it lowers the whole
codec to GF(2) bit-plane matmuls — but its matrices are built from this field.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D  # primitive polynomial, matches Backblaze/klauspost tables
FIELD_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(256, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255] = exp[0]  # alpha^255 == 1; all indexing goes through % 255 anyway
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()

# Full 256x256 product table (64 KiB).  Lets the numpy reference codec do a
# whole GF matmul as one fancy-index + XOR-reduce, and is the source of truth
# for the bit-matrix expansion used by the device path.
_a = np.arange(256)
_log_sum = LOG_TABLE[_a][:, None] + LOG_TABLE[_a][None, :]
MUL_TABLE = EXP_TABLE[_log_sum % 255].astype(np.uint8)
MUL_TABLE[0, :] = 0
MUL_TABLE[:, 0] = 0
del _a, _log_sum


def mul(a, b):
    """Elementwise GF(2^8) product of uint8 arrays (broadcasting)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return MUL_TABLE[a, b]


def div(a, b):
    """Elementwise a / b.  Division by zero raises."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    if np.any(b == 0):
        raise ZeroDivisionError("GF(2^8) division by zero")
    out = EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255].astype(np.uint8)
    return np.where(a == 0, np.uint8(0), out)


def inv(a):
    """Multiplicative inverse.  Zero raises."""
    return div(np.uint8(1), a)


def gf_pow(a, n: int):
    """a**n in GF(2^8) — matches klauspost's galExp (galois.go): 0**0 == 1."""
    a = np.asarray(a, dtype=np.uint8)
    if n == 0:
        return np.ones_like(a)
    out = EXP_TABLE[(LOG_TABLE[a].astype(np.int64) * n) % 255].astype(np.uint8)
    return np.where(a == 0, np.uint8(0), out)


def matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product, XOR-accumulated.

    A: (r, n) uint8, B: (n, c) uint8 -> (r, c) uint8.
    This is the numpy reference for the codec: parity = matmul(gen[k:], data).
    """
    A = np.ascontiguousarray(A, dtype=np.uint8)
    B = np.ascontiguousarray(B, dtype=np.uint8)
    assert A.ndim == 2 and B.ndim == 2 and A.shape[1] == B.shape[0]
    # products: (r, n, c) then XOR-reduce the middle axis.
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for i in range(A.shape[1]):  # k is small (<=32); B's columns are the long axis
        out ^= MUL_TABLE[A[:, i][:, None], B[i][None, :]]
    return out


def mat_inv(A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8).  Raises on singular input."""
    A = np.array(A, dtype=np.uint8)
    n = A.shape[0]
    assert A.shape == (n, n)
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = col + int(np.argmax(aug[col:, col] != 0))
        if aug[pivot, col] == 0:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = div(aug[col], aug[col, col])
        mask = aug[:, col].copy()
        mask[col] = 0
        aug ^= MUL_TABLE[mask[:, None], aug[col][None, :]]
    return np.ascontiguousarray(aug[:, n:])


def identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)
