"""GF(2^8) arithmetic in plain NumPy, the benchmark's frozen copy.

The field is the one klauspost/reedsolomon (and so SeaweedFS's EC) uses:
primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D), generator 2.

`matmul_rows(M, X)` is the one bulk product every reference computation
goes through: out[i] = XOR_j M[i, j] * X[j] over byte rows.  It works on
eight bytes at a time in uint64 lanes (x * 2 is a shift and a conditional
XOR with 0x1d per byte), over column blocks small enough to stay in cache.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(EXP[255 - LOG[a]])


def power(a: int, n: int) -> int:
    """a**n with 0**0 == 1 (klauspost's galExp)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


def small_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Product of two small coefficient matrices (element by element)."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            acc = 0
            for t in range(A.shape[1]):
                acc ^= mul(int(A[i, t]), int(B[t, j]))
            out[i, j] = acc
    return out


def mat_inv(A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8); raises on a singular matrix."""
    A = [[int(v) for v in row] for row in np.asarray(A, dtype=np.uint8)]
    n = len(A)
    aug = [row + [1 if i == j else 0 for j in range(n)]
           for i, row in enumerate(A)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r][col]), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        aug[col], aug[pivot] = aug[pivot], aug[col]
        s = inv(aug[col][col])
        aug[col] = [mul(v, s) for v in aug[col]]
        for r in range(n):
            f = aug[r][col]
            if r != col and f:
                aug[r] = [v ^ mul(f, w) for v, w in zip(aug[r], aug[col])]
    return np.array([row[n:] for row in aug], dtype=np.uint8)


_LOW7 = np.uint64(0x7F7F7F7F7F7F7F7F)
_ONES = np.uint64(0x0101010101010101)
_POLY = np.uint64(0x1D)
_ONE = np.uint64(1)
_SEVEN = np.uint64(7)

# uint64 words per column block: 512 KiB of each row
BLOCK_WORDS = 65536


def _block(M: np.ndarray, X64: np.ndarray, out64: np.ndarray,
           lo: int, hi: int) -> None:
    w = hi - lo
    acc = np.zeros((M.shape[0], w), dtype=np.uint64)
    v = np.empty(w, dtype=np.uint64)
    t = np.empty(w, dtype=np.uint64)
    for j in range(M.shape[1]):
        col = M[:, j]
        if not col.any():
            continue
        v[:] = X64[j, lo:hi]
        for b in range(8):
            for i in np.nonzero((col >> b) & 1)[0]:
                np.bitwise_xor(acc[i], v, out=acc[i])
            if b < 7 and (col >> (b + 1)).any():
                # v = v * 2 in every byte lane
                np.right_shift(v, _SEVEN, out=t)
                np.bitwise_and(t, _ONES, out=t)
                np.multiply(t, _POLY, out=t)
                np.bitwise_and(v, _LOW7, out=v)
                np.left_shift(v, _ONE, out=v)
                np.bitwise_xor(v, t, out=v)
    out64[:, lo:hi] = acc


def matmul_rows(M: np.ndarray, X: np.ndarray) -> np.ndarray:
    """[r, s] coefficients times [s, n] byte rows -> [r, n] byte rows."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    X = np.asarray(X, dtype=np.uint8)
    if M.ndim != 2 or X.ndim != 2 or M.shape[1] != X.shape[0]:
        raise ValueError(f"matmul_rows: {M.shape} x {X.shape}")
    n = X.shape[1]
    n8 = -(-n // 8) * 8
    if n8 != n or not X.flags.c_contiguous:
        Xp = np.zeros((X.shape[0], n8), dtype=np.uint8)
        Xp[:, :n] = X
        X = Xp
    X64 = X.view(np.uint64)
    out = np.empty((M.shape[0], n8), dtype=np.uint8)
    out64 = out.view(np.uint64)
    words = n8 // 8
    for lo in range(0, words, BLOCK_WORDS):
        _block(M, X64, out64, lo, min(lo + BLOCK_WORDS, words))
    return out[:, :n]


def scale(c: int, X: np.ndarray) -> np.ndarray:
    """c * X for a byte array of any shape."""
    X = np.asarray(X, dtype=np.uint8)
    flat = np.ascontiguousarray(X).reshape(1, -1)
    return matmul_rows(np.array([[c]], dtype=np.uint8), flat).reshape(
        X.shape)


def generator(k: int, m: int, kind: str = "vandermonde") -> np.ndarray:
    """(k+m, k) systematic generator.  "vandermonde" is klauspost's
    default New(k, m) (Vandermonde, top square inverted); "cauchy" its
    WithCauchyMatrix option."""
    if kind == "vandermonde":
        vm = np.array([[power(r, c) for c in range(k)]
                       for r in range(k + m)], dtype=np.uint8)
        return small_matmul(vm, mat_inv(vm[:k]))
    if kind == "cauchy":
        gen = np.zeros((k + m, k), dtype=np.uint8)
        gen[:k] = np.eye(k, dtype=np.uint8)
        for r in range(k, k + m):
            for c in range(k):
                gen[r, c] = inv(r ^ c)
        return gen
    raise ValueError(f"unknown generator kind {kind!r}")


def decode_matrix(gen: np.ndarray, present: list, targets: list
                  ) -> np.ndarray:
    """D with shards[targets] = D @ shards[present[:k]]."""
    k = gen.shape[1]
    rows = list(present)[:k]
    return small_matmul(gen[list(targets)], mat_inv(gen[rows]))
