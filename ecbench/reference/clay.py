"""Clay(k, m) encode in plain NumPy, the benchmark's frozen copy.

The code of Vajha et al., "Clay Codes: Moulding MDS Codes to Yield an MSR
Code" (FAST'18), as SeaweedFS's `ec.encode -kind clay` stores it, with
repair degree d = n - 1 (every survivor helps a repair): q = d - k + 1 = m,
t = ceil((k+m)/q), n0 = q*t nodes on a q x t grid (internal node i sits at
x = i % q, y = i // q), alpha = q^t layers per node.  Internal nodes are
the k data nodes, n0-m-k virtual all-zero nodes, then the m parity nodes.

Each small block of a shard (one "window") holds its node's alpha layers
of w_a = small / alpha bytes, layer-major.  Per window:

1. uncouple the k0 = n0 - m non-parity nodes: U[v, z] = C[v, z] ^
   g * C[v*, z*] where z's digit y is w != x, v* = (w, y) and z* is z with
   digit y set to x; U = C on the diagonal (w == x);
2. every layer of U is a codeword of the systematic (n0, k0) Vandermonde
   MDS code, so the parity rows' U is R @ U[:k0] with R = gen[k0:];
3. couple the parity row: C[p, z] = (U[p, z] ^ g * U[p*, z*]) / (1 + g^2).

g = 2.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf256

GAMMA = 2


class Clay:
    def __init__(self, k: int, m: int, d: int):
        if d != k + m - 1:
            raise ValueError(f"the reference builds Clay codes with d = "
                             f"n - 1 = {k + m - 1} only, not d = {d}")
        self.k, self.m, self.d = k, m, d
        self.q = d - k + 1
        self.t = -(-(k + m) // self.q)
        self.n0 = self.q * self.t
        self.k0 = self.n0 - m
        self.alpha = self.q ** self.t
        self.beta = self.alpha // self.q
        self.R = gf256.generator(self.k0, m)[self.k0:]
        self.det_inv = gf256.inv(1 ^ gf256.mul(GAMMA, GAMMA))
        self.unc_src, self.unc_mask = self._pairs(range(self.k0), 0)
        self.cpl_src, self.cpl_mask = self._pairs(
            range(self.k0, self.n0), self.k0)

    def _digit(self, z: int, y: int) -> int:
        return (z // self.q ** y) % self.q

    def _with_digit(self, z: int, y: int, x: int) -> int:
        return z + (x - self._digit(z, y)) * self.q ** y

    def _pairs(self, nodes, base: int) -> tuple[np.ndarray, np.ndarray]:
        """For each (node, layer) of `nodes`, the flat row (node - base) *
        alpha + layer of its companion cell, and whether it has one."""
        nodes = list(nodes)
        src = np.empty((len(nodes), self.alpha), dtype=np.int64)
        mask = np.zeros((len(nodes), self.alpha), dtype=bool)
        for r, node in enumerate(nodes):
            x, y = node % self.q, node // self.q
            for z in range(self.alpha):
                w = self._digit(z, y)
                if w == x:
                    src[r, z] = r * self.alpha + z
                else:
                    src[r, z] = ((y * self.q + w - base) * self.alpha
                                 + self._with_digit(z, y, x))
                    mask[r, z] = True
        return src.reshape(-1), mask.reshape(-1)

    def encode_window(self, data: np.ndarray) -> np.ndarray:
        """data [k, alpha, w] (one window of each data shard) -> parity
        [m, alpha, w]."""
        k, alpha, w = data.shape
        C = np.zeros((self.k0 * alpha, w), dtype=np.uint8)
        C[:k * alpha] = data.reshape(k * alpha, w)
        U = C ^ np.where(self.unc_mask[:, None],
                         gf256.scale(GAMMA, C[self.unc_src]), 0)
        P = gf256.matmul_rows(self.R, U.reshape(self.k0, alpha * w))
        P = P.reshape(self.m * alpha, w)
        coupled = gf256.scale(self.det_inv,
                              P ^ gf256.scale(GAMMA, P[self.cpl_src]))
        return np.where(self.cpl_mask[:, None], coupled, P).reshape(
            self.m, alpha, w)


@functools.lru_cache(maxsize=4)
def code(k: int, m: int, d: int) -> Clay:
    return Clay(k, m, d)
