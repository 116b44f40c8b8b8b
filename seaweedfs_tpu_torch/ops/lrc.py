"""LRC — Locally Repairable Codes (Azure-LRC style), the port's copy of
the JAX package's numpy oracle and repair planner.

LRC(k, l, r): k data shards in l local groups (k/l each); each group adds
one LOCAL parity (the GF sum of its group); r GLOBAL parities come from
Vandermonde rows over all k.  Shard order: [data 0..k-1 | local parities
k..k+l-1 | global parities k+l..k+l+r-1].

A single lost shard, the common failure, rebuilds from its k/l group peers
instead of k shards (LRC(10,2,2): 5 reads instead of 10).  Multi-failures
fall back to a global solve over any invertible k-subset.

The encode is one GF(2^8) matmul, which storage/ec/codes.py runs through
`ops.codec.gf_apply` on the device; the numpy code here is the correctness
reference and the matrix factory.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from . import gf256


@dataclass(frozen=True)
class LrcGeometry:
    k: int = 12   # data shards
    l: int = 2    # local groups (k % l == 0)
    r: int = 2    # global parities

    @property
    def n(self) -> int:
        return self.k + self.l + self.r

    @property
    def group_size(self) -> int:
        return self.k // self.l

    def group_of(self, data_shard: int) -> int:
        return data_shard // self.group_size

    def group_members(self, g: int) -> list[int]:
        s = self.group_size
        return list(range(g * s, (g + 1) * s))

    def local_parity_index(self, g: int) -> int:
        return self.k + g


@functools.lru_cache(maxsize=32)
def generator_matrix(geo: LrcGeometry) -> np.ndarray:
    """(n, k) over GF(2^8): identity; l local XOR rows; r Vandermonde
    global rows.  The global rows are taken from evaluation points beyond
    the data points so they are independent of the locals for all
    practically recoverable patterns (validated in tests by exhaustive
    small-geometry failure sweeps)."""
    if geo.k % geo.l:
        raise ValueError(f"k={geo.k} not divisible by l={geo.l}")
    G = np.zeros((geo.n, geo.k), dtype=np.uint8)
    G[:geo.k] = gf256.identity(geo.k)
    for g in range(geo.l):
        for c in geo.group_members(g):
            G[geo.local_parity_index(g), c] = 1  # XOR = GF(2^8) add
    # global parities: Vandermonde-style coefficient rows over distinct
    # nonzero evaluation points: row i has coefficient (c+1)^(i+1) for
    # data column c
    pts = np.arange(1, geo.k + 1, dtype=np.uint8)
    for i in range(geo.r):
        G[geo.k + geo.l + i] = gf256.gf_pow(pts, i + 1)
    return G


def encode(geo: LrcGeometry, data: np.ndarray) -> np.ndarray:
    """data [k, B] -> parities [l + r, B] (locals first)."""
    G = generator_matrix(geo)
    return gf256.matmul(G[geo.k:], data)


@dataclass
class RepairPlan:
    kind: str                  # "local" | "global"
    read_shards: list[int]    # shard ids to read
    matrix: np.ndarray        # [n_missing, len(read_shards)] decode coeffs
    missing: list[int]


def plan_repair(geo: LrcGeometry, missing: list[int],
                available: "list[int] | None" = None) -> RepairPlan:
    """The reconstruct planner.

    Single failure inside one local group (data or the group's local
    parity): repair from the group's surviving members — k/l reads.
    Anything else: global solve from any k+l... rows whose submatrix of
    the generator (restricted to data columns) is invertible."""
    G = generator_matrix(geo)
    missing = sorted(set(missing))
    if available is None:
        available = [s for s in range(geo.n) if s not in missing]
    else:
        available = [s for s in available if s not in missing]

    if len(missing) == 1:
        s = missing[0]
        g = None
        if s < geo.k:
            g = geo.group_of(s)
        elif s < geo.k + geo.l:
            g = s - geo.k
        if g is not None:
            group = geo.group_members(g) + [geo.local_parity_index(g)]
            reads = [x for x in group if x != s]
            if all(x in available for x in reads):
                # XOR of the group's survivors reproduces the missing one
                m = np.ones((1, len(reads)), dtype=np.uint8)
                return RepairPlan("local", reads, m, missing)

    # global: greedily pick k linearly-independent available rows via GF
    # Gaussian elimination — finds a solvable subset whenever ONE exists
    # (rank(available rows) == k), unlike any fixed-window scan
    rows = _independent_rows(G, available, geo.k)
    if rows is None:
        raise ValueError(f"unrecoverable: missing={missing}, "
                         f"available={available}")
    inv = gf256.mat_inv(G[rows])
    # data = inv @ read_shards; missing shard s = G[s] @ data
    want = gf256.matmul(G[missing], inv)
    return RepairPlan("global", rows, want, missing)


def _independent_rows(G: np.ndarray, candidates: list[int],
                      k: int) -> "list[int] | None":
    """First k rows of G[candidates] that are linearly independent over
    GF(2^8), by incremental elimination; None if rank < k."""
    basis: list[np.ndarray] = []
    pivots: list[int] = []
    chosen: list[int] = []
    for r in candidates:
        v = G[r].copy()
        for b, p in zip(basis, pivots):
            if v[p]:
                v = v ^ gf256.mul(gf256.div(v[p], b[p]), b)
        nz = np.nonzero(v)[0]
        if len(nz) == 0:
            continue  # dependent on chosen rows
        basis.append(v)
        pivots.append(int(nz[0]))
        chosen.append(r)
        if len(chosen) == k:
            return chosen
    return None


def repair(geo: LrcGeometry, plan: RepairPlan,
           shard_data: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """Execute a plan: shard_data maps shard id -> [B] bytes for every
    shard in plan.read_shards.  Returns {missing shard id: bytes}."""
    stack = np.stack([shard_data[s] for s in plan.read_shards])
    out = gf256.matmul(plan.matrix, stack)
    return {s: out[i] for i, s in enumerate(plan.missing)}


def encode_shards(geo: LrcGeometry, data: np.ndarray) -> np.ndarray:
    """[k, B] -> all [n, B] shards (data + locals + globals)."""
    return np.concatenate([data, encode(geo, data)], axis=0)
