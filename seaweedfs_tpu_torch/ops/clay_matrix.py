"""Flat-matrix factory for Clay codes (the port's own copy): turns the
numpy oracle (ops/clay.py) into plain GF(2^8) matrices, so a multi-loss
decode is one product through codec.gf_apply (bit-plane matmul on the
GPU) instead of layer-by-layer host solves.

Clay is linear over GF(2^8): every parity symbol is a fixed GF-linear
combination of the k*alpha data symbols.  So each operation IS a matrix,
and the oracle only has to run once per (k, m[, loss mask]) — on an
identity batch — to produce it:

- generator_flat(k, m):        [m*alpha, k*alpha]   (encode)
- decode_flat(k, m, present):  [t*alpha, k*alpha]   (multi-loss rebuild,
                               contracted over the chosen k survivors)
- repair_flat(k, m, lost):     [alpha, (n-1)*beta]  (single-loss repair
                               from the beta plane symbols of every
                               helper — the bandwidth-optimal path)

Matrices are lru-cached; masks repeat across rebuild windows and
volumes, so the oracle cost amortizes to zero.  The symbol layout used
everywhere: node shard windows are [alpha, B'] layer-major, flattened
row-major — symbol (node i, layer z) is flat row i*alpha + z.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf256
from .clay import ClayCode


@functools.lru_cache(maxsize=8)
def code(k: int, m: int) -> ClayCode:
    return ClayCode(k, m)


@functools.lru_cache(maxsize=8)
def generator_flat(k: int, m: int) -> np.ndarray:
    """[m*alpha, k*alpha]: parity symbols as GF-linear maps of data
    symbols, derived by encoding the identity through the oracle."""
    c = code(k, m)
    ka = k * c.alpha
    eye = gf256.identity(ka)  # column j = unit impulse on data symbol j
    data = eye.reshape(k, c.alpha, ka)
    parity = c.encode(data)   # [m, alpha, ka]
    return np.ascontiguousarray(parity.reshape(m * c.alpha, ka))


@functools.lru_cache(maxsize=256)
def decode_flat(k: int, m: int, present: tuple, lost: tuple) -> np.ndarray:
    """[len(lost)*alpha, k*alpha]: lost nodes' symbols from the symbols
    of the FIRST k nodes in `present` (external ids, ascending input
    row order node-major/layer-minor)."""
    c = code(k, m)
    chosen = list(present[:k])
    ka = k * c.alpha
    eye = gf256.identity(ka)
    shards = {ext: eye[i * c.alpha:(i + 1) * c.alpha]
              for i, ext in enumerate(chosen)}
    # the oracle wants every non-erased node's cells: mark the surviving
    # nodes we are NOT reading as erased too (|lost| + unread = m at
    # most, still within the code's tolerance)
    all_lost = list(lost) + [e for e in range(k + m)
                             if e not in chosen and e not in lost]
    out = c.decode(shards, all_lost)  # {ext: [alpha, ka]}
    return np.ascontiguousarray(
        np.concatenate([out[e] for e in lost], axis=0))


@functools.lru_cache(maxsize=64)
def repair_flat(k: int, m: int, lost: int) -> tuple:
    """(helpers, plane, R): single-loss bandwidth-optimal repair.

    helpers: external ids read (all n-1 survivors); plane: the beta
    layer indices read from EACH helper; R [alpha, (n-1)*beta] maps the
    stacked plane symbols (helper-major, plane-layer-minor) to the lost
    node's full [alpha] symbols.  Total reads = (n-1)*beta symbols vs
    RS's k*alpha — the alpha/beta = q advantage on every helper."""
    c = code(k, m)
    plan = c.repair_plan(lost)             # {helper: plane layers}
    helpers = sorted(plan)
    plane = plan[helpers[0]]
    rows = len(helpers) * len(plane)
    eye = gf256.identity(rows)
    sym = {h: {z: eye[hi * len(plane) + zi]
               for zi, z in enumerate(plane)}
           for hi, h in enumerate(helpers)}
    R = c.repair(lost, sym)                # [alpha, rows]
    return tuple(helpers), tuple(plane), np.ascontiguousarray(R)
