"""LRC, the locally repairable code of Huang et al. (Windows Azure
Storage, USENIX ATC'12) in SeaweedFS's shard files (`ec.encode -kind lrc
-lrcLocals l`).  The configuration states k (`data_shards`), the l local
groups (`lrc_locals`) and the l + r parities (`parity_shards`).

Shards: data 0..k-1 in l groups of k/l consecutive shards; local parity
k + g the XOR of group g; global parity k + l + i - 1 (i = 1..r) with
coefficient (c+1)^i on data column c, over GF(2^8).  A single loss of a
data shard or a local parity reads the k/l other members of its group;
any other loss reads k shards."""

from __future__ import annotations

import numpy as np

from .. import gf256


def _shape(config: dict) -> tuple[int, int, int]:
    """(k, l, r)."""
    k, l = config["data_shards"], config["lrc_locals"]
    if not l or k % l or config["parity_shards"] <= l:
        raise ValueError(f"lrc needs lrc_locals dividing k and below the "
                         f"parity count: k={k} l={l} "
                         f"parity={config['parity_shards']}")
    return k, l, config["parity_shards"] - l


def generator(config: dict) -> np.ndarray:
    """(k + l + r, k): identity, the l local XOR rows, the r global rows."""
    k, l, r = _shape(config)
    gen = np.zeros((k + l + r, k), dtype=np.uint8)
    gen[:k] = np.eye(k, dtype=np.uint8)
    for g in range(l):
        gen[k + g, g * (k // l):(g + 1) * (k // l)] = 1
    for i in range(1, r + 1):
        gen[k + l + i - 1] = [gf256.power(c + 1, i) for c in range(k)]
    return gen


def parity_shards(config: dict, data: np.ndarray) -> np.ndarray:
    k = config["data_shards"]
    return gf256.matmul_rows(generator(config)[k:], data)


def _reads(config: dict, lost: int) -> int:
    """Shards a repair of `lost` alone reads: its group's other members
    for a data shard or a local parity, k for a global parity."""
    k, l, _ = _shape(config)
    return k // l if lost < k + l else k


def single_loss_read_bytes(config: dict, lost: int, shard: int) -> int:
    return _reads(config, lost) * shard


def degraded_io_bytes(config: dict, lost: int, length: int) -> int:
    """The repair's input intervals of `length` bytes and one output."""
    return (_reads(config, lost) + 1) * length


def control_generator(config: dict) -> np.ndarray:
    """Cauchy RS(k, l + r): MDS at the same overhead, other bytes and no
    local group."""
    return gf256.generator(config["data_shards"], config["parity_shards"],
                           "cauchy")
