"""Reed-Solomon, klauspost/reedsolomon's default Vandermonde code
(SeaweedFS's ec.encode)."""

from __future__ import annotations

import numpy as np

from .. import gf256


def parity_shards(config: dict, data: np.ndarray) -> np.ndarray:
    k, m = config["data_shards"], config["parity_shards"]
    return gf256.matmul_rows(gf256.generator(k, m)[k:], data)


def single_loss_read_bytes(config: dict, lost: int, shard: int) -> int:
    """k whole survivors."""
    return config["data_shards"] * shard


def degraded_io_bytes(config: dict, lost: int, length: int) -> int:
    """k input intervals of `length` bytes and one output."""
    return (config["data_shards"] + 1) * length


def control_generator(config: dict) -> np.ndarray:
    """klauspost's Cauchy option: MDS at the same overhead, other bytes."""
    return gf256.generator(config["data_shards"], config["parity_shards"],
                           "cauchy")
