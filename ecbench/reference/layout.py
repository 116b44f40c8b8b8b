"""The small-block EC layout and the shards it implies, in plain NumPy: the
benchmark's frozen copy of weed/storage/erasure_coding (ec_encoder.go
encodeDataOneBatch, ec_locate.go) for volumes smaller than one large row.

The .dat is cut into rows of k small blocks, the last row zero-padded;
block s of every row goes to shard s, so data shard s is the column of
blocks s.  The parity shards are each code kind's (reference/codes/).
"""

from __future__ import annotations

import numpy as np


def shard_size(dat_size: int, k: int, small: int, large: int) -> int:
    if dat_size >= k * large:
        raise ValueError("the reference covers only volumes below one "
                         "large row")
    return -(-dat_size // (k * small)) * small


def data_shards(dat: np.ndarray, k: int, small: int, large: int
                ) -> np.ndarray:
    """[k, shard_size] data shards of the .dat bytes."""
    size = shard_size(len(dat), k, small, large)
    rows = size // small
    padded = np.zeros(rows * k * small, dtype=np.uint8)
    padded[:len(dat)] = dat
    return np.ascontiguousarray(
        padded.reshape(rows, k, small).transpose(1, 0, 2)).reshape(k, -1)


def locate(offset: int, size: int, k: int, small: int
           ) -> list[tuple[int, int, int]]:
    """[(shard, offset in the shard, length)] of a .dat byte range."""
    out = []
    while size > 0:
        block, inner = divmod(offset, small)
        n = min(size, small - inner)
        row, shard = divmod(block, k)
        out.append((shard, row * small + inner, n))
        offset += n
        size -= n
    return out
