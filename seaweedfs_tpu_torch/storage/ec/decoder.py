"""EC decode: shard files back into a normal volume (.dat/.idx).

Capability-equivalent to weed/storage/erasure_coding/ec_decoder.go:
- write_dat_file            (WriteDatFile :154) — stitch .ec00-.ec09 -> .dat
- write_idx_file_from_ec_index (WriteIdxFileFromEcIndex :18) — .ecx+.ecj -> .idx
- find_dat_file_size        (FindDatFileSize :47) — max live-entry stop offset
"""

from __future__ import annotations

import os

import numpy as np

from ..idx import idx_entry_bytes, parse_index_bytes
from ..super_block import SuperBlock
from ..types import (NEEDLE_ID_SIZE, TOMBSTONE_FILE_SIZE, get_actual_size)
from .layout import DEFAULT_GEOMETRY, EcGeometry, to_ext


def read_ec_volume_version(base_path: str) -> int:
    """Volume version from the superblock at the head of .ec00
    (ec_decoder.go readEcVolumeVersion — shard 0 starts with the original
    .dat's first bytes, i.e. the superblock)."""
    with open(base_path + to_ext(0), "rb") as f:
        return SuperBlock.from_bytes(f.read(512)).version


def iterate_ecj_keys(base_path: str):
    """Yield deleted needle ids from the .ecj journal (8-byte big-endian
    each, ec_decoder.go iterateEcjFile)."""
    path = base_path + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        raw = f.read()
    n = len(raw) // NEEDLE_ID_SIZE
    if n:
        keys = np.frombuffer(raw[:n * NEEDLE_ID_SIZE],
                             dtype=">u8")
        for k in keys:
            yield int(k)


def find_dat_file_size(base_path: str, index_base_path: str | None = None
                       ) -> int:
    """Reconstruct the original .dat size as max(offset + actual_size) over
    live .ecx entries (ec_decoder.go:47-70)."""
    index_base_path = index_base_path or base_path
    version = read_ec_volume_version(base_path)
    with open(index_base_path + ".ecx", "rb") as f:
        arr = parse_index_bytes(f.read())
    live = arr[arr["size"] != TOMBSTONE_FILE_SIZE]
    if not len(live):
        return 0
    stops = live["offset"] + np.array(
        [get_actual_size(int(s), version) for s in live["size"]])
    return int(stops.max())


def write_dat_file(base_path: str, dat_size: int,
                   geo: EcGeometry = DEFAULT_GEOMETRY) -> None:
    """Stitch the k data shards back into <base>.dat (WriteDatFile
    ec_decoder.go:154-196): large rows while a full large row remains
    (`>=`, :175), then small rows."""
    shards = [np.memmap(base_path + to_ext(s), dtype=np.uint8, mode="r")
              for s in range(geo.data_shards)]
    with open(base_path + ".dat", "wb") as dat:
        remaining = dat_size
        pos = [0] * geo.data_shards  # per-shard read offset
        while remaining >= geo.large_row_size():
            for s in range(geo.data_shards):
                dat.write(shards[s][pos[s]:pos[s] + geo.large_block_size]
                          .tobytes())
                pos[s] += geo.large_block_size
                remaining -= geo.large_block_size
        while remaining > 0:
            for s in range(geo.data_shards):
                take = min(remaining, geo.small_block_size)
                if take <= 0:
                    break
                dat.write(shards[s][pos[s]:pos[s] + take].tobytes())
                pos[s] += take
                remaining -= take


def write_idx_file_from_ec_index(base_path: str,
                                 index_base_path: str | None = None) -> None:
    """.ecx copied verbatim + one tombstone entry per .ecj key
    (WriteIdxFileFromEcIndex ec_decoder.go:18-44)."""
    index_base_path = index_base_path or base_path
    with open(index_base_path + ".ecx", "rb") as f:
        ecx = f.read()
    with open(base_path + ".idx", "wb") as idx:
        idx.write(ecx)
        for key in iterate_ecj_keys(index_base_path):
            idx.write(idx_entry_bytes(key, 0, TOMBSTONE_FILE_SIZE))
