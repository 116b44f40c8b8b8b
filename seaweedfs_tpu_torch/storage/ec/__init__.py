"""Erasure coding subsystem — RS(k,m), Clay and LRC striping of sealed
volumes onto shard files, with GPU-batched encode/rebuild and degraded
reads.

File family per volume (reference weed/storage/erasure_coding/):
  .ec00-.ec13  shard files (data 0..k-1, parity k..n-1)
  .ecx         sorted copy of the needle index
  .ecj         deletion journal (8-byte needle ids)
  .vif         volume info (version) — JSON, like the reference's jsonpb
"""

from __future__ import annotations

import json
import os

from .decoder import (find_dat_file_size, read_ec_volume_version,
                      write_dat_file, write_idx_file_from_ec_index)
from .ec_volume import (EcNotFoundError, EcShardUnavailableError, EcVolume,
                        EcVolumeShard, rebuild_ecx_file)
from .codes import ClayWindowCodec, LrcWindowCodec
from .encoder import (Codec, encode_ec_files_batch, rebuild_ec_files,
                      rebuild_ec_files_batch, write_ec_files,
                      write_sorted_file_from_idx)
from .layout import (DATA_SHARDS_COUNT, DEFAULT_GEOMETRY, LARGE_BLOCK_SIZE,
                     PARITY_SHARDS_COUNT, SMALL_BLOCK_SIZE,
                     TOTAL_SHARDS_COUNT, EcGeometry, Interval, locate_data,
                     to_ext)
from .shard_bits import ShardBits


def save_volume_info(base_path: str, version: int, **extra) -> None:
    """.vif sidecar (reference pb.SaveVolumeInfo writes jsonpb of
    VolumeInfo, weed/pb/volume_info.go)."""
    info = {"version": version, **extra}
    with open(base_path + ".vif", "w") as f:
        json.dump(info, f)


def load_volume_info(base_path: str) -> dict:
    path = base_path + ".vif"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def geometry_from_vif(base_path: str,
                      default: EcGeometry = DEFAULT_GEOMETRY) -> EcGeometry:
    """The stripe geometry is part of the volume's identity — wide stripes
    RS(28,4)/RS(16,8) coexist with RS(10,4) volumes, so every consumer
    (mount, rebuild, decode, reads) loads (k, m) from the .vif sidecar."""
    info = load_volume_info(base_path)
    if "data_shards" in info:
        return EcGeometry(
            data_shards=info["data_shards"],
            parity_shards=info["parity_shards"],
            large_block_size=info.get("large_block_size",
                                      default.large_block_size),
            small_block_size=info.get("small_block_size",
                                      default.small_block_size),
            code_kind=info.get("code_kind", "rs"),
            lrc_locals=info.get("lrc_locals", 0))
    return default


def encode_volume_to_ec(base_path: str, version: int,
                        geo: EcGeometry = DEFAULT_GEOMETRY,
                        codec: "Codec | None" = None) -> None:
    """The full VolumeEcShardsGenerate flow
    (weed/server/volume_grpc_erasure_coding.go:38-80): shards + .ecx + .vif.

    The exact .dat size goes into .vif: shard size alone cannot recover the
    large/small row split at row boundaries (layout.n_large_block_rows).
    The geometry goes there too (wide-stripe volumes are self-describing)."""
    write_sorted_file_from_idx(base_path)
    write_ec_files(base_path, geo, codec)
    save_volume_info(base_path, version,
                     dat_size=os.path.getsize(base_path + ".dat"),
                     data_shards=geo.data_shards,
                     parity_shards=geo.parity_shards,
                     large_block_size=geo.large_block_size,
                     small_block_size=geo.small_block_size,
                     code_kind=geo.code_kind,
                     lrc_locals=geo.lrc_locals)


def decode_ec_to_volume(base_path: str,
                        geo: "EcGeometry | None" = None,
                        codec: "Codec | None" = None) -> None:
    """The VolumeEcShardsToVolume flow
    (volume_grpc_erasure_coding.go VolumeEcShardsToVolume): rebuild missing
    data shards if needed, then stitch .dat and .idx back."""
    geo = geo or geometry_from_vif(base_path)
    missing_data = [s for s in range(geo.data_shards)
                    if not os.path.exists(base_path + to_ext(s))]
    if missing_data:
        rebuild_ec_files(base_path, geo, codec)
    dat_size = find_dat_file_size(base_path)
    write_dat_file(base_path, dat_size, geo)
    write_idx_file_from_ec_index(base_path)
