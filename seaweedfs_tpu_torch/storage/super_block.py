"""Volume superblock (8 bytes) + replica placement grammar.

Layout (weed/storage/super_block/super_block.go:16-23):
  byte 0: needle version; byte 1: replica placement; bytes 2-3: TTL;
  bytes 4-5: compaction revision; bytes 6-7: extra-size (pb blob follows).

Replica placement "xyz" = DiffDataCenter/DiffRack/SameRack extra-copy counts
(super_block/replica_placement.go:8-54).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import types as t
from .ttl import TTL, EMPTY_TTL

SUPER_BLOCK_SIZE = 8


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack_count: int = 0
    diff_rack_count: int = 0
    diff_data_center_count: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        digits = [0, 0, 0]
        for i, c in enumerate(s[:3]):
            n = ord(c) - ord("0")
            if not 0 <= n <= 2:
                raise ValueError(f"unknown replication type {s!r}")
            digits[i] = n
        return cls(diff_data_center_count=digits[0],
                   diff_rack_count=digits[1],
                   same_rack_count=digits[2])

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return (self.diff_data_center_count * 100
                + self.diff_rack_count * 10 + self.same_rack_count)


@dataclass
class SuperBlock:
    version: int = t.CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = EMPTY_TTL
    compaction_revision: int = 0
    extra: bytes = b""  # serialized SuperBlockExtra pb, opaque here

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        struct.pack_into(">H", header, 4, self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            struct.pack_into(">H", header, 6, len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @classmethod
    def from_bytes(cls, header: bytes) -> "SuperBlock":
        if len(header) < SUPER_BLOCK_SIZE:
            raise ValueError("super block truncated")
        extra_size = struct.unpack_from(">H", header, 6)[0]
        return cls(
            version=header[0],
            replica_placement=ReplicaPlacement.from_byte(header[1]),
            ttl=TTL.from_bytes(header[2:4]),
            compaction_revision=struct.unpack_from(">H", header, 4)[0],
            extra=bytes(header[SUPER_BLOCK_SIZE:SUPER_BLOCK_SIZE + extra_size]),
        )
