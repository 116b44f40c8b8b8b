"""ShardBits — which of the n shards a server holds, as a bitmask.

Mirrors weed/storage/erasure_coding/ec_volume_info.go:65-117 (uint32 bitmask,
bit i = shard i present) but as a tiny immutable helper class; works for wide
stripes too (n <= 32).
"""

from __future__ import annotations


class ShardBits(int):
    def add_shard_id(self, shard_id: int) -> "ShardBits":
        return ShardBits(self | (1 << shard_id))

    def remove_shard_id(self, shard_id: int) -> "ShardBits":
        return ShardBits(self & ~(1 << shard_id))

    def has_shard_id(self, shard_id: int) -> bool:
        return bool(self & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(32) if self & (1 << i)]

    def shard_id_count(self) -> int:
        return bin(self).count("1")

    def plus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self & ~other)

    @classmethod
    def from_ids(cls, ids) -> "ShardBits":
        b = 0
        for i in ids:
            b |= 1 << i
        return cls(b)
