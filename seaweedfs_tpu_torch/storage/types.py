"""Core storage scalar types and on-disk encodings.

Byte-compatible with the reference formats (all integers big-endian, per
weed/util/bytes.go:34-74):

- NeedleId: uint64, 8 bytes (weed/storage/types/needle_id_type.go:10-13)
- Cookie:   uint32, 4 bytes (weed/storage/types/needle_types.go:31)
- Size:     int32 stored as uint32; TombstoneFileSize = -1 marks deletion
  (needle_types.go:15-22,40)
- Offset:   stored /8 (NeedlePaddingSize) so 4 bytes address 32 GB
  (offset_4bytes.go:12-15).
- Needle map entry: key(8) + offset(4) + size(4) (needle_types.go:36-38)
"""

from __future__ import annotations

import struct

NEEDLE_ID_SIZE = 8
COOKIE_SIZE = 4
SIZE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
OFFSET_SIZE = 4
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16

TOMBSTONE_FILE_SIZE = -1  # Size(-1) tombstone (needle_types.go:40)

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_to_bytes(size: int) -> bytes:
    return struct.pack(">I", size & 0xFFFFFFFF)


def bytes_to_size(b: bytes) -> int:
    (v,) = struct.unpack(">I", b[:4])
    return v - (1 << 32) if v & 0x80000000 else v


def needle_id_to_bytes(nid: int) -> bytes:
    return struct.pack(">Q", nid)


def bytes_to_needle_id(b: bytes) -> int:
    return struct.unpack(">Q", b[:8])[0]


def cookie_to_bytes(cookie: int) -> bytes:
    return struct.pack(">I", cookie)


def bytes_to_cookie(b: bytes) -> int:
    return struct.unpack(">I", b[:4])[0]


def offset_to_bytes(actual_offset: int, width: int = OFFSET_SIZE) -> bytes:
    """Store actual byte offset / 8; big-endian in `width` bytes."""
    smaller = actual_offset // NEEDLE_PADDING_SIZE
    return smaller.to_bytes(width, "big")


def padding_length(needle_size: int, version: int) -> int:
    """NB: returns 8 (not 0) when already aligned — quirk preserved for
    byte-compatibility (needle_read_write.go:354-360)."""
    if version == VERSION3:
        body = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
    else:
        body = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
    return NEEDLE_PADDING_SIZE - (body % NEEDLE_PADDING_SIZE)


def needle_body_length(needle_size: int, version: int) -> int:
    """needle_read_write.go:362-367."""
    if version == VERSION3:
        return (needle_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
                + padding_length(needle_size, version))
    return needle_size + NEEDLE_CHECKSUM_SIZE + padding_length(needle_size, version)


def get_actual_size(size: int, version: int) -> int:
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)
