"""The version-3 needle record and the needle index, the benchmark's
frozen copy (weed/storage/needle/needle_read_write.go, weed/storage/idx).

A record holding only a payload (flags 0, no name, mime, TTL or pairs):

    cookie u32 | id u64 | size u32           header, big-endian
    data_size u32 | data | flags u8           the body; size = 4 + n + 1
    checksum u32                              masked CRC32-C of data
    append_at_ns u64
    zero padding to a multiple of 8 (8 bytes when already aligned)

An index entry is key u64 | offset / 8 u32 | size u32, big-endian.
"""

from __future__ import annotations

import struct

import numpy as np

HEADER = 16
TRAILER = 4 + 8          # checksum, append_at_ns
SUPER_BLOCK = bytes([3, 0, 0, 0, 0, 0, 0, 0])   # version 3, no extra
ENTRY = 16


def body_size(data_size: int) -> int:
    return 4 + data_size + 1


def record_size(data_size: int) -> int:
    unpadded = HEADER + body_size(data_size) + TRAILER
    return unpadded + 8 - unpadded % 8


def masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def write_frame(buf: memoryview, pos: int, cookie: int, nid: int,
                data_size: int, checksum: int, append_at_ns: int) -> None:
    """Everything of the record at `pos` but its data, which sits at
    pos + HEADER + 4 already."""
    struct.pack_into(">IQII", buf, pos, cookie, nid, body_size(data_size),
                     data_size)
    at = pos + HEADER + 4 + data_size
    struct.pack_into(">BIQ", buf, at, 0, checksum, append_at_ns)
    end = pos + record_size(data_size)
    at += 1 + TRAILER
    buf[at:end] = bytes(end - at)


def data_of(record: bytes) -> tuple[int, int, bytes]:
    """(cookie, id, data) of a record."""
    cookie, nid, size = struct.unpack_from(">IQI", record, 0)
    (n,) = struct.unpack_from(">I", record, HEADER)
    if size != body_size(n):
        raise ValueError(f"needle {nid:x}: size {size} != 4 + {n} + 1")
    return cookie, nid, bytes(record[HEADER + 4:HEADER + 4 + n])


def index_bytes(keys: np.ndarray, offsets: np.ndarray,
                sizes: np.ndarray) -> bytes:
    out = np.empty((len(keys), ENTRY), dtype=np.uint8)
    out[:, :8] = keys.astype(">u8").view(np.uint8).reshape(-1, 8)
    out[:, 8:12] = (offsets // 8).astype(">u4").view(np.uint8).reshape(-1, 4)
    out[:, 12:] = sizes.astype(">u4").view(np.uint8).reshape(-1, 4)
    return out.tobytes()


def parse_index(raw: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keys, offsets in bytes, sizes) of index entries."""
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, ENTRY)
    keys = rows[:, :8].copy().view(">u8").reshape(-1).astype(np.uint64)
    offsets = rows[:, 8:12].copy().view(">u4").reshape(-1).astype(
        np.int64) * 8
    sizes = rows[:, 12:].copy().view(">u4").reshape(-1).astype(np.int64)
    return keys, offsets, sizes
