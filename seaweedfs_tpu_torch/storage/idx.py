""".idx file entries — 16 bytes each: key(8) offset(4) size(4), big-endian
(weed/storage/idx/walk.go:12-55, needle_types.go:36-38), parsed and
written with numpy in one vectorized pass."""

from __future__ import annotations

import numpy as np

from . import types as t


def parse_index_bytes(raw: bytes) -> np.ndarray:
    """-> structured array with fields key(u8), offset(i8 actual bytes),
    size(i4). Truncates any torn trailing partial entry."""
    n = len(raw) // t.NEEDLE_MAP_ENTRY_SIZE
    raw = raw[:n * t.NEEDLE_MAP_ENTRY_SIZE]
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(n, t.NEEDLE_MAP_ENTRY_SIZE)
    key = rows[:, :8].copy().view(">u8").reshape(n)
    off_scaled = rows[:, 8:12].copy().view(">u4").reshape(n)
    size = rows[:, 12:16].copy().view(">i4").reshape(n)
    out = np.empty(n, dtype=[("key", "u8"), ("offset", "i8"), ("size", "i4")])
    out["key"] = key
    out["offset"] = off_scaled.astype(np.int64) * t.NEEDLE_PADDING_SIZE
    out["size"] = size
    return out


def idx_entry_bytes(key: int, actual_offset: int, size: int) -> bytes:
    return (t.needle_id_to_bytes(key)
            + t.offset_to_bytes(actual_offset)
            + t.size_to_bytes(size))


def index_array_to_bytes(arr: np.ndarray) -> bytes:
    """Inverse of parse_index_bytes: structured array (key, offset actual
    bytes, size) -> packed big-endian 16-byte entries, one vectorized pass."""
    n = len(arr)
    rows = np.empty((n, t.NEEDLE_MAP_ENTRY_SIZE), dtype=np.uint8)
    rows[:, :8] = arr["key"].astype(">u8").view(np.uint8).reshape(n, 8)
    scaled = (arr["offset"] // t.NEEDLE_PADDING_SIZE).astype(">u4")
    rows[:, 8:12] = scaled.view(np.uint8).reshape(n, 4)
    rows[:, 12:16] = arr["size"].astype(">i4").view(np.uint8).reshape(n, 4)
    return rows.tobytes()
