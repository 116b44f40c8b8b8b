"""Needle checksum: CRC32-Castagnoli with the masked final value
`rot15(crc) + 0xa282ead8` the reference uses (weed/storage/needle/crc.go:12-26,
the snappy/"masked CRC" construction), so .dat files interoperate byte-for-byte.

Fast path is `csrc/crc32c.cpp` (SSE4.2 crc32q on x86, table slice-by-8
otherwise), built with the host g++ on first use; without a compiler the
pure-Python slice-by-8 below runs instead (~4 MB/s: fine for small needles,
far too slow for a GiB-scale volume).
"""

from __future__ import annotations

import ctypes
import struct
import threading

CASTAGNOLI_POLY = 0x82F63B78  # reflected 0x1EDC6F41


def _make_tables(n: int = 8) -> list[list[int]]:
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ CASTAGNOLI_POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, n):
        prev = tables[k - 1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8) for i in range(256)])
    return tables


_TABLES = _make_tables()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    t = _TABLES
    n8 = len(data) // 8 * 8
    for i in range(0, n8, 8):
        c ^= struct.unpack_from("<I", data, i)[0]
        hi = struct.unpack_from("<I", data, i + 4)[0]
        c = (t[7][c & 0xFF] ^ t[6][(c >> 8) & 0xFF]
             ^ t[5][(c >> 16) & 0xFF] ^ t[4][(c >> 24) & 0xFF]
             ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
             ^ t[1][(hi >> 16) & 0xFF] ^ t[0][(hi >> 24) & 0xFF])
    for b in data[n8:]:
        c = t[0][(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_native_lock = threading.Lock()
_native = None
_native_tried = False


def native_crc32c():
    """The compiled sw_crc32c(crc, data, len), or None when it cannot be
    built on this host."""
    global _native, _native_tried
    if _native_tried:  # lock-free once resolved: this is on every needle
        return _native
    with _native_lock:
        if not _native_tried:
            from ..ops import _build
            try:
                lib = _build.load("crc32c")
            except (_build.BuildError, OSError):
                lib = None
            if lib is not None:
                fn = lib.sw_crc32c
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_size_t]
                _native = fn
            # publish _native before the flag the fast path reads
            _native_tried = True
        return _native


def crc32c(data: bytes, crc: int = 0) -> int:
    fn = native_crc32c()
    if fn is not None:
        return fn(crc, bytes(data), len(data))
    return _crc32c_py(data, crc)


def masked_value(crc: int) -> int:
    """The stored checksum: rot17-left + magic (needle/crc.go:24-26)."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
