"""The seeded volume generator: a version-3 SeaweedFS volume (.dat and
.idx) written by the benchmark's own record writer (reference/needle.py),
so that no change to the program changes the inputs.

Payload sizes are log-uniform between the configuration's bounds, drawn
from a fixed stream: every seed gets the same sizes, so seeds do not
change the amount of the work.  The seed orders them (so each seed puts
other needles at other offsets and on other shards) and draws the payload
bytes, the needle ids and the cookies.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np

from .reference import needle

# the fixed stream of payload sizes (not the run's seed)
SIZE_STREAM = 0x5EEDF00D
APPEND_AT_NS = 1_700_000_000_000_000_000

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "build")
CRC_SOURCE = os.path.join(HERE, "native", "crc32c.cpp")


@dataclass
class Volume:
    base: str                 # path without extension
    dat_size: int
    ids: np.ndarray           # uint64, in .dat order
    cookies: np.ndarray       # uint32
    offsets: np.ndarray       # int64 record offsets in the .dat
    data_sizes: np.ndarray    # int64 payload bytes


def payload_sizes(total_bytes: int, lo: int, hi: int) -> np.ndarray:
    """The payload sizes of a volume of at least `total_bytes`: log-uniform
    on [lo, hi], the same for every seed."""
    rng = np.random.default_rng(SIZE_STREAM)
    sizes: list[int] = []
    used = len(needle.SUPER_BLOCK)
    while used < total_bytes:
        draw = np.floor(lo * (hi / lo) ** rng.random(4096)).astype(np.int64)
        for s in draw:
            if used >= total_bytes:
                break
            sizes.append(int(s))
            used += needle.record_size(int(s))
    return np.array(sizes, dtype=np.int64)


def _crc_library() -> str:
    """Build the checksum once into a fixed directory of the checkout,
    named by a hash of the source and the command."""
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    with open(CRC_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(cmd).encode())
    lib = os.path.join(BUILD_DIR, f"libcrc32c-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        if shutil.which("g++") is None:
            raise RuntimeError("g++ is needed to build ecbench's CRC32-C")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(cmd + ["-o", tmp, CRC_SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return lib


@functools.cache
def _crc_fn():
    fn = ctypes.CDLL(_crc_library()).sw_crc32c
    fn.restype = ctypes.c_uint32
    fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
    return fn


def crc32c(buf: np.ndarray, lo: int, n: int) -> int:
    """CRC32-C of buf[lo:lo + n] (a contiguous uint8 array)."""
    return int(_crc_fn()(0, buf.ctypes.data + lo, n))


def make_volume(base: str, total_bytes: int, seed: int, lo: int, hi: int
                ) -> Volume:
    """Write <base>.dat and <base>.idx: a super block and seeded needles
    until the .dat holds at least `total_bytes`."""
    rng = np.random.Generator(np.random.SFC64(seed))
    sizes = payload_sizes(total_bytes, lo, hi)
    sizes = sizes[rng.permutation(len(sizes))]
    records = np.array([needle.record_size(int(s)) for s in sizes],
                       dtype=np.int64)
    offsets = len(needle.SUPER_BLOCK) + np.concatenate(
        ([0], np.cumsum(records)[:-1]))
    dat_size = int(offsets[-1] + records[-1])
    ids = _unique_ids(rng, len(sizes))
    cookies = rng.integers(0, 1 << 32, len(sizes), dtype=np.uint64)
    # every byte random first; the frames then overwrite all but the data
    buf = rng.bit_generator.random_raw(-(-dat_size // 8)).view(np.uint8)
    view = memoryview(buf)
    view[:len(needle.SUPER_BLOCK)] = needle.SUPER_BLOCK
    for i, (off, n) in enumerate(zip(offsets.tolist(), sizes.tolist())):
        crc = crc32c(buf, off + needle.HEADER + 4, n)
        needle.write_frame(view, off, int(cookies[i]), int(ids[i]), n,
                           needle.masked(crc), APPEND_AT_NS + i)
    with open(base + ".dat", "wb") as f:
        f.write(view[:dat_size])
    body = np.array([needle.body_size(int(s)) for s in sizes],
                    dtype=np.int64)
    with open(base + ".idx", "wb") as f:
        f.write(needle.index_bytes(ids, offsets, body))
    return Volume(base, dat_size, ids, cookies.astype(np.uint32), offsets,
                  sizes)


def _unique_ids(rng: np.random.Generator, n: int) -> np.ndarray:
    ids = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    while len(np.unique(ids)) != n:
        ids = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    return ids
