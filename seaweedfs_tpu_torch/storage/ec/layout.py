"""EC stripe layout: how a logical .dat byte range maps onto shard files.

Geometry (reference weed/storage/erasure_coding/ec_encoder.go:17-23): the
volume's .dat is cut row-major into rows of `k` blocks — first rows of LARGE
(1 GB) blocks while a full large row fits, then rows of SMALL (1 MB) blocks
for the tail.  Block i of a row goes to shard i, so shard files are the
column-major view: shard s = [large blocks of column s...] ++ [small blocks
of column s...].

locate_data / Interval.to_shard_id_and_offset reproduce the arithmetic of
ec_locate.go:15-87 (including the nLargeBlockRows derivation quirk at
ec_locate.go:19: rows are derived from datSize + k*small so that a shard's
large-row count is recoverable from the shard size alone).

The geometry is parameterized (k, large, small) instead of hard-coding
RS(10,4)/1GB/1MB, so the same math serves wide stripes RS(28,4)/RS(16,8).
"""

from __future__ import annotations

from dataclasses import dataclass

DATA_SHARDS_COUNT = 10        # ec_encoder.go:18
PARITY_SHARDS_COUNT = 4       # ec_encoder.go:19
TOTAL_SHARDS_COUNT = DATA_SHARDS_COUNT + PARITY_SHARDS_COUNT
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024   # ec_encoder.go:21
SMALL_BLOCK_SIZE = 1024 * 1024          # ec_encoder.go:22


def to_ext(shard_id: int) -> str:
    """0 -> '.ec00' (ec_encoder.go ToExt)."""
    return f".ec{shard_id:02d}"


@dataclass(frozen=True)
class EcGeometry:
    """One stripe configuration; the default matches the reference.

    `code_kind` names the erasure code family (beyond the reference's
    fixed RS): "rs" (default), "clay" (MSR regenerating code) or "lrc"
    (local reconstruction code; parity_shards = lrc_locals local XORs +
    globals).  Data shards are byte-identical across kinds (all are
    systematic), so the locate math never consults the kind."""
    data_shards: int = DATA_SHARDS_COUNT
    parity_shards: int = PARITY_SHARDS_COUNT
    large_block_size: int = LARGE_BLOCK_SIZE
    small_block_size: int = SMALL_BLOCK_SIZE
    code_kind: str = "rs"
    lrc_locals: int = 0

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    def large_row_size(self) -> int:
        return self.large_block_size * self.data_shards

    def small_row_size(self) -> int:
        return self.small_block_size * self.data_shards

    def n_large_block_rows(self, dat_size: int) -> int:
        """Large-row count for a TRUE dat size — the same `//` the encoder
        walks, so locate and encode always agree.

        The reference instead derives rows from k*shardFileSize with a
        fudge term (ec_locate.go:19), which is ambiguous: a shard of
        L large + 1024 small blocks has the same SIZE as L+1 large blocks
        but a different layout, corrupting reads for dat sizes in the last
        small-row window below a large-row multiple.  We persist the true
        dat size in .vif instead (see EcVolume.dat_size)."""
        return dat_size // self.large_row_size()

    def shard_file_size(self, dat_size: int) -> int:
        """Size of each .ecNN file for a dat of dat_size bytes."""
        large_rows = self.n_large_block_rows(dat_size)
        rem = dat_size - large_rows * self.large_row_size()
        small_rows = (rem + self.small_row_size() - 1) // self.small_row_size()
        return (large_rows * self.large_block_size
                + small_rows * self.small_block_size)


DEFAULT_GEOMETRY = EcGeometry()


@dataclass(frozen=True)
class Interval:
    """One contiguous run inside a single block (ec_locate.go:7-13)."""
    block_index: int          # row-major block number within its area
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, geo: EcGeometry = DEFAULT_GEOMETRY
                               ) -> tuple[int, int]:
        """Map to (shard id, byte offset in the shard file)
        (ec_locate.go:77-87)."""
        offset = self.inner_block_offset
        row = self.block_index // geo.data_shards
        if self.is_large_block:
            offset += row * geo.large_block_size
        else:
            offset += (self.large_block_rows_count * geo.large_block_size
                       + row * geo.small_block_size)
        return self.block_index % geo.data_shards, offset


def _locate_offset(geo: EcGeometry, dat_size: int, offset: int
                   ) -> tuple[int, bool, int]:
    """-> (block_index, is_large, inner_offset) (ec_locate.go:54-69)."""
    large_row = geo.large_row_size()
    n_large_rows = dat_size // large_row
    if offset < n_large_rows * large_row:
        return offset // geo.large_block_size, True, offset % geo.large_block_size
    offset -= n_large_rows * large_row
    return offset // geo.small_block_size, False, offset % geo.small_block_size


def locate_data(dat_size: int, offset: int, size: int,
                geo: EcGeometry = DEFAULT_GEOMETRY) -> list[Interval]:
    """Split a logical [offset, offset+size) range of the original .dat into
    per-block intervals (ec_locate.go:15-52)."""
    block_index, is_large, inner = _locate_offset(geo, dat_size, offset)
    n_large_rows = geo.n_large_block_rows(dat_size)
    intervals: list[Interval] = []
    while size > 0:
        block = geo.large_block_size if is_large else geo.small_block_size
        take = min(size, block - inner)
        intervals.append(Interval(block_index, inner, take, is_large,
                                  n_large_rows))
        size -= take
        block_index += 1
        if is_large and block_index == n_large_rows * geo.data_shards:
            is_large = False
            block_index = 0
        inner = 0
    return intervals
