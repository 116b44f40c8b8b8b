"""EcVolume / EcVolumeShard — the runtime for serving reads from EC shards.

Capability-equivalent to weed/storage/erasure_coding/ec_volume.go:25-251,
ec_shard.go:17-93 and the read/recover path of weed/storage/store_ec.go:
- needle lookup by binary search on the sorted .ecx (ec_volume.go:206-251);
  here the whole .ecx (16B * needles, tens of MB for a full volume) is
  parsed into numpy arrays once and searched with np.searchsorted — O(log n)
  without per-probe syscalls — with tombstones written through to the file.
- delete = in-place tombstone in .ecx + append key to the .ecj journal
  (ec_volume_delete.go:13-49); rebuild_ecx_file replays .ecj (:51).
- read_needle walks locate_data intervals; each interval is served from a
  local shard when present, a remote shard via the pluggable `remote_reader`,
  or — degraded path — reconstructed on the fly from >= k other shards in
  ONE batched codec call (store_ec.go:125-382, recoverOneRemoteEcShardInterval).
  Clay decodes whole windows; LRC reads the repair plan's shards, one local
  group for a single loss.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

import numpy as np

from ...ops import clay_matrix, lrc
from ...ops.codec import gf_apply, job, stage
from .. import types as t
from ..idx import parse_index_bytes
from ..needle import Needle
from .decoder import iterate_ecj_keys
from .encoder import Codec, codec_for
from .layout import EcGeometry, Interval, locate_data, to_ext
from .shard_bits import ShardBits


class EcNotFoundError(Exception):
    pass


class EcShardUnavailableError(Exception):
    pass


# remote_reader(vid, shard_id, shard_offset, size) -> bytes | None
RemoteShardReader = Callable[[int, int, int, int], "bytes | None"]


def volume_base(directory: str, collection: str, vid: int) -> str:
    """<dir>/<collection>_<vid>, or <dir>/<vid> without a collection: the
    path of a volume's files without their extension."""
    if collection:
        return os.path.join(directory, f"{collection}_{vid}")
    return os.path.join(directory, str(vid))


class EcVolumeShard:
    """One local .ecNN file (ec_shard.go:17-93)."""

    def __init__(self, directory: str, collection: str, vid: int,
                 shard_id: int):
        self.directory = directory
        self.collection = collection
        self.volume_id = vid
        self.shard_id = shard_id
        self.path = self.file_name() + to_ext(shard_id)
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def file_name(self) -> str:
        return volume_base(self.directory, self.collection, self.volume_id)

    def read_at(self, size: int, offset: int) -> bytes:
        # positional IO: concurrent readers must never seek-race
        return os.pread(self._f.fileno(), size, offset)

    def close(self) -> None:
        self._f.close()

    def destroy(self) -> None:
        self.close()
        os.remove(self.path)


class EcVolume:
    """All local shards of one EC volume + its .ecx/.ecj index files."""

    def __init__(self, directory: str, collection: str, vid: int,
                 geo: "EcGeometry | None" = None,
                 codec: "Codec | None" = None,
                 remote_reader: RemoteShardReader | None = None,
                 version: int = t.CURRENT_VERSION):
        self.directory = directory
        self.collection = collection
        self.volume_id = vid
        if geo is None:
            # wide-stripe volumes are self-describing via .vif
            from . import geometry_from_vif
            geo = geometry_from_vif(self._base())
        self.geo = geo
        self.codec = codec_for(geo, codec)
        self.remote_reader = remote_reader
        self.version = version
        self.shards: dict[int, EcVolumeShard] = {}
        self._lock = threading.RLock()

        base = self._base()
        self._ecx_path = base + ".ecx"
        self._ecj_path = base + ".ecj"
        with open(self._ecx_path, "rb") as f:
            arr = parse_index_bytes(f.read())
        # parallel arrays sorted by key (the .ecx invariant)
        self._keys = np.ascontiguousarray(arr["key"])
        self._offsets = np.ascontiguousarray(arr["offset"])
        self._sizes = np.ascontiguousarray(arr["size"]).astype(np.int64)
        self._ecx_rw = open(self._ecx_path, "r+b")
        # true original-volume size from the .vif sidecar; k*shard_size is
        # ambiguous at large-row boundaries (see layout.n_large_block_rows)
        from . import load_volume_info
        self._vif_dat_size: "int | None" = \
            load_volume_info(base).get("dat_size")
        # replay any existing journal so restarts see prior deletes
        for key in iterate_ecj_keys(base):
            self._tombstone_in_memory(key)

    def _base(self) -> str:
        return volume_base(self.directory, self.collection, self.volume_id)

    # -- shard management --------------------------------------------------
    def add_shard(self, shard_id: int) -> EcVolumeShard:
        with self._lock:
            if shard_id not in self.shards:
                self.shards[shard_id] = EcVolumeShard(
                    self.directory, self.collection, self.volume_id, shard_id)
            return self.shards[shard_id]

    # the name the store loads shards by (disk_location_ec.go)
    def load_shard(self, shard_id: int) -> EcVolumeShard:
        return self.add_shard(shard_id)

    def delete_shard(self, shard_id: int) -> None:
        with self._lock:
            s = self.shards.pop(shard_id, None)
            if s:
                s.close()

    def shard_bits(self) -> ShardBits:
        return ShardBits.from_ids(self.shards.keys())

    def shard_size(self) -> int:
        if not self.shards:
            return 0
        return next(iter(self.shards.values())).size

    def dat_size(self) -> int:
        """Logical original-volume size the locate math runs against.

        Prefers the exact size recorded in .vif at encode time; falls back
        to k * shardFileSize (the reference's derivation, ec_volume.go:218)
        which over-counts by the final row's zero padding and is ambiguous
        when the tail lands in the last small-row window of a large row."""
        if self._vif_dat_size is not None:
            return self._vif_dat_size
        if not self.shards:
            raise EcShardUnavailableError(
                f"vol {self.volume_id}: no .vif dat_size and no local shard "
                f"to derive the volume size from")
        return self.geo.data_shards * self.shard_size()

    # -- ecx lookup (SearchNeedleFromSortedIndex ec_volume.go:227-251) -----
    def _find_ecx_row(self, needle_id: int) -> int:
        i = int(np.searchsorted(self._keys, np.uint64(needle_id)))
        if i < len(self._keys) and int(self._keys[i]) == needle_id:
            return i
        return -1

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """-> (actual offset in the logical .dat, stored size)."""
        i = self._find_ecx_row(needle_id)
        if i < 0:
            raise EcNotFoundError(f"needle {needle_id:x} not in ecx")
        size = int(self._sizes[i])
        if t.size_is_deleted(size):
            raise EcNotFoundError(f"needle {needle_id:x} deleted")
        return int(self._offsets[i]), size

    def locate_ec_shard_needle(self, needle_id: int
                               ) -> tuple[int, int, list[Interval]]:
        """(offset, size, intervals) (LocateEcShardNeedle ec_volume.go:206)."""
        offset, size = self.find_needle_from_ecx(needle_id)
        intervals = locate_data(self.dat_size(), offset,
                                t.get_actual_size(size, self.version),
                                self.geo)
        return offset, size, intervals

    # -- delete (ec_volume_delete.go:27-49) --------------------------------
    def _tombstone_in_memory(self, needle_id: int) -> bool:
        i = self._find_ecx_row(needle_id)
        if i < 0:
            return False
        self._sizes[i] = t.TOMBSTONE_FILE_SIZE
        return True

    def delete_needle(self, needle_id: int) -> None:
        with self._lock:
            i = self._find_ecx_row(needle_id)
            if i < 0:
                return
            self._sizes[i] = t.TOMBSTONE_FILE_SIZE
            # write-through: size field lives at entry+8+OFFSET_SIZE.
            # Positioned write — no shared seek offset, nothing buffered
            # to flush (the handle is used only for these tombstones)
            pos = (i * t.NEEDLE_MAP_ENTRY_SIZE
                   + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE)
            os.pwrite(self._ecx_rw.fileno(), t.size_to_bytes(
                t.TOMBSTONE_FILE_SIZE), pos)
            # the .ecj tombstone journal append must be ordered with the
            # in-memory tombstone it mirrors; this is the volume's own
            # fine-grained lock, and the append is tiny
            with open(self._ecj_path, "ab") as j:
                j.write(t.needle_id_to_bytes(needle_id))

    # -- interval reads (store_ec.go:188-382) ------------------------------
    def _read_local_or_remote(self, shard_id: int, offset: int, size: int
                              ) -> "bytes | None":
        shard = self.shards.get(shard_id)
        if shard is not None:
            return shard.read_at(size, offset)
        if self.remote_reader is not None:
            return self.remote_reader(self.volume_id, shard_id, offset, size)
        return None

    def _reconstruct_interval(self, missing_shard: int, offset: int,
                              size: int) -> bytes:
        """Degraded read: gather [offset, offset+size) from >= k other
        shards, reconstruct the missing one in a single codec call
        (recoverOneRemoteEcShardInterval store_ec.go:328-382).  LRC reads
        the repair plan's shards (_reconstruct_interval_lrc); clay decodes
        whole alpha-layer windows (_reconstruct_interval_clay)."""
        if self.geo.code_kind == "lrc":
            return self._reconstruct_interval_lrc(missing_shard, offset,
                                                  size)
        if self.geo.code_kind == "clay":
            return self._reconstruct_interval_clay(missing_shard, offset,
                                                   size)
        n = self.geo.total_shards
        shards: list[np.ndarray | None] = [None] * n
        got = 0
        with stage("ec_read", self.codec.label, "read"):
            for sid in range(n):
                if sid == missing_shard or got >= self.geo.data_shards:
                    continue
                raw = self._read_local_or_remote(sid, offset, size)
                if raw is not None and len(raw) == size:
                    shards[sid] = np.frombuffer(raw, dtype=np.uint8)
                    got += 1
        if got < self.geo.data_shards:
            raise EcShardUnavailableError(
                f"vol {self.volume_id} shard {missing_shard}: only {got} "
                f"shards reachable, need {self.geo.data_shards}")
        return self.codec.reconstruct(shards)[missing_shard].tobytes()

    def _reconstruct_interval_lrc(self, missing_shard: int, offset: int,
                                  size: int) -> bytes:
        """LRC is scalar, so exact intervals are read from the repair
        plan's shards: one local group for a single loss.  If a group
        member does not answer either, every shard is probed and the
        repair re-planned globally over those that answered."""
        with stage("ec_read", self.codec.label, "read"):
            lgeo = self.codec.lgeo
            with stage("ec_plan", self.codec.label, "read"):
                plan = lrc.plan_repair(lgeo, [missing_shard])
            rows = []
            for sid in plan.read_shards:
                raw = self._read_local_or_remote(sid, offset, size)
                if raw is None or len(raw) != size:
                    rows = None
                    break
                rows.append(np.frombuffer(raw, dtype=np.uint8))
            if rows is None:
                got: dict[int, np.ndarray] = {}
                for sid in range(self.geo.total_shards):
                    if sid == missing_shard:
                        continue
                    raw = self._read_local_or_remote(sid, offset, size)
                    if raw is not None and len(raw) == size:
                        got[sid] = np.frombuffer(raw, dtype=np.uint8)
                try:
                    with stage("ec_plan", self.codec.label, "read"):
                        plan = lrc.plan_repair(lgeo, [missing_shard],
                                               available=sorted(got))
                except ValueError as e:
                    raise EcShardUnavailableError(
                        f"vol {self.volume_id} shard {missing_shard}: "
                        f"{e}") from None
                rows = [got[sid] for sid in plan.read_shards]
            x = np.stack(rows)
        out = gf_apply(plan.matrix, x, device=self.codec.device,
                       metered=(self.codec.label, "reconstruct"))
        return out[0].tobytes()

    def _reconstruct_interval_clay(self, missing_shard: int, offset: int,
                                   size: int) -> bytes:
        """Clay symbols live in [alpha, win_a] layers per small-block
        window: align the read to whole windows, flat-decode from the first
        k reachable survivors on the codec's device (gf_apply), slice the
        requested bytes.  The beta-plane partial reads are reserved for
        rebuild, where helpers are local files."""
        geo = self.geo
        code = self.codec.code
        small = geo.small_block_size
        alpha, win_a = code.alpha, small // code.alpha
        w0 = offset // small
        w1 = -(-(offset + size) // small)
        a_off, wn = w0 * small, w1 - w0
        a_size = wn * small
        present, blocks = [], []
        with stage("ec_read", self.codec.label, "read"):
            for sid in range(geo.total_shards):
                if sid == missing_shard or len(present) >= geo.data_shards:
                    continue
                raw = self._read_local_or_remote(sid, a_off, a_size)
                if raw is not None and len(raw) == a_size:
                    present.append(sid)
                    arr = np.frombuffer(raw, dtype=np.uint8)
                    blocks.append(np.ascontiguousarray(
                        arr.reshape(wn, alpha, win_a).transpose(1, 0, 2)
                    ).reshape(alpha, -1))
            if len(present) < geo.data_shards:
                raise EcShardUnavailableError(
                    f"vol {self.volume_id} shard {missing_shard}: only "
                    f"{len(present)} shards reachable, need "
                    f"{geo.data_shards}")
            x = np.concatenate(blocks, axis=0)
        D = clay_matrix.decode_flat(geo.data_shards, geo.parity_shards,
                                    tuple(present), (missing_shard,))
        rec = gf_apply(D, x, device=self.codec.device,
                       metered=(self.codec.label, "reconstruct"))
        window = np.ascontiguousarray(
            rec.reshape(alpha, wn, win_a).transpose(1, 0, 2)).reshape(-1)
        lo = offset - a_off
        return window[lo:lo + size].tobytes()

    def read_interval(self, interval: Interval) -> bytes:
        shard_id, shard_offset = interval.to_shard_id_and_offset(self.geo)
        with stage("ec_read", self.codec.label, "read"):
            data = self._read_local_or_remote(shard_id, shard_offset,
                                              interval.size)
        if data is not None and len(data) == interval.size:
            return data
        return self._reconstruct_interval(shard_id, shard_offset,
                                          interval.size)

    def read_needle(self, needle_id: int, cookie: "int | None" = None
                    ) -> Needle:
        """Full EC needle read (ReadEcShardNeedle store_ec.go:125-186).  The
        job ec.read_needle, named `vid:needle id` (hex)."""
        with job("ec.read_needle", f"{self.volume_id}:{needle_id:x}"):
            _, size, intervals = self.locate_ec_shard_needle(needle_id)
            raw = b"".join(self.read_interval(iv) for iv in intervals)
            n = Needle()
            with stage("needle_parse", self.codec.label, "read"):
                n.read_bytes(raw, 0, size, self.version)
            if cookie is not None and n.cookie != cookie:
                raise EcNotFoundError(f"cookie mismatch for {needle_id:x}")
            return n

    # -- maintenance -------------------------------------------------------
    def file_count(self) -> int:
        return int((self._sizes != t.TOMBSTONE_FILE_SIZE).sum())

    def deleted_count(self) -> int:
        return int((self._sizes == t.TOMBSTONE_FILE_SIZE).sum())

    def close(self) -> None:
        with self._lock:
            self._ecx_rw.close()
            for s in self.shards.values():
                s.close()
            self.shards.clear()

    def destroy(self) -> None:
        """Close and remove every file of this EC volume: .ecx, .ecj, .vif
        and every shard file of the family, loaded here or not
        (ec_volume.go Destroy)."""
        with self._lock:
            self.close()
            base = self._base()
            for ext in [".ecx", ".ecj", ".vif"] + [
                    to_ext(s) for s in range(self.geo.total_shards)]:
                if os.path.exists(base + ext):
                    os.remove(base + ext)


def rebuild_ecx_file(base_path: str) -> None:
    """Replay .ecj tombstones into .ecx, then remove .ecj
    (RebuildEcxFile ec_volume_delete.go:51-89)."""
    ecj = base_path + ".ecj"
    if not os.path.exists(ecj):
        return
    with open(base_path + ".ecx", "rb") as f:
        arr = parse_index_bytes(f.read())
    keys = np.ascontiguousarray(arr["key"])
    with open(base_path + ".ecx", "r+b") as f:
        for key in iterate_ecj_keys(base_path):
            i = int(np.searchsorted(keys, np.uint64(key)))
            if i < len(keys) and keys[i] == key:
                f.seek(i * t.NEEDLE_MAP_ENTRY_SIZE
                       + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE)
                f.write(t.size_to_bytes(t.TOMBSTONE_FILE_SIZE))
    os.remove(ecj)
