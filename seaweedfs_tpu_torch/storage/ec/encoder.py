"""EC encode/rebuild: volume files -> shard files, batched through the GPU.

Capability-equivalent to weed/storage/erasure_coding/ec_encoder.go
(WriteEcFiles:57, RebuildEcFiles:61, WriteSortedFileFromIdx:27):

- Each read covers a whole *row batch*: one contiguous [k * block] slice of
  .dat reshapes to the [k, block] stripe matrix, several stripes stack into
  a [k, B] batch, and ONE codec call (the GF(2^8) bit-plane kernel) produces
  all parity for the batch.  The batch is gathered straight into the
  dispatch's host staging (`ops.codec.staging`: pinned on CUDA), which the
  codec uploads with no further copy; data shards are written from it.
- Rebuild reads the first k surviving shards' aligned windows into one
  [k, B] staging buffer and reconstructs every missing shard in one codec
  call per window.
- One loop per operation serves V >= 1 volumes side by side on the byte
  axis of one [k, V * B] buffer: the fleet forms' groups, and the
  single-volume entries with V = 1.
- Clay and LRC geometries (`code_kind="clay"` / `"lrc"`) take the window
  codecs and rebuilds of storage/ec/codes.py: the same shard files, other
  parity math.

One deliberate divergence: the reference encodes a .dat whose size is an
exact multiple of the large row as small blocks (`>` at ec_encoder.go:215)
but *decodes* it as large blocks (`>=` at ec_decoder.go:175) — an
inconsistent edge.  We use `>=` on both sides so every size round-trips.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import queue as _queue
import threading
from typing import Union

import numpy as np

from ...ops.codec import RSCodec, current_job, job, span, stage, staging
from ...parallel.mesh_codec import MeshCodec, codec_for_devices
from ..idx import index_array_to_bytes, parse_index_bytes
from ..types import TOMBSTONE_FILE_SIZE
from .codes import (ClayWindowCodec, LrcWindowCodec, rebuild_clay,
                    rebuild_lrc, require_ported, window_codec_for)
from .layout import DEFAULT_GEOMETRY, EcGeometry, to_ext

# Per-shard bytes fed to one codec call: 8 MB x 10 shards = 80 MB reads.
DEFAULT_BATCH_BYTES = 8 * 1024 * 1024

# Batches in flight between the reading/submitting producer and the
# shard-file writer thread.  2 = classic double buffering: while the device
# encodes batch N and the writer drains N-1, the producer reads N+1 from
# disk.
PIPELINE_DEPTH = 2


def _pipelined(produce, consume, backend: str, op: str) -> None:
    """Run `produce` (a generator issuing async device work per item) against
    `consume(item)` on a writer thread, PIPELINE_DEPTH items in flight.

    The producer runs on the calling thread: it reads the next window from
    disk and submits its codec call while the device chews the previous one
    and the writer blocks in fetch()/file-writes.  A bounded queue keeps at
    most PIPELINE_DEPTH batches of host buffers alive, and writes happen in
    submission order (single consumer, FIFO queue), which append-only shard
    files require.  Each put, and the end of the stream with the writer's
    drain, is an ec_queue_wait stage under (backend, op); the writer thread
    takes the caller's job."""
    q: _queue.Queue = _queue.Queue(maxsize=PIPELINE_DEPTH)
    errs: list[BaseException] = []
    outer = current_job()

    def writer():
        with job(*outer) if outer else contextlib.nullcontext():
            while True:
                item = q.get()
                if item is None:
                    return
                if not errs:
                    try:
                        consume(item)
                    except BaseException as e:  # surfaced to the caller
                        errs.append(e)
                # after an error keep draining so the producer never
                # deadlocks on a full queue

    t = threading.Thread(target=writer, name="ec-writer")
    t.start()
    try:
        for item in produce:
            if errs:
                break
            with stage("ec_queue_wait", backend, op):
                q.put(item)
    finally:
        with stage("ec_queue_wait", backend, op):
            q.put(None)
            t.join()
    if errs:
        raise errs[0]


Codec = Union[RSCodec, MeshCodec, ClayWindowCodec, LrcWindowCodec]
_CODEC_CLASS = {"rs": (RSCodec, MeshCodec), "clay": ClayWindowCodec,
                "lrc": LrcWindowCodec}


def codec_for(geo: EcGeometry, codec: "Codec | None" = None, *,
              device=None) -> "Codec":
    """The caller's codec, checked against the geometry, or a new one for
    it on `device`, a `Mesh` or a torch device (CUDA unless the caller
    names another): for RS codec_for_devices (MeshCodec on a mesh, RSCodec
    on a device), for clay and LRC the window codecs of codes.py, which
    take a device the same way.  Building one is the span codec.build."""
    require_ported(geo)
    cls = _CODEC_CLASS[geo.code_kind]
    if codec is None:
        with span("codec.build"):
            if geo.code_kind == "rs":
                return codec_for_devices(geo.data_shards, geo.parity_shards,
                                         device=device)
            return window_codec_for(geo, device=device)
    if not isinstance(codec, cls):
        raise ValueError(f"a {type(codec).__name__} cannot code a "
                         f"{geo.code_kind!r} geometry")
    if (codec.k, codec.m) != (geo.data_shards, geo.parity_shards) or (
            cls is ClayWindowCodec and codec.geo.small_block_size
            != geo.small_block_size) or (    # the clay symbol windows
            cls is LrcWindowCodec and codec.geo.lrc_locals
            != geo.lrc_locals):             # the LRC local groups
        raise ValueError("codec geometry does not match EC geometry")
    return codec


def _iter_encode_batches(dat, dat_size: int, geo: EcGeometry,
                         batch_bytes: int):
    """Yield (width, gather) per [k, width] data matrix write_ec_files
    encodes, in shard append order: gather(out) copies the matrix out of
    .dat into `out`, a [k, width] array of the caller's (a staging buffer).
    Large rows first (column slices gathered across the k large blocks),
    then batched small rows, zero-padding the final partial row exactly
    like encodeDataOneBatch (ec_encoder.go:173).  Small-row batches are at
    least one whole block wide even when batch_bytes is smaller."""
    k = geo.data_shards
    large_row = geo.large_row_size()
    small_row = geo.small_row_size()
    block = geo.small_block_size

    def gather_large(pos, col, data):
        width = data.shape[1]
        for s in range(k):
            off = pos + s * geo.large_block_size + col
            data[s] = dat[off:off + width]

    def gather_small(pos, n_rows, data):
        # shard s of row r sits at .dat offset pos + r*small_row + s*block
        for r in range(n_rows):
            row_off = pos + r * small_row
            for s in range(k):
                o = row_off + s * block
                dst = data[s, r * block:(r + 1) * block]
                n = min(block, max(0, dat_size - o))
                if n > 0:
                    dst[:n] = dat[o:o + n]
                if n < block:
                    dst[n:] = 0    # zero-pad the final partial row

    pos = 0
    remaining = dat_size
    while remaining >= large_row:
        # one large row = k large blocks; stream it in batch_bytes column
        # slices, gathered into a [k, width] matrix
        for col in range(0, geo.large_block_size, batch_bytes):
            width = min(batch_bytes, geo.large_block_size - col)
            yield width, functools.partial(gather_large, pos, col)
        pos += large_row
        remaining -= large_row
    rows_per_batch = max(1, batch_bytes // block)
    while remaining > 0:
        n_rows = min(rows_per_batch,
                     (remaining + small_row - 1) // small_row)
        yield n_rows * block, functools.partial(gather_small, pos, n_rows)
        pos += n_rows * small_row
        remaining -= min(remaining, n_rows * small_row)


def _open_dat(base: str) -> tuple[np.ndarray, int]:
    size = os.path.getsize(base + ".dat")
    dat = np.memmap(base + ".dat", dtype=np.uint8, mode="r") \
        if size else np.zeros(0, dtype=np.uint8)
    return dat, size


def write_ec_files(base_path: str, geo: EcGeometry = DEFAULT_GEOMETRY,
                   codec: "Codec | None" = None,
                   batch_bytes: int = DEFAULT_BATCH_BYTES) -> None:
    """<base>.dat -> <base>.ec00 .. (WriteEcFiles ec_encoder.go:57): the
    encode loop `_encode_volumes` with one volume."""
    _encode_volumes([base_path], geo, codec, batch_bytes)


def encode_ec_files_batch(base_paths: list[str],
                          geo: EcGeometry = DEFAULT_GEOMETRY,
                          codec: "Codec | None" = None,
                          batch_bytes: int = DEFAULT_BATCH_BYTES) -> None:
    """Fleet encode: <base>.dat -> shard files for MANY volumes with
    batched codec dispatches.

    Volumes that share a shard-file size (ergo the same batch width
    sequence) share every window's codec call (`_encode_volumes`); a
    volume of a size of its own is a group of one.  Shard bytes are
    identical to write_ec_files."""
    groups: dict[int, list[str]] = {}
    for base in base_paths:
        dat_size = os.path.getsize(base + ".dat")
        groups.setdefault(geo.shard_file_size(dat_size), []).append(base)
    for _, bases in sorted(groups.items()):
        _encode_volumes(bases, geo, codec, batch_bytes)


def _encode_volumes(bases: list[str], geo: EcGeometry,
                    codec: "Codec | None", batch_bytes: int) -> None:
    """The encode loop of V >= 1 volumes of one shard-file size.

    Their batch iterators advance in lockstep (equal shard size =>
    provably equal width sequences), and each window of them is gathered
    into its own [k, V * width] staging buffer, the volumes side by side
    on the byte axis, which every code kind encodes column by column: one
    dispatch a window, bit-identical to encoding each volume alone.
    Pipelined: the calling thread gathers window N+1 and submits its
    encode while the device computes window N and a writer thread appends
    window N-1's shards, the data shards from the buffer, which the array
    queued with the window keeps alive until then.  The job
    ec.encode_volume, named by the volumes' base names."""
    with job("ec.encode_volume", ",".join(map(os.path.basename, bases))), \
            contextlib.ExitStack() as files:
        codec = codec_for(geo, codec)
        label = codec.label
        k, m, v = geo.data_shards, geo.parity_shards, len(bases)
        small = geo.small_block_size
        # one volume takes batch_bytes per window; a group shares them, so
        # that a dispatch stays near batch_bytes of host copies, each
        # volume's width floored to whole small blocks (the width
        # sequences must stay block-aligned) and to one block
        vol_batch = batch_bytes if v == 1 \
            else max(small, batch_bytes // v // small * small)
        dats = [_open_dat(b) for b in bases]
        outputs = [[files.enter_context(open(b + to_ext(i), "wb"))
                    for i in range(geo.total_shards)] for b in bases]
        sentinel = object()

        def produce():
            iters = [_iter_encode_batches(dat, size, geo, vol_batch)
                     for dat, size in dats]
            for gathers in itertools.zip_longest(*iters,
                                                 fillvalue=sentinel):
                # misalignment here would interleave volumes' bytes into
                # the wrong shards, so fail rather than truncate
                if any(g is sentinel for g in gathers) \
                        or len({w for w, _ in gathers}) != 1:
                    raise RuntimeError(
                        "same-shard-size volumes must batch in lockstep")
                width = gathers[0][0]
                with stage("ec_read", label, "encode"):
                    staged = staging(codec.device, (k, v * width))
                    data = staged.numpy().reshape(k, v, width)
                    for vi, (_, gather) in enumerate(gathers):
                        gather(data[:, vi])
                yield data, codec.encode_begin(staged, volumes=v)

        def consume(item):
            data, fetch = item
            # one write stage per window; the wait for the parity, between
            # the data and the parity writes, is a stage of its own
            with stage("ec_write", label, "encode"):
                for vi, shards in enumerate(outputs):
                    for s in range(k):
                        shards[s].write(data[s, vi])
                parity = fetch().reshape(m, v, -1)
                for vi, shards in enumerate(outputs):
                    for p in range(m):
                        shards[k + p].write(parity[p, vi])

        _pipelined(produce(), consume, label, "encode")


def rebuild_ec_files(base_path: str, geo: "EcGeometry | None" = None,
                     codec: "Codec | None" = None,
                     batch_bytes: int = DEFAULT_BATCH_BYTES,
                     stats: "dict | None" = None) -> list[int]:
    """Regenerate every missing .ecNN from the surviving ones
    (RebuildEcFiles ec_encoder.go:61/233).  Returns rebuilt shard ids.

    `stats`, when given, is filled with the rebuild's read accounting
    ({"bytes_read", "plan_kind", ...}): how the clay and LRC repair-IO
    advantages are measured.  RS volumes take the RS rebuild loop
    `_rebuild_rs_volumes` with one volume, clay and LRC volumes
    codes.rebuild_clay and codes.rebuild_lrc.  The job ec.rebuild, named
    by the volume's base name."""
    with job("ec.rebuild", os.path.basename(base_path)):
        if geo is None:
            from . import geometry_from_vif
            geo = geometry_from_vif(base_path)
        n = geo.total_shards
        have = [os.path.exists(base_path + to_ext(i)) for i in range(n)]
        missing = [i for i in range(n) if not have[i]]
        if not missing:
            return []
        if sum(have) < geo.data_shards:
            raise ValueError(f"need >= {geo.data_shards} shards to "
                             f"rebuild, have {sum(have)}")
        codec = codec_for(geo, codec)
        if geo.code_kind == "clay":
            return rebuild_clay(base_path, geo, missing, batch_bytes, codec,
                                stats=stats)
        if geo.code_kind == "lrc":
            return rebuild_lrc(base_path, geo, missing, batch_bytes, codec,
                               stats=stats)
        return _rebuild_rs_volumes([base_path], geo, have, codec,
                                   batch_bytes, stats)


def _rebuild_rs_volumes(bases: list[str], geo: EcGeometry, have, codec,
                        batch_bytes: int,
                        stats: "dict | None" = None) -> list[int]:
    """The RS rebuild loop of V >= 1 volumes that share the geometry, the
    loss mask `have` (one bool per shard) and the shard size.  Returns
    the rebuilt shard ids.

    Per window, each volume's first k survivors (the ids `used`, the same
    for every volume) are gathered into its columns of one [k, V * width]
    staging buffer, which the codec uploads as it is; ONE dispatch
    rebuilds the missing rows of every volume, and a writer thread
    appends each volume's columns of them to its files.  Queued with the
    window, the buffer stays valid until the window is written.  `stats`,
    when given, gets the bytes gathered ("bytes_read"), "plan_kind" and
    the ids read ("read_shards")."""
    label = codec.label
    n, k, v = geo.total_shards, geo.data_shards, len(bases)
    missing = [i for i in range(n) if not have[i]]
    used = [i for i in range(n) if have[i]][:k]
    inputs = [{i: np.memmap(b + to_ext(i), dtype=np.uint8, mode="r")
               for i in range(n) if have[i]} for b in bases]
    shard_size = len(inputs[0][used[0]])
    for b, shards in zip(bases, inputs):
        for i, arr in shards.items():
            if len(arr) != shard_size:
                raise ValueError(
                    f"{b} shard {i}: size {len(arr)} != {shard_size}")
    # one volume takes batch_bytes per window; a group shares them, so
    # that a dispatch stays near k * batch_bytes of host copies, each
    # volume's width floored to 4 KB, which only bounds the syscall count
    window = batch_bytes if v == 1 else max(4096, batch_bytes // v)
    gathered = 0

    def produce():
        nonlocal gathered
        for off in range(0, shard_size, window):
            width = min(window, shard_size - off)
            with stage("ec_read", label, "rebuild"):
                staged = staging(codec.device, (k, v * width))
                cols = staged.numpy().reshape(k, v, width)
                for vi, shards in enumerate(inputs):
                    for row, i in enumerate(used):
                        cols[row, vi] = shards[i][off:off + width]
            gathered += staged.nbytes
            yield staged, codec.reconstruct_rows_begin(staged, used, missing,
                                                       volumes=v)

    def consume(item):
        _, fetch = item
        rebuilt = fetch().reshape(len(missing), v, -1)
        with stage("ec_write", label, "rebuild"):
            for vi, shards in enumerate(outputs):
                for row, i in enumerate(missing):
                    shards[i].write(rebuilt[row, vi])

    with contextlib.ExitStack() as files:
        outputs = [{i: files.enter_context(open(b + to_ext(i), "wb"))
                    for i in missing} for b in bases]
        _pipelined(produce(), consume, label, "rebuild")
    if stats is not None:
        stats["bytes_read"] = gathered
        stats["plan_kind"] = "rs-full"
        stats["read_shards"] = used
    return missing


def rebuild_ec_files_batch(base_paths: list[str],
                           batch_bytes: int = DEFAULT_BATCH_BYTES,
                           codec: "Codec | None" = None
                           ) -> dict[str, list[int]]:
    """Fleet rebuild: regenerate missing shards across MANY volumes with
    batched codec calls.

    RS volumes sharing (geometry, loss mask, shard size) go through the RS
    rebuild loop together (`_rebuild_rs_volumes`): every window is ONE
    device round for the whole group, and a volume of its own is a group
    of one.  Clay and LRC volumes rebuild one by one (their reduced-IO
    repairs in codes.py).  The caller's `codec` serves the RS volumes; the
    other kinds get codecs of their own on its mesh or device (the default
    without one).  Returns {base_path: rebuilt shard ids}."""
    from . import geometry_from_vif
    groups: dict[tuple, list[str]] = {}
    for base in base_paths:
        geo = geometry_from_vif(base)
        require_ported(geo)
        n = geo.total_shards
        have = tuple(os.path.exists(base + to_ext(i)) for i in range(n))
        if all(have):
            continue
        if sum(have) < geo.data_shards:
            raise ValueError(f"{base}: need >= {geo.data_shards} shards, "
                             f"have {sum(have)}")
        size = os.path.getsize(base + to_ext(
            next(i for i in range(n) if have[i])))
        groups.setdefault((geo, have, size), []).append(base)

    out: dict[str, list[int]] = {b: [] for b in base_paths}
    device = None if codec is None else codec.mesh or codec.device
    for (geo, have, _), bases in groups.items():
        if geo.code_kind != "rs":
            kind_codec = codec_for(geo, device=device)
            for b in bases:
                out[b] = rebuild_ec_files(b, geo, codec=kind_codec,
                                          batch_bytes=batch_bytes)
            continue
        with job("ec.rebuild", ",".join(map(os.path.basename, bases))):
            missing = _rebuild_rs_volumes(bases, geo, have,
                                          codec_for(geo, codec), batch_bytes)
        for b in bases:
            out[b] = list(missing)
    return out


def write_sorted_file_from_idx(base_path: str, ext: str = ".ecx") -> None:
    """<base>.idx -> <base>.ecx: live entries, ascending key order
    (WriteSortedFileFromIdx ec_encoder.go:27-54): last write per key wins,
    drop tombstoned/zero-offset keys, sort by key."""
    with open(base_path + ".idx", "rb") as f:
        arr = parse_index_bytes(f.read())
    if len(arr):
        # keep only the LAST entry per key (np.unique keeps the first ->
        # reverse first), then drop deletions
        rev = arr[::-1]
        _, first_idx = np.unique(rev["key"], return_index=True)
        latest = rev[first_idx]  # unique returns sorted keys
        live = latest[(latest["size"] != TOMBSTONE_FILE_SIZE)
                      & (latest["offset"] != 0)]
    else:
        live = arr
    with open(base_path + ext, "wb") as out:
        out.write(index_array_to_bytes(live))
