"""EC encode/rebuild: volume files -> shard files, batched through the GPU.

Capability-equivalent to weed/storage/erasure_coding/ec_encoder.go
(WriteEcFiles:57, RebuildEcFiles:61, WriteSortedFileFromIdx:27):

- Each read covers a whole *row batch*: one contiguous [k * block] slice of
  .dat reshapes to the [k, block] stripe matrix, several stripes stack into
  a [k, B] batch, and ONE codec call (the GF(2^8) bit-plane kernel) produces
  all parity for the batch.  Data shards are pure memory views of the read
  buffer; only parity costs compute.
- Rebuild reads all surviving shards' aligned windows into a [n_have, B]
  batch and reconstructs every missing shard in one codec call per window.
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

from ...ops.codec import RSCodec, current_job, job, span, stage
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


class _BufferPool:
    """Cycled preallocated [k, batch] gather buffers.

    The pipeline holds at most PIPELINE_DEPTH queued batches plus one in
    the writer and one being produced, so `PIPELINE_DEPTH + 2` cycled
    buffers are never overwritten while still in flight."""

    def __init__(self, n: int, shape: tuple):
        self._bufs = [np.empty(shape, dtype=np.uint8) for _ in range(n)]
        self._i = 0

    def next(self) -> np.ndarray:
        buf = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        return buf


def _iter_encode_batches(dat, dat_size: int, geo: EcGeometry,
                         batch_bytes: int):
    """Yield one gather per [k, width] data matrix write_ec_files encodes,
    in shard append order: a function that copies the matrix out of .dat
    and returns it.  Large rows first (column slices gathered across the k
    large blocks), then batched small rows, zero-padding the final partial
    row exactly like encodeDataOneBatch (ec_encoder.go:173).

    Call each gather once, in order: the arrays they return are views into
    a cycled buffer pool, each valid until PIPELINE_DEPTH + 1 further
    batches have been gathered."""
    k = geo.data_shards
    large_row = geo.large_row_size()
    small_row = geo.small_row_size()
    block = geo.small_block_size
    # small-row batches are at least one whole block wide even when
    # batch_bytes is smaller (n_rows floors at 1)
    pool = _BufferPool(PIPELINE_DEPTH + 2, (k, max(batch_bytes, block)))

    def gather_large(pos, col, width):
        data = pool.next()[:, :width]
        for s in range(k):
            off = pos + s * geo.large_block_size + col
            data[s] = dat[off:off + width]
        return data

    def gather_small(pos, n_rows):
        data = pool.next()[:, :n_rows * block]
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
        return data

    pos = 0
    remaining = dat_size
    while remaining >= large_row:
        # one large row = k large blocks; stream it in batch_bytes column
        # slices, gathered into a [k, width] matrix
        for col in range(0, geo.large_block_size, batch_bytes):
            width = min(batch_bytes, geo.large_block_size - col)
            yield functools.partial(gather_large, pos, col, width)
        pos += large_row
        remaining -= large_row
    rows_per_batch = max(1, batch_bytes // block)
    while remaining > 0:
        n_rows = min(rows_per_batch,
                     (remaining + small_row - 1) // small_row)
        yield functools.partial(gather_small, pos, n_rows)
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
    """<base>.dat -> <base>.ec00 .. (WriteEcFiles ec_encoder.go:57).

    Pipelined: the calling thread reads batch N+1 from .dat and submits its
    encode while the device computes batch N and a writer thread appends
    batch N-1's shards.  The job ec.encode_volume, named by the volume's
    base name."""
    with job("ec.encode_volume", os.path.basename(base_path)):
        codec = codec_for(geo, codec)
        label = codec.label
        dat, dat_size = _open_dat(base_path)
        outputs = [open(base_path + to_ext(i), "wb")
                   for i in range(geo.total_shards)]
        k = geo.data_shards

        def produce():
            for gather in _iter_encode_batches(dat, dat_size, geo,
                                               batch_bytes):
                with stage("ec_read", label, "encode"):
                    data = gather()
                yield data, codec.encode_begin(data)

        def consume(item):
            data, fetch = item
            # one write stage per batch; the wait for the parity, between
            # the data and the parity writes, is a stage of its own
            with stage("ec_write", label, "encode"):
                for s in range(k):
                    outputs[s].write(data[s])
                parity = fetch()
                for p in range(geo.parity_shards):
                    outputs[k + p].write(parity[p])

        try:
            _pipelined(produce(), consume, label, "encode")
        finally:
            for f in outputs:
                f.close()


def encode_ec_files_batch(base_paths: list[str],
                          geo: EcGeometry = DEFAULT_GEOMETRY,
                          codec: "Codec | None" = None,
                          batch_bytes: int = DEFAULT_BATCH_BYTES) -> None:
    """Fleet encode: <base>.dat -> shard files for MANY volumes with
    batched codec dispatches.

    Volumes that share a shard-file size (ergo the same batch width
    sequence) share every window's codec call: RS stacks them into
    [V, k, width], clay folds them onto the byte axis [k, V*width] (its
    transform is window-local, so concatenated volumes encode independently
    and bit-identically).  Odd-sized volumes take the per-volume path.
    Shard bytes are identical to write_ec_files."""
    groups: dict[int, list[str]] = {}
    for base in base_paths:
        dat_size = os.path.getsize(base + ".dat")
        groups.setdefault(geo.shard_file_size(dat_size), []).append(base)
    for _, bases in sorted(groups.items()):
        if len(bases) == 1:
            write_ec_files(bases[0], geo, codec, batch_bytes)
            continue
        _encode_group(bases, geo, codec, batch_bytes)


def _encode_group(bases: list[str], geo: EcGeometry,
                  codec: "Codec | None", batch_bytes: int) -> None:
    """One same-shard-size group of encode_ec_files_batch: V volumes'
    batch iterators advance in lockstep (equal shard size => provably
    equal width sequences) and every window is one grouped dispatch.  The
    job ec.encode_volume, named by the volumes' base names."""
    with job("ec.encode_volume", ",".join(map(os.path.basename, bases))):
        codec = codec_for(geo, codec)
        label = codec.label
        k, m, v = geo.data_shards, geo.parity_shards, len(bases)
        small = geo.small_block_size
        # per-volume batch width shrinks with group size so the grouped
        # dispatch stays near batch_bytes of host copies total; floored to
        # one small block (width sequences must stay block-aligned)
        vol_batch = max(small, batch_bytes // v // small * small)
        rs = geo.code_kind == "rs"
        dats = [_open_dat(b) for b in bases]
        outputs = [[open(b + to_ext(i), "wb")
                    for i in range(geo.total_shards)] for b in bases]
        sentinel = object()

        def produce():
            iters = [_iter_encode_batches(dat, size, geo, vol_batch)
                     for dat, size in dats]
            for gathers in itertools.zip_longest(*iters,
                                                 fillvalue=sentinel):
                # misalignment here would interleave volumes' bytes into
                # the wrong shards, so fail rather than truncate
                if any(g is sentinel for g in gathers):
                    raise RuntimeError(
                        "same-shard-size volumes must batch in lockstep")
                with stage("ec_read", label, "encode"):
                    parts = [g() for g in gathers]
                    if len({p.shape[1] for p in parts}) != 1:
                        raise RuntimeError(
                            "same-shard-size volumes must batch in lockstep")
                    # stack/concatenate COPY out of the per-volume cycled
                    # pools, so the yielded batch stays valid in the
                    # pipeline
                    data = np.stack(parts) if rs \
                        else np.concatenate(parts, axis=1)
                if rs:     # RSCodec counts the volumes on the leading axis
                    yield data, codec.encode_begin(data)
                else:
                    yield data, codec.encode_begin(data, volumes=v)

        def consume(item):
            data, fetch = item
            width = data.shape[-1] if rs else data.shape[-1] // v
            with stage("ec_write", label, "encode"):
                for vi in range(v):
                    dpart = data[vi] if rs \
                        else data[:, vi * width:(vi + 1) * width]
                    for s in range(k):
                        outputs[vi][s].write(dpart[s])
                parity = fetch()
                for vi in range(v):
                    ppart = parity[vi] if rs \
                        else parity[:, vi * width:(vi + 1) * width]
                    for p in range(m):
                        outputs[vi][k + p].write(ppart[p])

        try:
            _pipelined(produce(), consume, label, "encode")
        finally:
            for files in outputs:
                for f in files:
                    f.close()


def rebuild_ec_files(base_path: str, geo: "EcGeometry | None" = None,
                     codec: "Codec | None" = None,
                     batch_bytes: int = DEFAULT_BATCH_BYTES,
                     stats: "dict | None" = None) -> list[int]:
    """Regenerate every missing .ecNN from the surviving ones
    (RebuildEcFiles ec_encoder.go:61/233).  Returns rebuilt shard ids.

    `stats`, when given, is filled with the rebuild's read accounting
    ({"bytes_read", "plan_kind", ...}): how the clay and LRC repair-IO
    advantages are measured.  Clay and LRC volumes take codes.rebuild_clay
    and codes.rebuild_lrc.  The job ec.rebuild, named by the volume's base
    name."""
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
        label = codec.label
        inputs = {i: np.memmap(base_path + to_ext(i), dtype=np.uint8,
                               mode="r") for i in range(n) if have[i]}
        shard_size = len(next(iter(inputs.values())))
        for i, arr in inputs.items():
            if len(arr) != shard_size:
                raise ValueError(
                    f"shard {i} size {len(arr)} != {shard_size}")
        outputs = {i: open(base_path + to_ext(i), "wb") for i in missing}
        used = [i for i in range(n) if have[i]][:geo.data_shards]

        def produce():
            for off in range(0, shard_size, batch_bytes):
                width = min(batch_bytes, shard_size - off)
                # memmap slices stay lazy; reconstruct materializes only
                # the first k present shards it actually decodes from
                shards: list[np.ndarray | None] = [
                    inputs[i][off:off + width] if have[i] else None
                    for i in range(n)]
                yield codec.reconstruct_begin(shards)

        def consume(fetch):
            rebuilt = fetch()
            with stage("ec_write", label, "rebuild"):
                for i in missing:
                    outputs[i].write(rebuilt[i])

        try:
            _pipelined(produce(), consume, label, "rebuild")
        finally:
            for f in outputs.values():
                f.close()
        if stats is not None:
            stats["bytes_read"] = len(used) * shard_size
            stats["plan_kind"] = "rs-full"
            stats["read_shards"] = used
        return missing


def rebuild_ec_files_batch(base_paths: list[str],
                           batch_bytes: int = DEFAULT_BATCH_BYTES,
                           codec: "Codec | None" = None
                           ) -> dict[str, list[int]]:
    """Fleet rebuild: regenerate missing shards across MANY volumes with
    batched [V, B] codec calls.

    RS volumes sharing (geometry, loss mask, shard size) stack onto the
    codec's leading batch axis and every window is ONE device round for the
    whole group.  Odd-one-out volumes take the single path, and clay and
    LRC volumes rebuild one by one (their reduced-IO repairs in codes.py).
    The caller's `codec` serves the RS volumes; the other kinds get codecs
    of their own on its mesh or device (the default without one).
    Returns {base_path: rebuilt shard ids}."""
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
    device = None if codec is None \
        else getattr(codec, "mesh", None) or codec.device
    for (geo, have, shard_size), bases in groups.items():
        if len(bases) == 1 or geo.code_kind != "rs":
            kind_codec = codec if geo.code_kind == "rs" \
                else codec_for(geo, device=device)
            for b in bases:
                out[b] = rebuild_ec_files(b, geo, codec=kind_codec,
                                          batch_bytes=batch_bytes)
            continue
        n = geo.total_shards
        missing = [i for i in range(n) if not have[i]]
        group_codec = codec_for(geo, codec)
        label = group_codec.label
        inputs = {b: {i: np.memmap(b + to_ext(i), dtype=np.uint8, mode="r")
                      for i in range(n) if have[i]} for b in bases}
        for b in bases:
            for i, arr in inputs[b].items():
                if len(arr) != shard_size:
                    raise ValueError(
                        f"{b} shard {i}: size {len(arr)} != {shard_size}")
        outputs = {b: {i: open(b + to_ext(i), "wb") for i in missing}
                   for b in bases}
        # keep the stacked group near n_have * batch_bytes of host copies
        # regardless of group size; the 4KB floor only bounds syscall count
        window = max(4096, batch_bytes // max(1, len(bases)))

        def produce():
            for off in range(0, shard_size, window):
                width = min(window, shard_size - off)
                shards: list[np.ndarray | None] = [
                    np.stack([np.asarray(inputs[b][i][off:off + width])
                              for b in bases]) if have[i] else None
                    for i in range(n)]
                yield group_codec.reconstruct_begin(shards)

        def consume(fetch):
            rebuilt = fetch()  # missing -> [V, width]
            with stage("ec_write", label, "rebuild"):
                for i in missing:
                    for vi, b in enumerate(bases):
                        outputs[b][i].write(rebuilt[i][vi])

        try:
            with job("ec.rebuild", ",".join(map(os.path.basename, bases))):
                _pipelined(produce(), consume, label, "rebuild")
        finally:
            for b in bases:
                for f in outputs[b].values():
                    f.close()
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
