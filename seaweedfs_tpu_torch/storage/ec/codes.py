"""Beyond-RS erasure codes over the same shard-file layout: Clay, the MSR
regenerating code, and LRC, the locally repairable code.

`EcGeometry.code_kind` selects the family; shard file names, .ecx, the
locate math, mounting and reads are unchanged, because the codes are
systematic: data shards are byte-identical to RS's.  Only parity
generation and rebuild differ.

Symbol layout (clay): every `small_block_size` window of a shard is
[alpha, small/alpha] layer-major — layer z of window w occupies bytes
[w*small + z*w_a, +w_a) of the shard file.  Single-node repair therefore
reads only the beta = alpha/q plane layers of each helper window — real
partial-range file reads, 1/q of the repair IO of RS at the same storage
overhead.

Execution: the clay encode and single-loss repair each run as one launch of
a fused kernel (ops/clay_structured.py over csrc/clay_fused.cu); a clay
multi-loss rebuild, a clay degraded read and every LRC product apply a
matrix from the numpy oracles (ops/clay_matrix.py, ops/lrc.py) through
codec.gf_apply on the device.  LRC is scalar per byte column like RS, so
its advantage lives in the rebuild planner (lrc.plan_repair): a single loss
reads one local group.

On a device mesh (a `Mesh` passed as the device) both window codecs
encode through the mesh arms of parallel/mesh_codec.py: the clay windows
split over every position, each on the fused encode kernel, and the LRC
parity rows on the GF(2^8) kernel at every position.  Rebuilds, repairs
and degraded reads stay on one device, the mesh's first position.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ...ops import clay_matrix, clay_structured, lrc
from ...ops.codec import (codec_metrics, device_call_begin, gf_apply,
                          metered_fetch, resolve_device, stage, waited)
from ...parallel.mesh import Mesh
from ...parallel.mesh_codec import (clay_mesh_encode_begin,
                                    gf_mesh_encode_begin)
from .layout import EcGeometry, to_ext

CODE_KINDS = ("rs", "clay", "lrc")


def require_ported(geo: EcGeometry) -> None:
    """Raise for a code kind neither package knows."""
    if geo.code_kind not in CODE_KINDS:
        raise ValueError(f"unknown code_kind {geo.code_kind!r}")


def window_codec_for(geo: EcGeometry, *, device=None):
    """The encode codec write_ec_files uses for non-RS kinds, on `device`:
    a torch device or a `Mesh` (see `placement`)."""
    require_ported(geo)
    if geo.code_kind == "clay":
        return ClayWindowCodec(geo, device=device)
    if geo.code_kind == "lrc":
        return LrcWindowCodec(geo, device=device)
    raise ValueError(f"{geo.code_kind!r} has no window codec")


def placement(device) -> tuple:
    """(mesh, device) of a window codec.  A `Mesh` encodes on the mesh and
    rebuilds on its first position; any other device is the one device
    (None: CUDA)."""
    if isinstance(device, Mesh):
        return device, device.devices.flat[0]
    return None, resolve_device(device)


def lrc_geometry(geo: EcGeometry) -> lrc.LrcGeometry:
    if not geo.lrc_locals or geo.data_shards % geo.lrc_locals:
        raise ValueError(
            f"lrc needs lrc_locals dividing k: k={geo.data_shards} "
            f"l={geo.lrc_locals}")
    return lrc.LrcGeometry(k=geo.data_shards, l=geo.lrc_locals,
                           r=geo.parity_shards - geo.lrc_locals)


class LrcWindowCodec:
    """LRC encode: the [l + r, k] parity rows of the generator applied to
    [k, W] data, through gf_apply (the bit-plane product) on one device, or
    on a mesh through gf_mesh_encode_begin (the GF(2^8) kernel at every
    position).  `device` as `placement` takes it."""

    label = "lrc"     # the backend label of its codec metrics

    def __init__(self, geo: EcGeometry, *, device=None):
        self.geo = geo
        self.lgeo = lrc_geometry(geo)
        self.k = geo.data_shards
        self.m = geo.parity_shards
        self.mesh, self.device = placement(device)
        self.parity_rows = np.ascontiguousarray(
            lrc.generator_matrix(self.lgeo)[self.k:])

    def encode(self, data: np.ndarray) -> np.ndarray:
        return self.encode_begin(data)()

    def encode_begin(self, data: np.ndarray, *, volumes: int = 1):
        """Encode data [k, W]; returns fetch() -> parity [m, W].  `volumes`
        is how many volumes the bytes span (encode_ec_files_batch folds a
        group onto the byte axis)."""
        t0 = time.perf_counter()
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.k:
            raise ValueError(f"expected [{self.k}, W] data, got {data.shape}")
        if self.mesh is not None:
            fetch = gf_mesh_encode_begin(self.parity_rows, data, self.mesh)
        else:
            parity = gf_apply(self.parity_rows, data, device=self.device,
                              metered=(self.label, "encode"))
            fetch = lambda: parity  # noqa: E731
        return metered_fetch(fetch, self.label, "encode", data.nbytes, t0,
                             volumes=volumes)


class ClayWindowCodec:
    """Clay encode and single-loss repair on one device.  Each small-block
    window's [k, small] bytes are viewed as [k, alpha, small/alpha]
    layer-major symbols and encoded by the fused structured kernel
    (uncouple -> [m, k0] layer MDS -> couple in one launch): bit-identical
    to the flat [m*alpha, k*alpha] generator at ~alpha times fewer GF
    multiplies.  On a mesh the windows split over every position
    (clay_mesh_encode_begin); the repair runs on one device.  `device` as
    `placement` takes it."""

    label = "clay"    # the backend label of its codec metrics

    def __init__(self, geo: EcGeometry, *, device=None):
        self.geo = geo
        self.k = geo.data_shards
        self.m = geo.parity_shards
        self.code = clay_matrix.code(self.k, self.m)
        if geo.small_block_size % self.code.alpha:
            raise ValueError(
                f"small_block_size {geo.small_block_size} must be a "
                f"multiple of clay alpha {self.code.alpha}")
        self.mesh, self.device = placement(device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def _hold_planes(self, lost: "int | None") -> None:
        """Record the codec's stream on the cached solve planes the next
        launch reads (lost None: the encode's), as RSCodec does for its
        decode planes: the cache may drop them while the stream reads."""
        if self._stream is not None:
            clay_structured.solve_planes(
                self.k, self.m, lost, self.device).record_stream(self._stream)

    def encode(self, data: np.ndarray) -> np.ndarray:
        return self.encode_begin(data)()

    def encode_begin(self, data: np.ndarray, *, volumes: int = 1):
        """Start the encode of data [k, W] (W a multiple of the small
        block) asynchronously; returns fetch() -> parity [m, W].
        `volumes` is how many volumes the bytes span (encode_ec_files_batch
        folds a group onto the byte axis)."""
        t0 = time.perf_counter()
        data = np.asarray(data, dtype=np.uint8)
        small = self.geo.small_block_size
        if data.ndim != 2 or data.shape[0] != self.k \
                or data.shape[1] % small:
            raise ValueError(f"expected [{self.k}, n * {small}] window "
                             f"bytes, got {data.shape}")
        if self.mesh is not None:
            fetch = clay_mesh_encode_begin(self.k, self.m, data, small,
                                           self.mesh)
            return metered_fetch(fetch, self.label, "encode", data.nbytes,
                                 t0, volumes=volumes)
        with stage("codec_submit", self.label, "encode"):
            self._hold_planes(None)
            fetch = device_call_begin(
                self.device, self._stream, data,
                lambda d: clay_structured.encode_device(self.k, self.m, d,
                                                        small=small))
        return waited(metered_fetch(fetch, self.label, "encode", data.nbytes,
                                    t0, volumes=volumes),
                      self.label, "encode")

    def repair(self, lost: int, x4: np.ndarray) -> np.ndarray:
        """The lost shard's windows [n_win, alpha, w_a] from the helpers'
        plane layers x4 [k+m-1, n_win, beta, w_a] (one fused launch)."""
        with stage("codec_submit", self.label, "reconstruct"):
            self._hold_planes(lost)
            fetch = device_call_begin(
                self.device, self._stream, x4,
                lambda x: clay_structured.repair_device_fused(
                    self.k, self.m, lost, x))
        return waited(fetch, self.label, "reconstruct")()


# -- rebuild ---------------------------------------------------------------

def rebuild_lrc(base_path: str, geo: EcGeometry, missing: list[int],
                batch_bytes: int, codec: LrcWindowCodec,
                stats: "dict | None" = None) -> list[int]:
    """LRC rebuild: the planner picks the cheapest read set, one local
    group for a single loss (k/l reads instead of k), a global solve
    otherwise; each window is one gf_apply on the codec's device."""
    t0 = time.perf_counter()
    n = geo.total_shards
    have = [os.path.exists(base_path + to_ext(i)) for i in range(n)]
    plan = lrc.plan_repair(codec.lgeo, missing,
                           available=[i for i in range(n) if have[i]])
    inputs = {i: np.memmap(base_path + to_ext(i), dtype=np.uint8,
                           mode="r") for i in plan.read_shards}
    shard_size = len(next(iter(inputs.values())))
    outputs = {i: open(base_path + to_ext(i), "wb") for i in missing}
    bytes_read = 0
    try:
        for off in range(0, shard_size, batch_bytes):
            width = min(batch_bytes, shard_size - off)
            with stage("ec_read", codec.label, "rebuild"):
                x = np.stack([np.asarray(inputs[i][off:off + width])
                              for i in plan.read_shards])
            bytes_read += x.size
            rec = gf_apply(plan.matrix, x, device=codec.device,
                           metered=(codec.label, "reconstruct"))
            with stage("ec_write", codec.label, "rebuild"):
                for row, t in enumerate(plan.missing):
                    outputs[t].write(rec[row].tobytes())
    finally:
        for f in outputs.values():
            f.close()
    codec_metrics().observe("lrc", "reconstruct", bytes_read,
                            time.perf_counter() - t0)
    if stats is not None:
        stats["bytes_read"] = bytes_read
        stats["read_shards"] = list(plan.read_shards)
        stats["plan_kind"] = plan.kind
    return missing


def rebuild_clay(base_path: str, geo: EcGeometry, missing: list[int],
                 batch_bytes: int, codec: ClayWindowCodec,
                 stats: "dict | None" = None) -> list[int]:
    """Clay rebuild.  One loss: bandwidth-optimal repair reading only the
    beta plane layers of every helper window (beta/alpha = 1/q of each
    helper's bytes) into the fused repair kernel.  Multi-loss: flat decode
    from k full survivors through gf_apply."""
    t0 = time.perf_counter()
    k, m = geo.data_shards, geo.parity_shards
    n = geo.total_shards
    small = geo.small_block_size
    alpha, win_a = codec.code.alpha, small // codec.code.alpha
    have = [os.path.exists(base_path + to_ext(i)) for i in range(n)]
    wins_per_batch = max(1, batch_bytes // small)
    bytes_read = 0

    if len(missing) == 1:
        lost = missing[0]
        helpers, plane, _, _ = clay_structured.repair_parts(k, m, lost)
        inputs = {h: np.memmap(base_path + to_ext(h), dtype=np.uint8,
                               mode="r") for h in helpers}
        shard_size = len(next(iter(inputs.values())))
        if shard_size % small:
            raise ValueError(f"shard size {shard_size} is not a multiple "
                             f"of the small block {small}")
        plane_idx = np.asarray(plane)
        with open(base_path + to_ext(lost), "wb") as out:
            for w0 in range(0, shard_size // small, wins_per_batch):
                wn = min(wins_per_batch, shard_size // small - w0)
                # helper-major [H, wn, beta, win_a]: the gather is the
                # partial-range plane read; the kernel returns the natural
                # [wn, alpha, win_a] layer-major layout, written verbatim
                with stage("ec_read", codec.label, "rebuild"):
                    x4 = np.empty((len(helpers), wn, len(plane), win_a),
                                  dtype=np.uint8)
                    for hi, h in enumerate(helpers):
                        span = inputs[h][w0 * small:(w0 + wn) * small]
                        x4[hi] = span.reshape(wn, alpha, win_a)[:, plane_idx]
                bytes_read += x4.size
                rec = codec.repair(lost, x4)
                with stage("ec_write", codec.label, "rebuild"):
                    out.write(rec.tobytes())
        codec_metrics().observe("clay", "reconstruct", bytes_read,
                                time.perf_counter() - t0)
        if stats is not None:
            stats["bytes_read"] = bytes_read
            stats["plan_kind"] = "clay-plane-fused"
            stats["helpers"] = list(helpers)
            stats["layers_per_helper"] = len(plane)
        return missing

    # multi-loss: flat decode over k full survivors
    present = tuple(i for i in range(n) if have[i])
    D = clay_matrix.decode_flat(k, m, present, tuple(missing))
    chosen = present[:k]
    inputs = {i: np.memmap(base_path + to_ext(i), dtype=np.uint8,
                           mode="r") for i in chosen}
    shard_size = len(next(iter(inputs.values())))
    outputs = {i: open(base_path + to_ext(i), "wb") for i in missing}
    try:
        for w0 in range(0, shard_size // small, wins_per_batch):
            wn = min(wins_per_batch, shard_size // small - w0)
            with stage("ec_read", codec.label, "rebuild"):
                x = np.empty((k * alpha, wn * win_a), dtype=np.uint8)
                for ci, i in enumerate(chosen):
                    span = np.asarray(
                        inputs[i][w0 * small:(w0 + wn) * small])
                    bytes_read += span.size
                    x[ci * alpha:(ci + 1) * alpha] = np.ascontiguousarray(
                        span.reshape(wn, alpha, win_a).transpose(1, 0, 2)
                    ).reshape(alpha, -1)
            rec = gf_apply(D, x, device=codec.device,
                           metered=(codec.label, "reconstruct"))
            with stage("ec_write", codec.label, "rebuild"):
                for row, t in enumerate(missing):
                    part = rec[row * alpha:(row + 1) * alpha]
                    outputs[t].write(np.ascontiguousarray(
                        part.reshape(alpha, wn, win_a).transpose(1, 0, 2)
                    ).tobytes())
    finally:
        for f in outputs.values():
            f.close()
    codec_metrics().observe("clay", "reconstruct", bytes_read,
                            time.perf_counter() - t0)
    if stats is not None:
        stats["bytes_read"] = bytes_read
        stats["plan_kind"] = "clay-decode"
    return missing
