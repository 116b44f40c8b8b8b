"""MeshCodec: the multi-device EC codec.

`ops.codec.RSCodec` is the single-device codec; this is its drop-in mesh
version (same host API, numpy in and out), which `codec_for_devices` and
`storage.ec.encoder.codec_for` build when a caller passes a `Mesh`:

- encode: stripe columns are independent, so the byte axis is split over
  every position (both mesh axes) and each runs its local product: no
  communication.
- reconstruct: the first k surviving shards are split over the "s" axis
  (as they live on distinct servers) and the byte axis over "b"; each
  position multiplies its column block of the decode matrix
  (sharded_codec.make_shard_parallel_matmul), and the partials are
  XOR-reduced over "s" onto its first position (`xor_reduce`).

Batched [V, k, B] data and [V, B] shards keep their volumes: the byte axis
of each volume is split, and stripe columns are independent, so the bytes
equal the single-device codec's.  `clay_mesh_encode_begin` and
`gf_mesh_encode_begin` are the Clay and LRC window codecs' mesh arms.

One process drives the mesh: the volume server builds a codec per RPC, so
a process group per request is out of the question, and one GPU cannot
hold two NCCL ranks.  Every local product is one launch of a hand-written
kernel on that position's device.

The mesh is the caller's choice.  The JAX package picks its mesh by
itself on a host with several devices; here a host with several GPUs
still encodes on one unless a caller passes a `Mesh`, since this mesh has
not yet run on two real GPUs nor beaten RSCodec end to end (ROADMAP).
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from ..ops import clay_structured, rs_cuda, rs_matrix
from ..ops.codec import RSCodec, metered_fetch
from . import sharded_codec
from .mesh import Mesh, gather_begin, local_devices, shard


def default_ec_mesh(devices=None) -> Mesh:
    """("s", "b") mesh over every CUDA device (or the given devices).

    Both axes are populated whenever the device count allows (b=2 from 4
    devices up), so reconstruct runs the combined shard-axis reduce and
    byte-axis split: 8 devices give s=4, b=2; 16 give s=8, b=2."""
    devices = list(devices) if devices is not None else local_devices()
    n = len(devices)
    b = 2 if n % 2 == 0 and n >= 4 else 1
    return Mesh(np.asarray(devices, dtype=object).reshape(n // b, b),
                ("s", "b"))


@functools.lru_cache(maxsize=4096)
def _decode_bits_cached(k: int, m: int, kind: str, k_pad: int,
                        present: tuple, chunk: tuple) -> np.ndarray:
    """Padded decode bit matrix [8 * len(chunk), 8 * k_pad] of one loss
    mask.  Masks repeat across rebuild windows and across volumes in a
    fleet rebuild: the GF inversion and the bit expansion are host work
    worth doing once per mask.  The JAX package pads to m rows for its one
    compiled program; the kernel takes any row count, so only the chunk's
    rows are computed."""
    gen = rs_matrix.generator_matrix(k, m, kind)
    D = rs_matrix.decode_matrix(gen, list(present), list(chunk))
    return sharded_codec.pad_decode_bits(D, len(chunk), k, k_pad)


class MeshCodec:
    """RSCodec's host API (encode / encode_begin / reconstruct /
    reconstruct_begin / verify); mesh-parallel device work."""

    def __init__(self, data_shards: int = rs_matrix.DEFAULT_DATA_SHARDS,
                 parity_shards: int = rs_matrix.DEFAULT_PARITY_SHARDS,
                 *, kind: str = "vandermonde", mesh: "Mesh | None" = None):
        self.mesh = mesh if mesh is not None else default_ec_mesh()
        # the device of its host staging, as a window codec's on a mesh
        self.device = self.mesh.devices.flat[0]
        if self.mesh.axis_names != ("s", "b"):
            raise ValueError(f"MeshCodec needs an (s, b) mesh "
                             f"(default_ec_mesh), got {self.mesh}")
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        self.kind = kind
        self.backend = "mesh"
        self.label = "rs_mesh"    # the backend label of its codec metrics
        self.gen = rs_matrix.generator_matrix(self.k, self.m, kind)
        self.parity_pm = rs_cuda.to_plane_major(
            rs_matrix.parity_bit_matrix(self.k, self.m, kind), self.m, self.k)
        self._recon, self.k_pad = sharded_codec.make_shard_parallel_matmul(
            self.mesh, "s", self.k, self.m, byte_axis="b")
        self._rec_mult = sharded_codec.local_block_multiple(self.mesh, ("b",))

    # -- device programs (mesh arrays in and out) ---------------------------
    def encode_device(self, blocks: np.ndarray) -> np.ndarray:
        """Parity of each position's [.., k, B_loc] data block: one local
        product per position."""
        planes = sharded_codec.mesh_planes(self.mesh, None, [self.parity_pm])
        return sharded_codec.local_products(self.mesh, planes, blocks)

    def reconstruct_device(self, present: tuple, chunk: tuple,
                           shards: np.ndarray) -> np.ndarray:
        """The shards `chunk` (at most m) rebuilt from the first k of
        `present`, laid out [k_pad, B] over ("s", "b"): each position's
        partial product, XOR-reduced over "s"; [len(chunk), B_loc] at the
        positions of s index 0, None at the others."""
        return self._recon(_decode_bits_cached(
            self.k, self.m, self.kind, self.k_pad, tuple(present[:self.k]),
            tuple(chunk)), shards)

    # -- RSCodec API -----------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k, B] or [V, k, B] uint8 -> parity [.., m, B] uint8."""
        return self.encode_begin(data)()

    def encode_begin(self, data: np.ndarray, *, volumes: int = 1):
        """Issue the mesh encode asynchronously; returns fetch() -> parity,
        as RSCodec.encode_begin (the seam the pipelined disk paths use),
        `volumes` counted as there."""
        t0 = time.perf_counter()
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim not in (2, 3) or data.shape[-2] != self.k:
            raise ValueError(f"expected [{self.k}, B] or [V, {self.k}, B] "
                             f"data, got {data.shape}")
        fetch = sharded_codec.mesh_matmul_begin(
            self.mesh, self.parity_pm, self.m, data,
            (None,) * (data.ndim - 1) + (self.mesh.axis_names,))
        return metered_fetch(fetch, self.label, "encode", data.nbytes, t0,
                             volumes=volumes * math.prod(data.shape[:-2]))

    def reconstruct(self, shards: list, *,
                    data_only: bool = False) -> list:
        """Fill None slots (enc.Reconstruct / enc.ReconstructData).  Present
        shards share one [B] or [V, B] shape (one loss mask across a
        batch of volumes)."""
        return self.reconstruct_begin(shards, data_only=data_only)()

    def reconstruct_begin(self, shards: list, *, data_only: bool = False):
        """Async form of reconstruct: every chunk of at most m targets is
        issued before returning; fetch() drains them."""
        t0 = time.perf_counter()
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots, got "
                             f"{len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        targets = [i for i, s in enumerate(shards) if s is None
                   and (not data_only or i < self.k)]
        if len(present) < self.k:
            raise ValueError(
                f"too few shards to reconstruct: {len(present)} < {self.k}")
        if not targets:
            res = list(shards)
            return lambda: res
        chosen = np.stack([np.asarray(shards[i], dtype=np.uint8)
                           for i in present[:self.k]])
        if chosen.ndim not in (2, 3):
            raise ValueError(
                "MeshCodec.reconstruct expects [B] or [V, B] shards")
        lead = chosen.shape[1:-1]        # () or (V,)
        pending = self._reconstruct_issue(
            present, targets, chosen.reshape(self.k, -1))

        def fetch():
            out = list(shards)
            for t, row in zip(targets, pending()):
                out[t] = row.reshape(*lead, -1)
            return out
        volumes = lead[0] if lead else 1
        return metered_fetch(fetch, self.label, "reconstruct", chosen.nbytes,
                             t0, volumes=volumes)

    def reconstruct_rows_begin(self, survivors: np.ndarray, used, targets,
                               *, volumes: int = 1):
        """RSCodec.reconstruct_rows_begin on the mesh: `survivors` [k, B]
        holds the shards `used` in that row order, its bytes spanning
        `volumes` volumes; only `targets` are rebuilt.  Returns fetch() ->
        [len(targets), B]."""
        t0 = time.perf_counter()
        survivors = np.asarray(survivors, dtype=np.uint8)
        if survivors.ndim != 2 or survivors.shape[0] != self.k \
                or len(used) != self.k:
            raise ValueError(f"expected [{self.k}, B] survivors of "
                             f"{self.k} shards, got {survivors.shape} of "
                             f"{len(used)}")
        pending = self._reconstruct_issue(list(used), list(targets),
                                          survivors)
        return metered_fetch(lambda: np.stack(pending()), self.label,
                             "reconstruct", survivors.nbytes, t0,
                             volumes=volumes)

    def _reconstruct_issue(self, present: list, targets: list,
                           flat: np.ndarray):
        """Lay `flat` [k, B] (the first k of `present`, in order) out on
        the mesh and issue `targets` in chunks of at most m; `flat` is
        copied before this returns.  Returns a drain: the rows of
        `targets`, in order."""
        b = flat.shape[-1]
        padded = (self.k_pad, -(-b // self._rec_mult) * self._rec_mult)
        pending = []
        with self.mesh.issue():
            parts = shard(self.mesh, flat, ("s", "b"), padded)
            for i in range(0, len(targets), self.m):
                chunk = tuple(targets[i:i + self.m])
                rec = self.reconstruct_device(tuple(present), chunk, parts)
                pending.append(gather_begin(
                    self.mesh, rec, (None, "b"), (len(chunk), b)))

        def drain():
            return [row for part in pending for row in part()]
        return drain

    def verify(self, shards: list) -> bool:
        """Check parity consistency (reference enc.Verify)."""
        data = np.stack(shards[:self.k], axis=-2)
        parity = np.stack(shards[self.k:], axis=-2)
        return bool(np.array_equal(self.encode(data), parity))


def gf_mesh_encode_begin(M: np.ndarray, data: np.ndarray,
                         mesh: "Mesh | None" = None):
    """Generic parity = M ∘GF∘ data[ki, B] with the byte axis split over
    every mesh position, each on the GF(2^8) kernel: the LRC window codec's
    mesh arm (LRC encode is per byte column, like RS, with another
    matrix).  Returns fetch() -> [mo, B]."""
    mesh = mesh if mesh is not None else default_ec_mesh()
    M = np.ascontiguousarray(M, dtype=np.uint8)
    mo, ki = M.shape
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim != 2 or data.shape[0] != ki:
        raise ValueError(f"gf_mesh_encode_begin: M {M.shape} and data "
                         f"{data.shape} do not chain")
    pm = rs_cuda.to_plane_major(rs_matrix.bit_matrix(M), mo, ki)
    return sharded_codec.mesh_matmul_begin(mesh, pm, mo, data,
                                           (None, mesh.axis_names))


def clay_mesh_device(k: int, m: int, blocks: np.ndarray, small: int,
                     mesh: Mesh) -> np.ndarray:
    """Each position's windows [k, W_loc] -> parity [m, W_loc] through
    clay_structured.encode_device (one fused-kernel launch per position).
    Clay's transform is window-local, so there is no communication."""
    out = np.empty(mesh.devices.shape, dtype=object)
    with mesh.issue():
        for dev, stream in mesh.streams().items():
            # the cache may drop the solve planes while the stream reads
            clay_structured.solve_planes(k, m, None, dev).record_stream(
                stream)
        for pos in mesh.positions():
            out[pos] = clay_structured.encode_device(k, m, blocks[pos],
                                                     small=small)
    return out


def clay_mesh_encode_begin(k: int, m: int, data: np.ndarray, small: int,
                           mesh: "Mesh | None" = None):
    """Multi-device clay window encode of data [k, W] (W a multiple of the
    small block); returns fetch() -> parity [m, W].  The windows are split
    over every position; W pads up to whole windows per position with zero
    windows, which encode to zero parity (clay is linear), and the pad is
    stripped."""
    mesh = mesh if mesh is not None else default_ec_mesh()
    data = np.asarray(data, dtype=np.uint8)
    w = data.shape[-1]
    if data.ndim != 2 or data.shape[0] != k or w % small:
        raise ValueError(f"expected [{k}, n * {small}] window bytes, got "
                         f"{data.shape}")
    per = small * mesh.size
    spec = (None, mesh.axis_names)
    with mesh.issue():
        blocks = shard(mesh, data, spec, (k, -(-w // per) * per))
        return gather_begin(mesh, clay_mesh_device(k, m, blocks, small, mesh),
                            spec, (m, w))


def multi_device_host() -> bool:
    """Does this process see more than one CUDA device, so that a mesh over
    them (default_ec_mesh()) is worth a caller's asking?"""
    return torch.cuda.device_count() > 1


def codec_for_devices(k: int, m: int, *, kind: str = "vandermonde",
                      device=None):
    """The RS picker: MeshCodec on a `Mesh`, else RSCodec on `device` (CUDA
    by default, also on a host with several GPUs: see the module
    docstring)."""
    if isinstance(device, Mesh):
        return MeshCodec(k, m, kind=kind, mesh=device)
    return RSCodec(k, m, kind=kind, device=device)
