"""Multi-device EC codec: the GF(2^8) kernel at every mesh position and an
XOR ring between them.

Three parallelism modes, as in the JAX package's sharded codec:

1. Volume data parallel ("v" axis): independent volumes, one block per
   position; no communication.
2. Byte-axis parallel ("b" axis): one volume's stripe columns split over
   positions; encode is columnwise-independent, so no communication
   either.
3. Shard-axis parallel: the k data shards themselves are split over a mesh
   axis (as they live on different volume servers).  Each position
   multiplies its column block of the bit matrix by its local shards, and
   the packed partials are XOR-combined onto the axis's first position by
   `xor_reduce`: n-1 peer copies (`Tensor.to(device)`) each followed by a
   local XOR on packed uint8.  `xor_psum` is the JAX package's all-reduce
   (a ring that leaves the result on every position).  Neither NCCL nor
   XLA has an XOR reduction, and a sum of unpacked bit planes would move
   8x the bytes.

Every local product is one launch of the hand-written kernel
(`ops/rs_cuda.gf_matmul_bits_cuda`, its plain version on CPU positions).
The JAX package feeds its TPU kernel a [k, 8, B/8] shard-major view and
shards the last axis, for the TPU's sublane tiling; stripe columns are
independent, so here the flat byte axis is split into contiguous blocks,
which gives the same bytes.  Arrays on the mesh are mesh arrays
(parallel/mesh.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import rs_cuda, rs_matrix
from . import mesh as meshlib
from .mesh import Mesh

# bytes per row the kernel loads at once (csrc/gf2_matmul.cu's aligned
# 16-byte path); every position's byte block is a whole number of them
ROW_BYTES = 16


def mesh_is_cuda(mesh: Mesh) -> bool:
    """True when the mesh's positions are CUDA devices (the kernels run);
    CPU positions run their plain versions."""
    return next(iter(mesh.devices.flat)).type == "cuda"


def local_block_multiple(mesh: Mesh, byte_axes) -> int:
    """The multiple callers pad B to, so that every position's byte block
    over `byte_axes` is a whole number of ROW_BYTES."""
    return math.prod(mesh.shape[ax] for ax in byte_axes) * ROW_BYTES


def xor_psum(parts: np.ndarray, mesh: Mesh, axis: str) -> np.ndarray:
    """All-reduce XOR over one mesh axis: every position ends with the XOR
    of the blocks of all positions on its line along `axis` (the JAX
    package's, whose shard_map replicates the result).

    A ring of n-1 steps: each position's current block moves to the next
    position on the axis (a peer copy between GPUs), and each position XORs
    what it received into its accumulator.  The accumulator and the block
    in flight stay distinct tensors: `Tensor.to(d)` returns the tensor
    itself when it is on d already (a mesh that repeats a device), so an
    in-place `acc ^= cur` could XOR a block with itself."""
    ax = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    acc, cur = parts.copy(), parts.copy()
    with mesh.issue():
        for _ in range(n - 1):
            nxt = np.empty_like(cur)
            for pos in mesh.positions():
                src = list(pos)
                src[ax] = (pos[ax] - 1) % n
                nxt[pos] = cur[tuple(src)].to(mesh.devices[pos],
                                              non_blocking=True)
            cur = nxt
            for pos in mesh.positions():
                acc[pos] = acc[pos] ^ cur[pos]
    return acc


def xor_reduce(parts: np.ndarray, mesh: Mesh, axis: str) -> np.ndarray:
    """Reduce XOR over one mesh axis onto its first position: the position
    at index 0 of `axis` ends with the XOR of its line's blocks, the others
    hold None.  n-1 peer copies into that position, each XORed into a new
    accumulator (never in place: on a mesh that repeats a device the block
    copied in is the tensor itself).  A product fetched once needs no more:
    gather_begin reads index 0 of every axis its spec does not split, where
    xor_psum would do n times the copies and XORs to replicate the result.

    Each `.to()` between two devices runs on the source's current stream
    (the mesh's, under issue()) after waiting for the destination's, and
    the destination's waits for it, so the XOR there reads a finished
    copy."""
    ax = mesh.axis_names.index(axis)
    out = np.empty(mesh.devices.shape, dtype=object)
    with mesh.issue():
        for pos in mesh.positions():
            if pos[ax]:
                continue
            dev, acc = mesh.devices[pos], parts[pos]
            for i in range(1, mesh.shape[axis]):
                src = list(pos)
                src[ax] = i
                acc = acc ^ parts[tuple(src)].to(dev, non_blocking=True)
            out[pos] = acc
    return out


@functools.lru_cache(maxsize=512)
def _planes_on(pm_bytes: bytes, shape: tuple,
               device: torch.device) -> torch.Tensor:
    """A plane-major bit matrix on `device`.  A CUDA copy is made on the
    device's default stream and waited for, so it belongs to no mesh
    stream; a launch that reads it records its own stream on it."""
    bits = torch.from_numpy(
        np.frombuffer(pm_bytes, dtype=np.uint8).reshape(shape).copy())
    if device.type != "cuda":
        return bits.to(device)
    with torch.cuda.device(device), \
            torch.cuda.stream(torch.cuda.default_stream(device)):
        out = bits.to(device)
        torch.cuda.default_stream(device).synchronize()
        return out


def mesh_planes(mesh: Mesh, axis: "str | None",
                blocks: list) -> np.ndarray:
    """Mesh array of plane-major bit matrices: position p holds
    blocks[p's index on `axis`] (blocks[0] everywhere for axis None),
    uploaded once per device and matrix and cached."""
    ax = None if axis is None else mesh.axis_names.index(axis)
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        pm = blocks[0 if ax is None else pos[ax]]
        dev = mesh.devices[pos]
        t = _planes_on(pm.tobytes(), pm.shape, dev)
        if dev.type == "cuda":
            # the cache may drop the matrix while the mesh stream reads it
            t.record_stream(mesh.streams()[dev])
        out[pos] = t
    return out


@functools.lru_cache(maxsize=4096)
def column_planes(bits_bytes: bytes, m: int, k_loc: int, n: int) -> tuple:
    """The bytes of a shard-major bit matrix [8m, 8*k_loc*n] -> the n
    plane-major column blocks [8m, 8*k_loc] of its shard groups, cut and
    expanded once per matrix: a rebuild reuses its loss mask's decode
    matrix in every window."""
    bits = np.frombuffer(bits_bytes, dtype=np.uint8).reshape(
        8 * m, 8 * k_loc * n)
    w = 8 * k_loc
    return tuple(rs_cuda.to_plane_major(
        np.ascontiguousarray(bits[:, i * w:(i + 1) * w]), m, k_loc)
        for i in range(n))


def local_products(mesh: Mesh, planes: np.ndarray,
                   blocks: np.ndarray) -> np.ndarray:
    """Each position's planes[p] ∘GF∘ blocks[p] (one kernel launch per
    position, on the mesh's streams)."""
    out = np.empty(mesh.devices.shape, dtype=object)
    with mesh.issue():
        for pos in mesh.positions():
            out[pos] = rs_cuda.gf_matmul_bits_cuda(planes[pos], blocks[pos])
    return out


def mesh_matmul_begin(mesh: Mesh, pm: np.ndarray, mo: int,
                      data: np.ndarray, spec: tuple):
    """Modes 1+2, every mesh product without communication (MeshCodec's
    parity, the LRC rows, encode_volumes): data [.., KI, B] laid out by
    `spec`, whose last entry names the axes B is split over (B padded to
    their local_block_multiple with zero columns); each position's product
    with the plane-major matrix `pm` [8*mo, 8*KI]; returns fetch() -> [..,
    mo, B]."""
    mult = local_block_multiple(mesh, meshlib.spec_axes(spec[-1]))
    b = data.shape[-1]
    planes = mesh_planes(mesh, None, [pm])
    with mesh.issue():
        blocks = meshlib.shard(mesh, data, spec,
                               data.shape[:-1] + (-(-b // mult) * mult,))
        return meshlib.gather_begin(mesh,
                                    local_products(mesh, planes, blocks),
                                    spec, data.shape[:-2] + (mo, b))


def encode_volumes(mesh: Mesh, parity_bits: np.ndarray,
                   data: np.ndarray) -> np.ndarray:
    """Modes 1+2 on a (v, b) mesh: data [V, k, B] split (v, -, b) -> parity
    [V, m, B], no communication.  `parity_bits` is the shard-major [8m, 8k]
    matrix (rs_matrix.parity_bit_matrix); V must split evenly over "v"."""
    m, k = parity_bits.shape[0] // 8, parity_bits.shape[1] // 8
    return mesh_matmul_begin(mesh, rs_cuda.to_plane_major(parity_bits, m, k),
                             m, data, ("v", None, "b"))()


def make_shard_parallel_matmul(mesh: Mesh, axis: str, k: int, m: int,
                               byte_axis: "str | None" = None):
    """Mode 3 core: returns (fn, k_pad).  fn(bits_full, shards) -> the mesh
    array of [mo, B_loc] products, XOR-reduced onto index 0 of `axis`
    (xor_reduce: None at the other positions; gather_begin reads there).

    bits_full: shard-major [8*mo, 8*k_pad] matrix (numpy), mo <= m; k is
    padded to a multiple of the axis size with zero shards, which add
    nothing to the XOR.  Its column blocks are cut, expanded and uploaded
    once per matrix.  shards: mesh array of the [k_pad, B] shards laid out
    by `shard(mesh, x, (axis, byte_axis))`: each position holds its
    k_pad/n shards and, with `byte_axis`, its block of the byte axis
    (modes 2+3, the layout of MeshCodec's reconstruct); B must then be a
    multiple of local_block_multiple(mesh, (byte_axis,)).  The bit matrix
    is an input, so one fn serves encode and every loss mask."""
    n_dev = mesh.shape[axis]
    k_pad = -(-k // n_dev) * n_dev
    k_loc = k_pad // n_dev

    def fn(bits_full: np.ndarray, shards: np.ndarray) -> np.ndarray:
        rows, cols = bits_full.shape
        if cols != 8 * k_pad or rows % 8 or not 0 < rows <= 8 * m:
            raise ValueError(f"bit matrix {bits_full.shape}: want [8 * mo, "
                             f"{8 * k_pad}] with mo <= {m}")
        bits = np.ascontiguousarray(bits_full, dtype=np.uint8)
        planes = mesh_planes(mesh, axis, column_planes(
            bits.tobytes(), rows // 8, k_loc, n_dev))
        return xor_reduce(local_products(mesh, planes, shards), mesh, axis)
    return fn, k_pad


def make_shard_parallel_encoder(mesh: Mesh, axis: str, k: int, m: int,
                                kind: str = "vandermonde"):
    """Mode 3 encode: (fn(shards) -> mesh array of parity [m, B_loc] at
    index 0 of `axis`, k_pad), shards laid out as for
    make_shard_parallel_matmul, whose fn this is with the parity matrix
    bound."""
    matmul, k_pad = make_shard_parallel_matmul(mesh, axis, k, m)
    gen = rs_matrix.generator_matrix(k, m, kind)
    full = np.zeros((m, k_pad), dtype=np.uint8)
    full[:, :k] = gen[k:]
    return functools.partial(matmul, rs_matrix.bit_matrix(full)), k_pad


def make_shard_parallel_reconstructor(mesh: Mesh, axis: str, k: int, m: int,
                                      kind: str = "vandermonde"):
    """Mode 3 degraded read / rebuild: make_shard_parallel_matmul's
    fn(dec_bits[8*mo, 8*k_pad], shards), the decode bit matrix built on the
    host per loss mask (pad_decode_bits)."""
    return make_shard_parallel_matmul(mesh, axis, k, m)


def pad_decode_bits(D: np.ndarray, m: int, k: int, k_pad: int) -> np.ndarray:
    """Host helper: decode matrix [t, k] -> padded bit matrix [8m, 8*k_pad]."""
    full = np.zeros((m, k_pad), dtype=np.uint8)
    full[:D.shape[0], :k] = D
    return rs_matrix.bit_matrix(full)
