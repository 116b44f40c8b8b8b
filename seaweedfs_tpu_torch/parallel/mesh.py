"""Device meshes for the distributed EC engine: one process driving a grid
of torch devices.

The JAX package shards its codec over a `jax.sharding.Mesh` with
`shard_map`: one program, one process, every local device.  This is the
same program shape on torch: a `Mesh` is a numpy object array of
`torch.device` with named axes, an array laid out on it is a "mesh array"
(a numpy object array shaped like `mesh.devices` holding each position's
block as a tensor on that position's device), and code over it loops over
the positions.  `shard` and `gather_begin` move a host array onto and off
the mesh by a partition spec, as `PartitionSpec` names them: one entry per
array dimension, None (whole on every position), an axis name, or a tuple
of axis names (split over their product, the first axis the major one).

Positions may repeat a device.  That is how the tests run the mesh
program on `[torch.device("cpu")] * 8` (the counterpart of the 8 virtual
CPU devices tests/conftest.py gives JAX) and how one GPU runs it as a
virtual mesh of `cuda:0` repeated.

Streams: every CUDA device of a mesh gets one side stream of the mesh's
own, and `Mesh.issue()` makes each of them current on its device, after
making it wait for the stream that was current there: whatever the caller
issued before (a mesh array built on the default stream, say) is complete
before the mesh reads it.  Work issued under it is ordered per device on
that stream; a copy between two devices (`Tensor.to(other)`) is ordered
by PyTorch against the current streams of both its source and its
destination, so a peer copy issued under `issue()` waits for the partial
it reads and is waited on by the XOR that reads its result.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import numpy as np
import torch


class Mesh:
    """A grid of torch devices with named axes: `devices` (numpy object
    array of torch.device), `axis_names`, `shape[axis]` (the axis size) and
    `size`, as the JAX package reads them off a jax Mesh."""

    def __init__(self, devices, axis_names: tuple):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [_indexed(torch.device(d)) for d in grid.flat]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device grid")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._streams: "dict | None" = None
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"

    def positions(self):
        """Every position's index tuple, row-major."""
        return np.ndindex(self.devices.shape)

    def streams(self) -> dict:
        """{CUDA device: the mesh's stream on it}, made on first use."""
        with self._lock:
            if self._streams is None:
                cuda = dict.fromkeys(d for d in self.devices.flat
                                     if d.type == "cuda")
                self._streams = {d: torch.cuda.Stream(d) for d in cuda}
            return self._streams

    @contextlib.contextmanager
    def issue(self):
        """Make the mesh's stream current on each of its CUDA devices, once
        it has waited for the stream current there before (a no-op on a
        mesh of CPU positions)."""
        with contextlib.ExitStack() as stack:
            for dev, stream in self.streams().items():
                before = torch.cuda.current_stream(dev)
                if before != stream:
                    stream.wait_stream(before)
                stack.enter_context(torch.cuda.stream(stream))
            yield


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its index: "cuda" is the current CUDA device, so that
    tensors' devices, the per-device caches and the mesh's stream keys all
    name one device one way."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> list:
    """Every CUDA device of this process.  Raises where there is none: the
    port never builds a mesh on the CPU by itself (pass the devices)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "seaweedfs_tpu_torch runs on CUDA GPUs and none is available; "
            "pass devices=[torch.device('cpu')] * n to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_volume: "int | None" = None, n_byte: int = 1,
              devices=None) -> Mesh:
    """(v, b) mesh over every CUDA device (or the given devices); the
    default is pure volume data parallelism."""
    devices = list(devices) if devices is not None else local_devices()
    if n_volume is None:
        n_volume = len(devices) // n_byte
    if n_volume * n_byte != len(devices):
        raise ValueError(f"mesh ({n_volume}, {n_byte}) does not cover "
                         f"{len(devices)} devices")
    return Mesh(np.asarray(devices, dtype=object).reshape(n_volume, n_byte),
                ("v", "b"))


def spec_axes(entry) -> tuple:
    """The mesh axes one partition-spec entry splits over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_slices(mesh: Mesh, spec: tuple, shape: tuple,
                  pos: tuple) -> tuple:
    """The slices of a `shape` array that position `pos` holds under
    `spec`.  Each split dimension must divide evenly (callers pad)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a {len(shape)}-d array")
    out = []
    for dim, entry in zip(shape, spec):
        n, idx = 1, 0
        for ax in spec_axes(entry):
            size = mesh.shape[ax]
            n *= size
            idx = idx * size + pos[mesh.axis_names.index(ax)]
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {n} "
                             f"positions ({entry})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard(mesh: Mesh, x: np.ndarray, spec: tuple,
          shape: "tuple | None" = None) -> np.ndarray:
    """Lay the host array `x` out on the mesh: each position gets its block
    under `spec` as a contiguous tensor on its device.  `shape` (default
    x's) may be larger than x: the part of a block outside x is zeros.

    The split happens on the host, one staging copy per position (pinned
    on CUDA, then an async host->device copy on the mesh's stream), never
    as a strided view made contiguous on the device."""
    x = np.asarray(x)
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if len(shape) != x.ndim or any(s < d for s, d in zip(shape, x.shape)):
        raise ValueError(f"shape {shape} does not hold x {x.shape}")
    parts = np.empty(mesh.devices.shape, dtype=object)
    with mesh.issue():
        for pos in mesh.positions():
            parts[pos] = _put(mesh.devices[pos], x,
                              _block_slices(mesh, spec, shape, pos))
    return parts


def _clip(sl: tuple, shape: tuple) -> tuple:
    """(slices, extent) of the part of the block `sl` that lies inside an
    array of `shape`."""
    inner = tuple(slice(s.start, min(s.stop, d)) for s, d in zip(sl, shape))
    return inner, tuple(max(0, s.stop - s.start) for s in inner)


def _put(dev: torch.device, x: np.ndarray, sl: tuple) -> torch.Tensor:
    """The block `sl` of x (zeros where it lies outside x) on `dev`."""
    block = tuple(s.stop - s.start for s in sl)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            staged = torch.empty(block, dtype=torch.uint8, pin_memory=True)
    else:
        staged = torch.empty(block, dtype=torch.uint8)
    buf = staged.numpy()
    inner, have = _clip(sl, x.shape)
    if have != block:
        buf[...] = 0
    if all(have):
        buf[tuple(slice(0, h) for h in have)] = x[inner]
    return staged.to(dev, non_blocking=True) if dev.type == "cuda" \
        else staged


def volume_sharding(mesh: Mesh, data: np.ndarray) -> np.ndarray:
    """[V, k, B] with volumes split over 'v' and bytes over 'b': each
    position's [V/v, k, B/b] block on its device."""
    return shard(mesh, data, ("v", None, "b"))


def gather_begin(mesh: Mesh, parts: np.ndarray, spec: tuple,
                 shape: tuple) -> Callable[[], np.ndarray]:
    """Start copying the mesh array `parts` (laid out by `spec`) to the
    host; returns fetch() -> the numpy array of `shape`, cropped from the
    blocks' (padded) extent.  One position per block is read: index 0 on
    each axis the spec does not split.  On CUDA the device->host copies go
    into pinned buffers on the mesh's streams, and fetch() waits on an
    event per device."""
    split = {ax for entry in spec for ax in spec_axes(entry)}
    first = parts[(0,) * parts.ndim]
    full = tuple(n * math.prod(mesh.shape[ax] for ax in spec_axes(entry))
                 for n, entry in zip(first.shape, spec))
    pending, done = [], []
    with mesh.issue():
        for pos in mesh.positions():
            if any(i and ax not in split
                   for i, ax in zip(pos, mesh.axis_names)):
                continue
            part = parts[pos]
            if part.device.type == "cuda":
                with torch.cuda.device(part.device):
                    host = torch.empty(part.shape, dtype=torch.uint8,
                                       pin_memory=True)
                host.copy_(part, non_blocking=True)
            else:
                host = part
            pending.append((_block_slices(mesh, spec, full, pos), host))
        for stream in mesh.streams().values():
            ev = torch.cuda.Event()
            ev.record(stream)
            done.append(ev)

    def fetch():
        for ev in done:
            ev.synchronize()
        out = np.empty(tuple(shape), dtype=np.uint8)
        for sl, host in pending:
            inner, have = _clip(sl, shape)
            if all(have):
                out[inner] = host.numpy()[tuple(slice(0, h) for h in have)]
        return out
    return fetch
