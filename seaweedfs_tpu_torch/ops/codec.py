"""High-level Reed-Solomon codec API — the GPU replacement for the reference's
`reedsolomon.Encoder` (created at weed/storage/erasure_coding/ec_encoder.go:198,
used via enc.Encode / enc.Reconstruct / enc.ReconstructData).

    codec = RSCodec(10, 4)                       # ec_encoder.go:17-19 geometry
    parity = codec.encode(data_blocks)           # enc.Encode
    codec.reconstruct(shards)                    # enc.Reconstruct (fills None)
    codec.reconstruct(shards, data_only=True)    # enc.ReconstructData

Accepts/returns numpy uint8; shapes are [k, B] or batched [V, k, B].  Every
product is one call of the hand-written kernel of ops/rs_cuda.py on the
GPU (the default device), its plain torch version when the caller asks for
`device="cpu"`.  `gf_apply` applies an arbitrary GF(2^8) matrix (the clay
and LRC decode matrices, the LRC parity rows) through the kernel its shape
picks: this dense one, or the row-sparse one of ops/gf_sparse.py.  With no
device given on a host without CUDA the constructor raises: the codec
never moves to the CPU by itself.

`codec_metrics()` is the process-wide registry of codec calls that a
volume server's GET /metrics appends to its page; `stage`, `job` and `span`
time the host stages of the EC paths into it and, while torch.profiler
records, onto the profiler's clock.

`staging(device, shape)` is the host buffer a bulk path gathers a batch
into: a codec entry handed that tensor uploads it as it is, where any
other input is first copied into the dispatch's own staging.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _torch_profiler

from ..stats import Registry
from . import gf_sparse, rs_cuda, rs_matrix


# -- codec metrics ----------------------------------------------------------
#
# One registry per process: every server in it shares the codecs.  Labels
# name the code family and its executor, `backend` in
#   rs_cuda   RSCodec on the GPU (the gf2_matmul kernel)
#   rs_torch  RSCodec on device="cpu" (the kernel's plain torch version)
#   clay      ClayWindowCodec and the clay rebuilds, on either device
#   lrc       LrcWindowCodec and the LRC rebuild, on either device
# and `op` in encode / reconstruct.

# codec calls span ~ms on the device to seconds on the CPU; the default
# request buckets would put everything in two of them
_CODEC_BUCKETS = [0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0]


# the host stages (see `stage`), in the registry's order: (attribute of
# _CodecMetrics, the span it opens while the profiler records, help); the
# family is seaweedfs_<attribute>_seconds
_STAGES = (
    ("ec_read", "ec.read",
     "EC shard or .dat bytes read into host memory in the codec's layout"),
    ("ec_write", "ec.write", "EC shard-file writes of one batch or window"),
    ("ec_queue_wait", "ec.queue_wait",
     "EC pipeline producer blocked on the shard-file writer"),
    ("codec_submit", "codec.submit",
     "host part of an EC codec dispatch, from its call to its return"),
    ("codec_wait", "codec.wait",
     "EC codec dispatch blocked on the device for its result"),
    ("needle_parse", "needle.parse",
     "needle header, body and CRC parse of an EC read"),
)
STAGE_SPANS = {attr: span_name for attr, span_name, _ in _STAGES}


class _CodecMetrics:
    def __init__(self):
        self.registry = Registry()
        self.seconds = self.registry.histogram(
            "seaweedfs_codec_op_seconds",
            "EC codec call wall time, dispatch through fetch",
            ["backend", "op"], buckets=_CODEC_BUCKETS)
        self.bytes = self.registry.counter(
            "seaweedfs_codec_bytes_total",
            "payload bytes processed by the EC codec",
            ["backend", "op"])
        # volumes_total / dispatch_total is the fleet encode's batching
        # factor: how many volumes one device round carries
        self.dispatch = self.registry.counter(
            "seaweedfs_codec_dispatch_total",
            "EC codec dispatches (one backend call each)",
            ["backend", "op"])
        self.dispatch_volumes = self.registry.counter(
            "seaweedfs_codec_dispatch_volumes_total",
            "volumes carried by EC codec dispatches",
            ["backend", "op"])
        # the host stages of the EC paths and of the dispatch (`stage`),
        # one observation per occurrence, labelled as the families above
        # with the volume codec's backend; op names the path (the ec_*
        # families: encode / rebuild / read) or the dispatch (codec_*:
        # encode / reconstruct)
        for attr, _, help_text in _STAGES:
            setattr(self, attr, self.registry.histogram(
                f"seaweedfs_{attr}_seconds", help_text, ["backend", "op"],
                buckets=_CODEC_BUCKETS))
        # how a dispatch's input reached its upload (`host_staged`,
        # `gf_apply`)
        self.staged = self.registry.counter(
            "seaweedfs_codec_staged_bytes_total",
            "EC codec dispatch input bytes by path: direct, uploaded from "
            "the caller's own staging; copied, copied into staging first",
            ["backend", "op", "path"])

    def observe(self, backend: str, op: str, nbytes: int,
                seconds: float, volumes: int = 1) -> None:
        self.seconds.observe(backend, op, value=seconds)
        self.bytes.inc(backend, op, value=float(nbytes))
        self.dispatch.inc(backend, op)
        self.dispatch_volumes.inc(backend, op, value=float(volumes))


_codec_metrics: "_CodecMetrics | None" = None
_codec_metrics_lock = threading.Lock()


def codec_metrics() -> _CodecMetrics:
    global _codec_metrics
    with _codec_metrics_lock:
        if _codec_metrics is None:
            _codec_metrics = _CodecMetrics()
        return _codec_metrics


def metered_fetch(fetch, backend: str, op: str, nbytes: int, t0: float,
                  volumes: int = 1):
    """Wrap an async codec fetch() so the span from issue (`t0`) to the
    fetch's return lands in the codec metrics: the window the pipelined
    disk loops wait on (h2d, kernels, d2h).  `volumes` is how many volumes
    this one dispatch carried."""
    def timed():
        out = fetch()
        codec_metrics().observe(backend, op, nbytes,
                                time.perf_counter() - t0, volumes=volumes)
        return out
    return timed


# -- host stages and spans ----------------------------------------------------
#
# A stage is one host step of an EC path or of a codec dispatch.  It is
# always one observation in a family of codec_metrics(), and while
# torch.profiler records, a span on the profiler's clock, which the CUDA
# kernels and copies share.  An entry call (`job`) is a span too, carrying
# what the stages inside it belong to as its args: a volume's base name or
# `vid:needle id`.  A worker thread of the job opens the job's span again
# on its own thread, so each stage span sits inside one carrying its job.


class _ThreadState(threading.local):
    def __init__(self):
        self.job = None       # the entry call: (span name, identifier)
        self.stages = []      # the open stages, innermost last


_state = _ThreadState()


def profiling() -> bool:
    """Whether a torch.profiler session records in this process.  The
    profiler's process-wide flag: torch.autograd._profiler_enabled()
    answers only on the thread that started the session, not on the EC
    writer threads, whose spans a profiler of all threads records."""
    return _torch_profiler._is_profiler_enabled


class _Stage:
    __slots__ = ("hist", "labels", "name", "t0", "inner", "rf")

    def __init__(self, hist, labels: tuple, name: str):
        self.hist, self.labels, self.name = hist, labels, name

    def __enter__(self):
        self.rf = None
        if profiling():
            # torch's C++ record function, with no args: a few us a span
            # under the profiler, against ~11 for record_function's op
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        _state.stages.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self.t0
        stages = _state.stages
        stages.pop()
        if stages:
            stages[-1].inner += elapsed
        self.hist.observe(*self.labels, value=elapsed - self.inner)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def stage(family: str, backend: str, op: str) -> _Stage:
    """Context manager timing one host stage: one observation of
    `family` (a key of STAGE_SPANS, the family's attribute of
    codec_metrics()) under (backend, op), the block's wall time less that
    of the stages nested in it on this thread; and, while the profiler
    records, the span STAGE_SPANS[family]."""
    return _Stage(getattr(_codec_metrics or codec_metrics(), family),
                  (backend, op), STAGE_SPANS[family])


@contextlib.contextmanager
def span(name: str):
    """A span with no family, while the profiler records; else nothing."""
    if not profiling():
        yield
        return
    with _RecordFunctionFast(name):
        yield


@contextlib.contextmanager
def job(name: str, ident: str):
    """An entry call: while the profiler records, the block is the span
    `name` carrying `ident` as its args.  Inside another job on the same
    thread the outer one stands for both; `current_job()` hands it to a
    worker thread, which opens it again there."""
    if _state.job is not None:
        yield
        return
    _state.job = (name, ident)
    try:
        if profiling():
            with torch.profiler.record_function(name, ident):
                yield
        else:
            yield
    finally:
        _state.job = None


def current_job() -> "tuple[str, str] | None":
    """The job this thread is in: (span name, identifier), or None."""
    return _state.job


def waited(fetch, backend: str, op: str):
    """fetch() with its wait on the device observed as a codec_wait
    stage."""
    def wait():
        with stage("codec_wait", backend, op):
            return fetch()
    return wait


def resolve_device(device=None) -> torch.device:
    """The device the port's entry points run on: CUDA unless the caller
    names another.  Raises when CUDA is asked for (or defaulted to) and
    this host has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "seaweedfs_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain torch version explicitly")
    return dev


def staging(device, shape) -> torch.Tensor:
    """A host uint8 tensor of `shape` for a caller to gather one batch
    into, in place of the copy a dispatch makes otherwise: page-locked
    when `device` is a CUDA device, plain memory for any other.

    The pinned blocks come from torch's caching host allocator, so they
    stay resident across jobs and codecs, and a block an upload still
    reads is not handed out again.  Fill the tensor through its numpy view
    (`.numpy()`, which keeps it alive) and hand the tensor itself to a
    codec entry to upload it with no host copy (`host_staged`); the mesh
    arms read it as any array."""
    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    return torch.empty(shape, dtype=torch.uint8)


def host_input(x) -> "np.ndarray | torch.Tensor":
    """A codec entry's input before its dispatch: a tensor as it is (see
    `host_staged`), anything else as a uint8 numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.uint8)


def _count_staged(metered, path: str, nbytes: int) -> None:
    """Add a dispatch's input bytes to seaweedfs_codec_staged_bytes_total
    under `metered` (backend, op) and `path`."""
    (_codec_metrics or codec_metrics()).staged.inc(
        *metered, path, value=float(nbytes))


def host_staged(device: torch.device, inputs,
                metered: "tuple[str, str] | None" = None) -> torch.Tensor:
    """`inputs` as the host tensor a dispatch on `device` uploads.  A
    contiguous uint8 CPU tensor (pinned, for a CUDA device), as `staging`
    gives, is taken as it is: path `direct`.  Anything else is copied into
    `staging(device)` first on CUDA, and on the CPU handed over as a uint8
    array: path `copied`.  `metered` (backend, op): the bytes counted in
    seaweedfs_codec_staged_bytes_total under the path taken; None, not
    counted."""
    if isinstance(inputs, torch.Tensor) and inputs.device.type == "cpu" \
            and inputs.dtype == torch.uint8 and inputs.is_contiguous() \
            and (device.type != "cuda" or inputs.is_pinned()):
        staged, path = inputs, "direct"
    else:
        x = np.ascontiguousarray(inputs, dtype=np.uint8)
        if device.type == "cuda":
            staged = staging(device, x.shape)
            staged.numpy()[...] = x
        else:
            if not x.flags.writeable:  # torch wants writable memory
                x = x.copy()
            staged = torch.from_numpy(x)
        path = "copied"
    if metered:
        _count_staged(metered, path, staged.nbytes)
    return staged


def device_call_begin(device: torch.device, stream,
                      inputs: "np.ndarray | torch.Tensor",
                      fn: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Callable[[], np.ndarray]:
    """Start out = fn(inputs as a tensor on `device`); returns fetch() ->
    numpy.

    `inputs` goes through `host_staged` (not metered): a tensor from
    `staging` is uploaded as it is, an array copied into pinned staging
    first; a codec entry calls host_staged itself to count the path.  On
    CUDA the host->device copy, fn's kernels and the device->host copy
    are queued on `stream` and an event is recorded; only fetch() waits on
    it.  That is the seam the pipelined disk loops of storage/ec
    (`pipeline._pipelined`) use to overlap disk reads, the device and
    shard-file writes.  On the CPU fn runs here (its kernels' plain
    versions) and fetch() returns the result."""
    staged = host_staged(device, inputs)
    if device.type != "cuda":
        out = fn(staged).numpy()
        return lambda: out
    # the output buffer and the event belong to `device`, which need not
    # be the thread's current device
    with torch.cuda.device(device):
        with torch.cuda.stream(stream):
            dev_out = fn(staged.to(device, non_blocking=True))
            host = torch.empty(dev_out.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(dev_out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)

    def fetch():
        done.synchronize()
        return host.numpy()
    return fetch


# input bytes of one gf_apply chunk (a chunk of columns of x)
GF_APPLY_CHUNK_BYTES = 1 << 25


def gf_apply(M: np.ndarray, x: np.ndarray, *, device=None,
             metered: "tuple[str, str] | None" = None) -> np.ndarray:
    """out[MO, B] = M ∘GF∘ x[KI, B] for an arbitrary GF(2^8) matrix (numpy
    in and out) — the executor of the clay flat-matrix paths (multi-loss
    rebuild, degraded reads) and of the LRC rows.

    It takes the role `rs_jax.gf_matmul_bits` has in the JAX package, with
    a hand-written kernel picked by M's shape: the dense GF(2^8) kernel
    (ops/rs_cuda.py) where its shared memory holds M's masks (the LRC
    rows), else the row-sparse kernel (ops/gf_sparse.py), which walks
    only M's nonzeros (the clay matrices, [256..1024, 2560] at Clay(10,4),
    1.2-2.2% nonzero).  A CPU device runs the same kernel's plain version.
    Columns go in chunks of at most GF_APPLY_CHUNK_BYTES of x.  Runs on
    CUDA unless the caller names another device; the form of the last few
    M stays on the device.  `metered` (backend, op): each chunk's
    codec_submit and codec_wait stages under those labels; None, no
    stage."""
    dev = resolve_device(device)
    M = np.ascontiguousarray(M, dtype=np.uint8)
    x = np.asarray(x, dtype=np.uint8)
    if M.ndim != 2 or x.ndim != 2 or x.shape[0] != M.shape[1]:
        raise ValueError(f"gf_apply: M {M.shape} and x {x.shape} do not "
                         f"chain")
    mo, ki = M.shape
    product, form, held = _apply_form_cached(M.tobytes(), M.shape, dev)
    if dev.type == "cuda":
        # the cache may drop the form while this stream reads it
        stream = torch.cuda.current_stream(dev)
        for t in held:
            t.record_stream(stream)
    b = x.shape[1]
    out = np.empty((mo, b), dtype=np.uint8)
    if metered:    # each chunk goes up from pageable memory
        _count_staged(metered, "copied", x.nbytes)
    chunk = max(1, GF_APPLY_CHUNK_BYTES // ki)
    for c0 in range(0, b, chunk):
        # each chunk is one dispatch: its upload and product issued, then
        # its result waited for (stages only when metered)
        with stage("codec_submit", *metered) if metered \
                else contextlib.nullcontext():
            part = torch.from_numpy(np.ascontiguousarray(
                x[:, c0:c0 + chunk]))
            prod = product(form, part.to(dev))
        with stage("codec_wait", *metered) if metered \
                else contextlib.nullcontext():
            out[:, c0:c0 + chunk] = prod.cpu().numpy()
    return out


@functools.lru_cache(maxsize=16)
def _apply_form_cached(m_bytes: bytes, shape: tuple, device: torch.device):
    """(product, form, tensors): the kernel entry M's shape picks, M in its
    form on `device` — the plane-major bit matrix of the dense kernel, or
    the RowSparse of the row-sparse one (~60 KB for a clay decode matrix)
    — and the form's tensors.  A decode matrix repeats across rebuild
    windows and degraded reads."""
    M = np.frombuffer(m_bytes, dtype=np.uint8).reshape(shape)
    if rs_cuda.smem_bytes(*shape) <= rs_cuda.MAX_SMEM_BYTES:
        planes = rs_cuda.matrix_planes(M, device)
        return rs_cuda.gf_matmul_bits_cuda, planes, (planes,)
    form = gf_sparse.row_sparse(M, device)
    return gf_sparse.gf_sparse_matmul_cuda, form, form.tensors()


class RSCodec:
    mesh = None    # it runs on `device`; a MeshCodec on its `mesh`

    def __init__(self, data_shards: int = rs_matrix.DEFAULT_DATA_SHARDS,
                 parity_shards: int = rs_matrix.DEFAULT_PARITY_SHARDS,
                 *, kind: str = "vandermonde", device=None):
        self.device = resolve_device(device)
        # the executor in the metrics' backend label, rs_cuda / rs_torch
        self.backend = "cuda" if self.device.type == "cuda" else "torch"
        self.label = f"rs_{self.backend}"
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        self.kind = kind
        self.gen = rs_matrix.generator_matrix(self.k, self.m, kind)
        self.parity_planes = rs_cuda.matrix_planes(self.gen[self.k:],
                                                   self.device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    # -- helpers ---------------------------------------------------------
    def decode_planes(self, present: tuple, targets: tuple) -> torch.Tensor:
        """Plane-major bit-matrix (on the codec's device) that rebuilds
        shards `targets` from the first k of `present`; one per loss mask,
        cached."""
        return _decode_matrix_cached(self.k, self.m, self.kind,
                                     tuple(present), tuple(targets),
                                     self.device)

    def _matmul_begin(self, planes: torch.Tensor,
                      inputs: "np.ndarray | torch.Tensor", op: str,
                      volumes: int = 1):
        """Issue out = M ∘GF∘ inputs[..., KI, B]; returns fetch() -> numpy,
        metered as `op`, each [KI, B] matrix counted as `volumes` volumes.
        See device_call_begin for the stream and fetch() contract, and for
        `inputs` from `staging`."""
        t0 = time.perf_counter()
        if self._stream is not None:
            # the decode-matrix cache may drop `planes` while the stream
            # reads it
            planes.record_stream(self._stream)
        fetch = device_call_begin(
            self.device, self._stream,
            host_staged(self.device, inputs, (self.label, op)),
            lambda x: rs_cuda.gf_matmul_bits_cuda(planes, x))
        volumes *= math.prod(inputs.shape[:-2])
        return waited(metered_fetch(fetch, self.label, op, inputs.nbytes, t0,
                                    volumes=volumes), self.label, op)

    # -- public API ------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [.., k, B] uint8 -> parity [.., m, B] uint8."""
        return self.encode_begin(data)()

    def encode_begin(self, data: "np.ndarray | torch.Tensor", *,
                     volumes: int = 1):
        """Issue the encode asynchronously; returns fetch() -> parity.
        `volumes` is how many volumes a [k, B] input's bytes span (the
        encode loop folds them onto the byte axis; [V, k, B] counts V).  A
        tensor from `staging` is uploaded as it is, any other input copied
        into staging first (`host_staged`)."""
        data = host_input(data)
        if data.ndim not in (2, 3) or data.shape[-2] != self.k:
            raise ValueError(f"expected [{self.k}, B] or [V, {self.k}, B] "
                             f"data, got {data.shape}")
        with stage("codec_submit", self.label, "encode"):
            return self._matmul_begin(self.parity_planes, data, "encode",
                                      volumes)

    def reconstruct(self, shards: list[np.ndarray | None], *,
                    data_only: bool = False) -> list[np.ndarray]:
        """Fill in missing (None) shards in place of the reference's
        enc.Reconstruct / enc.ReconstructData (ec_encoder.go:270,
        store_ec.go:360).  `shards` has length k+m; present entries must share
        one [B] or [V, B] shape."""
        return self.reconstruct_begin(shards, data_only=data_only)()

    def reconstruct_begin(self, shards: list[np.ndarray | None], *,
                          data_only: bool = False):
        """Async form of reconstruct: issues the decode matmul, returns
        fetch() -> filled shard list (see _matmul_begin for the contract)."""
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots, got {len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        targets = [i for i, s in enumerate(shards) if s is None
                   and (not data_only or i < self.k)]
        if len(present) < self.k:
            raise ValueError(
                f"too few shards to reconstruct: {len(present)} < {self.k}")
        if not targets:
            res = list(shards)
            return lambda: res
        # the stack copies the survivors into the staging layout: the
        # dispatch's host part (the RS rebuild loop gathers them itself
        # and calls reconstruct_rows_begin)
        with stage("codec_submit", self.label, "reconstruct"):
            planes = self.decode_planes(tuple(present), tuple(targets))
            chosen = np.stack([np.asarray(shards[i], dtype=np.uint8)
                               for i in present[:self.k]], axis=-2)
            raw = self._matmul_begin(planes, chosen, "reconstruct")

        def fetch():
            rec = raw()
            out = list(shards)
            for row, t in enumerate(targets):
                out[t] = np.ascontiguousarray(rec[..., row, :])
            return out
        return fetch

    def reconstruct_rows_begin(self, survivors: "np.ndarray | torch.Tensor",
                               used, targets, *, volumes: int = 1):
        """Issue the rebuild of shards `targets` from survivors the caller
        has gathered: `survivors` [k, B] holds the shards `used` (k ids)
        in that row order, its bytes spanning `volumes` volumes.  Returns
        fetch() -> [len(targets), B], the rows of `targets` in that order.
        Nothing is stacked: a tensor from `staging` is uploaded as it is,
        any other input copied once into the dispatch's staging
        (`host_staged`)."""
        survivors = host_input(survivors)
        if survivors.ndim != 2 or survivors.shape[0] != self.k \
                or len(used) != self.k:
            raise ValueError(f"expected [{self.k}, B] survivors of "
                             f"{self.k} shards, got {survivors.shape} of "
                             f"{len(used)}")
        with stage("codec_submit", self.label, "reconstruct"):
            planes = self.decode_planes(tuple(used), tuple(targets))
            return self._matmul_begin(planes, survivors, "reconstruct",
                                      volumes)

    def verify(self, shards: list[np.ndarray]) -> bool:
        """Check parity consistency (reference enc.Verify)."""
        data = np.stack(shards[:self.k], axis=-2)
        parity = np.stack(shards[self.k:], axis=-2)
        return bool(np.array_equal(self.encode(data), parity))


@functools.lru_cache(maxsize=1024)
def _decode_matrix_cached(k: int, m: int, kind: str, present: tuple,
                          targets: tuple, device: torch.device) -> torch.Tensor:
    """The decode matrix of one loss mask as a plane-major bit-matrix on
    `device`.  Loss masks repeat across rebuild windows and degraded reads;
    the GF inversion and the upload are worth one pass per mask (keyed by
    geometry, not codec instance)."""
    gen = rs_matrix.generator_matrix(k, m, kind)
    D = rs_matrix.decode_matrix(gen, list(present), list(targets))
    return rs_cuda.matrix_planes(D, device)
