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
and LRC decode matrices, the LRC parity rows) through the bit-plane product
on the device.  With no device given on a host without CUDA the constructor
raises: the codec never moves to the CPU by itself.

`codec_metrics()` is the process-wide registry of codec calls that a
volume server's GET /metrics appends to its page; `stage`, `job` and `span`
time the host stages of the EC paths into it and, while torch.profiler
records, onto the profiler's clock.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _torch_profiler

from ..stats import Registry
from . import rs_cuda, rs_matrix, rs_torch


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


def device_call_begin(device: torch.device, stream, inputs: np.ndarray,
                      fn: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Callable[[], np.ndarray]:
    """Start out = fn(inputs as a tensor on `device`); returns fetch() ->
    numpy.

    On CUDA the host->device copy (from pinned staging), fn's kernels and
    the device->host copy are queued on `stream` and an event is
    recorded; only fetch() waits on it.  That is the seam the pipelined
    disk loops in storage/ec/encoder.py use to overlap disk reads, the
    device and shard-file writes.  On the CPU fn runs here (its kernels'
    plain versions) and fetch() returns the result."""
    inputs = np.ascontiguousarray(inputs, dtype=np.uint8)
    if device.type != "cuda":
        if not inputs.flags.writeable:  # torch wants writable memory
            inputs = inputs.copy()
        out = fn(torch.from_numpy(inputs)).numpy()
        return lambda: out
    # the staging, the output buffer and the event belong to `device`,
    # which need not be the thread's current device
    with torch.cuda.device(device):
        staged = torch.empty(inputs.shape, dtype=torch.uint8,
                             pin_memory=True)
        staged.numpy()[...] = inputs
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


# bit-planes of one gf_apply chunk: float32 planes take 32 bytes per input
# byte, so a chunk of columns holds at most this many bytes of planes
GF_APPLY_PLANE_BYTES = 1 << 30
# float32 sums of 0/1 products are exact up to 2^24 = 8 * KI
GF_APPLY_MAX_KI = 1 << 21


def gf_apply(M: np.ndarray, x: np.ndarray, *, device=None,
             metered: "tuple[str, str] | None" = None) -> np.ndarray:
    """out[MO, B] = M ∘GF∘ x[KI, B] for an arbitrary GF(2^8) matrix (numpy
    in and out) — the executor of the clay flat-matrix paths (multi-loss
    rebuild, degraded reads).

    It takes the role `rs_jax.gf_matmul_bits` has in the JAX package: the
    bit-plane product as one float32 `torch.matmul` on the device
    (`rs_torch.gf_matmul_bits`), not a hand-written kernel, since the
    [8MO, 8KI] bit matrix (up to [8192, 20480] for clay) is far beyond a
    kernel's shared memory.  Columns go in chunks of at most
    GF_APPLY_PLANE_BYTES of planes.  Runs on CUDA unless the caller names
    another device; the bit matrix of the last few M stays on the device.
    `metered` (backend, op): each chunk's codec_submit and codec_wait
    stages under those labels; None, no stage."""
    dev = resolve_device(device)
    M = np.ascontiguousarray(M, dtype=np.uint8)
    x = np.asarray(x, dtype=np.uint8)
    if M.ndim != 2 or x.ndim != 2 or x.shape[0] != M.shape[1]:
        raise ValueError(f"gf_apply: M {M.shape} and x {x.shape} do not "
                         f"chain")
    mo, ki = M.shape
    if ki > GF_APPLY_MAX_KI:
        raise ValueError(f"gf_apply: KI={ki} > {GF_APPLY_MAX_KI} would "
                         f"overflow the float32 sums")
    bits = _apply_bits_cached(M.tobytes(), M.shape, dev)
    b = x.shape[1]
    out = np.empty((mo, b), dtype=np.uint8)
    chunk = max(1, GF_APPLY_PLANE_BYTES // (32 * ki))
    for c0 in range(0, b, chunk):
        # each chunk is one dispatch: its upload and product issued, then
        # its result waited for (stages only when metered)
        with stage("codec_submit", *metered) if metered \
                else contextlib.nullcontext():
            part = torch.from_numpy(np.ascontiguousarray(
                x[:, c0:c0 + chunk]))
            prod = rs_torch.gf_matmul_bits(bits, part.to(dev))
        with stage("codec_wait", *metered) if metered \
                else contextlib.nullcontext():
            out[:, c0:c0 + chunk] = prod.cpu().numpy()
    return out


@functools.lru_cache(maxsize=4)
def _apply_bits_cached(m_bytes: bytes, shape: tuple,
                       device: torch.device) -> torch.Tensor:
    """The float32 bit matrix of one GF matrix on `device`; a decode matrix
    repeats across rebuild windows and degraded reads."""
    M = np.frombuffer(m_bytes, dtype=np.uint8).reshape(shape)
    return torch.from_numpy(rs_matrix.bit_matrix(M)).to(
        device=device, dtype=torch.float32)


class RSCodec:
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

    def _matmul_begin(self, planes: torch.Tensor, inputs: np.ndarray,
                      op: str):
        """Issue out = M ∘GF∘ inputs[..., KI, B]; returns fetch() -> numpy,
        metered as `op`.  See device_call_begin for the stream and fetch()
        contract."""
        t0 = time.perf_counter()
        if self._stream is not None:
            # the decode-matrix cache may drop `planes` while the stream
            # reads it
            planes.record_stream(self._stream)
        fetch = device_call_begin(
            self.device, self._stream, inputs,
            lambda x: rs_cuda.gf_matmul_bits_cuda(planes, x))
        volumes = int(np.prod(inputs.shape[:-2])) if inputs.ndim > 2 else 1
        return waited(metered_fetch(fetch, self.label, op, inputs.nbytes, t0,
                                    volumes=volumes), self.label, op)

    # -- public API ------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [.., k, B] uint8 -> parity [.., m, B] uint8."""
        return self.encode_begin(data)()

    def encode_begin(self, data: np.ndarray):
        """Issue the encode asynchronously; returns fetch() -> parity."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim not in (2, 3) or data.shape[-2] != self.k:
            raise ValueError(f"expected [{self.k}, B] or [V, {self.k}, B] "
                             f"data, got {data.shape}")
        with stage("codec_submit", self.label, "encode"):
            return self._matmul_begin(self.parity_planes, data, "encode")

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
        # the stack reads the survivors (lazily mapped shard slices in a
        # rebuild) into the staging layout: the dispatch's host part
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
