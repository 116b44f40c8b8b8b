"""High-level Reed-Solomon codec API — the GPU replacement for the reference's
`reedsolomon.Encoder` (created at weed/storage/erasure_coding/ec_encoder.go:198,
used via enc.Encode / enc.Reconstruct / enc.ReconstructData).

    codec = RSCodec(10, 4)                       # ec_encoder.go:17-19 geometry
    parity = codec.encode(data_blocks)           # enc.Encode
    codec.reconstruct(shards)                    # enc.Reconstruct (fills None)
    codec.reconstruct(shards, data_only=True)    # enc.ReconstructData

Accepts/returns numpy uint8; shapes are [k, B] or batched [V, k, B].  Every
product is one call of ops/rs_cuda.gf_matmul_bits_cuda: the hand-written
kernel on the GPU (the default device), its plain torch version when the
caller asks for `device="cpu"`.  With no device given on a host without
CUDA the constructor raises: the codec never moves to the CPU by itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import rs_cuda, rs_matrix


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


class RSCodec:
    def __init__(self, data_shards: int = rs_matrix.DEFAULT_DATA_SHARDS,
                 parity_shards: int = rs_matrix.DEFAULT_PARITY_SHARDS,
                 *, kind: str = "vandermonde", device=None):
        self.device = resolve_device(device)
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

    def _matmul_begin(self, planes: torch.Tensor, inputs: np.ndarray):
        """Issue out = M ∘GF∘ inputs[..., KI, B]; returns fetch() -> numpy.

        On CUDA the host->device copy (from pinned staging), the kernel and
        the device->host copy are queued on the codec's stream and an event
        is recorded; only fetch() waits on it.  That is the seam the
        pipelined disk loops in storage/ec/encoder.py use to overlap disk
        reads, the device and shard-file writes.  On the CPU the product
        runs here and fetch() returns it."""
        inputs = np.ascontiguousarray(inputs, dtype=np.uint8)
        if self.device.type != "cuda":
            if not inputs.flags.writeable:  # torch wants writable memory
                inputs = inputs.copy()
            out = rs_cuda.gf_matmul_bits_cuda(
                planes, torch.from_numpy(inputs)).numpy()
            return lambda: out
        staged = torch.empty(inputs.shape, dtype=torch.uint8,
                             pin_memory=True)
        staged.numpy()[...] = inputs
        # the decode-matrix cache may drop `planes` while this stream reads it
        planes.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            dev_in = staged.to(self.device, non_blocking=True)
            dev_out = rs_cuda.gf_matmul_bits_cuda(planes, dev_in)
            host = torch.empty(dev_out.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(dev_out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)

        def fetch():
            done.synchronize()
            return host.numpy()
        return fetch

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
        return self._matmul_begin(self.parity_planes, data)

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
        planes = self.decode_planes(tuple(present), tuple(targets))
        chosen = np.stack([np.asarray(shards[i], dtype=np.uint8)
                           for i in present[:self.k]], axis=-2)
        raw = self._matmul_begin(planes, chosen)

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
