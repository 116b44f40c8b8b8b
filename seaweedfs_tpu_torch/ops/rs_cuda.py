"""The GF(2^8) bit-plane matmul on the GPU: the wrapper of the hand-written
CUDA kernel `csrc/gf2_matmul.cu`, its launch count and its plain version.

    out[..., MO, N] = M ∘GF∘ data[..., KI, N]

with M given as its plane-major bit-matrix `mbits_pm` [8MO, 8KI]: row
i*MO + r, column j*KI + c holds bit i of M[r, c] * 2^j (`to_plane_major`
of the shard-major `rs_matrix.bit_matrix`).  The kernel replaces the TPU
kernel `gf_matmul_bits_pallas_sm` (seaweedfs_tpu/ops/rs_pallas.py); the
source says what bounds it and how.

Three entries share the kernel, each with its own launch count and plain
version, one for each layout a TPU kernel of the JAX package took:

- `gf_matmul_bits_cuda`: [KI, N] or [V, KI, N] (`gf_matmul_bits_pallas_sm`,
  every product of the RS codec, its fleet forms' volume stacks included);
- `gf_matmul_bits_vm_cuda`: volume-major [V, KI, B] -> [V, MO, B]
  (`gf_matmul_bits_pallas`, which has no caller in the JAX package either;
  chip_smoke.py holds it against its plain version);
- `gf_matmul_bits_cols_cuda`: column-tiled [KI, X, 128] -> [MO, X, 128]
  (`gf_matmul_bits_pallas_cols`, the layer-MDS product of the clay tiled
  path, ops/clay_structured.encode_device_tiled).

On the GPU all three are views of one launch: a contiguous [KI, X, 128] is
[KI, X*128].  Each runs its plain version for a tensor on the CPU; for a
tensor on the GPU it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import rs_matrix, rs_torch

# shared memory a block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
# minor axis of the column-tiled layout (the TPU's lane width)
LANE = 128


class LaunchCounter:
    """How many times a kernel was launched: one per launch, nowhere else."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


launches = LaunchCounter()       # gf_matmul_bits_cuda
vm_launches = LaunchCounter()    # gf_matmul_bits_vm_cuda
cols_launches = LaunchCounter()  # gf_matmul_bits_cols_cuda

_lib_lock = threading.Lock()
_lib = None


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            from . import _build
            lib = _build.load("gf2_matmul")
            lib.gf2_matmul_bits.restype = ctypes.c_int
            lib.gf2_matmul_bits.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            lib.gf2_matmul_smem_bytes.restype = ctypes.c_longlong
            lib.gf2_matmul_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.gf2_error_string.restype = ctypes.c_char_p
            lib.gf2_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def plane_major_perm(mo: int, ki: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) index arrays that permute a shard-major bit matrix
    [8MO, 8KI] into plane-major order: new row i*MO + r <- old row r*8 + i,
    new col j*KI + c <- old col c*8 + j."""
    i = np.arange(8 * mo) // mo
    r = np.arange(8 * mo) % mo
    j = np.arange(8 * ki) // ki
    c = np.arange(8 * ki) % ki
    return r * 8 + i, c * 8 + j


def to_plane_major(bitmat: np.ndarray, mo: int, ki: int) -> np.ndarray:
    """Shard-major [8MO, 8KI] (rs_matrix.bit_matrix) -> plane-major."""
    if bitmat.shape != (8 * mo, 8 * ki):
        raise ValueError(f"bit matrix {bitmat.shape} != {(8 * mo, 8 * ki)}")
    rows, cols = plane_major_perm(mo, ki)
    return np.ascontiguousarray(bitmat[rows][:, cols])


def from_reference(bitmat: np.ndarray, device="cpu") -> torch.Tensor:
    """A shard-major bit matrix as the JAX package builds it
    (`rs_matrix.bit_matrix`, numpy [8MO, 8KI]) -> the plane-major uint8
    tensor this module's functions take, on `device`."""
    bitmat = np.asarray(bitmat, dtype=np.uint8)
    mo, ki = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    return torch.from_numpy(to_plane_major(bitmat, mo, ki)).to(device)


def matrix_planes(M: np.ndarray, device="cpu") -> torch.Tensor:
    """A GF(2^8) matrix [MO, KI] -> its plane-major bit-matrix tensor."""
    return from_reference(rs_matrix.bit_matrix(M), device)


def gf_matmul_bits_plain(mbits_pm: torch.Tensor,
                         data: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device: undo the
    plane-major permutation, then rs_torch.gf_matmul_bits."""
    mo, ki = mbits_pm.shape[0] // 8, mbits_pm.shape[1] // 8
    rows, cols = plane_major_perm(mo, ki)
    shard_major = torch.empty_like(mbits_pm)
    r = torch.as_tensor(rows, device=mbits_pm.device)
    c = torch.as_tensor(cols, device=mbits_pm.device)
    shard_major[r[:, None], c[None, :]] = mbits_pm
    return rs_torch.gf_matmul_bits(shard_major, data)


def _check(mbits_pm: torch.Tensor, data: torch.Tensor) -> tuple[int, int]:
    if mbits_pm.device != data.device:
        raise ValueError(f"bit matrix on {mbits_pm.device}, data on "
                         f"{data.device}")
    if mbits_pm.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"bit matrix must be uint8 or int8, not "
                        f"{mbits_pm.dtype}")
    if data.dtype != torch.uint8:
        raise TypeError(f"data must be uint8, not {data.dtype}")
    if mbits_pm.dim() != 2 or mbits_pm.shape[0] % 8 or mbits_pm.shape[1] % 8:
        raise ValueError(f"bit matrix must be [8MO, 8KI], got "
                         f"{tuple(mbits_pm.shape)}")
    mo, ki = mbits_pm.shape[0] // 8, mbits_pm.shape[1] // 8
    if data.dim() not in (2, 3) or data.shape[-2] != ki:
        raise ValueError(f"data must be [{ki}, N] or [V, {ki}, N], got "
                         f"{tuple(data.shape)}")
    if mo == 0 or ki == 0:
        raise ValueError("empty bit matrix")
    if not (mbits_pm.is_contiguous() and data.is_contiguous()):
        raise ValueError("bit matrix and data must be contiguous")
    return mo, ki


def _launch(mbits_pm: torch.Tensor, data: torch.Tensor, mo: int,
            ki: int) -> torch.Tensor:
    """One kernel launch on data [..., KI, N] (checked, on the GPU); the
    caller counts it."""
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    lib = _kernel_lib()
    smem = lib.gf2_matmul_smem_bytes(mo, ki)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"[{8 * mo}, {8 * ki}] bit matrix needs {smem} B "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    out = torch.empty((*data.shape[:-2], mo, data.shape[-1]),
                      dtype=torch.uint8, device=data.device)
    v = data.shape[0] if data.dim() == 3 else 1
    n = data.shape[-1]
    if v == 0 or n == 0:
        return out
    props = torch.cuda.get_device_properties(data.device)
    # the C entry's cudaFuncSetAttribute and <<<>>> act on the thread's
    # current device, which need not be data's
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device)
        rc = lib.gf2_matmul_bits(mbits_pm.data_ptr(), mo, ki,
                                 data.data_ptr(), out.data_ptr(), v, n,
                                 props.multi_processor_count,
                                 stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gf2_matmul launch failed: "
                           f"{lib.gf2_error_string(rc).decode()} ({rc})")
    return out


def gf_matmul_bits_cuda(mbits_pm: torch.Tensor,
                        data: torch.Tensor) -> torch.Tensor:
    """out [..., MO, N] = M ∘GF∘ data [..., KI, N] (uint8).

    mbits_pm: plane-major [8MO, 8KI] uint8/int8 0/1, on data's device.
    data: contiguous [KI, N] or [V, KI, N] uint8, any N.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (no synchronisation) or raises."""
    mo, ki = _check(mbits_pm, data)
    if data.device.type == "cpu":
        return gf_matmul_bits_plain(mbits_pm, data)
    out = _launch(mbits_pm, data, mo, ki)
    launches.add()
    return out


def gf_matmul_bits_vm_plain(mbits_pm: torch.Tensor,
                            data: torch.Tensor) -> torch.Tensor:
    """The volume-major entry's function in plain torch ops."""
    return gf_matmul_bits_plain(mbits_pm, data)


def gf_matmul_bits_vm_cuda(mbits_pm: torch.Tensor,
                           data: torch.Tensor) -> torch.Tensor:
    """Volume-major out [V, MO, B] = M ∘GF∘ data [V, KI, B], any B: the
    counterpart of the TPU kernel `gf_matmul_bits_pallas`, without its
    B % block_b padding.  CPU tensors take the plain version."""
    if data.dim() != 3:
        raise ValueError(f"data must be [V, KI, B], got {tuple(data.shape)}")
    mo, ki = _check(mbits_pm, data)
    if data.device.type == "cpu":
        return gf_matmul_bits_vm_plain(mbits_pm, data)
    out = _launch(mbits_pm, data, mo, ki)
    vm_launches.add()
    return out


def gf_matmul_bits_cols_plain(mbits_pm: torch.Tensor,
                              data: torch.Tensor) -> torch.Tensor:
    """The column-tiled entry's function in plain torch ops."""
    ki, x, lane = data.shape
    out = gf_matmul_bits_plain(mbits_pm, data.reshape(ki, x * lane))
    return out.reshape(out.shape[0], x, lane)


def gf_matmul_bits_cols_cuda(mbits_pm: torch.Tensor,
                             data: torch.Tensor) -> torch.Tensor:
    """Column-tiled out [MO, X, 128] = M ∘GF∘ data [KI, X, 128]: the
    counterpart of the TPU kernel `gf_matmul_bits_pallas_cols`, any X (no
    vblock padding).  On the GPU the contiguous operand is the kernel's
    [KI, X*128] view.  CPU tensors take the plain version."""
    if data.dim() != 3 or data.shape[-1] != LANE:
        raise ValueError(f"data must be [KI, X, {LANE}], got "
                         f"{tuple(data.shape)}")
    ki, x, lane = data.shape
    flat = data.reshape(ki, x * lane)
    mo, _ = _check(mbits_pm, flat)
    if data.device.type == "cpu":
        return gf_matmul_bits_cols_plain(mbits_pm, data)
    out = _launch(mbits_pm, flat, mo, ki)
    cols_launches.add()
    return out.reshape(mo, x, lane)
