"""The fused Clay kernels on the GPU: wrappers of the hand-written CUDA
kernels in `csrc/clay_fused.cu`, their launch counts and their plain
versions.

- `clay_fused_encode(rbits_pm, data4, q=, t=, gamma=, det_inv=)`:
  data4 [k, n_win, alpha, w_a] -> parity [q, n_win, alpha, w_a]; replaces
  the TPU kernel `clay_fused_encode_pallas` (seaweedfs_tpu/ops/rs_pallas.py).
- `clay_fused_repair(rbits_pm, x4, k=, q=, t=, lost=, gamma=, inv_gamma=)`:
  the helpers' repair-plane layers x4 [k+q-1, n_win, beta, w_a] -> the lost
  shard's windows [n_win, alpha, w_a]; replaces `clay_fused_repair_pallas`.

`rbits_pm` is the [q, k0] solve matrix (R = gen[k0:] for the encode, R_r
of the loss for the repair) as its plane-major bit-matrix [8q, 8k0], as the
Pallas kernels take it.  Any w_a >= 1 runs: the TPU's 128-lane column tiles
are not carried over.  The CUDA source says what bounds the kernels and how.

Each wrapper runs its plain version for a tensor on the CPU.  For a tensor
on the GPU it launches the kernel or raises.  The plain versions follow the
Pallas bodies step by step in torch: the companion permutation is a swap of
the node axis with a layer-digit axis, a constant GF(2^8) multiply is eight
select-XORs, the layer-MDS product is `rs_cuda.gf_matmul_bits_plain`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import gf256, rs_cuda
from .rs_cuda import MAX_SMEM_BYTES, LaunchCounter

encode_launches = LaunchCounter()   # clay_fused_encode
repair_launches = LaunchCounter()   # clay_fused_repair

# parity counts the kernels are instantiated for (csrc/clay_fused.cu)
MIN_Q, MAX_Q = 2, 8

_lib_lock = threading.Lock()
_lib = None


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            from . import _build
            lib = _build.load("clay_fused")
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.clay_fused_encode.restype = i32
            lib.clay_fused_encode.argtypes = [
                ptr, i32, i32, i32, i32, i32, ptr, ptr, i64, i64, i32, ptr]
            lib.clay_fused_repair.restype = i32
            lib.clay_fused_repair.argtypes = [
                ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, i64, i64, i32,
                ptr]
            lib.clay_fused_smem_bytes.restype = i64
            lib.clay_fused_smem_bytes.argtypes = [i32, i32, i32]
            lib.clay_error_string.restype = ctypes.c_char_p
            lib.clay_error_string.argtypes = [i32]
            _lib = lib
        return _lib


# -- elementwise pieces of the plain versions ---------------------------------

def gf_const_mul(const: int, x: torch.Tensor) -> torch.Tensor:
    """const ∘GF∘ x elementwise on uint8: XOR over the set bits j of x of
    the byte const * 2^j — eight select-XORs."""
    y = torch.zeros_like(x)
    for j in range(8):
        term = int(gf256.mul(np.uint8(const), np.uint8(1 << j)))
        y ^= ((x >> j) & 1) * term
    return y


def digit_iota(q: int, ndim: int, axis: int, device) -> torch.Tensor:
    """arange(q) along `axis` of an ndim-dimensional broadcast shape."""
    shape = [1] * ndim
    shape[axis] = q
    return torch.arange(q, device=device).reshape(shape)


def uncouple(row: torch.Tensor, q: int, ax: int, gamma: int) -> torch.Tensor:
    """U of one grid row: row axis 0 is the node's x, axis `ax` the layer
    digit z_y of the row.  The companion of (x, z) swaps x with z_y; the
    diagonal cells (x == z_y) keep U = C."""
    comp = row.transpose(0, ax)
    diag = digit_iota(q, row.dim(), 0, row.device) == \
        digit_iota(q, row.dim(), ax, row.device)
    return torch.where(diag, row, row ^ gf_const_mul(gamma, comp))


def couple(par: torch.Tensor, q: int, ax: int, gamma: int,
           det_inv: int) -> torch.Tensor:
    """C of the parity row from its U: C = det_inv * (U ^ gamma * U[comp])
    off the diagonal, C = U on it."""
    comp = par.transpose(0, ax)
    diag = digit_iota(q, par.dim(), 0, par.device) == \
        digit_iota(q, par.dim(), ax, par.device)
    return torch.where(diag, par, gf_const_mul(
        det_inv, par ^ gf_const_mul(gamma, comp)))


# -- encode -------------------------------------------------------------------

def clay_fused_encode_plain(rbits_pm: torch.Tensor, data4: torch.Tensor, *,
                            q: int, t: int, gamma: int,
                            det_inv: int) -> torch.Tensor:
    """The encode kernel's function in plain torch ops, on any device."""
    k, n_win, alpha, w_a = data4.shape
    lead = (n_win,) + (q,) * t + (w_a,)   # [n_win, z_{t-1}, .., z_0, w_a]
    u_rows = []
    for y in range(t - 1):
        lo, hi = y * q, (y + 1) * q
        real = data4[lo:min(hi, k)]
        row = torch.cat([real, data4.new_zeros(
            (hi - lo - real.shape[0], n_win, alpha, w_a))])
        # digit z_y is axis 2 + (t-1-y): z_{t-1} owns the largest stride
        u_rows.append(uncouple(row.reshape(q, *lead), q, 2 + (t - 1 - y),
                               gamma))
    u = torch.stack(u_rows).reshape(q * (t - 1), -1)
    par = rs_cuda.gf_matmul_bits_plain(rbits_pm, u).reshape(q, *lead)
    # parity row y = t-1: companions pair within the row (digit z_{t-1})
    return couple(par, q, 2, gamma, det_inv).reshape(q, n_win, alpha, w_a)


def _check_common(rbits_pm: torch.Tensor, x: torch.Tensor, q: int,
                  k0: int) -> None:
    if rbits_pm.device != x.device:
        raise ValueError(f"bit matrix on {rbits_pm.device}, data on "
                         f"{x.device}")
    if rbits_pm.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"bit matrix must be uint8 or int8, not "
                        f"{rbits_pm.dtype}")
    if x.dtype != torch.uint8:
        raise TypeError(f"data must be uint8, not {x.dtype}")
    if not MIN_Q <= q <= MAX_Q:
        raise ValueError(f"q={q}: the kernels take {MIN_Q} <= q <= {MAX_Q}")
    if tuple(rbits_pm.shape) != (8 * q, 8 * k0):
        raise ValueError(f"bit matrix must be [{8 * q}, {8 * k0}], got "
                         f"{tuple(rbits_pm.shape)}")
    if not (rbits_pm.is_contiguous() and x.is_contiguous()):
        raise ValueError("bit matrix and data must be contiguous")


def _check_launch(lib, x: torch.Tensor, q: int, t: int,
                  repair: bool) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    smem = lib.clay_fused_smem_bytes(q, t, int(repair))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"clay q={q}, t={t} needs {smem} B of shared "
                         f"memory, more than {MAX_SMEM_BYTES}")


def _launch(entry, x: torch.Tensor, *args) -> int:
    """rc of the C entry `entry(*args, sm_count, stream)` for x's device,
    on its current stream.  The entry's cudaFuncSetAttribute and <<<>>>
    act on the thread's current device, so the call runs under a guard of
    x's."""
    props = torch.cuda.get_device_properties(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        return entry(*args, props.multi_processor_count, stream.cuda_stream)


def clay_fused_encode(rbits_pm: torch.Tensor, data4: torch.Tensor, *,
                      q: int, t: int, gamma: int,
                      det_inv: int) -> torch.Tensor:
    """parity [q, n_win, alpha, w_a] = the Clay encode of data4 [k, n_win,
    alpha, w_a] (uint8, contiguous, any w_a).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel on the current stream
    (no synchronisation) or raises."""
    k0 = q * (t - 1)
    _check_common(rbits_pm, data4, q, k0)
    if data4.dim() != 4 or data4.shape[2] != q ** t:
        raise ValueError(f"data must be [k, n_win, {q ** t}, w_a], got "
                         f"{tuple(data4.shape)}")
    k, n_win, alpha, w_a = data4.shape
    if not q * (t - 2) < k <= k0:
        raise ValueError(f"k={k} does not fit a q={q}, t={t} grid")
    if data4.device.type == "cpu":
        return clay_fused_encode_plain(rbits_pm, data4, q=q, t=t,
                                       gamma=gamma, det_inv=det_inv)
    lib = _kernel_lib()
    _check_launch(lib, data4, q, t, repair=False)
    out = torch.empty((q, n_win, alpha, w_a), dtype=torch.uint8,
                      device=data4.device)
    if out.numel() == 0:
        return out
    rc = _launch(lib.clay_fused_encode, data4, rbits_pm.data_ptr(), q, k, t,
                 gamma, det_inv, data4.data_ptr(), out.data_ptr(), n_win,
                 w_a)
    if rc != 0:
        raise RuntimeError(f"clay_fused_encode launch failed: "
                           f"{lib.clay_error_string(rc).decode()} ({rc})")
    encode_launches.add()
    return out


# -- single-loss repair -------------------------------------------------------

def internal_id(k: int, q: int, t: int, ext: int) -> int:
    """External shard id -> internal grid node (parity ids k..k+q-1 are
    the last q internal nodes)."""
    return ext if ext < k else q * t - q + (ext - k)


def clay_fused_repair_plain(rbits_pm: torch.Tensor, x4: torch.Tensor, *,
                            k: int, q: int, t: int, lost: int, gamma: int,
                            inv_gamma: int) -> torch.Tensor:
    """The repair kernel's function in plain torch ops, on any device."""
    _, n_win, beta, w_a = x4.shape
    n0 = q * t
    lost_int = internal_id(k, q, t, lost)
    x0, y0 = lost_int % q, lost_int // q
    helpers = [e for e in range(k + q) if e != lost]   # ascending ids
    ext = {internal_id(k, q, t, e): e for e in range(k + q)}
    zeros = x4.new_zeros((n_win, beta, w_a))
    cells = [x4[helpers.index(ext[i])] if i in ext and i != lost_int
             else zeros for i in range(n0)]   # virtual nodes store zeros
    # plane lattice: the free digits (all y != y0), descending
    free = [y for y in range(t - 1, -1, -1) if y != y0]
    lead = (n_win,) + (q,) * len(free) + (w_a,)
    u_rows = [uncouple(torch.stack(cells[y * q:(y + 1) * q]).reshape(
                  q, *lead), q, 2 + free.index(y), gamma)
              for y in range(t) if y != y0]
    u = torch.stack(u_rows).reshape(n0 - q, -1)
    u_y0 = rs_cuda.gf_matmul_bits_plain(rbits_pm, u).reshape(q, *lead)
    # x = x0: the lost node's in-plane (diagonal) cell, C = U; other x give
    # the out-of-plane cell z with digit y0 := x, C = (U ^ C[helper]) / g
    c_row = torch.stack([zeros if x == x0 else cells[y0 * q + x]
                         for x in range(q)]).reshape(q, *lead)
    at_x0 = digit_iota(q, u_y0.dim(), 0, u_y0.device) == x0
    vals = torch.where(at_x0, u_y0, gf_const_mul(inv_gamma, u_y0 ^ c_row))
    # axes [digit z_{y0}, n_win, free digits desc, w_a] -> natural layers
    return vals.movedim(0, 1 + (t - 1 - y0)).reshape(n_win, q ** t, w_a)


def clay_fused_repair(rbits_pm: torch.Tensor, x4: torch.Tensor, *, k: int,
                      q: int, t: int, lost: int, gamma: int,
                      inv_gamma: int) -> torch.Tensor:
    """The lost shard's windows [n_win, alpha, w_a] from the helpers'
    repair-plane layers x4 [k+q-1, n_win, beta, w_a] (external ids
    ascending without `lost`, plane layers ascending; uint8, contiguous,
    any w_a).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    k0 = q * (t - 1)
    _check_common(rbits_pm, x4, q, k0)
    if x4.dim() != 4 or x4.shape[0] != k + q - 1 \
            or x4.shape[2] != q ** (t - 1):
        raise ValueError(f"data must be [{k + q - 1}, n_win, {q ** (t - 1)}"
                         f", w_a], got {tuple(x4.shape)}")
    if not q * (t - 2) < k <= k0:
        raise ValueError(f"k={k} does not fit a q={q}, t={t} grid")
    if not 0 <= lost < k + q:
        raise ValueError(f"lost shard {lost} outside 0..{k + q - 1}")
    if x4.device.type == "cpu":
        return clay_fused_repair_plain(rbits_pm, x4, k=k, q=q, t=t,
                                       lost=lost, gamma=gamma,
                                       inv_gamma=inv_gamma)
    lib = _kernel_lib()
    _check_launch(lib, x4, q, t, repair=True)
    _, n_win, _, w_a = x4.shape
    out = torch.empty((n_win, q ** t, w_a), dtype=torch.uint8,
                      device=x4.device)
    if out.numel() == 0:
        return out
    rc = _launch(lib.clay_fused_repair, x4, rbits_pm.data_ptr(), q, k, t,
                 lost, gamma, inv_gamma, x4.data_ptr(), out.data_ptr(),
                 n_win, w_a)
    if rc != 0:
        raise RuntimeError(f"clay_fused_repair launch failed: "
                           f"{lib.clay_error_string(rc).decode()} ({rc})")
    repair_launches.add()
    return out
