"""Structured (layered) Clay encode and single-loss repair — the
alpha-times-cheaper form of the flat generator matmul
(ops/clay_matrix.generator_flat), on the GPU.

The construction (Vajha et al., FAST'18) factors the encode into three
steps, two of them elementwise:

1. **Uncouple** the data rows: U = C ^ g*C[companion], where the companion
   of cell (x, y, z) swaps x with the layer digit z_y (a swap of two axes
   of the [x, z_{t-1}, .., z_0] view); diagonal cells keep U = C.
2. **Layer MDS**: every layer of U is a codeword of one (n0, k0)
   systematic MDS code, so all alpha layers solve with one [m, k0] matrix
   R = gen[k0:].
3. **Couple** the parity row: C = (U ^ g*U[comp]) / (1 + g^2).

Host half (numpy, lru-cached): `encode_parts`, `repair_parts`, the views
`fused_shape` / `tiled_shape` and the R bit matrices.  Device half (torch):

- `encode_device_fused` / `repair_device_fused`: the whole transform in one
  launch of the hand-written kernels of csrc/clay_fused.cu
  (ops/clay_cuda.py), the path every encode and single-loss rebuild takes;
- `encode_device_tiled`: the three steps as separate device passes —
  uncouple and couple as torch elementwise ops, the layer MDS through the
  column-tiled entry of the GF(2^8) kernel (`rs_cuda.gf_matmul_bits_cols_
  cuda`).  It is the JAX package's kill-switch path, kept as a function
  (chip_smoke.py runs it) and not behind a knob;
- `encode_device`: [k, W] window bytes -> [m, W] parity through the fused
  kernel.

The device of the tensor picks the path: a CPU tensor runs the kernels'
plain versions, a CUDA tensor the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import clay_cuda, gf256, rs_cuda, rs_matrix
from .clay import GAMMA
from .clay_matrix import code
from .rs_cuda import LANE


@functools.lru_cache(maxsize=8)
def encode_parts(k: int, m: int) -> tuple:
    """Static pieces of the structured encode for ClayCode(k, m):
    (unc_src, unc_mask, R, cpl_src, cpl_mask, det_inv)

    unc_src [k0*alpha] int32: flat row index (node*alpha + layer) of the
    companion cell each non-parity cell uncouples with (self for diagonal
    cells); unc_mask [k0*alpha] uint8: 1 where a companion term applies.
    R [m, k0]: the per-layer MDS solve matrix (generator is systematic, so
    R = gen[k0:]).  cpl_src / cpl_mask: the same for the parity coupling
    step over the [m*alpha] parity rows.  det_inv: 1/(1+g^2)."""
    c = code(k, m)
    alpha, k0, n0 = c.alpha, c.k0, c.n0
    if not np.array_equal(c.gen[:k0], gf256.identity(k0)):
        raise AssertionError("layer MDS generator is not systematic")
    unc_src = np.empty((k0, alpha), np.int32)
    unc_mask = np.zeros((k0, alpha), np.uint8)
    for i in range(k0):
        x, y = c._xy(i)
        for z in range(alpha):
            w = c._digit(z, y)
            if w == x:
                unc_src[i, z] = i * alpha + z
            else:
                unc_src[i, z] = c._node(w, y) * alpha \
                    + c._with_digit(z, y, x)
                unc_mask[i, z] = 1
    cpl_src = np.empty((m, alpha), np.int32)
    cpl_mask = np.zeros((m, alpha), np.uint8)
    for pi in range(m):
        x, y = c._xy(n0 - m + pi)          # the whole top row y = t-1
        for z in range(alpha):
            w = c._digit(z, y)
            if w == x:
                cpl_src[pi, z] = pi * alpha + z
            else:
                # companion node (w, t-1) is parity index w (the row base
                # n0-m is a multiple of q)
                cpl_src[pi, z] = w * alpha + c._with_digit(z, y, x)
                cpl_mask[pi, z] = 1
    R = np.ascontiguousarray(c.gen[k0:])
    return (unc_src.reshape(-1), unc_mask.reshape(-1), R,
            cpl_src.reshape(-1), cpl_mask.reshape(-1), int(c._det_inv))


@functools.lru_cache(maxsize=32)
def repair_parts(k: int, m: int, lost: int) -> tuple:
    """Static pieces of the structured single-loss repair of external node
    `lost`: (helpers, plane, R_r, inv_gamma).

    helpers: the k+m-1 surviving external ids ascending (the read set, each
    contributing its beta repair-plane cells).  plane: the beta layer
    indices z ascending with digit(z, y0) == x0 (the lost node's repair
    plane).  R_r [q, k0]: the per-plane solve matrix — with one node lost,
    the unknown uncoupled cells of a repair-plane layer are exactly the
    lost node's grid row y0, so known = the k0 other internal nodes and
    R_r = gen[row y0] @ inv(gen[known]).  inv_gamma: 1/g for the
    out-of-plane back-substitution."""
    c = code(k, m)
    q, n0 = c.q, c.n0
    lost_int = lost if lost < k else n0 - m + (lost - k)
    x0, y0 = c._xy(lost_int)
    helpers = tuple(e for e in range(k + m) if e != lost)
    plane = tuple(z for z in range(c.alpha) if c._digit(z, y0) == x0)
    assert len(plane) == c.beta
    unknown = [c._node(x, y0) for x in range(q)]
    known = sorted(set(range(n0)) - set(unknown))
    assert len(known) == c.k0
    R_r = gf256.matmul(c.gen[unknown], gf256.mat_inv(c.gen[known]))
    inv_gamma = int(gf256.inv(np.uint8(GAMMA)))
    return helpers, plane, R_r, inv_gamma


@functools.lru_cache(maxsize=8)
def r_bits(k: int, m: int) -> np.ndarray:
    """R = gen[k0:] as its shard-major bit matrix [8m, 8k0]."""
    c = code(k, m)
    return rs_matrix.bit_matrix(np.ascontiguousarray(c.gen[c.k0:]))


@functools.lru_cache(maxsize=8)
def r_bits_plane_major(k: int, m: int) -> np.ndarray:
    """R's bit matrix in the plane-major form the kernels take."""
    return rs_cuda.to_plane_major(r_bits(k, m), m, code(k, m).k0)


@functools.lru_cache(maxsize=32)
def repair_bits_plane_major(k: int, m: int, lost: int) -> np.ndarray:
    """repair_parts' R_r in plane-major bit form."""
    _, _, R_r, _ = repair_parts(k, m, lost)
    return rs_cuda.to_plane_major(
        rs_matrix.bit_matrix(np.ascontiguousarray(R_r)), m, code(k, m).k0)


@functools.lru_cache(maxsize=64)
def solve_planes(k: int, m: int, lost: "int | None",
                 device: torch.device) -> torch.Tensor:
    """The fused kernels' [q, k0] solve matrix as a plane-major bit tensor
    on `device`: R = gen[k0:] for the encode (lost None), R_r of the loss
    for the repair.  A CUDA copy is made on the default stream (a blocking
    upload), so it belongs to no codec's side stream; a codec that reads it
    on its own stream records that stream on it."""
    bits = torch.from_numpy(r_bits_plane_major(k, m) if lost is None
                            else repair_bits_plane_major(k, m, lost))
    if device.type != "cuda":
        return bits.to(device)
    with torch.cuda.stream(torch.cuda.default_stream(device)):
        return bits.to(device)


def fused_shape(k: int, m: int, w: int, small: int) -> "tuple | None":
    """The 4D view [k, n_win, alpha, w_a] of a [k, w] volume slab that the
    fused kernel takes (a free reshape of a contiguous array); None when
    the small block is not a multiple of alpha or w not of the block."""
    c = code(k, m)
    if small % c.alpha or w % small:
        return None
    return (k, w // small, c.alpha, small // c.alpha)


def tiled_shape(k: int, m: int, w: int, small: int) -> "tuple | None":
    """The digit-tiled 5D view [k, n_win, alpha, w_i, 128] of a [k, w]
    slab the tiled path takes; None unless w_a is a multiple of 128."""
    shape4 = fused_shape(k, m, w, small)
    if shape4 is None or shape4[3] % LANE:
        return None
    return shape4[:3] + (shape4[3] // LANE, LANE)


def encode_device_fused(k: int, m: int, data4: torch.Tensor, *,
                        small: int) -> torch.Tensor:
    """data4 [k, n_win, alpha, w_a] uint8 -> parity [m, n_win, alpha, w_a]
    in one launch of the fused encode kernel (its plain version for a CPU
    tensor)."""
    c = code(k, m)
    if tuple(data4.shape[:1]) + tuple(data4.shape[2:]) != \
            (k, c.alpha, small // c.alpha):
        raise ValueError(f"data4 {tuple(data4.shape)} is not [{k}, n_win, "
                         f"{c.alpha}, {small // c.alpha}]")
    return clay_cuda.clay_fused_encode(
        solve_planes(k, m, None, data4.device), data4, q=c.q, t=c.t,
        gamma=GAMMA, det_inv=int(c._det_inv))


def repair_device_fused(k: int, m: int, lost: int,
                        x4: torch.Tensor) -> torch.Tensor:
    """x4 [H, n_win, beta, w_a] uint8 — helper-major (repair_parts'
    helpers order), plane layers ascending — -> the lost shard's windows
    [n_win, alpha, w_a] in the natural layer-major layout, in one launch of
    the fused repair kernel (its plain version for a CPU tensor)."""
    c = code(k, m)
    _, _, _, inv_gamma = repair_parts(k, m, lost)
    return clay_cuda.clay_fused_repair(
        solve_planes(k, m, lost, x4.device), x4, k=k, q=c.q, t=c.t,
        lost=lost, gamma=GAMMA, inv_gamma=inv_gamma)


def encode_device_tiled(k: int, m: int, data5: torch.Tensor, *,
                        small: int) -> torch.Tensor:
    """data5 [k, n_win, alpha, w_i, 128] uint8 (tiled_shape's view of the
    natural [k, W] slab) -> parity [m, n_win, alpha, w_i, 128], in three
    device passes: uncouple (elementwise), the [m, k0] layer-MDS product
    over the [k0, X, 128] column-tiled operand, couple (elementwise).  The
    uncoupled operand and the uncoupled parity make a round trip through
    device memory, which the fused kernel avoids."""
    c = code(k, m)
    alpha, k0, q, t = c.alpha, c.k0, c.q, c.t
    kk, n_win, a, w_i, inner = data5.shape
    if (kk, a, inner) != (k, alpha, LANE) or small // alpha != w_i * LANE:
        raise ValueError(f"data5 {tuple(data5.shape)} is not the tiled "
                         f"view of small={small}")
    lead = (n_win,) + (q,) * t + (w_i, inner)
    u_rows = []
    for y in range(t - 1):
        lo, hi = y * q, (y + 1) * q
        real = data5[lo:min(hi, k)]
        row = torch.cat([real, data5.new_zeros(
            (hi - lo - real.shape[0], n_win, alpha, w_i, inner))])
        u_rows.append(clay_cuda.uncouple(row.reshape(q, *lead), q,
                                         2 + (t - 1 - y), GAMMA))
    # [k0, n_win, alpha, w_i, 128] -> the [k0, X, 128] column-tiled operand
    u = torch.stack(u_rows).reshape(k0, -1, inner)
    u_par = rs_cuda.gf_matmul_bits_cols_cuda(solve_planes(k, m, None,
                                                        data5.device), u)
    cpl = clay_cuda.couple(u_par.reshape(q, *lead), q, 2, GAMMA,
                           int(c._det_inv))
    return cpl.reshape(m, n_win, alpha, w_i, inner)


def encode_device(k: int, m: int, data: torch.Tensor, *,
                  small: int) -> torch.Tensor:
    """data [k, W] uint8 (W a multiple of the small block, as
    write_ec_files streams it) -> parity [m, W] in the same layout,
    through the fused kernel on the free 4D view."""
    w = data.shape[-1]
    shape4 = fused_shape(k, m, w, small)
    if shape4 is None:
        raise ValueError(f"window {w} / small block {small} do not fit "
                         f"clay alpha {code(k, m).alpha}")
    return encode_device_fused(k, m, data.reshape(shape4),
                               small=small).reshape(m, w)
