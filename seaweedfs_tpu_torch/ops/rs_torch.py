"""Reed-Solomon over GF(2^8) as GF(2) bit-plane matmuls, in plain torch ops.

Multiplying a byte by a GF(2^8) constant is linear over GF(2), so an RS
encode `parity[m, B] = G_parity[m, k] ∘GF∘ data[k, B]` lowers exactly to

    parity_bits[8m, B] = (Gbits[8m, 8k] @ data_bits[8k, B]) mod 2

where `data_bits` are the LSB-first bit-planes of the data bytes and `Gbits`
is `rs_matrix.bit_matrix` of the parity rows.  The operands are 0/1, so the
partial sums are <= 8k <= 2040: exact in a float32 accumulator (do NOT
narrow it).  The low bit of each sum is the GF(2) result.

This is the plain version of the hand-written kernel in ops/rs_cuda.py: it
runs on any device, materializes the 8x bit-plane tensor (in float32, 32
bytes per input byte) and is the reference the kernel is held to.
"""

from __future__ import annotations

import contextlib

import torch


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """[..., S, B] uint8 -> [..., 8S, B] uint8 bit-planes, LSB-first.

    Plane 8*s + j holds bit j of shard-row s."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data.unsqueeze(-2) >> shifts[:, None]) & 1
    return bits.reshape(*data.shape[:-2], data.shape[-2] * 8, data.shape[-1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of unpack_bits: [..., 8S, B] {0,1} uint8 -> [..., S, B] uint8."""
    s8, b = bits.shape[-2], bits.shape[-1]
    v = bits.reshape(*bits.shape[:-2], s8 // 8, 8, b)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (v << shifts[:, None]).sum(dim=-2, dtype=torch.uint8)


@contextlib.contextmanager
def _full_fp32_matmul(device: torch.device):
    """TF32 would still be exact for 0/1 operands with an fp32
    accumulator, but the codec states its precision instead of relying on
    that: full float32 on the card for the duration of the product."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def gf_matmul_bits(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix-multiply via the bit-plane formulation.

    bitmat: [8M, 8K] {0,1} (shard-major, from rs_matrix.bit_matrix)
    data:   [..., K, B] uint8
    returns [..., M, B] uint8
    """
    planes = unpack_bits(data).to(torch.float32)
    w = bitmat.to(device=data.device, dtype=torch.float32)
    with _full_fp32_matmul(data.device):
        acc = torch.matmul(w, planes)
    out_bits = (acc.to(torch.int32) & 1).to(torch.uint8)
    return pack_bits(out_bits)
