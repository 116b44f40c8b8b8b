// Bit-sliced byte rows for Hopper (sm_90a), shared by gf2_matmul.cu and
// clay_fused.cu.
//
// A thread owns 32 byte columns of a 1024-column warp tile: words 0..3 are
// bytes [c0, c0+16), words 4..7 bytes [c0+512, c0+528), c0 = tile start +
// 16 * lane, so the warp reads or writes a row as two coalesced 16-byte
// accesses per thread.  transpose8 turns the 8 words into 8 plane words
// (word j = bit j of the 32 bytes) and back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTileCols = 1024;  // columns per warp tile (32 per thread)

__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int s,
                                          uint32_t m) {
  uint32_t t = ((a >> s) ^ b) & m;
  b ^= t;
  a ^= t << s;
}

// In every byte lane, transpose the 8x8 bit matrix (word q, bit b) ->
// (word b, bit q).  An involution: it also converts plane words back.
__device__ __forceinline__ void transpose8(uint32_t w[8]) {
#pragma unroll
  for (int q = 0; q < 4; q++) swap_bits(w[q], w[q + 4], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int q = 0; q < 8; q += 4) {
    swap_bits(w[q], w[q + 2], 2, 0x33333333u);
    swap_bits(w[q + 1], w[q + 3], 2, 0x33333333u);
  }
#pragma unroll
  for (int q = 0; q < 8; q += 2) swap_bits(w[q], w[q + 1], 1, 0x55555555u);
}

// Thread columns: words 0..3 are bytes [c0, c0+16), words 4..7 are bytes
// [c0+512, c0+528), where c0 = tile start + 16 * lane.
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row,
                                         long long c0, long long n, bool vec,
                                         uint32_t w[8]) {
  if (vec) {
    uint4 a = __ldg(reinterpret_cast<const uint4*>(row + c0));
    uint4 b = __ldg(reinterpret_cast<const uint4*>(row + c0 + 512));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; q++) {
    long long base = c0 + (q < 4 ? 4 * q : 512 + 4 * (q - 4));
    uint32_t v = 0;
#pragma unroll
    for (int l = 0; l < 4; l++) {
      long long x = base + l;
      if (x < n) v |= static_cast<uint32_t>(row[x]) << (8 * l);
    }
    w[q] = v;
  }
}

__device__ __forceinline__ void store_row(uint8_t* __restrict__ row,
                                          long long c0, long long n, bool vec,
                                          const uint32_t w[8]) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + c0) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(row + c0 + 512) =
        make_uint4(w[4], w[5], w[6], w[7]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; q++) {
    long long base = c0 + (q < 4 ? 4 * q : 512 + 4 * (q - 4));
#pragma unroll
    for (int l = 0; l < 4; l++) {
      long long x = base + l;
      if (x < n) row[x] = static_cast<uint8_t>(w[q] >> (8 * l));
    }
  }
}
