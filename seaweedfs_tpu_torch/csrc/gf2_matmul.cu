// GF(2^8) matrix product on bit-planes, for Hopper (sm_90a).
//
//   out[v, r, x] = XOR_c  M[r, c] * in[v, c, x]        (products in GF(2^8))
//
// for any GF(2^8) matrix M [MO, KI], given as its plane-major bit-matrix
// mbits [8MO, 8KI] (one byte per bit, 0 or 1): row i*MO + r, column j*KI + c
// holds bit i of M[r, c] * 2^j.  The matrix is a runtime input, so one build
// serves the Reed-Solomon encode (parity rows) and every reconstruct (a
// decode matrix per loss mask).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py
// gf_matmul_bits_pallas_sm (body _gf2_matmul_kernel_sm), which unpacks the
// bytes to 8 bit-planes, runs a 0/1 int8 matmul on the MXU, keeps the low
// bit and packs.  Its (8, 128) tiling, the [KI, V, B] shard-major layout and
// the V % 8 / B % block_b padding exist for the TPU and are not carried
// over: this kernel takes [KI, N] or [V, KI, N], contiguous, any N, and
// masks the ragged edge itself.
//
// What bounds it: the function moves (KI + MO) * N bytes and no more (each
// input byte read once, each output byte written once), so on an H100 it is
// bound by HBM bandwidth (3.35 TB/s); as int8 multiply-adds the work is
// 2 * 8MO * 8KI * N operations, which the tensor cores would finish in less
// time than the bytes take.  This design spends integer-ALU instructions
// instead of tensor cores:
//
// - Bit-sliced.  A thread owns 32 byte columns of a 1024-column warp tile
//   and reads each input row as two coalesced 16-byte loads (the warp reads
//   512 contiguous bytes per load).  An 8x8 bit transpose inside each byte
//   lane (3 rounds of masked swaps over the 8 words) turns the 32 bytes
//   into 8 plane words: word j holds bit j of all 32 bytes.
// - XOR network.  Each output plane word accumulates, over the 8KI input
//   plane words, `acc ^= plane & mask`, one LOP3 per (input, output) plane
//   pair for 32 columns.  The masks (0 or ~0 per pair) are expanded once per
//   block into shared memory and read as warp-broadcast 16-byte loads.
// - The same transpose turns the 8 plane words of each output row back into
//   32 bytes, stored with the same two coalesced 16-byte stores.
//
// Output rows are processed R <= 8 at a time (blockIdx.y picks the group),
// which bounds the accumulators at 8R registers.  Blocks walk the
// (volume, tile) space grid-stride.  Tiles that run past N, or rows that
// are not 16-byte aligned, take a byte-wise guarded load and store path.
//
// Plain C interface for ctypes: the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitslice.cuh"

namespace {

constexpr int kThreads = 256;

// R: output rows per block (the row group).  Shared memory holds, for each
// input plane p = 8c + j, the 8R masks of output planes o = i*R + rr.
template <int R>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const uint8_t* __restrict__ mbits, int mo, int ki,
                  const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  long long v, long long n, int aligned) {
  extern __shared__ uint4 smem4[];
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem4);
  constexpr int kOut = 8 * R;
  const int g = blockIdx.y;
  const int kin = 8 * ki;
  for (int s = threadIdx.x; s < kin * kOut; s += blockDim.x) {
    const int o = s % kOut, p = s / kOut;
    const int c = p >> 3, j = p & 7;
    const int i = o / R, r = g * R + o % R;
    uint32_t m = 0;
    if (r < mo) m = mbits[(i * mo + r) * kin + j * ki + c] ? ~0u : 0u;
    masks[s] = m;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long tiles_per_row = (n + kTileCols - 1) / kTileCols;
  const long long total = v * tiles_per_row;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  for (; t < total; t += nwarps) {
    const long long vol = t / tiles_per_row;
    const long long c0 = (t - vol * tiles_per_row) * kTileCols + 16 * lane;
    const bool vec = aligned && (c0 + 528 <= n);
    const uint8_t* src = in + vol * ki * n;
    uint32_t acc[kOut];
#pragma unroll
    for (int o = 0; o < kOut; o++) acc[o] = 0;
    for (int c = 0; c < ki; c++) {
      uint32_t w[8];
      load_row(src + c * n, c0, n, vec, w);
      transpose8(w);
      const uint4* mrow = smem4 + c * 8 * (kOut / 4);
#pragma unroll
      for (int j = 0; j < 8; j++) {
#pragma unroll
        for (int o4 = 0; o4 < kOut / 4; o4++) {
          const uint4 m = mrow[j * (kOut / 4) + o4];
          acc[4 * o4 + 0] ^= w[j] & m.x;
          acc[4 * o4 + 1] ^= w[j] & m.y;
          acc[4 * o4 + 2] ^= w[j] & m.z;
          acc[4 * o4 + 3] ^= w[j] & m.w;
        }
      }
    }
    uint8_t* dst = out + (vol * mo + g * R) * n;
#pragma unroll
    for (int rr = 0; rr < R; rr++) {
      if (g * R + rr >= mo) break;
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; i++) w[i] = acc[i * R + rr];
      transpose8(w);
      store_row(dst + rr * n, c0, n, vec, w);
    }
  }
}

template <int R>
int launch(const uint8_t* mbits, int mo, int ki, const uint8_t* in,
           uint8_t* out, long long v, long long n, int sm_count,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(8) * ki * 8 * R * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_matmul_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = v * ((n + kTileCols - 1) / kTileCols);
  const long long warps_per_block = kThreads / 32;
  long long blocks = (tiles + warps_per_block - 1) / warps_per_block;
  const long long cap = static_cast<long long>(sm_count) * 8;
  if (blocks > cap) blocks = cap;
  const int aligned = (n % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  dim3 grid(static_cast<unsigned>(blocks), (mo + R - 1) / R);
  gf2_matmul_kernel<R><<<grid, kThreads, smem, stream>>>(mbits, mo, ki, in,
                                                         out, v, n, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [v, mo, n] = M ∘GF∘ in [v, ki, n]; mbits is the plane-major
// [8mo, 8ki] bit-matrix.  All pointers on the device; the launch goes on
// `stream` and does not synchronise.  Returns cudaGetLastError().
int gf2_matmul_bits(const uint8_t* mbits, int mo, int ki, const uint8_t* in,
                    uint8_t* out, long long v, long long n, int sm_count,
                    void* stream) {
  if (v == 0 || n == 0 || mo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = mo < 8 ? mo : 8;
  switch (r) {
    case 1: return launch<1>(mbits, mo, ki, in, out, v, n, sm_count, s);
    case 2: return launch<2>(mbits, mo, ki, in, out, v, n, sm_count, s);
    case 3: return launch<3>(mbits, mo, ki, in, out, v, n, sm_count, s);
    case 4: return launch<4>(mbits, mo, ki, in, out, v, n, sm_count, s);
    case 5: return launch<5>(mbits, mo, ki, in, out, v, n, sm_count, s);
    case 6: return launch<6>(mbits, mo, ki, in, out, v, n, sm_count, s);
    case 7: return launch<7>(mbits, mo, ki, in, out, v, n, sm_count, s);
    default: return launch<8>(mbits, mo, ki, in, out, v, n, sm_count, s);
  }
}

// Shared memory one launch needs for (mo, ki): the wrapper's budget check.
long long gf2_matmul_smem_bytes(int mo, int ki) {
  const int r = mo < 8 ? mo : 8;
  return 8LL * ki * 8 * r * static_cast<long long>(sizeof(uint32_t));
}

const char* gf2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
