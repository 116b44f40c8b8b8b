// Fused Clay (MSR regenerating code) kernels for Hopper (sm_90a): the
// structured encode and the bandwidth-optimal single-loss repair.
//
// Clay(k, m): q = m, t = ceil((k + m) / q), n0 = q*t internal nodes on a
// q x t grid (node i = (x, y) = (i % q, i / q); data 0..k-1, virtual zero
// nodes k..k0-1, parity n0-q..n0-1), k0 = n0 - q, alpha = q^t layers per
// node, beta = q^(t-1).  Layer z has base-q digits z_0..z_{t-1}; digit y
// has stride q^y, so z_{t-1} owns the largest stride.  The companion of
// cell (x, y, z) with z_y != x is node (z_y, y) at layer z with digit
// y := x; uncoupled U = C ^ g*C[companion] (U = C on the diagonal).
//
// clay_fused_encode: data [k, n_win, alpha, w_a] -> parity [q, n_win,
// alpha, w_a].  Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py
// clay_fused_encode_pallas (body _clay_fused_encode_kernel): uncouple the
// t-1 data grid rows, apply the [q, k0] layer-MDS matrix R = gen[k0:] to
// every layer, couple the parity row back: C = det_inv*(P ^ g*P[comp]).
//
// clay_fused_repair: the helpers' repair-plane layers x4 [k+m-1, n_win,
// beta, w_a] (external ids ascending without the lost one, plane layers
// ascending) -> the lost shard's windows [n_win, alpha, w_a], layer-major.
// Replaces clay_fused_repair_pallas (body _clay_fused_repair_kernel):
// uncouple the k0 known cells of each plane layer, solve the lost node's
// grid row with R_r [q, k0], then write the in-plane cell (U) and the
// q-1 out-of-plane cells C = g^-1*(U ^ C[helper]).
//
// Both take the matrix as its plane-major bit form [8q, 8k0] (as the
// Pallas kernels do; row b*q + r, column j*k0 + c holds bit b of
// M[r, c]*2^j) and every Clay parameter (k, t, g, det_inv / g^-1, lost) at
// run time, so one build serves every geometry and loss.  The TPU's lane
// tiling (w_a a multiple of the 128-lane column tile, clay_fused_cb_for) is
// not carried over: any w_a >= 1 runs, the ragged column edge masked byte
// by byte.
//
// What bounds them: each moves its inputs once and its outputs once —
// encode (k + q)*n_win*alpha*w_a bytes, repair ((k+q-1)*beta + alpha)*
// n_win*w_a — so on an H100 the floor is HBM bandwidth (3.35 TB/s): at the
// fleet shapes, the encode [10, 512, 256, 4096] moves 7.5 GB in 2.244 ms,
// the repair [13, 512, 64, 4096] 2.28 GB in 0.681 ms.  Both keep the whole
// transform out of device memory, as the TPU kernels keep it in VMEM: the
// uncoupled operand, the virtual zero nodes and the uncoupled parity (the
// solved row) never reach HBM.
//
// Encode: bit-sliced, as gf2_matmul.cu (bitslice.cuh).  A warp owns one
// (window, layer, 1024-column tile); each thread reads 32 byte columns of a
// row as two 16-byte loads and transposes them into 8 plane words (word j
// = bit j of the 32 bytes).  In the plane domain a byte constant c is a
// fixed GF(2)-linear map, out plane b = XOR_j in plane j where bit b of
// c*2^j is set, so:
// - uncouple: U = C ^ G(C[companion]), the companion's 32 bytes read again
//   (through L2: blocks walk the grid in window order, so a window's
//   k*alpha*w_a bytes stay resident while its layers are encoded);
// - layer product: acc[o] ^= U[j] & mask[c, j, o], one LOP3 per (input
//   plane, output plane) pair over the 8k0 input planes, into 8q
//   accumulator planes (o = b*q + p);
// - couple: the parity row pairs (node p, layer z) with (node z_{t-1},
//   layer z with z_{t-1} := p).  A block holds the q layers of one class
//   (layers that differ only in z_{t-1}) for the same tiles, a warp each,
//   so the partner's planes come through shared memory after one barrier;
//   C = D(P ^ G(P')) in the plane domain (C = P on the diagonal), then the
//   transpose back and two 16-byte stores.
// The masks of R and the maps G (gamma) and D (det_inv) are expanded once
// per block into shared memory as 0 / ~0 words and read as warp-broadcast
// 16-byte loads; a thread issues the next cell's row loads before this
// cell's network, so they fly under it.  What still keeps it above half its bound is the LOP3
// network itself: 8q*8k0 LOP3 per 32 columns of a layer (3,072 at
// Clay(10,4)), about 3.5 ms at the fleet shape at the integer ALUs' rate,
// plus the transposes and the companion maps.
//
// Repair: bit-sliced the same way.  A warp owns one (window, plane rank r,
// 1024-column tile); a block's 8 warps take 8 consecutive items and walk
// the grid in window order, so a window's helper rows (13*64*4096 bytes at
// the default geometry) stay in L2 for the companion re-reads.  No warp
// reads another's results: there is no barrier in the item loop.
// - uncouple the k0 known cells (every node outside the lost row y0): own
//   row x4[helper, win, r] (0 for a virtual node), U ^= G(companion row),
//   the companion being in the plane too, at rank r with digit y moved to
//   x; a cell with neither row adds no term and is skipped;
// - row solve: acc[o] ^= U[j] & mask[i, j, o] over the 8k0 known planes
//   into the 8q planes (o = b*q + p) of the lost row's U, the masks of R_r
//   expanded once per block as for the encode;
// - outputs: the in-plane cell x0 is U itself; each other x reads its
//   helper's row at rank r, C = IG(U ^ C[helper]) with IG the inv_gamma
//   map, stored at layer z with digit y0 := x.
// What keeps it above its bound is, as for the encode, integer work: the
// LOP3 network, 8q*8k0 = 3,072 LOP3 and 768 broadcast 16-byte shared loads
// per 32 columns of a plane layer at Clay(10,4), plus about 2,800 ops of
// transposes (one per row read and per row written) and maps.  At the
// integer ALUs' rate (64 lanes per SM per clock) that is about 0.9 ms of
// network and 1.9 ms in all at the fleet shape.
//
// Plain C interface for ctypes: each launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitslice.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 30;

__device__ __forceinline__ uint32_t gf_mul_byte(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 8; i++) {
    if (b & 1u) r ^= a;
    b >>= 1;
    a <<= 1;
    if (a & 0x100u) a ^= 0x11Du;
  }
  return r;
}

// -- encode -------------------------------------------------------------------

// Block of the encode for parity count Q: a warp per (layer of the class,
// warp tile), kTiles tiles side by side.
template <int Q>
struct EncodeShape {
  static constexpr int kTiles = 8 / Q;
  static constexpr int kThreads = 32 * Q * kTiles;
  static constexpr int kOut = 8 * Q;   // accumulator planes, o = b*Q + p
};

// out[b] ^= XOR_j in[j] & map[j][b]: the plane form of a byte constant c
// times the 32 bytes of `in`, map[j] holding bit b of c*2^j as 0 / ~0 (two
// uint4 per j, loaded warp-broadcast).
__device__ __forceinline__ void gf_const_planes(const uint32_t in[8],
                                                const uint4* __restrict__ map,
                                                uint32_t out[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const uint4 lo = map[2 * j], hi = map[2 * j + 1];
    out[0] ^= in[j] & lo.x;
    out[1] ^= in[j] & lo.y;
    out[2] ^= in[j] & lo.z;
    out[3] ^= in[j] & lo.w;
    out[4] ^= in[j] & hi.x;
    out[5] ^= in[j] & hi.y;
    out[6] ^= in[j] & hi.z;
    out[7] ^= in[j] & hi.w;
  }
}

// Dynamic shared memory of the encode: masks [k0][8][8q] | maps [G, D][8][8]
// | exchange [tiles][q (layer digit)][q (node)][8 planes][32 lanes], words.
size_t encode_smem_bytes(int q, int t) {
  const size_t k0 = static_cast<size_t>(q) * (t - 1);
  const size_t tiles = 8 / q;
  return (k0 * 8 * 8 * q + 2 * 64 + tiles * q * q * 8 * 32) *
         sizeof(uint32_t);
}

template <int Q>
__global__ void __launch_bounds__(EncodeShape<Q>::kThreads)
clay_encode_kernel(const uint8_t* __restrict__ rbits,
                   const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                   int k, int t, int gamma, int det_inv, long long n_win,
                   long long w_a, int aligned) {
  using S = EncodeShape<Q>;
  constexpr int kOut = S::kOut, kO4 = kOut / 4;
  extern __shared__ uint4 smem4[];
  __shared__ int pw[kMaxT + 1];
  const int k0 = Q * (t - 1);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem4);
  const uint4* gmap = smem4 + k0 * 8 * kO4;
  const uint4* dmap = gmap + 16;
  uint32_t* ex = reinterpret_cast<uint32_t*>(smem4 + k0 * 8 * kO4 + 32);
  if (threadIdx.x == 0) {
    int p = 1;
    for (int y = 0; y <= t; y++) {
      pw[y] = p;
      p *= Q;
    }
  }
  // mask of (input cell c, input plane j) for output plane o = b*Q + p:
  // bit b of R[p, c] * 2^j, i.e. rbits[o, j*k0 + c]
  for (int s = threadIdx.x; s < k0 * 8 * kOut; s += blockDim.x) {
    const int o = s % kOut, cj = s / kOut;
    masks[s] = rbits[o * (8 * k0) + (cj & 7) * k0 + (cj >> 3)] ? ~0u : 0u;
  }
  for (int s = threadIdx.x; s < 128; s += blockDim.x) {
    const uint32_t c = static_cast<uint32_t>(s < 64 ? gamma : det_inv);
    const int j = (s >> 3) & 7, b = s & 7;
    masks[k0 * 8 * kOut + s] = (gf_mul_byte(c, 1u << j) >> b) & 1u ? ~0u : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zt = warp % Q, slot = warp / Q;   // layer digit z_{t-1}, tile
  const int beta = pw[t - 1];
  const long long alpha = pw[t];
  const long long tiles = (w_a + kTileCols - 1) / kTileCols;
  const long long groups = (tiles + S::kTiles - 1) / S::kTiles;
  const long long items = n_win * beta * groups;
  uint32_t* xs = ex + slot * (Q * Q * 8 * 32) + lane;   // [zt][p][b], x32
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long tile = (it % groups) * S::kTiles + slot;
    const long long rest = it / groups;
    const int s = static_cast<int>(rest % beta);   // digits z_0..z_{t-2}
    const long long win = rest / beta;
    const int z = s + zt * beta;
    const bool active = tile < tiles;
    const long long c0 = tile * kTileCols + 16 * lane;
    const bool vec = aligned && c0 + 528 <= w_a;
    uint32_t acc[kOut];
#pragma unroll
    for (int o = 0; o < kOut; o++) acc[o] = 0;
    if (active) {
      // the rows of cell i = y*Q + x: its own (none for a virtual node) and
      // its companion's (none on the diagonal or for a virtual companion)
      auto rows = [&](int i, const uint8_t*& own, const uint8_t*& cmp) {
        const int y = i / Q, x = i % Q;
        const int zy = (s / pw[y]) % Q;   // y < t-1: the digit lies in s
        const int comp = y * Q + zy;
        own = i < k ? data + ((i * n_win + win) * alpha + z) * w_a : nullptr;
        cmp = zy != x && comp < k
                  ? data + ((comp * n_win + win) * alpha + z +
                            (x - zy) * pw[y]) * w_a
                  : nullptr;
      };
      const uint8_t *own, *cmp;
      uint32_t ru[8], rc[8] = {};   // raw words of the cell in flight
      rows(0, own, cmp);
      if (own) load_row(own, c0, w_a, vec, ru);
      if (cmp) load_row(cmp, c0, w_a, vec, rc);
#pragma unroll 1
      for (int i = 0; i < k0; i++) {
        const bool has_own = own != nullptr, has_cmp = cmp != nullptr;
        uint32_t u[8], cw[8];
#pragma unroll
        for (int b = 0; b < 8; b++) {
          u[b] = has_own ? ru[b] : 0u;   // virtual nodes store zeros
          cw[b] = rc[b];
        }
        if (i + 1 < k0) {   // the next cell's loads fly under this network
          rows(i + 1, own, cmp);
          if (own) load_row(own, c0, w_a, vec, ru);
          if (cmp) load_row(cmp, c0, w_a, vec, rc);
        }
        if (!has_own && !has_cmp) continue;   // U = 0: no term
        if (has_own) transpose8(u);
        if (has_cmp) {   // U = C ^ G(C[companion]); a virtual node's U
          transpose8(cw);   // need not be 0
          gf_const_planes(cw, gmap, u);
        }
        const uint4* mrow = smem4 + i * 8 * kO4;   // masks of cell i
#pragma unroll
        for (int j = 0; j < 8; j++) {
#pragma unroll
          for (int o4 = 0; o4 < kO4; o4++) {
            const uint4 m = mrow[j * kO4 + o4];
            acc[4 * o4 + 0] ^= u[j] & m.x;
            acc[4 * o4 + 1] ^= u[j] & m.y;
            acc[4 * o4 + 2] ^= u[j] & m.z;
            acc[4 * o4 + 3] ^= u[j] & m.w;
          }
        }
      }
      // this layer's uncoupled parity planes, for the partners' couple
#pragma unroll
      for (int p = 0; p < Q; p++) {
#pragma unroll
        for (int b = 0; b < 8; b++) {
          xs[((zt * Q + p) * 8 + b) * 32] = acc[b * Q + p];
        }
      }
    }
    __syncthreads();
    if (active) {
      // couple the parity row: (node p, digit zt) pairs with (node zt,
      // digit p); C = D(P ^ G(P')) off the diagonal, C = P on it
#pragma unroll
      for (int p = 0; p < Q; p++) {
        uint32_t w[8];
        if (p == zt) {
#pragma unroll
          for (int b = 0; b < 8; b++) w[b] = acc[b * Q + p];
        } else {
          uint32_t v[8], e[8];
#pragma unroll
          for (int b = 0; b < 8; b++) {
            v[b] = acc[b * Q + p];
            e[b] = xs[((p * Q + zt) * 8 + b) * 32];
            w[b] = 0;
          }
          gf_const_planes(e, gmap, v);
          gf_const_planes(v, dmap, w);
        }
        transpose8(w);
        store_row(out + ((p * n_win + win) * alpha + z) * w_a, c0, w_a, vec,
                  w);
      }
    }
    __syncthreads();   // the exchange is reused by the next item
  }
}

// -- repair -------------------------------------------------------------------

// Dynamic shared memory of the repair: masks [k0][8][8q] | maps [G, IG][8][8]
// words | hidx [n0] ints.
size_t repair_smem_bytes(int q, int t) {
  const size_t k0 = static_cast<size_t>(q) * (t - 1);
  return (k0 * 8 * 8 * q + 2 * 64) * sizeof(uint32_t) +
         static_cast<size_t>(q) * t * sizeof(int);
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
clay_repair_kernel(const uint8_t* __restrict__ rbits,
                   const uint8_t* __restrict__ x4, uint8_t* __restrict__ out,
                   int k, int t, int lost, int gamma, int inv_gamma,
                   long long n_win, long long w_a, int aligned) {
  constexpr int kOut = 8 * Q, kO4 = kOut / 4;   // planes o = b*Q + p
  constexpr int kWarps = kThreads / 32;
  extern __shared__ uint4 smem4[];
  __shared__ int pw[kMaxT + 1];
  const int k0 = Q * (t - 1);
  const int n0 = Q * t;
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem4);
  const uint4* gmap = smem4 + k0 * 8 * kO4;
  const uint4* imap = gmap + 16;
  int* hidx = reinterpret_cast<int*>(smem4 + k0 * 8 * kO4 + 32);
  const int lost_int = lost < k ? lost : n0 - Q + (lost - k);
  if (threadIdx.x == 0) {
    int p = 1;
    for (int y = 0; y <= t; y++) {
      pw[y] = p;
      p *= Q;
    }
  }
  for (int n = threadIdx.x; n < n0; n += blockDim.x) {
    // internal node -> helper row (external ids ascending, lost skipped);
    // -1 for virtual nodes and the lost node
    const int ext = n < k ? n : (n >= n0 - Q ? k + (n - (n0 - Q)) : -1);
    hidx[n] = (ext < 0 || n == lost_int) ? -1 : (ext < lost ? ext : ext - 1);
  }
  // mask of (known cell i, input plane j) for output plane o = b*Q + p:
  // bit b of R_r[p, i] * 2^j, i.e. rbits[o, j*k0 + i]
  for (int s = threadIdx.x; s < k0 * 8 * kOut; s += blockDim.x) {
    const int o = s % kOut, cj = s / kOut;
    masks[s] = rbits[o * (8 * k0) + (cj & 7) * k0 + (cj >> 3)] ? ~0u : 0u;
  }
  for (int s = threadIdx.x; s < 128; s += blockDim.x) {
    const uint32_t c = static_cast<uint32_t>(s < 64 ? gamma : inv_gamma);
    const int j = (s >> 3) & 7, b = s & 7;
    masks[k0 * 8 * kOut + s] = (gf_mul_byte(c, 1u << j) >> b) & 1u ? ~0u : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = lost_int % Q, y0 = lost_int / Q;
  const int beta = pw[t - 1];
  const long long alpha = pw[t];
  const long long tiles = (w_a + kTileCols - 1) / kTileCols;
  const long long items = n_win * beta * tiles;
  const long long hstride = n_win * beta * w_a;   // one helper's bytes
  // a warp per (window, plane rank, tile) item, a block's warps on
  // consecutive items; no warp reads another's results
  for (long long it = static_cast<long long>(blockIdx.x) * kWarps + warp;
       it < items; it += static_cast<long long>(gridDim.x) * kWarps) {
    const long long tile = it % tiles;
    const long long rest = it / tiles;
    const int r = static_cast<int>(rest % beta);   // plane rank
    const long long win = rest / beta;
    // the plane layer: digit y0 := x0 inserted into r
    const int z = (r / pw[y0]) * pw[y0 + 1] + x0 * pw[y0] + r % pw[y0];
    const long long c0 = tile * kTileCols + 16 * lane;
    const bool vec = aligned && c0 + 528 <= w_a;
    const uint8_t* xw = x4 + win * beta * w_a;
    // the rows of known cell i (internal node i, or i + Q from row y0 on):
    // its own (none for a virtual node) and its companion's (none on the
    // diagonal or for a virtual companion).  The companion layer keeps
    // digit y0 = x0, so it is in the plane: digit y has stride pw[y] in
    // the rank below y0 and pw[y - 1] above it.
    auto rows = [&](int i, const uint8_t*& own, const uint8_t*& cmp) {
      const int n = i < y0 * Q ? i : i + Q;
      const int y = n / Q, x = n % Q;
      const int py = pw[y < y0 ? y : y - 1];
      const int zy = (r / py) % Q;
      const int hc = hidx[y * Q + zy];
      own = hidx[n] >= 0 ? xw + hidx[n] * hstride + r * w_a : nullptr;
      cmp = zy != x && hc >= 0
                ? xw + hc * hstride + (r + (x - zy) * py) * w_a
                : nullptr;
    };
    uint32_t acc[kOut];
#pragma unroll
    for (int o = 0; o < kOut; o++) acc[o] = 0;
    const uint8_t *own, *cmp;
    uint32_t ru[8], rc[8] = {};   // raw words of the cell in flight
    rows(0, own, cmp);
    if (own) load_row(own, c0, w_a, vec, ru);
    if (cmp) load_row(cmp, c0, w_a, vec, rc);
#pragma unroll 1
    for (int i = 0; i < k0; i++) {
      const bool has_own = own != nullptr, has_cmp = cmp != nullptr;
      uint32_t u[8], cw[8];
#pragma unroll
      for (int b = 0; b < 8; b++) {
        u[b] = has_own ? ru[b] : 0u;   // virtual nodes store zeros
        cw[b] = rc[b];
      }
      if (i + 1 < k0) {   // the next cell's loads fly under this network
        rows(i + 1, own, cmp);
        if (own) load_row(own, c0, w_a, vec, ru);
        if (cmp) load_row(cmp, c0, w_a, vec, rc);
      }
      if (!has_own && !has_cmp) continue;   // U = 0: no term
      if (has_own) transpose8(u);
      if (has_cmp) {   // U = C ^ G(C[companion])
        transpose8(cw);
        gf_const_planes(cw, gmap, u);
      }
      const uint4* mrow = smem4 + i * 8 * kO4;   // masks of known cell i
#pragma unroll
      for (int j = 0; j < 8; j++) {
#pragma unroll
        for (int o4 = 0; o4 < kO4; o4++) {
          const uint4 m = mrow[j * kO4 + o4];
          acc[4 * o4 + 0] ^= u[j] & m.x;
          acc[4 * o4 + 1] ^= u[j] & m.y;
          acc[4 * o4 + 2] ^= u[j] & m.z;
          acc[4 * o4 + 3] ^= u[j] & m.w;
        }
      }
    }
    // the lost node's cells of row y0: x = x0 is in the plane (diagonal,
    // C = U); every other x lies out of it, at layer z with digit y0 := x,
    // C = IG(U ^ C[helper (x, y0)]), a virtual helper reading as 0
    uint8_t* ow = out + win * alpha * w_a;
#pragma unroll
    for (int x = 0; x < Q; x++) {
      uint32_t w[8];
      if (x == x0) {
#pragma unroll
        for (int b = 0; b < 8; b++) w[b] = acc[b * Q + x];
      } else {
        const int hn = hidx[y0 * Q + x];
        uint32_t v[8] = {};
        if (hn >= 0) {
          load_row(xw + hn * hstride + r * w_a, c0, w_a, vec, v);
          transpose8(v);
        }
#pragma unroll
        for (int b = 0; b < 8; b++) {
          v[b] ^= acc[b * Q + x];
          w[b] = 0;
        }
        gf_const_planes(v, imap, w);
      }
      transpose8(w);
      store_row(ow + (z + (x - x0) * pw[y0]) * w_a, c0, w_a, vec, w);
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

long long ipow(int q, int e) {
  long long p = 1;
  for (int i = 0; i < e; i++) p *= q;
  return p;
}

// One block per resident slot: the blocks walk the (window, class, tile
// group) items in order, so the windows in flight stay in L2.
template <int Q>
int launch_encode(const uint8_t* rbits, int k, int t, int gamma, int det_inv,
                  const uint8_t* data, uint8_t* out, long long n_win,
                  long long w_a, int aligned, int sm_count,
                  cudaStream_t stream) {
  using S = EncodeShape<Q>;
  const size_t smem = encode_smem_bytes(Q, t);
  int rc = prepare(clay_encode_kernel<Q>, smem);
  if (rc) return rc;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, clay_encode_kernel<Q>, S::kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (w_a + kTileCols - 1) / kTileCols;
  const long long items =
      n_win * ipow(Q, t - 1) * ((tiles + S::kTiles - 1) / S::kTiles);
  long long blocks =
      static_cast<long long>(sm_count) * (per_sm > 0 ? per_sm : 1);
  if (blocks > items) blocks = items;
  clay_encode_kernel<Q><<<static_cast<unsigned>(blocks), S::kThreads, smem,
                          stream>>>(rbits, data, out, k, t, gamma, det_inv,
                                    n_win, w_a, aligned);
  return static_cast<int>(cudaGetLastError());
}

// The same walk for the repair: a block's warps take consecutive (window,
// plane rank, tile) items, so a window's helper rows stay in L2 for the
// companion re-reads.
template <int Q>
int launch_repair(const uint8_t* rbits, int k, int t, int lost, int gamma,
                  int inv_gamma, const uint8_t* x4, uint8_t* out,
                  long long n_win, long long w_a, int aligned, int sm_count,
                  cudaStream_t stream) {
  const size_t smem = repair_smem_bytes(Q, t);
  int rc = prepare(clay_repair_kernel<Q>, smem);
  if (rc) return rc;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, clay_repair_kernel<Q>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (w_a + kTileCols - 1) / kTileCols;
  const long long items = n_win * ipow(Q, t - 1) * tiles;
  const long long groups = (items + kThreads / 32 - 1) / (kThreads / 32);
  long long blocks =
      static_cast<long long>(sm_count) * (per_sm > 0 ? per_sm : 1);
  if (blocks > groups) blocks = groups;
  clay_repair_kernel<Q><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(rbits, x4, out, k, t, lost, gamma,
                                    inv_gamma, n_win, w_a, aligned);
  return static_cast<int>(cudaGetLastError());
}

int aligned16_for(const void* a, const void* b, long long w_a) {
  return (w_a % 16 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

}  // namespace

extern "C" {

// parity [q, n_win, alpha, w_a] from data [k, n_win, alpha, w_a]; rbits is
// R = gen[k0:] as plane-major bits [8q, 8k0].  All pointers on the device;
// the launch goes on `stream` and does not synchronise.  q in 2..8.
int clay_fused_encode(const uint8_t* rbits, int q, int k, int t, int gamma,
                      int det_inv, const uint8_t* data, uint8_t* out,
                      long long n_win, long long w_a, int sm_count,
                      void* stream) {
  if (n_win == 0 || w_a == 0) return 0;
  if (t < 2 || t > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int al = aligned16_for(data, out, w_a);
  switch (q) {
    case 2: return launch_encode<2>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    case 3: return launch_encode<3>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    case 4: return launch_encode<4>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    case 5: return launch_encode<5>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    case 6: return launch_encode<6>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    case 7: return launch_encode<7>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    case 8: return launch_encode<8>(rbits, k, t, gamma, det_inv, data, out, n_win, w_a, al, sm_count, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the lost shard [n_win, alpha, w_a] from x4 [k+q-1, n_win, beta, w_a];
// rbits is R_r as plane-major bits [8q, 8k0]; lost is the external id.
int clay_fused_repair(const uint8_t* rbits, int q, int k, int t, int lost,
                      int gamma, int inv_gamma, const uint8_t* x4,
                      uint8_t* out, long long n_win, long long w_a,
                      int sm_count, void* stream) {
  if (n_win == 0 || w_a == 0) return 0;
  if (t < 2 || t > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int al = aligned16_for(x4, out, w_a);
  switch (q) {
    case 2: return launch_repair<2>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    case 3: return launch_repair<3>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    case 4: return launch_repair<4>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    case 5: return launch_repair<5>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    case 6: return launch_repair<6>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    case 7: return launch_repair<7>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    case 8: return launch_repair<8>(rbits, k, t, lost, gamma, inv_gamma, x4, out, n_win, w_a, al, sm_count, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one launch needs: the wrapper's budget check.
long long clay_fused_smem_bytes(int q, int t, int repair) {
  return static_cast<long long>(repair ? repair_smem_bytes(q, t)
                                       : encode_smem_bytes(q, t));
}

const char* clay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
