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
// Pallas kernels do; row b*q + r, column c holds bit b of M[r, c]) and
// every Clay parameter (k, t, g, det_inv / g^-1, lost) at run time, so one
// build serves every geometry and loss.  The TPU's lane tiling (w_a a
// multiple of the 128-lane column tile, clay_fused_cb_for) is not carried
// over: any w_a >= 1 runs, the ragged column edge masked byte by byte.
//
// What bounds them: each moves its inputs once and its outputs once —
// encode (k + q)*n_win*alpha*w_a bytes, repair ((k+q-1)*beta + alpha)*
// n_win*w_a — so on an H100 the floor is HBM bandwidth (3.35 TB/s).  The
// design keeps the whole transform out of device memory, as the TPU kernel
// keeps it in VMEM: the uncoupled operand, the virtual zero nodes and the
// uncoupled parity live only in registers.  The arithmetic runs on the
// integer ALUs on packed 4-byte words: a byte constant c times a word w is
// XOR_j (lane mask of bit j of w) & (c*2^j replicated in 4 lanes), and the
// R terms sit in shared memory in that replicated form.  This first design
// is simple rather than fast (a word per thread, companions re-read through
// L1/L2); making it meet the bound is later work.
//
// Encode: one thread per (window, class of the low digits z_0..z_{t-2},
// 4-byte column word).  The q layers of a class (z_{t-1} = 0..q-1) times
// the q parity nodes form a group the coupling step keeps closed (the
// parity row's companions differ only in digit t-1), so a thread holds the
// group's q*q parity words in registers and couples them without leaving
// the thread.
//
// Repair: one thread per (window, plane layer, column word).  The known
// rows' companions stay inside the plane; the thread writes its layer's
// in-plane cell and the q-1 cells the back-substitution reaches.
//
// Plain C interface for ctypes: each launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

// 0xFF in every byte lane whose bit j is set, 0x00 elsewhere
__device__ __forceinline__ uint32_t lane_mask(uint32_t w, int j) {
  return ((w >> j) & 0x01010101u) * 0xFFu;
}

// terms[j] = (c * 2^j) in all four byte lanes
__device__ __forceinline__ void const_terms(uint32_t c, uint32_t terms[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) terms[j] = gf_mul_byte(c, 1u << j) * 0x01010101u;
}

// c * w in every byte lane of w
__device__ __forceinline__ uint32_t gf_mul_word(uint32_t w,
                                                const uint32_t terms[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) acc ^= lane_mask(w, j) & terms[j];
  return acc;
}

// Bytes [c, c+4) of a row of n bytes; bytes at or past n read as 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row,
                                              long long c, long long n,
                                              bool aligned) {
  if (aligned && c + 4 <= n) {
    return __ldg(reinterpret_cast<const uint32_t*>(row + c));
  }
  uint32_t v = 0;
#pragma unroll
  for (int l = 0; l < 4; l++) {
    if (c + l < n) v |= static_cast<uint32_t>(__ldg(row + c + l)) << (8 * l);
  }
  return v;
}

__device__ __forceinline__ void store_word(uint8_t* __restrict__ row,
                                           long long c, long long n,
                                           bool aligned, uint32_t v) {
  if (aligned && c + 4 <= n) {
    *reinterpret_cast<uint32_t*>(row + c) = v;
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; l++) {
    if (c + l < n) row[c + l] = static_cast<uint8_t>(v >> (8 * l));
  }
}

// Shared-memory prologue common to both kernels: pw[y] = Q^y, and the
// replicated terms rterm[(i*8 + j)*Q + p] = (M[p, i] * 2^j) x 4 lanes of
// the [Q, k0] matrix given as its plane-major bits [8Q, 8k0].
template <int Q>
__device__ void load_matrix_terms(const uint8_t* __restrict__ mbits, int k0,
                                  int t, uint32_t* rterm, int* pw) {
  if (threadIdx.x == 0) {
    int p = 1;
    for (int y = 0; y <= t; y++) {
      pw[y] = p;
      p *= Q;
    }
  }
  for (int s = threadIdx.x; s < k0 * 8 * Q; s += blockDim.x) {
    const int p = s % Q, j = (s / Q) % 8, i = s / (8 * Q);
    uint32_t r = 0;
    for (int b = 0; b < 8; b++) {
      r |= static_cast<uint32_t>(mbits[(b * Q + p) * (8 * k0) + i] & 1u) << b;
    }
    rterm[s] = gf_mul_byte(r, 1u << j) * 0x01010101u;
  }
  __syncthreads();
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
clay_encode_kernel(const uint8_t* __restrict__ rbits,
                   const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                   int k, int t, int gamma, int det_inv, long long n_win,
                   long long w_a, int aligned) {
  extern __shared__ uint32_t rterm[];
  __shared__ int pw[kMaxT + 1];
  const int k0 = Q * (t - 1);
  load_matrix_terms<Q>(rbits, k0, t, rterm, pw);
  uint32_t gt[8], dt[8];
  const_terms(static_cast<uint32_t>(gamma), gt);
  const_terms(static_cast<uint32_t>(det_inv), dt);

  const int beta = pw[t - 1];
  const long long alpha = pw[t];
  const long long nwords = (w_a + 3) / 4;
  const long long total = n_win * beta * nwords;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < total; g += stride) {
    const long long c = (g % nwords) * 4;
    const long long rest = g / nwords;
    const int s = static_cast<int>(rest % beta);   // digits z_0..z_{t-2}
    const long long win = rest / beta;
    uint32_t par[Q][Q];   // [z_{t-1}][parity node]
#pragma unroll
    for (int a = 0; a < Q; a++) {
#pragma unroll
      for (int p = 0; p < Q; p++) par[a][p] = 0;
    }
#pragma unroll
    for (int zt = 0; zt < Q; zt++) {
      const int z = s + zt * beta;
      for (int i = 0; i < k0; i++) {
        const int x = i % Q, y = i / Q;
        const int zy = (s / pw[y]) % Q;   // y < t-1: the digit lies in s
        uint32_t u = 0;
        if (i < k) {   // virtual nodes store zeros (their U need not be 0)
          u = load_word(data + ((i * n_win + win) * alpha + z) * w_a, c,
                        w_a, aligned);
        }
        const int comp = y * Q + zy;
        if (zy != x && comp < k) {
          const int zc = z + (x - zy) * pw[y];
          u ^= gf_mul_word(
              load_word(data + ((comp * n_win + win) * alpha + zc) * w_a, c,
                        w_a, aligned),
              gt);
        }
        const uint32_t* rt = rterm + i * 8 * Q;
#pragma unroll
        for (int j = 0; j < 8; j++) {
          const uint32_t m = lane_mask(u, j);
#pragma unroll
          for (int p = 0; p < Q; p++) par[zt][p] ^= m & rt[j * Q + p];
        }
      }
    }
    // couple the parity row: (node p, layer zt) pairs with (node zt, layer p)
#pragma unroll
    for (int zt = 0; zt < Q; zt++) {
#pragma unroll
      for (int p = 0; p < Q; p++) {
        uint32_t v = par[zt][p];
        if (zt != p) v = gf_mul_word(v ^ gf_mul_word(par[p][zt], gt), dt);
        store_word(out + ((p * n_win + win) * alpha + s + zt * beta) * w_a,
                   c, w_a, aligned, v);
      }
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
clay_repair_kernel(const uint8_t* __restrict__ rbits,
                   const uint8_t* __restrict__ x4, uint8_t* __restrict__ out,
                   int k, int t, int lost, int gamma, int inv_gamma,
                   long long n_win, long long w_a, int aligned) {
  extern __shared__ uint32_t rterm[];
  __shared__ int pw[kMaxT + 1];
  const int k0 = Q * (t - 1);
  const int n0 = Q * t;
  int* hidx = reinterpret_cast<int*>(rterm + k0 * 8 * Q);   // [n0]
  const int lost_int = lost < k ? lost : n0 - Q + (lost - k);
  for (int n = threadIdx.x; n < n0; n += blockDim.x) {
    // internal node -> helper row (external ids ascending, lost skipped);
    // -1 for virtual nodes and the lost node
    int ext = n < k ? n : (n >= n0 - Q ? k + (n - (n0 - Q)) : -1);
    hidx[n] = (ext < 0 || n == lost_int) ? -1 : (ext < lost ? ext : ext - 1);
  }
  load_matrix_terms<Q>(rbits, k0, t, rterm, pw);
  uint32_t gt[8], it[8];
  const_terms(static_cast<uint32_t>(gamma), gt);
  const_terms(static_cast<uint32_t>(inv_gamma), it);

  const int x0 = lost_int % Q, y0 = lost_int / Q;
  const int beta = pw[t - 1];
  const long long alpha = pw[t];
  const long long nwords = (w_a + 3) / 4;
  const long long total = n_win * beta * nwords;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long hstride = n_win * beta * w_a;   // one helper's bytes
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < total; g += stride) {
    const long long c = (g % nwords) * 4;
    const long long rest = g / nwords;
    const int r = static_cast<int>(rest % beta);   // plane rank
    const long long win = rest / beta;
    // the plane layer: digit y0 := x0 inserted into r
    const int z = (r / pw[y0]) * pw[y0 + 1] + x0 * pw[y0] + r % pw[y0];
    const uint8_t* xw = x4 + win * beta * w_a;
    uint32_t acc[Q];
#pragma unroll
    for (int p = 0; p < Q; p++) acc[p] = 0;
    int ki = 0;   // column of R_r: known nodes ascending
    for (int n = 0; n < n0; n++) {
      const int y = n / Q;
      if (y == y0) continue;
      const int x = n % Q;
      const int zy = (z / pw[y]) % Q;
      uint32_t u = 0;
      if (hidx[n] >= 0) {
        u = load_word(xw + hidx[n] * hstride + r * w_a, c, w_a, aligned);
      }
      const int comp = y * Q + zy;
      if (zy != x && hidx[comp] >= 0) {
        // the companion layer keeps digit y0 = x0: it is in the plane
        const int zc = z + (x - zy) * pw[y];
        const int rc = (zc / pw[y0 + 1]) * pw[y0] + zc % pw[y0];
        u ^= gf_mul_word(load_word(xw + hidx[comp] * hstride + rc * w_a, c,
                                   w_a, aligned),
                         gt);
      }
      const uint32_t* rt = rterm + ki * 8 * Q;
#pragma unroll
      for (int j = 0; j < 8; j++) {
        const uint32_t m = lane_mask(u, j);
#pragma unroll
        for (int p = 0; p < Q; p++) acc[p] ^= m & rt[j * Q + p];
      }
      ki++;
    }
    uint8_t* ow = out + win * alpha * w_a;
#pragma unroll
    for (int x = 0; x < Q; x++) {
      if (x == x0) {   // the lost node's in-plane cell is diagonal: C = U
        store_word(ow + z * w_a, c, w_a, aligned, acc[x]);
        continue;
      }
      // C[lost, z with digit y0 := x] = g^-1 * (U[helper] ^ C[helper])
      const int hn = hidx[y0 * Q + x];
      const uint32_t ch =
          hn >= 0 ? load_word(xw + hn * hstride + r * w_a, c, w_a, aligned)
                  : 0u;
      store_word(ow + (z + (x - x0) * pw[y0]) * w_a, c, w_a, aligned,
                 gf_mul_word(acc[x] ^ ch, it));
    }
  }
}

size_t smem_bytes(int q, int t, bool repair) {
  const size_t k0 = static_cast<size_t>(q) * (t - 1);
  return k0 * 8 * q * sizeof(uint32_t) +
         (repair ? static_cast<size_t>(q) * t * sizeof(int) : 0);
}

long long grid_for(long long total, int sm_count) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count) * 8;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : blocks;
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

template <int Q>
int launch_encode(const uint8_t* rbits, int k, int t, int gamma, int det_inv,
                  const uint8_t* data, uint8_t* out, long long n_win,
                  long long w_a, int aligned, int sm_count,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, t, false);
  int rc = prepare(clay_encode_kernel<Q>, smem);
  if (rc) return rc;
  const long long total = n_win * ipow(Q, t - 1) * ((w_a + 3) / 4);
  clay_encode_kernel<Q><<<static_cast<unsigned>(grid_for(total, sm_count)),
                          kThreads, smem, stream>>>(
      rbits, data, out, k, t, gamma, det_inv, n_win, w_a, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_repair(const uint8_t* rbits, int k, int t, int lost, int gamma,
                  int inv_gamma, const uint8_t* x4, uint8_t* out,
                  long long n_win, long long w_a, int aligned, int sm_count,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, t, true);
  int rc = prepare(clay_repair_kernel<Q>, smem);
  if (rc) return rc;
  const long long total = n_win * ipow(Q, t - 1) * ((w_a + 3) / 4);
  clay_repair_kernel<Q><<<static_cast<unsigned>(grid_for(total, sm_count)),
                          kThreads, smem, stream>>>(
      rbits, x4, out, k, t, lost, gamma, inv_gamma, n_win, w_a, aligned);
  return static_cast<int>(cudaGetLastError());
}

int aligned_for(const void* a, const void* b, long long w_a) {
  return (w_a % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 4 == 0);
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
  const int al = aligned_for(data, out, w_a);
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
  const int al = aligned_for(x4, out, w_a);
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
  return static_cast<long long>(smem_bytes(q, t, repair != 0));
}

const char* clay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
