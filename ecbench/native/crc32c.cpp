// CRC32-Castagnoli, hardware-accelerated where available.
//
// The benchmark's frozen copy of the needle checksum SeaweedFS uses
// (weed/storage/needle/crc.go:12), built with the host g++ by
// ecbench/volume.py.
// x86-64: SSE4.2 crc32q instruction, 8 bytes/cycle-ish; elsewhere a
// slice-by-8 table fallback. Exposed via a plain C ABI for ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <cpuid.h>
#include <nmmintrin.h>
#endif

namespace {

const uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; k++)
      for (uint32_t i = 0; i < 256; i++)
        t[k][i] = t[0][t[k - 1][i] & 0xFF] ^ (t[k - 1][i] >> 8);
  }
};
const Tables kTables;

uint32_t crc_sw(uint32_t crc, const uint8_t* p, size_t n) {
  uint32_t c = crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = kTables.t[7][c & 0xFF] ^ kTables.t[6][(c >> 8) & 0xFF] ^
        kTables.t[5][(c >> 16) & 0xFF] ^ kTables.t[4][c >> 24] ^
        kTables.t[3][hi & 0xFF] ^ kTables.t[2][(hi >> 8) & 0xFF] ^
        kTables.t[1][(hi >> 16) & 0xFF] ^ kTables.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = kTables.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c;
}

#if defined(__x86_64__)
bool have_sse42() {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
  return c & bit_SSE4_2;
}
const bool kHaveSse42 = have_sse42();

__attribute__((target("sse4.2")))
uint32_t crc_hw(uint32_t c64, const uint8_t* p, size_t n) {
  uint64_t c = c64;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}
#endif

}  // namespace

extern "C" uint32_t sw_crc32c(uint32_t crc, const uint8_t* data, size_t len) {
  uint32_t c = crc ^ 0xFFFFFFFFu;
#if defined(__x86_64__)
  if (kHaveSse42) return crc_hw(c, data, len) ^ 0xFFFFFFFFu;
#endif
  return crc_sw(c, data, len) ^ 0xFFFFFFFFu;
}
