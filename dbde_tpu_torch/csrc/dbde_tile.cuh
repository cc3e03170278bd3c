// Per-tile DBDE arithmetic shared by the CUDA kernels (dbde_kernels.cu) and a
// CPU test library built from this header alone with g++
// (tests/test_torch_tile_math.py).  Everything here is plain integer code on
// one 8x8 tile held in registers; loading and storing a tile belongs to the
// kernels.
//
// A tile is 16 u32 words: word 2r+h holds pixels (r, 4h..4h+3), lowest byte
// first -- the little-endian view of the tile's 8 rows of 8 bytes.  Pixel i
// (row-major, 0..63) is byte i&3 of word i>>2.
//
// Counterparts in the JAX package: the depth rule of
// dbde_tpu/ops/pallas_band.py:370-383 (_depths_kernel), the pack closed form
// of dbde_tpu/ops/kernel_common.py:57-71 (_pack_contributions) and the
// funnel-shift unpack of dbde_tpu/ops/pallas_band.py:1521-1550, and the
// bytewise min subtract/add of its uniform depth-8 kernels (pallas_band.py:889,
// 1025, 1189).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define DBDE_HD __host__ __device__ __forceinline__
#define DBDE_UNROLL _Pragma("unroll")
#else
#define DBDE_HD inline
#define DBDE_UNROLL
#endif

#define DBDE_WORDS_PER_TILE 16  // depth 8: 64 pixels * 8 bits / 32

DBDE_HD uint32_t dbde_pixel(const uint32_t tile[16], int i) {
  return (tile[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// Depth rule (dbde_util.cpp:48,57,66-68): 0 iff the tile is flat, otherwise
// bit_length(max - min), so 8 iff the range is at least 128.
DBDE_HD uint32_t dbde_depth_of_range(uint32_t range) {
#ifdef __CUDA_ARCH__
  return range ? 32u - (uint32_t)__clz((int)range) : 0u;
#else
  return range ? 32u - (uint32_t)__builtin_clz(range) : 0u;
#endif
}

DBDE_HD void dbde_tile_depth_min(const uint32_t tile[16], uint32_t* depth,
                                 uint32_t* mn) {
  uint32_t lo = 255u, hi = 0u;
  DBDE_UNROLL
  for (int i = 0; i < 64; ++i) {
    const uint32_t p = dbde_pixel(tile, i);
    lo = p < lo ? p : lo;
    hi = p > hi ? p : hi;
  }
  *depth = dbde_depth_of_range(hi - lo);
  *mn = lo;
}

// Pack the residuals pixel - mn of a depth-K tile LSB-first into words
// w[0..2K): pixel i occupies bits [i*K, i*K+K) of the tile's bit string, so
// word j = (i*K)>>5 at shift (i*K)&31, straddling into word j+1 for
// K in {3, 5, 6, 7}.  A pair of u32 words, low word first, is the format's
// little-endian u64.  Requires every residual < 2^K (true when K is the
// tile's own depth).  Writes nothing past w[2K-1].
template <int K>
DBDE_HD void dbde_pack_k(const uint32_t tile[16], uint32_t mn, uint32_t w[16]) {
  DBDE_UNROLL
  for (int j = 0; j < 2 * K; ++j) w[j] = 0u;
  DBDE_UNROLL
  for (int i = 0; i < 64; ++i) {
    const uint32_t r = dbde_pixel(tile, i) - mn;
    const int bit = i * K, j = bit >> 5, sh = bit & 31;
    w[j] |= r << sh;
    if (sh + K > 32) w[j + 1] |= r >> (32 - sh);  // guard: no shift by 32
  }
}

// Inverse of dbde_pack_k: reads w[0..2K), adds mn back (mod 256, as the
// JAX package's u8 cast does for corrupt streams) and returns pixels in
// the tile word layout.
template <int K>
DBDE_HD void dbde_unpack_k(const uint32_t w[16], uint32_t mn, uint32_t tile[16]) {
  const uint32_t mask = (1u << K) - 1u;
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) {
    uint32_t out = 0u;
    DBDE_UNROLL
    for (int b = 0; b < 4; ++b) {
      const int bit = (4 * q + b) * K, j = bit >> 5, sh = bit & 31;
      uint32_t v = w[j] >> sh;
      if (sh + K > 32) v |= w[j + 1] << (32 - sh);  // funnel shift
      out |= (((v & mask) + mn) & 0xFFu) << (8 * b);
    }
    tile[q] = out;
  }
}

// A tile whose depth is 0 (or not a legal depth) decodes to its minimum.
DBDE_HD void dbde_fill_tile(uint32_t mn, uint32_t tile[16]) {
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) tile[q] = (mn & 0xFFu) * 0x01010101u;
}

// Bytewise a - b and a + b modulo 256, four bytes a word, no borrow or carry
// between bytes (SWAR: the low seven bits of each byte add in place, the top
// bit is fixed up by xor).
DBDE_HD uint32_t dbde_sub_bytes(uint32_t a, uint32_t b) {
  return ((a | 0x80808080u) - (b & 0x7F7F7F7Fu)) ^ ((a ^ ~b) & 0x80808080u);
}

DBDE_HD uint32_t dbde_add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu)) ^ ((a ^ b) & 0x80808080u);
}

// Depth 8 as a whole-tile form: pixel i is byte i of the tile's 64-byte bit
// string, which is byte i&3 of word i>>2 -- the tile word layout itself.  So
// a depth-8 tile's 16 payload words are its 16 row words with the minimum
// taken from every byte, and decoding adds it back.  Same words as
// dbde_pack_k<8> / dbde_unpack_k<8> in a quarter of the operations; the
// uniform depth-8 kernels (K4, K5) use these.
DBDE_HD void dbde_pack8(const uint32_t tile[16], uint32_t mn, uint32_t w[16]) {
  const uint32_t m4 = (mn & 0xFFu) * 0x01010101u;
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) w[q] = dbde_sub_bytes(tile[q], m4);
}

DBDE_HD void dbde_unpack8(const uint32_t w[16], uint32_t mn, uint32_t tile[16]) {
  const uint32_t m4 = (mn & 0xFFu) * 0x01010101u;
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) tile[q] = dbde_add_bytes(w[q], m4);
}

// Runtime-depth forms of the above, for the CPU test library.  The kernels
// switch on the depth themselves so that every word index stays a
// compile-time constant and the words stay in registers.
DBDE_HD int dbde_pack(const uint32_t tile[16], uint32_t mn, uint32_t k,
                      uint32_t w[16]) {
  switch (k) {
    case 1: dbde_pack_k<1>(tile, mn, w); break;
    case 2: dbde_pack_k<2>(tile, mn, w); break;
    case 3: dbde_pack_k<3>(tile, mn, w); break;
    case 4: dbde_pack_k<4>(tile, mn, w); break;
    case 5: dbde_pack_k<5>(tile, mn, w); break;
    case 6: dbde_pack_k<6>(tile, mn, w); break;
    case 7: dbde_pack_k<7>(tile, mn, w); break;
    case 8: dbde_pack_k<8>(tile, mn, w); break;
    default: return 0;
  }
  return 2 * (int)k;
}

DBDE_HD void dbde_unpack(const uint32_t w[16], uint32_t mn, uint32_t k,
                         uint32_t tile[16]) {
  switch (k) {
    case 1: dbde_unpack_k<1>(w, mn, tile); break;
    case 2: dbde_unpack_k<2>(w, mn, tile); break;
    case 3: dbde_unpack_k<3>(w, mn, tile); break;
    case 4: dbde_unpack_k<4>(w, mn, tile); break;
    case 5: dbde_unpack_k<5>(w, mn, tile); break;
    case 6: dbde_unpack_k<6>(w, mn, tile); break;
    case 7: dbde_unpack_k<7>(w, mn, tile); break;
    case 8: dbde_unpack_k<8>(w, mn, tile); break;
    default: dbde_fill_tile(mn, tile); break;
  }
}
