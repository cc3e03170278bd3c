// Per-tile DBDE arithmetic shared by the CUDA kernels (dbde_kernels.cu,
// dbde_tiles.cu) and a CPU test library built from this header alone with g++
// (tests/test_torch_tile_math.py).  Everything here is plain integer code on
// one 8x8 tile held in registers, with the word stores and loads of a tile's
// payload and of the tiles backend's layout; loading a tile from a frame
// belongs to the kernels.
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

#include <stddef.h>
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

// Pack a depth-K tile and store its 2K words at dst[0..2K), nothing else.
template <int K>
DBDE_HD void dbde_pack_store_k(const uint32_t tile[16], uint32_t mn,
                               uint32_t* dst) {
  uint32_t w[16];
  dbde_pack_k<K>(tile, mn, w);
  DBDE_UNROLL
  for (int j = 0; j < 2 * K; ++j) dst[j] = w[j];
}

// Read a depth-K tile's 2K words at src[off..off+2K) and unpack them.  A word
// index at or past the stride S reads word S-1 instead (the clamp of the
// plain gather_windows), so a corrupt depth map cannot read outside the
// frame's row.
template <int K>
DBDE_HD void dbde_load_unpack_k(const uint32_t* src, uint32_t off, uint32_t S,
                                uint32_t mn, uint32_t tile[16]) {
  uint32_t w[16];
  DBDE_UNROLL
  for (int j = 0; j < 2 * K; ++j) w[j] = src[off + j < S ? off + j : S - 1];
  dbde_unpack_k<K>(w, mn, tile);
}

// Runtime-depth dispatch of the two above, one case per depth, so that every
// word index stays a compile-time constant and the words stay in registers.
// A depth of 0 stores nothing (and so does an illegal one); it decodes, as
// does an illegal one, to the tile's minimum.
DBDE_HD void dbde_pack_store(const uint32_t tile[16], uint32_t mn, uint32_t k,
                             uint32_t* dst) {
  switch (k) {
    case 1: dbde_pack_store_k<1>(tile, mn, dst); break;
    case 2: dbde_pack_store_k<2>(tile, mn, dst); break;
    case 3: dbde_pack_store_k<3>(tile, mn, dst); break;
    case 4: dbde_pack_store_k<4>(tile, mn, dst); break;
    case 5: dbde_pack_store_k<5>(tile, mn, dst); break;
    case 6: dbde_pack_store_k<6>(tile, mn, dst); break;
    case 7: dbde_pack_store_k<7>(tile, mn, dst); break;
    case 8: dbde_pack_store_k<8>(tile, mn, dst); break;
    default: break;
  }
}

DBDE_HD void dbde_load_unpack(const uint32_t* src, uint32_t off, uint32_t S,
                              uint32_t mn, uint32_t k, uint32_t tile[16]) {
  switch (k) {
    case 1: dbde_load_unpack_k<1>(src, off, S, mn, tile); break;
    case 2: dbde_load_unpack_k<2>(src, off, S, mn, tile); break;
    case 3: dbde_load_unpack_k<3>(src, off, S, mn, tile); break;
    case 4: dbde_load_unpack_k<4>(src, off, S, mn, tile); break;
    case 5: dbde_load_unpack_k<5>(src, off, S, mn, tile); break;
    case 6: dbde_load_unpack_k<6>(src, off, S, mn, tile); break;
    case 7: dbde_load_unpack_k<7>(src, off, S, mn, tile); break;
    case 8: dbde_load_unpack_k<8>(src, off, S, mn, tile); break;
    default: dbde_fill_tile(mn, tile); break;
  }
}

// The tile layout of the tiles backend (K6, K7): tiles_W is (16, Tp) u32 a
// frame, word ww of tile t at tw[ww*Tp + t].  Thread t of a warp moving word
// ww of its tile touches consecutive words.
DBDE_HD void dbde_tile_w_load(const uint32_t* tw, size_t tp, size_t t,
                              uint32_t tile[16]) {
  DBDE_UNROLL
  for (int ww = 0; ww < 16; ++ww) tile[ww] = tw[(size_t)ww * tp + t];
}

DBDE_HD void dbde_tile_w_store(uint32_t* tw, size_t tp, size_t t,
                               const uint32_t tile[16]) {
  DBDE_UNROLL
  for (int ww = 0; ww < 16; ++ww) tw[(size_t)ww * tp + t] = tile[ww];
}

// Status words of K6's chained scan over a frame's blocks of tiles: a flag in
// the high 32 bits and a word count in the low 32, stored and loaded as one
// 64-bit word, so that a reader never sees a flag without its value.
// Flag 0: not yet published; AGGREGATE: the block's own word count;
// PREFIX: the words of the frame's stream up to and including the block.
#define DBDE_STATUS_AGGREGATE 1u
#define DBDE_STATUS_PREFIX 2u

DBDE_HD uint64_t dbde_status(uint32_t flag, uint32_t value) {
  return ((uint64_t)flag << 32) | value;
}

// One step of the look-back: fold a predecessor's status word into the
// running base.  Returns 0 if the predecessor has published nothing yet (look
// again), 1 to go on to the block before it, 2 when the base is complete.
DBDE_HD int dbde_lookback_step(uint64_t status, uint32_t* base) {
  const uint32_t flag = (uint32_t)(status >> 32);
  if (flag != DBDE_STATUS_AGGREGATE && flag != DBDE_STATUS_PREFIX) return 0;
  *base += (uint32_t)status;
  return flag == DBDE_STATUS_PREFIX ? 2 : 1;
}
