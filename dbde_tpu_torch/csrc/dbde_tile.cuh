// Per-tile DBDE arithmetic shared by the CUDA kernels (dbde_kernels.cu,
// dbde_tiles.cu) and a CPU test library built from this header alone with g++
// (tests/test_torch_tile_math.py).  Everything here is plain integer code on
// one 8x8 tile held in registers, with the word stores and loads of a tile's
// payload, the tiles backend's layout store, and K6's look-back fold, staging
// and copy-out; loading a tile from a frame belongs to the kernels.
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

// The same depth and minimum as dbde_tile_depth_min in 16-bit lanes: each
// word splits into its even and its odd bytes (two u16 pairs) and the
// minima and maxima run two pixels an instruction (min.u16x2 and max.u16x2
// on sm_90), a quarter of the per-pixel operations.  K6 uses it.
DBDE_HD uint32_t dbde_min_u16x2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const uint32_t lo = (a & 0xFFFFu) < (b & 0xFFFFu) ? a & 0xFFFFu : b & 0xFFFFu;
  const uint32_t hi = (a >> 16) < (b >> 16) ? a >> 16 : b >> 16;
  return lo | (hi << 16);
#endif
}

DBDE_HD uint32_t dbde_max_u16x2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const uint32_t lo = (a & 0xFFFFu) > (b & 0xFFFFu) ? a & 0xFFFFu : b & 0xFFFFu;
  const uint32_t hi = (a >> 16) > (b >> 16) ? a >> 16 : b >> 16;
  return lo | (hi << 16);
#endif
}

DBDE_HD void dbde_tile_depth_min_u16x2(const uint32_t tile[16], uint32_t* depth,
                                       uint32_t* mn) {
  uint32_t lo = 0x00FF00FFu, hi = 0u;
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) {
    const uint32_t even = tile[q] & 0x00FF00FFu;
#ifdef __CUDA_ARCH__
    const uint32_t odd = __byte_perm(tile[q], 0u, 0x4341);  // bytes 1, 3 -> 0, 2
#else
    const uint32_t odd = (tile[q] >> 8) & 0x00FF00FFu;
#endif
    lo = dbde_min_u16x2(lo, dbde_min_u16x2(even, odd));
    hi = dbde_max_u16x2(hi, dbde_max_u16x2(even, odd));
  }
  const uint32_t l0 = lo & 0xFFFFu, l1 = lo >> 16, h0 = hi & 0xFFFFu, h1 = hi >> 16;
  const uint32_t lo1 = l0 < l1 ? l0 : l1, hi1 = h0 > h1 ? h0 : h1;
  *depth = dbde_depth_of_range(hi1 - lo1);
  *mn = lo1;
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
// ww of its tile touches consecutive words.  K7 stores a tile so; K6 loads
// two neighbouring tiles' words at once.
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

// One window of K6's warp-wide look-back: lane k holds the status word of
// the k-th predecessor counted back from the window's start, for the n <= 32
// lanes that exist.  `published` and `prefix` are the warp's votes (bit k
// set when lane k's flag is AGGREGATE or PREFIX, and PREFIX).  The window
// counts up to and including its nearest PREFIX, or all n lanes if it has
// none.  Returns 0 if a lane that counts is unpublished (read the window
// again), 1 if all n lanes are aggregates (add them and go on to the next
// window), 2 if the nearest PREFIX ends the base; *count is the number of
// lanes, from lane 0, whose values add to the base.  The same outcome and
// base as dbde_lookback_step over the lanes in order.
DBDE_HD int dbde_window_fold(uint32_t published, uint32_t prefix, int n, int* count) {
  const uint32_t valid = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  prefix &= published & valid;
  if (prefix) {
#ifdef __CUDA_ARCH__
    const int p = __ffs((int)prefix) - 1;
#else
    const int p = __builtin_ctz(prefix);
#endif
    const uint32_t upto = p == 31 ? 0xFFFFFFFFu : (2u << p) - 1u;
    if ((published & upto) != upto) return 0;
    *count = p + 1;
    return 2;
  }
  if ((published & valid) != valid) return 0;
  *count = n;
  return 1;
}

// K6 stages a block's stream in 16384 shared words (every tile at depth 8).
// Word k of the stream sits at slot k with its column in the 32-word row
// xor-ed with the row index, so a warp whose lanes store at a stride of 16
// or 32 words (two tiles of depth 4 or 8 a lane) spreads over the 32 banks
// instead of 2 or 1.  The slot stays within the word's own row.
#define DBDE_STAGE_WORDS (1024 * DBDE_WORDS_PER_TILE)

DBDE_HD uint32_t dbde_stage_slot(uint32_t k) { return k ^ ((k >> 5) & 31u); }

// Stage a tile of depth k (any depth; 0 and illegal depths stage nothing)
// at stream words off .. off+2k, with mn the tile's own minimum.  One code
// path for every depth, so the lanes of a warp whose tiles differ in depth
// do not run one case after another; the same words as dbde_pack_k<k>.
// Since no pixel is below mn, a word less mn*0x01010101 is its four
// residuals with no borrow between bytes.  Each residual word becomes one
// 4k-bit chunk -- its odd bytes shifted down next to the even ones, then its
// high half next to the low one -- and chunk q goes at bit 4k*q of the tile's
// bit string, through a 32-bit accumulator that is stored as it fills.
// Depth 8 is the whole-tile form: the residual words themselves.
DBDE_HD void dbde_stage_tile(const uint32_t tile[16], uint32_t mn, uint32_t k,
                             uint32_t* stage, uint32_t off) {
  if (k == 0u || k > 8u) return;
  const uint32_t m4 = (mn & 0xFFu) * 0x01010101u;
  if (k == 8u) {
    DBDE_UNROLL
    for (int q = 0; q < 16; ++q) stage[dbde_stage_slot(off + (uint32_t)q)] = tile[q] - m4;
    return;
  }
  const uint32_t s1 = 8u - k, s2 = 16u - 2u * k, bits = 4u * k;
  uint32_t acc = 0u, nb = 0u;  // nb < 32 bits pending in acc
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) {
    const uint32_t r = tile[q] - m4;
    const uint32_t w1 = (r & 0x00FF00FFu) | ((r & 0xFF00FF00u) >> s1);
    const uint32_t c = (w1 & 0xFFFFu) | ((w1 & 0xFFFF0000u) >> s2);
    acc |= c << nb;
    nb += bits;
    if (nb >= 32u) {  // bits < 32, so nb was at least 1 and the shift below is < 32
      stage[dbde_stage_slot(off++)] = acc;
      nb -= 32u;
      acc = c >> (bits - nb);
    }
  }
}

// The split of a copy of `total` words to dst: scalar words up to dst's
// first 16-byte boundary (*head, at most 3), 16-byte groups (*body), then
// scalar words (*tail, at most 3).
DBDE_HD void dbde_copy_split(const uint32_t* dst, uint32_t total, uint32_t* head,
                             uint32_t* body, uint32_t* tail) {
  const uint32_t mis = (uint32_t)(((uintptr_t)dst >> 2) & 3u);
  *head = (4u - mis) & 3u;
  if (*head > total) *head = total;
  *body = (total - *head) >> 2;
  *tail = total - *head - 4u * *body;
}

DBDE_HD void dbde_store4(uint32_t* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  p[0] = a;
  p[1] = b;
  p[2] = c;
  p[3] = d;
#endif
}

// Thread tid of nthreads (>= 3) copies its share of the staged stream
// words 0 .. total to dst[0 .. total): the head and the tail a word a thread,
// the body 16 bytes a thread at consecutive addresses, each group gathered
// from the stage at whatever word alignment dst gives.  Writes dst[0 ..
// total) and nothing else.
DBDE_HD void dbde_copy_out(const uint32_t* stage, uint32_t total, uint32_t* dst, int tid,
                           int nthreads) {
  uint32_t head, body, tail;
  dbde_copy_split(dst, total, &head, &body, &tail);
  const uint32_t t = (uint32_t)tid;
  if (t < head) dst[t] = stage[dbde_stage_slot(t)];
  for (uint32_t q = t; q < body; q += (uint32_t)nthreads) {
    const uint32_t k = head + 4u * q;
    dbde_store4(dst + k, stage[dbde_stage_slot(k)], stage[dbde_stage_slot(k + 1u)],
                stage[dbde_stage_slot(k + 2u)], stage[dbde_stage_slot(k + 3u)]);
  }
  const uint32_t k = head + 4u * body + t;
  if (t < tail) dst[k] = stage[dbde_stage_slot(k)];
}
