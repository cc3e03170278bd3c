// Per-tile DBDE arithmetic shared by the CUDA kernels (dbde_kernels.cu,
// dbde_tiles.cu) and a CPU test library built from this header alone with g++
// (tests/test_torch_tile_math.py).  Everything here is plain integer code on
// one 8x8 tile held in registers, with the word stores and loads of a tile's
// payload, a tile's loads and stores in a u8 frame, the tiles backend's
// layout store, K6's look-back fold, and the block-level steps of K2, K3 and
// K6: the sum of a frame's earlier depths, the staged pack and unpack, and
// the coalesced copies between a block's stage and its stream words.
//
// A tile is 16 u32 words: word 2r+h holds pixels (r, 4h..4h+3), lowest byte
// first -- the little-endian view of the tile's 8 rows of 8 bytes.  Pixel i
// (row-major, 0..63) is byte i&3 of word i>>2.
//
// Counterparts in the JAX package: the depth rule of
// dbde_tpu/ops/pallas_band.py:370-383 (_depths_kernel), the bit layout of
// the pack closed form of dbde_tpu/ops/kernel_common.py:57-71
// (_pack_contributions) and the funnel-shift unpack of
// dbde_tpu/ops/pallas_band.py:1521-1550, and the
// bytewise min subtract/add of its uniform depth-8 kernels (pallas_band.py:889,
// 1025, 1189).
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

// Unpack a depth-K tile from words w[0..2K): pixel i is bits [i*K, i*K+K)
// of the tile's LSB-first bit string (word j = (i*K)>>5 at shift (i*K)&31,
// straddling into word j+1 for K in {3, 5, 6, 7}; a pair of u32 words, low
// word first, is the format's little-endian u64), plus mn modulo 256 (as
// the JAX package's u8 cast does for corrupt streams); pixels come back in
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
// taken from every byte, and decoding adds it back.  Same pixels as
// dbde_unpack_k<8> in a quarter of the operations; the uniform depth-8
// kernels (K4, K5) use these.
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

// Runtime-depth dispatch of the above, one case per depth, so that every
// word index stays a compile-time constant and the words stay in registers.
// A depth of 0 decodes, as does an illegal one, to the tile's minimum.
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
// do not run one case after another.
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

// The split of a copy of `total` words to or from p: scalar words up to p's
// first 16-byte boundary (*head, at most 3), 16-byte groups (*body), then
// scalar words (*tail, at most 3).
DBDE_HD void dbde_copy_split(const uint32_t* p, uint32_t total, uint32_t* head,
                             uint32_t* body, uint32_t* tail) {
  const uint32_t mis = (uint32_t)(((uintptr_t)p >> 2) & 3u);
  *head = (4u - mis) & 3u;
  if (*head > total) *head = total;
  *body = (total - *head) >> 2;
  *tail = total - *head - 4u * *body;
}

DBDE_HD void dbde_store4(uint32_t* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  const uint32_t v[4] = {a, b, c, d};
  memcpy(p, v, 16);
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

DBDE_HD void dbde_load4(const uint32_t* p, uint32_t* a, uint32_t* b, uint32_t* c,
                        uint32_t* d) {
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  *a = v.x;
  *b = v.y;
  *c = v.z;
  *d = v.w;
#else
  uint32_t v[4];
  memcpy(v, p, 16);
  *a = v[0];
  *b = v[1];
  *c = v[2];
  *d = v[3];
#endif
}

// The mirror of dbde_copy_out: thread tid of nthreads (>= 3) stages its share
// of the words src[0 .. total) at stream words 0 .. total -- the head and the
// tail a word a thread, the body 16 bytes a thread at consecutive addresses.
// Reads src[0 .. total) and nothing else, so words after a block's stream
// (another block's, or garbage past the frame's) are never read.
DBDE_HD void dbde_copy_in(const uint32_t* src, uint32_t total, uint32_t* stage, int tid,
                          int nthreads) {
  uint32_t head, body, tail;
  dbde_copy_split(src, total, &head, &body, &tail);
  const uint32_t t = (uint32_t)tid;
  if (t < head) stage[dbde_stage_slot(t)] = src[t];
  for (uint32_t q = t; q < body; q += (uint32_t)nthreads) {
    const uint32_t k = head + 4u * q;
    uint32_t a, b, c, d;
    dbde_load4(src + k, &a, &b, &c, &d);
    stage[dbde_stage_slot(k)] = a;
    stage[dbde_stage_slot(k + 1u)] = b;
    stage[dbde_stage_slot(k + 2u)] = c;
    stage[dbde_stage_slot(k + 3u)] = d;
  }
  const uint32_t k = head + 4u * body + t;
  if (t < tail) stage[dbde_stage_slot(k)] = src[k];
}

// Inverse of dbde_stage_tile: the tile of depth k whose 2k words are staged
// at stream words off .. off+2k, each pixel its k-bit residual plus mn modulo
// 256 (as dbde_unpack_k); depth 0 or any depth above 8 decodes to the tile's
// minimum and reads nothing.  One code path for every depth, so the lanes of
// a warp whose tiles differ in depth do not run one case after another: a
// 64-bit accumulator takes stage words as it runs short, gives one 4k-bit
// chunk (four pixels) a step, and each chunk spreads back to a word of four
// bytes -- its high half up to bit 16, then its odd pixels up to bits 8 and 24.
// Reads exactly the tile's 2k words.
DBDE_HD void dbde_unstage_tile(const uint32_t* stage, uint32_t off, uint32_t mn, uint32_t k,
                               uint32_t tile[16]) {
  if (k == 0u || k > 8u) {
    dbde_fill_tile(mn, tile);
    return;
  }
  const uint32_t m4 = (mn & 0xFFu) * 0x01010101u;
  const uint32_t bits = 4u * k, half = 2u * k;
  const uint64_t cmask = (1ull << bits) - 1ull;
  const uint32_t pmask = ((1u << k) - 1u) * 0x00010001u;  // a pixel at bits 0 and 16
  uint64_t acc = 0u;
  uint32_t nb = 0u;  // bits pending in acc
  DBDE_UNROLL
  for (int q = 0; q < 16; ++q) {
    if (nb < bits) {
      acc |= (uint64_t)stage[dbde_stage_slot(off++)] << nb;
      nb += 32u;
    }
    const uint32_t c = (uint32_t)(acc & cmask);
    acc >>= bits;
    nb -= bits;
    const uint32_t w1 = (c & ((1u << half) - 1u)) | ((c >> half) << 16);
    tile[q] = dbde_add_bytes((w1 & pmask) | (((w1 >> k) & pmask) << 8), m4);
  }
}

// The words of a frame's stream before a block: thread tid of nthreads
// (>= 15) returns its share of the sum of the bytes d[0 .. n) -- the bytes up
// to d's first 16-byte boundary a byte a thread, then 16 bytes a thread at
// consecutive addresses (four __dp4a on the card), then the rest a byte a
// thread.  The shares of all threads add up to the sum, at any alignment of d.
DBDE_HD uint32_t dbde_sum_bytes(const uint8_t* d, uint32_t n, int tid, int nthreads) {
  uint32_t head = (uint32_t)((16u - ((uintptr_t)d & 15u)) & 15u);
  if (head > n) head = n;
  const uint32_t body = (n - head) >> 4, tail = n - head - 16u * body;
  const uint32_t t = (uint32_t)tid;
  uint32_t acc = t < head ? d[t] : 0u;
  for (uint32_t q = t; q < body; q += (uint32_t)nthreads) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(d + head + 16u * q);
    uint32_t w[4];
    dbde_load4(p, &w[0], &w[1], &w[2], &w[3]);
    DBDE_UNROLL
    for (int i = 0; i < 4; ++i) {
#ifdef __CUDA_ARCH__
      acc = __dp4a(w[i], 0x01010101u, acc);
#else
      acc += (w[i] & 0xFFu) + ((w[i] >> 8) & 0xFFu) + ((w[i] >> 16) & 0xFFu) + (w[i] >> 24);
#endif
    }
  }
  if (t < tail) acc += d[head + 16u * body + t];
  return acc;
}

// -- A tile in a (H, W) u8 frame, row-major --------------------------------
//
// Tile (ty, tx) covers rows 8ty .. 8ty+8 and columns 8tx .. 8tx+8.  Its row r
// is words 2r and 2r+1 of the tile: one 8-byte run of the frame when the
// tile lies inside it.

DBDE_HD void dbde_load8(const uint8_t* p, uint32_t* a, uint32_t* b) {
#ifdef __CUDA_ARCH__
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  *a = v.x;
  *b = v.y;
#else
  memcpy(a, p, 4);
  memcpy(b, p + 4, 4);
#endif
}

DBDE_HD void dbde_store8(uint8_t* p, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint2*>(p) = make_uint2(a, b);
#else
  memcpy(p, &a, 4);
  memcpy(p + 4, &b, 4);
#endif
}

// Load tile (ty, tx).  Pixels past the frame's right or bottom edge read at
// the clamped coordinates (min(y, H-1), min(x, W-1)): that is exactly the
// format's right-then-down edge rule (ref_numpy.tile_image).  `vec` (W % 8
// == 0 and an 8-byte-aligned frame) allows one 8-byte load per row of a tile
// that lies wholly inside the frame; otherwise byte loads.
DBDE_HD void dbde_load_tile(const uint8_t* img, int H, int W, int ty, int tx, int vec,
                            uint32_t tile[16]) {
  const int y0 = 8 * ty, x0 = 8 * tx;
  if (vec && y0 + 8 <= H) {
    DBDE_UNROLL
    for (int r = 0; r < 8; ++r)
      dbde_load8(img + (size_t)(y0 + r) * W + x0, &tile[2 * r], &tile[2 * r + 1]);
    return;
  }
  DBDE_UNROLL
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = img + (size_t)(y0 + r < H ? y0 + r : H - 1) * W;
    uint32_t lo = 0u, hi = 0u;
    DBDE_UNROLL
    for (int c = 0; c < 4; ++c) {
      lo |= (uint32_t)row[x0 + c < W ? x0 + c : W - 1] << (8 * c);
      hi |= (uint32_t)row[x0 + 4 + c < W ? x0 + 4 + c : W - 1] << (8 * c);
    }
    tile[2 * r] = lo;
    tile[2 * r + 1] = hi;
  }
}

// Store the in-frame part of tile (ty, tx); pixels past H or W are dropped.
DBDE_HD void dbde_store_tile(uint8_t* img, int H, int W, int ty, int tx, int vec,
                             const uint32_t tile[16]) {
  const int y0 = 8 * ty, x0 = 8 * tx;
  if (vec && y0 + 8 <= H) {
    DBDE_UNROLL
    for (int r = 0; r < 8; ++r)
      dbde_store8(img + (size_t)(y0 + r) * W + x0, tile[2 * r], tile[2 * r + 1]);
    return;
  }
  DBDE_UNROLL
  for (int r = 0; r < 8; ++r) {
    if (y0 + r >= H) break;
    uint8_t* row = img + (size_t)(y0 + r) * W;
    DBDE_UNROLL
    for (int c = 0; c < 8; ++c)
      if (x0 + c < W) row[x0 + c] = (uint8_t)dbde_pixel(tile, 8 * r + c);
  }
}
