// The tiles backend's kernels for Hopper (sm_90a): K6, a fused encode from
// the word-major tile layout to per-tile depths, minima and the frame's
// compacted payload stream in one launch, and K7, its decode.  Layout
// (dbde_tpu_torch/ops/tile_layout.py): tiles_W is (B, 16, Tp) u32, word ww
// of tile t of frame b at tw[(b*16 + ww)*Tp + t], Tp a multiple of 1024; the
// payload is (B, S) u32 with frame b's stream at words [b*S, b*S + 2*n64[b]).
//
// One block takes one chunk of 1024 tiles of one frame.  K6 has 512
// threads and gives thread i tiles 2i and 2i+1 (a warp's 8-byte loads of
// word ww cover 256 consecutive bytes); K7 has 256 and gives thread i tiles
// i, i+256, i+512 and i+768 (a warp's stores of word ww cover 32
// consecutive words).
//
// Each launcher is a plain C function bound with ctypes
// (dbde_tpu_torch/ops/build.py): it launches on the caller's stream and
// current device, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dbde_tile.cuh"

namespace {

constexpr int kChunk = 1024;  // tiles a block: TILES_BLOCK of tile_layout.py
constexpr int kThreads = 256;
constexpr int kPerThread = kChunk / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kEncThreads = 512;  // K6: threads a block, two blocks an SM
constexpr int kEncPer = kChunk / kEncThreads;  // consecutive tiles a K6 thread
constexpr int kEncWarps = kEncThreads / 32;
static_assert(kEncPer == 2, "K6 loads a thread's two tiles as one uint2");

// Exclusive scan of the chunk's 1024 word counts in shared memory, in place;
// returns their sum.  Thread i scans elements 4i..4i+3 serially, the warps
// scan those sums with shuffles, and one more step adds the warps' totals.
// Callers synchronise before (counts written) and the scan synchronises
// before it returns (offsets readable by every thread).
__device__ uint32_t chunk_scan(uint32_t* s, uint32_t* warp_total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t v[kPerThread], sum = 0u;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    v[i] = s[kPerThread * tid + i];
    sum += v[i];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  uint32_t run = incl - sum, total = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t t = warp_total[w];
    run += w < warp ? t : 0u;
    total += t;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    s[kPerThread * tid + i] = run;
    run += v[i];
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ void publish(unsigned long long* status, uint32_t flag,
                                        uint32_t value) {
  atomicExch(status, (unsigned long long)dbde_status(flag, value));
}

// K6.  Replaces dbde_tpu/ops/pallas_kernels.py _encode_kernel (l.79,
// wrapper encode_tiles_kernel l.150).
//
// Bound: bytes.  One read of tiles_W and a write of the depths, minima and
// the live payload words: at 16 x 2048^2 camera content about 67 + 2 + 35 MB,
// 31 us at 3.35 TB/s.  The integer work, some 300 operations a tile, needs
// about 19 us of the card's 64 INT32 lanes an SM at 1.98 GHz, so the design
// keeps it small and the two blocks of an SM overlap it with their loads.
//
// Design.  The TPU kernel walks a frame's blocks in grid order, carries the
// stream cursor from one step to the next, assembles the block's whole
// stream in one VMEM staging value and moves it with a single DMA.  Blocks
// here run in any order, so the cursor becomes a single-pass chained scan
// over 64-bit status words (flag and value in one atomicExch), and each
// block takes its chunk of 1024 tiles from an atomic ticket, so every chunk
// it waits on belongs to a block that has started.  One block, 512 threads:
//   1. Thread i owns the consecutive tiles 2i and 2i+1 of the chunk and
//      reads word ww of both with one 8-byte load (4-byte loads where
//      tiles_W itself is not 8-byte aligned).  The 32 words stay in
//      registers until the pack: each tile is read once.
//   2. Depths and minima in 16-bit lanes (dbde_tile_depth_min_u16x2; pad
//      tiles t >= T are depth 0 and minimum 0), two of each stored as one
//      u16; an exclusive scan of the threads' 2*depth sums with warp
//      shuffles; thread 0 publishes the block's AGGREGATE (a frame's first
//      block its PREFIX) at once, before any pack, so later blocks'
//      look-backs can go on.
//   3. Every thread packs its tiles into a 64 KB shared staging buffer
//      (dynamic shared memory) at the local scanned offsets, which need no
//      base, with one code path for every depth (dbde_stage_tile), so lanes
//      whose tiles differ in depth do not take turns; depth 8 is the
//      whole-tile form.  The slots are swizzled (dbde_stage_slot) so that
//      lanes 16 to 32 words apart do not store to one bank.
//   4. Warp 0, its own tiles packed, walks the decoupled look-back (Merrill
//      and Garland, 2016) 32 predecessors at a time: one status word a lane,
//      a ballot of the published lanes and of the PREFIX lanes, the window
//      fold (dbde_window_fold) and one warp reduction of the values; a
//      window with no PREFIX moves 32 blocks back.  It then publishes the
//      block's PREFIX.  The blocks that a block waits on mostly started
//      with it, and their aggregates come as their own loads end; packing
//      first puts the pack between this block's aggregate and its look-back,
//      and walking before the pack made K6 slower on the H100 (PERF.md).
//   5. After one __syncthreads all threads copy the block's words from the
//      stage to payload + b*S + base (dbde_copy_out): at most 3 scalar words
//      up to a 16-byte boundary, 16-byte stores at consecutive addresses for
//      the body, at most 3 scalar words at the end.  A block writes only its
//      own words, so blocks that share a 16-byte segment at a seam need no
//      read-modify-write, and nothing at or past 2*n64 is written.
// What each step removes: a second read of each tile for the pack (1);
// 2*depth scalar stores a tile at scanned offsets, where a warp store
// touched up to 32 partial sectors (5); the look-back walked by one thread
// while the block waited (4); a switch per tile whose cases a warp of mixed
// depths ran in turn, and the general pack at depth 8 (3).
// Occupancy: the 64 KB stage lets three blocks share an SM; the registers
// allow two.  __launch_bounds__ holds the kernel to 64 registers for two
// blocks of 512 threads (32 warps an SM, no spills); 256 threads of four
// tiles took 112 registers, two blocks (16 warps) an SM, and ran slower on
// the H100 (PERF.md).
__device__ __forceinline__ void load_tile_words(const uint32_t* p, int vec,
                                                uint32_t v[kEncPer]) {
  if (vec) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldcs(p);
    v[1] = __ldcs(p + 1);
  }
}

// Step 4: the base of chunk g of a frame whose status words are st, walked
// by one warp; every lane returns it.
__device__ uint32_t warp_lookback(const unsigned long long* st, int g, int lane) {
  uint32_t base = 0u;
  for (int hi = g - 1;;) {  // hi: the window's nearest predecessor
    const int n = hi + 1 < 32 ? hi + 1 : 32;
    uint64_t s = 0u;
    if (lane < n) s = *(const volatile unsigned long long*)&st[hi - lane];
    const uint32_t flag = (uint32_t)(s >> 32);
    const uint32_t published = __ballot_sync(
        0xFFFFFFFFu, flag == DBDE_STATUS_AGGREGATE || flag == DBDE_STATUS_PREFIX);
    const uint32_t prefix = __ballot_sync(0xFFFFFFFFu, flag == DBDE_STATUS_PREFIX);
    int count = 0;
    const int step = dbde_window_fold(published, prefix, n, &count);
    if (step == 0) {
      __nanosleep(32);  // a predecessor has not published yet: read again
      continue;
    }
    base += __reduce_add_sync(0xFFFFFFFFu, lane < count ? (uint32_t)s : 0u);
    if (step == 2) return base;
    hi -= 32;  // chunk 0 always holds a PREFIX, so this ends
  }
}

__global__ void __launch_bounds__(kEncThreads, 2)
    encode_tiles_kernel(const uint32_t* __restrict__ tw, uint8_t* __restrict__ depths,
                        uint8_t* __restrict__ mins, uint32_t* __restrict__ payload,
                        int32_t* __restrict__ n64, unsigned long long* status,
                        unsigned int* ticket, int nb, int Tp, int T, int S, int vec) {
  extern __shared__ uint32_t stage[];  // DBDE_STAGE_WORDS
  __shared__ uint32_t s_warp[kEncWarps];
  __shared__ uint32_t s_ticket, s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = (int)(s_ticket / (unsigned)nb), g = (int)(s_ticket % (unsigned)nb);
  const int t0 = g * kChunk + kEncPer * tid;  // this thread's first tile

  // 1. one read of each tile
  uint32_t tile[kEncPer][16];
  const uint32_t* src = tw + (size_t)b * 16 * Tp + t0;
#pragma unroll
  for (int ww = 0; ww < 16; ++ww) {
    uint32_t v[kEncPer];
    load_tile_words(src + (size_t)ww * Tp, vec, v);
#pragma unroll
    for (int i = 0; i < kEncPer; ++i) tile[i][ww] = v[i];
  }

  // 2. depths, minima, the local scan and the published aggregate
  uint32_t d[kEncPer], m[kEncPer], dq = 0u, mq = 0u, words = 0u;
#pragma unroll
  for (int i = 0; i < kEncPer; ++i) {
    d[i] = m[i] = 0u;
    if (t0 + i < T) dbde_tile_depth_min_u16x2(tile[i], &d[i], &m[i]);
    dq |= d[i] << (8 * i);
    mq |= m[i] << (8 * i);
    words += 2u * d[i];
  }
  const size_t row = (size_t)b * Tp + t0;  // even: Tp % 1024 == 0
  *reinterpret_cast<uint16_t*>(depths + row) = (uint16_t)dq;
  *reinterpret_cast<uint16_t*>(mins + row) = (uint16_t)mq;
  uint32_t incl = words;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, k);
    if (lane >= k) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t off = incl - words, total = 0u;
#pragma unroll
  for (int w = 0; w < kEncWarps; ++w) {
    const uint32_t t = s_warp[w];
    off += w < warp ? t : 0u;
    total += t;
  }
  unsigned long long* st = status + (size_t)b * nb;
  if (tid == 0) publish(&st[g], g ? DBDE_STATUS_AGGREGATE : DBDE_STATUS_PREFIX, total);

  // 3. pack into the stage at the local offsets
#pragma unroll
  for (int i = 0; i < kEncPer; ++i) {
    dbde_stage_tile(tile[i], m[i], d[i], stage, off);
    off += 2u * d[i];
  }

  // 4. warp 0: the look-back and the block's prefix
  if (warp == 0) {
    const uint32_t base = g ? warp_lookback(st, g, lane) : 0u;
    if (lane == 0) {
      if (g) publish(&st[g], DBDE_STATUS_PREFIX, base + total);
      if (g == nb - 1) n64[b] = (int32_t)((base + total) / 2u);
      s_base = base;
    }
  }
  __syncthreads();

  // 5. the coalesced copy-out
  dbde_copy_out(stage, total, payload + (size_t)b * S + s_base, tid, kEncThreads);
}

// K7.  Replaces dbde_tpu/ops/pallas_kernels.py _decode_kernel (l.189,
// wrapper decode_tiles_kernel l.264).  Bound: a read of the depths, minima
// and live payload words and a write of tiles_W (at 16 x 2048^2 camera
// content about 2 + 35 + 67 MB, some 31 us at 3.35 TB/s).  Design: like the
// TPU kernel it finds its own offsets and takes no scanned-offset array, but
// it needs no cursor carried between blocks: the depths are already there,
// so each block sums the depths of its frame's earlier chunks itself (at most
// T bytes, from L2, four at a time with __dp4a), scans its own chunk in
// shared memory and unpacks each tile from exactly its 2*depth words, so any
// stride S >= 2*n64 and garbage after the stream decode alike.
__global__ void __launch_bounds__(kThreads)
    decode_tiles_kernel(const uint8_t* __restrict__ depths,
                        const uint8_t* __restrict__ mins,
                        const uint32_t* __restrict__ payload, uint32_t* __restrict__ tw,
                        int nb, int Tp, int S, int dvec) {
  __shared__ uint32_t s_off[kChunk];
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_sum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / nb, g = blockIdx.x % nb;
  const uint8_t* drow = depths + (size_t)b * Tp;

  // the words of the frame's stream before this chunk: 2 * sum of depths
  const int before = g * kChunk;
  uint32_t acc = 0u;
  if (dvec) {  // rows 16-byte aligned (Tp is a multiple of 1024)
    const uint4* d4 = reinterpret_cast<const uint4*>(drow);
    for (int i = tid; i < before / 16; i += kThreads) {
      const uint4 q = d4[i];
      acc = __dp4a(q.x, 0x01010101u, acc);
      acc = __dp4a(q.y, 0x01010101u, acc);
      acc = __dp4a(q.z, 0x01010101u, acc);
      acc = __dp4a(q.w, 0x01010101u, acc);
    }
  } else {
    for (int i = tid; i < before; i += kThreads) acc += drow[i];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
  if (lane == 0) s_sum[warp] = acc;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int l = i * kThreads + tid;
    s_off[l] = 2u * drow[before + l];
  }
  __syncthreads();
  chunk_scan(s_off, s_warp);
  uint32_t base = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) base += s_sum[w];
  base *= 2u;

  const uint32_t* src = payload + (size_t)b * S;
  uint32_t* frame = tw + (size_t)b * 16 * Tp;
#pragma unroll 1
  for (int i = 0; i < kPerThread; ++i) {
    const int l = i * kThreads + tid, t = before + l;
    uint32_t tile[16];
    dbde_load_unpack(src, base + s_off[l], (uint32_t)S, mins[(size_t)b * Tp + t], drow[t],
                     tile);
    dbde_tile_w_store(frame, Tp, t, tile);
  }
}

}  // namespace

extern "C" {

// scratch: B*nb status words then the ticket, all zero (the wrapper's torch.zeros)
int dbde_encode_tiles(const void* tw, void* depths, void* mins, void* payload, void* n64,
                      void* scratch, int B, int Tp, int T, int S, void* stream) {
  const int nb = Tp / kChunk;
  const int smem = DBDE_STAGE_WORDS * (int)sizeof(uint32_t);
  // the 64 KB stage is above the default 48 KB of dynamic shared memory:
  // raise the kernel's limit once per device (a repeat is harmless)
  static bool configured[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !configured[dev])) {
    err = cudaFuncSetAttribute(encode_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(encode_tiles_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < 64) configured[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = (unsigned long long*)scratch;
  encode_tiles_kernel<<<(unsigned)(B * nb), kEncThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)tw, (uint8_t*)depths, (uint8_t*)mins, (uint32_t*)payload,
      (int32_t*)n64, status, (unsigned int*)(status + (size_t)B * nb), nb, Tp, T, S,
      (int)((uintptr_t)tw % (4 * kEncPer) == 0));
  return (int)cudaGetLastError();
}

int dbde_decode_tiles(const void* depths, const void* mins, const void* payload, void* tw,
                      int B, int Tp, int S, int dvec, void* stream) {
  const int nb = Tp / kChunk;
  decode_tiles_kernel<<<(unsigned)(B * nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)depths, (const uint8_t*)mins, (const uint32_t*)payload,
      (uint32_t*)tw, nb, Tp, S, dvec);
  return (int)cudaGetLastError();
}

}  // extern "C"
