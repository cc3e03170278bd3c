// The tiles backend's kernels for Hopper (sm_90a): K6, a fused encode from
// the word-major tile layout to per-tile depths, minima and the frame's
// compacted payload stream in one launch, and K7, its decode.  Layout
// (dbde_tpu_torch/ops/tile_layout.py): tiles_W is (B, 16, Tp) u32, word ww
// of tile t of frame b at tw[(b*16 + ww)*Tp + t], Tp a multiple of 1024; the
// payload is (B, S) u32 with frame b's stream at words [b*S, b*S + 2*n64[b]).
//
// One block takes one chunk of 1024 tiles of one frame with 256 threads;
// thread i owns tiles i, i+256, i+512 and i+768 of the chunk, so a warp
// moving word ww of its tiles reads or writes 32 consecutive words.
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
// wrapper encode_tiles_kernel l.150).  Bound: one read of tiles_W and a write
// of the depths, minima and the live payload words (at 16 x 2048^2 camera
// content about 67 + 2 + 35 MB, some 31 us at 3.35 TB/s); the arithmetic is a
// few hundred integer operations a tile.  Design: the TPU kernel walks a
// frame's blocks in grid order and carries the stream cursor and a partial
// row from one step to the next.  Blocks here run in any order, so the
// cursor becomes a single-pass chained scan: a block scans its chunk's
// 2*depth in shared memory, publishes its total in the chunk's status word,
// looks back over its predecessors' status words for its base, publishes its
// inclusive prefix, and then every thread stores exactly its tiles' 2*depth
// words at base + local offset.  Blocks take their chunk from a ticket, not
// from blockIdx, so every chunk a block waits on belongs to a block that has
// started.  Pad tiles (t >= T) are depth 0 and minimum 0 and store nothing;
// no word at or past 2*n64 is written.
__global__ void __launch_bounds__(kThreads)
    encode_tiles_kernel(const uint32_t* __restrict__ tw, uint8_t* __restrict__ depths,
                        uint8_t* __restrict__ mins, uint32_t* __restrict__ payload,
                        int32_t* __restrict__ n64, unsigned long long* status,
                        unsigned int* ticket, int nb, int Tp, int T, int S) {
  __shared__ uint32_t s_off[kChunk];
  __shared__ uint8_t s_depth[kChunk], s_min[kChunk];
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_ticket, s_base;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = (int)(s_ticket / (unsigned)nb), g = (int)(s_ticket % (unsigned)nb);
  const uint32_t* frame = tw + (size_t)b * 16 * Tp;
  const size_t row = (size_t)b * Tp;

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int l = i * kThreads + tid, t = g * kChunk + l;
    uint32_t d = 0u, m = 0u;
    if (t < T) {
      uint32_t tile[16];
      dbde_tile_w_load(frame, Tp, t, tile);
      dbde_tile_depth_min(tile, &d, &m);
    }
    s_depth[l] = (uint8_t)d;
    s_min[l] = (uint8_t)m;
    s_off[l] = 2u * d;
    depths[row + t] = (uint8_t)d;
    mins[row + t] = (uint8_t)m;
  }
  __syncthreads();
  const uint32_t total = chunk_scan(s_off, s_warp);

  if (tid == 0) {
    unsigned long long* st = status + (size_t)b * nb;
    uint32_t base = 0u;
    if (g > 0) {
      publish(&st[g], DBDE_STATUS_AGGREGATE, total);
      // chunk 0 publishes its prefix without waiting, so this ends
      for (int p = g - 1;; --p) {
        int step;
        do {
          step = dbde_lookback_step(*(volatile unsigned long long*)&st[p], &base);
        } while (step == 0);
        if (step == 2) break;
      }
    }
    publish(&st[g], DBDE_STATUS_PREFIX, base + total);
    if (g == nb - 1) n64[b] = (int32_t)((base + total) / 2u);
    s_base = base;
  }
  __syncthreads();

  uint32_t* dst = payload + (size_t)b * S + s_base;
#pragma unroll 1
  for (int i = 0; i < kPerThread; ++i) {
    const int l = i * kThreads + tid;
    const uint32_t k = s_depth[l];
    if (k == 0u) continue;
    uint32_t tile[16];  // again, from L1/L2: the block read it moments ago
    dbde_tile_w_load(frame, Tp, g * kChunk + l, tile);
    dbde_pack_store(tile, s_min[l], k, dst + s_off[l]);
  }
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
  unsigned long long* status = (unsigned long long*)scratch;
  encode_tiles_kernel<<<(unsigned)(B * nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tw, (uint8_t*)depths, (uint8_t*)mins, (uint32_t*)payload,
      (int32_t*)n64, status, (unsigned int*)(status + (size_t)B * nb), nb, Tp, T, S);
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
