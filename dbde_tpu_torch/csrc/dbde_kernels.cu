// The codec's main-path kernels for Hopper (sm_90a): encode phase A (per-tile
// depth and minimum), encode phase B (bit-pack each tile into its place in
// the frame's payload stream) and decode, and the uniform depth-8 pair of
// encode phase B and decode that serve batches whose tiles are all depth 8.
// Frames are contiguous (B, H, W) u8, row-major, at any H and W; the payload
// is (B, S) u32 with frame b's stream at words [b*S, b*S + 2*n64[b]).  Tile t
// of a frame is tile row t / w_tiles, tile column t % w_tiles, as in the
// format.
//
// Which pair runs is chosen on the device.  K1 writes a flag, one int32 that
// is nonzero iff some tile of the batch is not depth 8 ("mixed"); K2 and K3
// are launched with it and return at once where it is 0, K4 and K5 where it
// is not, so the codec launches both kernels of a step, in that order, and
// never reads the flag on the host.  A null flag runs the kernel as it is.
//
// K1, K4 and K5: one thread owns one 8x8 tile; the grid is (ceil(T/256), B)
// with 256 threads a block.  Neighbouring threads own neighbouring tiles of
// a tile row, so a warp's row loads and stores cover one contiguous 256-byte
// run of the frame.  K2 and K3: one block of 512 threads owns a chunk of
// 1024 consecutive tiles of one frame, two a thread; the grid is
// (ceil(T/1024), B).
//
// Each launcher is a plain C function bound with ctypes
// (dbde_tpu_torch/ops/build.py): it launches on the caller's stream and
// current device, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dbde_tile.cuh"

namespace {

constexpr int kThreads = 256;

// K1.  Replaces dbde_tpu/ops/pallas_band.py _depths_kernel (l.370, wrapper
// encode_depths_kernel l.386).  Bound: one read of the frame (16 x 2048^2 u8
// is 67 MB, about 20 us at 3.35 TB/s); the arithmetic is ~200 integer ops a
// tile.  Design: no image transpose or u32 repacking as on the TPU -- each
// thread reads its tile's 8 rows straight from the u8 frame, and the warp's
// loads coalesce along the tile row.  With `mixed` (zeroed by the launcher
// first), a block with a tile not at depth 8 stores 1 there: one vote a
// block (__syncthreads_or), so the batch's K2/K4 choice costs no pass of its
// own over the depths and no read-back.
__global__ void __launch_bounds__(kThreads)
    encode_depths_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ depths,
                         uint8_t* __restrict__ mins, int32_t* __restrict__ mixed, int H,
                         int W, int w_tiles, int T, int vec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  uint32_t depth = 8u;
  if (t < T) {
    uint32_t tile[16], mn;
    dbde_load_tile(img + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
    dbde_tile_depth_min(tile, &depth, &mn);
    depths[(size_t)b * T + t] = (uint8_t)depth;
    mins[(size_t)b * T + t] = (uint8_t)mn;
  }
  if (mixed != nullptr && __syncthreads_or(depth != 8u) && threadIdx.x == 0) *mixed = 1;
}

// The gate of a flag-selected kernel: false where the batch's flag selects
// the other kernel of the pair.  Read by every thread before anything else.
__device__ __forceinline__ bool gated_off(const int32_t* mixed, bool general) {
  return mixed != nullptr && ((*mixed != 0) != general);
}

// K2 and K3 share their chunking: block (g, b) owns chunk g of frame b,
// tiles g*1024 .. g*1024+1024, and its thread i the tiles g*1024+i and
// g*1024+512+i (none, or only the first, past the frame's last tile), so a
// warp's row loads and stores of one tile each cover 256 consecutive bytes
// of the frame.  Each block finds its place in the frame's stream itself,
// from the depths alone:
//   - the words before the chunk, 2 * the sum of the frame's depths before
//     it: read by all threads from L2 at 16 bytes a thread with __dp4a
//     (dbde_sum_bytes, at any alignment of the frame's depth row), as K7
//     does, then a warp reduction;
//   - its tiles' places in the chunk: an exclusive scan of the words of
//     each thread's two tiles (two warp-shuffle scans, then one step over
//     the 16 warps' totals).
// So no offsets tensor, no scan before the launch, no status words and no
// order between blocks.  The cost is T^2/2048 bytes a frame read from L2
// (2 MB at 2048^2, 32 MB at 4096^2).  Chosen by measurement over K6's
// chained scan (a ticket, zeroed status words and a warp look-back), which
// was no faster at 2048^2 or 4096^2 and took 1.5x as long on depth-8
// content, whose stores load the memory system most (PERF.md).
constexpr int kChunk = 1024;        // tiles a block
constexpr int kChunkThreads = 512;  // two tiles a thread, 512 apart
constexpr int kChunkWarps = kChunkThreads / 32;
static_assert(2 * kChunkThreads == kChunk, "K2 and K3 give a thread two tiles");
constexpr int kStageBytes = DBDE_STAGE_WORDS * (int)sizeof(uint32_t);  // 64 KB

// The chunk's place in the frame's stream from the words w0 and w1 of the
// thread's two tiles: returns the words before the chunk; off[0] and off[1]
// are the tiles' first words within the chunk and *total the chunk's
// words.  s_warp holds 3 * kChunkWarps words.  Synchronises once.
__device__ __forceinline__ uint32_t chunk_place(const uint8_t* drow, int g, uint32_t w0,
                                                uint32_t w1, uint32_t off[2],
                                                uint32_t* total, uint32_t* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t before = __reduce_add_sync(
      0xFFFFFFFFu, dbde_sum_bytes(drow, (uint32_t)g * kChunk, tid, kChunkThreads));
  uint32_t i0 = w0, i1 = w1;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const uint32_t y0 = __shfl_up_sync(0xFFFFFFFFu, i0, k);
    const uint32_t y1 = __shfl_up_sync(0xFFFFFFFFu, i1, k);
    if (lane >= k) {
      i0 += y0;
      i1 += y1;
    }
  }
  if (lane == 31) {
    s_warp[warp] = i0;
    s_warp[kChunkWarps + warp] = i1;
  }
  if (lane == 0) s_warp[2 * kChunkWarps + warp] = before;
  __syncthreads();
  uint32_t o0 = i0 - w0, o1 = i1 - w1, t0 = 0u, t1 = 0u, base = 0u;
#pragma unroll
  for (int w = 0; w < kChunkWarps; ++w) {
    const uint32_t a = s_warp[w], c = s_warp[kChunkWarps + w];
    o0 += w < warp ? a : 0u;
    o1 += w < warp ? c : 0u;
    t0 += a;
    t1 += c;
    base += s_warp[2 * kChunkWarps + w];
  }
  off[0] = o0;
  off[1] = t0 + o1;
  *total = t0 + t1;
  return 2u * base;
}

// K2.  Replaces dbde_tpu/ops/pallas_band.py _payload_kernel (l.419, wrapper
// encode_payload_kernel l.695) together with stream_meta (l.271), the XLA
// scan that gives it its lane groups' starts.
//
// Bound: bytes.  One read of the frame, the depths and minima, and a write
// of the live payload words and n64: at 16 x 2048^2 camera content about
// 67 + 2 + 35 MB, 31 us at 3.35 TB/s.  The integer work, some 200
// operations a tile, is under half of that at the card's INT32 rate.
//
// Design.  The TPU kernel packs a block's tiles into one VMEM staging value
// at offsets it computes from its group starts and moves it with one DMA.
// Here, one block of 512 threads a chunk of 1024 tiles:
//   1. Each thread reads its two tiles' depths and minima (K1's output) and
//      loads the tiles, 8-byte rows where the frame allows it, bytes with
//      the edge rule otherwise (dbde_load_tile).  Each tile is read once.
//   2. The chunk's place (chunk_place), its L2 reads under the tile loads.
//   3. Every thread packs its tiles into a 64 KB shared stage at the local
//      offsets with one code path for every depth (dbde_stage_tile, as K6).
//   4. After one __syncthreads all threads copy the chunk's words from the
//      stage to payload + b*S + base (dbde_copy_out): at most 3 scalar words
//      up to a 16-byte boundary, 16-byte stores at consecutive addresses,
//      at most 3 scalar words at the end.  A block writes only its own words
//      -- blocks that share a 16-byte segment at a seam need no
//      read-modify-write -- and nothing at or past 2*n64 is written.
//   5. The frame's last chunk writes n64[b].
// Gated by `mixed` (nonzero: K2 runs; see the top of this file).
// What this removes against a K2 that takes scanned offsets: the offsets
// tensor and the four device operations of its scan (torch.cumsum, a cast,
// a multiply and a subtract), and 2*depth scalar stores a tile at its own
// offset, where a warp store touched up to 32 partial sectors.  Depths must
// be K1's (0 to 8): a depth above 8 stages nothing but counts 2*depth words.
// Occupancy: two blocks of 512 threads an SM (64 registers a thread, the
// 64 KB stage), as K6.
__global__ void __launch_bounds__(kChunkThreads, 2)
    encode_payload_kernel(const uint8_t* __restrict__ img,
                          const uint8_t* __restrict__ depths,
                          const uint8_t* __restrict__ mins, uint32_t* __restrict__ payload,
                          int32_t* __restrict__ n64, const int32_t* __restrict__ mixed, int H,
                          int W, int w_tiles, int T, int S, int vec) {
  extern __shared__ uint32_t stage[];  // DBDE_STAGE_WORDS
  __shared__ uint32_t s_warp[3 * kChunkWarps];
  if (gated_off(mixed, true)) return;
  const int tid = threadIdx.x, g = blockIdx.x, b = blockIdx.y;
  const uint8_t* drow = depths + (size_t)b * T;

  // 1. depths, minima and one read of each tile
  const uint8_t* frame = img + (size_t)b * H * W;
  uint32_t tile[2][16], d[2] = {0u, 0u}, m[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = g * kChunk + i * kChunkThreads + tid;
    if (t < T) {
      d[i] = drow[t];
      m[i] = mins[(size_t)b * T + t];
      dbde_load_tile(frame, H, W, t / w_tiles, t % w_tiles, vec, tile[i]);
    }
  }

  // 2. the chunk's place
  uint32_t off[2], total;
  const uint32_t base = chunk_place(drow, g, 2u * d[0], 2u * d[1], off, &total, s_warp);

  // 3. pack into the stage
#pragma unroll
  for (int i = 0; i < 2; ++i) dbde_stage_tile(tile[i], m[i], d[i], stage, off[i]);
  __syncthreads();

  // 4. the coalesced copy-out; 5. n64
  dbde_copy_out(stage, total, payload + (size_t)b * S + base, tid, kChunkThreads);
  if (tid == 0 && g == (int)gridDim.x - 1) n64[b] = (int32_t)((base + total) / 2u);
}

// K3.  Replaces dbde_tpu/ops/pallas_band.py _decode_kernel (l.1308,
// wrappers decode_band_kernel l.1575 and _decode_call l.1612), which DMAs
// its block's contiguous stream into VMEM and unpacks it there.
//
// Bound: bytes.  A read of the depths, minima and live payload words and a
// write of the frame: at 16 x 2048^2 camera content about 2 + 35 + 67 MB,
// 31 us at 3.35 TB/s.
//
// Design, K2's steps in reverse: the chunk's place [base, base + total)
// (chunk_place); all threads copy those stream words into the 64 KB shared
// stage with 16-byte loads at consecutive addresses and at most 3 scalar
// words at each end (dbde_copy_in); after one __syncthreads each thread unpacks its two
// tiles from the stage with one code path for every depth
// (dbde_unstage_tile) and stores them, 8-byte rows where the frame allows
// it (dbde_store_tile; pixels past H or W are dropped).  A block reads no
// payload word outside [base, base + total), so any stride S >= 2*n64 and
// garbage after the stream decode alike.  A corrupt depth map whose chunk
// does not fit the stage or runs past word S takes each tile's words
// straight from the payload instead, clamped at word S-1 as the plain
// version's gather is (dbde_load_unpack).  Gated by `mixed` as K2.
__global__ void __launch_bounds__(kChunkThreads, 2)
    decode_kernel(const uint8_t* __restrict__ depths, const uint8_t* __restrict__ mins,
                  const uint32_t* __restrict__ payload, uint8_t* __restrict__ out,
                  const int32_t* __restrict__ mixed, int H, int W, int w_tiles, int T, int S,
                  int vec) {
  extern __shared__ uint32_t stage[];  // DBDE_STAGE_WORDS
  __shared__ uint32_t s_warp[3 * kChunkWarps];
  if (gated_off(mixed, true)) return;
  const int tid = threadIdx.x, g = blockIdx.x, b = blockIdx.y;
  const uint8_t* drow = depths + (size_t)b * T;
  uint32_t d[2] = {0u, 0u}, m[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = g * kChunk + i * kChunkThreads + tid;
    if (t < T) {
      d[i] = drow[t];
      m[i] = mins[(size_t)b * T + t];
    }
  }
  uint32_t off[2], total;
  const uint32_t base = chunk_place(drow, g, 2u * d[0], 2u * d[1], off, &total, s_warp);

  const uint32_t* src = payload + (size_t)b * S;
  uint32_t tile[2][16];
  if (total <= (uint32_t)DBDE_STAGE_WORDS && (uint64_t)base + total <= (uint64_t)S) {
    dbde_copy_in(src + base, total, stage, tid, kChunkThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) dbde_unstage_tile(stage, off[i], m[i], d[i], tile[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      dbde_load_unpack(src, base + off[i], (uint32_t)S, m[i], d[i], tile[i]);
  }
  uint8_t* frame = out + (size_t)b * H * W;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = g * kChunk + i * kChunkThreads + tid;
    if (t < T) dbde_store_tile(frame, H, W, t / w_tiles, t % w_tiles, vec, tile[i]);
  }
}

// Store or load a tile's 16 payload words: four 16-byte vectors when `pvec`
// (the row base is 16-byte aligned and the stride a multiple of 4 words).
__device__ __forceinline__ void store_words16(uint32_t* __restrict__ dst, int pvec,
                                              const uint32_t w[16]) {
  if (pvec) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) dst[j] = w[j];
}

__device__ __forceinline__ void load_words16(const uint32_t* __restrict__ src, int pvec,
                                             uint32_t w[16]) {
  if (pvec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = src[j];
}

// K4.  Replaces dbde_tpu/ops/pallas_band.py _payload_u8_kernel (l.1017,
// wrapper encode_payload_u8_kernel l.1093), encode phase B for a batch whose
// tiles are all depth 8.  There the stream layout is static: tile t's 16
// words sit at 16*t, so no depths, offsets or scan are needed.  Bound: one
// read of the frame and a write of the same number of bytes.  Design: the
// TPU kernel permutes words out of its folded u32 image layout; here a
// tile's 8 row loads already are its payload words less min*0x01010101
// (dbde_pack8), and each thread stores them as four 16-byte vectors, so a
// warp writes one contiguous 2 KB run.  Gated by `mixed` (zero: K4 runs);
// when it runs and `n64` is given, each frame's first thread writes its
// n64, 8*T, as K2 writes its own.
__global__ void __launch_bounds__(kThreads)
    encode_payload_u8_kernel(const uint8_t* __restrict__ img,
                             const uint8_t* __restrict__ mins,
                             uint32_t* __restrict__ payload, int32_t* __restrict__ n64,
                             const int32_t* __restrict__ mixed, int H, int W, int w_tiles,
                             int T, int S, int vec, int pvec) {
  if (gated_off(mixed, false)) return;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n64 != nullptr && t == 0) n64[b] = 8 * T;
  if (t >= T) return;
  uint32_t tile[16], w[16];
  dbde_load_tile(img + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
  dbde_pack8(tile, mins[(size_t)b * T + t], w);
  store_words16(payload + (size_t)b * S + (size_t)16 * t, pvec, w);
}

// K5.  Replaces dbde_tpu/ops/pallas_band.py _decode_u8_kernel (l.1182,
// wrapper decode_band_u8_kernel l.1262), the inverse of K4.  Bound: a read
// of the payload (16 words a tile) and a write of the frame.  Design: four
// 16-byte loads at 16*t, a bytewise add of the minimum (dbde_unpack8), and
// the same row stores as K3; no depths and no offsets are read.  Gated by
// `mixed` as K4.
__global__ void __launch_bounds__(kThreads)
    decode_u8_kernel(const uint8_t* __restrict__ mins,
                     const uint32_t* __restrict__ payload, uint8_t* __restrict__ out,
                     const int32_t* __restrict__ mixed, int H, int W, int w_tiles, int T,
                     int S, int vec, int pvec) {
  if (gated_off(mixed, false)) return;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  uint32_t w[16], tile[16];
  load_words16(payload + (size_t)b * S + (size_t)16 * t, pvec, w);
  dbde_unpack8(w, mins[(size_t)b * T + t], tile);
  dbde_store_tile(out + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
}

dim3 grid_for(int B, int T) { return dim3((unsigned)((T + kThreads - 1) / kThreads), (unsigned)B); }

dim3 chunk_grid(int B, int T) { return dim3((unsigned)((T + kChunk - 1) / kChunk), (unsigned)B); }

// The 64 KB stage is above the default 48 KB of dynamic shared memory:
// raise the kernel's limit once per device (a repeat is harmless), as
// dbde_encode_tiles does.  The device is this library's runtime's current
// one: nvcc links the runtime statically, and that copy takes its current
// device from the CUDA context current on the thread, which
// torch.cuda.device sets around each launch (ops/launch.py;
// dbde_current_device shows it).
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_stage(Kernel kernel, bool configured[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && configured[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// `mixed` may be null; otherwise it is zeroed on the stream before K1 runs.
int dbde_encode_depths(const void* img, void* depths, void* mins, void* mixed, int B,
                       int H, int W, int vec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  if (mixed != nullptr) {
    const cudaError_t err = cudaMemsetAsync(mixed, 0, sizeof(int32_t), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  encode_depths_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (uint8_t*)depths, (uint8_t*)mins, (int32_t*)mixed, H, W, w_tiles,
      T, vec);
  return (int)cudaGetLastError();
}

int dbde_encode_payload(const void* img, const void* depths, const void* mins,
                        void* payload, void* n64, const void* mixed, int B, int H, int W,
                        int S, int vec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  static bool configured[kMaxDevices];
  const cudaError_t err = allow_stage(encode_payload_kernel, configured);
  if (err != cudaSuccess) return (int)err;
  encode_payload_kernel<<<chunk_grid(B, T), kChunkThreads, kStageBytes,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)depths, (const uint8_t*)mins, (uint32_t*)payload,
      (int32_t*)n64, (const int32_t*)mixed, H, W, w_tiles, T, S, vec);
  return (int)cudaGetLastError();
}

int dbde_decode(const void* depths, const void* mins, const void* payload, void* out,
                const void* mixed, int B, int H, int W, int S, int vec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  static bool configured[kMaxDevices];
  const cudaError_t err = allow_stage(decode_kernel, configured);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<<<chunk_grid(B, T), kChunkThreads, kStageBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)depths, (const uint8_t*)mins, (const uint32_t*)payload, (uint8_t*)out,
      (const int32_t*)mixed, H, W, w_tiles, T, S, vec);
  return (int)cudaGetLastError();
}

int dbde_encode_payload_u8(const void* img, const void* mins, void* payload, void* n64,
                           const void* mixed, int B, int H, int W, int S, int vec, int pvec,
                           void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  encode_payload_u8_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)mins, (uint32_t*)payload, (int32_t*)n64,
      (const int32_t*)mixed, H, W, w_tiles, T, S, vec, pvec);
  return (int)cudaGetLastError();
}

int dbde_decode_u8(const void* mins, const void* payload, void* out, const void* mixed,
                   int B, int H, int W, int S, int vec, int pvec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  decode_u8_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mins, (const uint32_t*)payload, (uint8_t*)out, (const int32_t*)mixed,
      H, W, w_tiles, T, S, vec, pvec);
  return (int)cudaGetLastError();
}

// This library's runtime's current device, or -1 where it has none.
int dbde_current_device() {
  int device = -1;
  return cudaGetDevice(&device) == cudaSuccess ? device : -1;
}

const char* dbde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
