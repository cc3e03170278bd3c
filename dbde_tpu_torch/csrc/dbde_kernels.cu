// The codec's main-path kernels for Hopper (sm_90a): encode phase A (per-tile
// depth and minimum), encode phase B (bit-pack each tile into its place in
// the frame's payload stream) and decode, and the uniform depth-8 pair of
// encode phase B and decode that serve batches whose tiles are all depth 8.  Frames are contiguous (B, H, W) u8,
// row-major, at any H and W; the payload is (B, S) u32 with frame b's stream
// at words [b*S, b*S + 2*n64[b]).  Tile t of a frame is tile row t / w_tiles,
// tile column t % w_tiles, as in the format.
//
// One thread owns one 8x8 tile; the grid is (ceil(T/256), B) with 256 threads
// a block.  Neighbouring threads own neighbouring tiles of a tile row, so a
// warp's row loads and stores cover one contiguous 256-byte run of the frame.
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

// Load tile (ty, tx) of one frame.  Pixels past the frame's right or bottom
// edge read at the clamped coordinates (min(y, H-1), min(x, W-1)): that is
// exactly the format's right-then-down edge rule (ref_numpy.tile_image).
// `vec` (W % 8 == 0 and an 8-byte-aligned base) allows one u64 load per row
// of a tile that lies wholly inside the frame; otherwise byte loads.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ img, int H,
                                          int W, int ty, int tx, int vec,
                                          uint32_t tile[16]) {
  const int y0 = 8 * ty, x0 = 8 * tx;
  if (vec && y0 + 8 <= H) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(img + (size_t)(y0 + r) * W + x0);
      tile[2 * r] = v.x;
      tile[2 * r + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = img + (size_t)min(y0 + r, H - 1) * W;
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo |= (uint32_t)row[min(x0 + c, W - 1)] << (8 * c);
      hi |= (uint32_t)row[min(x0 + 4 + c, W - 1)] << (8 * c);
    }
    tile[2 * r] = lo;
    tile[2 * r + 1] = hi;
  }
}

// Store the in-frame part of tile (ty, tx); pixels past H or W are dropped.
__device__ __forceinline__ void store_tile(uint8_t* __restrict__ img, int H, int W,
                                           int ty, int tx, int vec,
                                           const uint32_t tile[16]) {
  const int y0 = 8 * ty, x0 = 8 * tx;
  if (vec && y0 + 8 <= H) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<uint2*>(img + (size_t)(y0 + r) * W + x0) =
          make_uint2(tile[2 * r], tile[2 * r + 1]);
    return;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (y0 + r >= H) break;
    uint8_t* row = img + (size_t)(y0 + r) * W;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (x0 + c < W) row[x0 + c] = (uint8_t)dbde_pixel(tile, 8 * r + c);
  }
}

// K1.  Replaces dbde_tpu/ops/pallas_band.py _depths_kernel (l.370, wrapper
// encode_depths_kernel l.386).  Bound: one read of the frame (16 x 2048^2 u8
// is 67 MB, about 20 us at 3.35 TB/s); the arithmetic is ~200 integer ops a
// tile.  Design: no image transpose or u32 repacking as on the TPU -- each
// thread reads its tile's 8 rows straight from the u8 frame, and the warp's
// loads coalesce along the tile row.
__global__ void __launch_bounds__(kThreads)
    encode_depths_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ depths,
                         uint8_t* __restrict__ mins, int H, int W, int w_tiles,
                         int T, int vec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  uint32_t tile[16];
  load_tile(img + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
  uint32_t depth, mn;
  dbde_tile_depth_min(tile, &depth, &mn);
  depths[(size_t)b * T + t] = (uint8_t)depth;
  mins[(size_t)b * T + t] = (uint8_t)mn;
}

// K2.  Replaces dbde_tpu/ops/pallas_band.py _payload_kernel (l.419, wrapper
// encode_payload_kernel l.695) together with its in-kernel compaction
// (binary-search inverse map and roll splice, kernel_common.py:91-368).
// Bound: one more read of the frame and a write of at most its size.
// Design: offsets come from a scan of 2*depth done before the launch, so
// every tile stores its own 2*depth words straight at its offset -- no
// search, no splice, no carry between blocks.  It writes nothing else: no
// zero fill and no word past the tile's own 2*depth (the round-3 bug of the
// TPU kernel, kernel_common.py:74-88).
__global__ void __launch_bounds__(kThreads)
    encode_payload_kernel(const uint8_t* __restrict__ img,
                          const uint8_t* __restrict__ depths,
                          const uint8_t* __restrict__ mins,
                          const int32_t* __restrict__ offsets,
                          uint32_t* __restrict__ payload, int H, int W, int w_tiles,
                          int T, int S, int vec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  const size_t bt = (size_t)b * T + t;
  const uint32_t k = depths[bt];
  if (k == 0u || k > 8u) return;
  uint32_t tile[16];
  load_tile(img + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
  dbde_pack_store(tile, mins[bt], k, payload + (size_t)b * S + offsets[bt]);
}

// K3.  Replaces dbde_tpu/ops/pallas_band.py _decode_kernel (l.1308, wrappers
// decode_band_kernel l.1575 and _decode_call l.1612).  Bound: a read of the
// payload and a write of the frame.  Design: the TPU kernel gathers a
// 16-word window for every tile and selects by depth; here each thread
// reads only its tile's 2*depth words at its scanned offset, so garbage
// after a tile's words or after 2*n64, and any stride S >= 2*n64, are never
// seen.
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const uint8_t* __restrict__ depths, const uint8_t* __restrict__ mins,
                  const int32_t* __restrict__ offsets,
                  const uint32_t* __restrict__ payload, uint8_t* __restrict__ out,
                  int H, int W, int w_tiles, int T, int S, int vec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  const size_t bt = (size_t)b * T + t;
  const uint32_t k = depths[bt], mn = mins[bt];
  const int off = offsets[bt];
  const uint32_t* src = payload + (size_t)b * S;
  uint32_t tile[16];
  dbde_load_unpack(src, (uint32_t)off, (uint32_t)S, mn, k, tile);
  store_tile(out + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
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
// warp writes one contiguous 2 KB run.
__global__ void __launch_bounds__(kThreads)
    encode_payload_u8_kernel(const uint8_t* __restrict__ img,
                             const uint8_t* __restrict__ mins,
                             uint32_t* __restrict__ payload, int H, int W, int w_tiles,
                             int T, int S, int vec, int pvec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  uint32_t tile[16], w[16];
  load_tile(img + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
  dbde_pack8(tile, mins[(size_t)b * T + t], w);
  store_words16(payload + (size_t)b * S + (size_t)16 * t, pvec, w);
}

// K5.  Replaces dbde_tpu/ops/pallas_band.py _decode_u8_kernel (l.1182,
// wrapper decode_band_u8_kernel l.1262), the inverse of K4.  Bound: a read
// of the payload (16 words a tile) and a write of the frame.  Design: four
// 16-byte loads at 16*t, a bytewise add of the minimum (dbde_unpack8), and
// the same row stores as K3; no depths and no offsets are read.
__global__ void __launch_bounds__(kThreads)
    decode_u8_kernel(const uint8_t* __restrict__ mins,
                     const uint32_t* __restrict__ payload, uint8_t* __restrict__ out,
                     int H, int W, int w_tiles, int T, int S, int vec, int pvec) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  uint32_t w[16], tile[16];
  load_words16(payload + (size_t)b * S + (size_t)16 * t, pvec, w);
  dbde_unpack8(w, mins[(size_t)b * T + t], tile);
  store_tile(out + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
}

dim3 grid_for(int B, int T) { return dim3((unsigned)((T + kThreads - 1) / kThreads), (unsigned)B); }

}  // namespace

extern "C" {

int dbde_encode_depths(const void* img, void* depths, void* mins, int B, int H,
                       int W, int vec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  encode_depths_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (uint8_t*)depths, (uint8_t*)mins, H, W, w_tiles, T, vec);
  return (int)cudaGetLastError();
}

int dbde_encode_payload(const void* img, const void* depths, const void* mins,
                        const void* offsets, void* payload, int B, int H, int W,
                        int S, int vec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  encode_payload_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)depths, (const uint8_t*)mins,
      (const int32_t*)offsets, (uint32_t*)payload, H, W, w_tiles, T, S, vec);
  return (int)cudaGetLastError();
}

int dbde_decode(const void* depths, const void* mins, const void* offsets,
                const void* payload, void* out, int B, int H, int W, int S, int vec,
                void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  decode_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)depths, (const uint8_t*)mins, (const int32_t*)offsets,
      (const uint32_t*)payload, (uint8_t*)out, H, W, w_tiles, T, S, vec);
  return (int)cudaGetLastError();
}

int dbde_encode_payload_u8(const void* img, const void* mins, void* payload, int B,
                           int H, int W, int S, int vec, int pvec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  encode_payload_u8_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)mins, (uint32_t*)payload, H, W, w_tiles, T,
      S, vec, pvec);
  return (int)cudaGetLastError();
}

int dbde_decode_u8(const void* mins, const void* payload, void* out, int B, int H,
                   int W, int S, int vec, int pvec, void* stream) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles;
  decode_u8_kernel<<<grid_for(B, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mins, (const uint32_t*)payload, (uint8_t*)out, H, W, w_tiles, T,
      S, vec, pvec);
  return (int)cudaGetLastError();
}

const char* dbde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
