"""The CUDA kernels' per-tile arithmetic, run on the CPU.

``dbde_tpu_torch/csrc/dbde_tile.cuh`` holds the depth/min, pack and unpack
code that the kernels inline, a tile's loads and stores in a frame, the
tiles backend's layout store, K6's status words, warp-window look-back
fold, and the block steps of K2, K3 and K6 (the sum of a frame's earlier
depths, the staged pack and unpack, the copies between stage and stream);
it compiles under g++ as well.
This test builds it into a small ctypes library and holds it against the
port's plain PyTorch versions (themselves held against the JAX package in
test_torch_ops.py, test_torch_codec.py and test_torch_tiles.py), tolerance
0; K2 and K3, and K6 and K7, run there block by block, in any block order.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dbde_tpu_torch.bench_core import make_adversarial, make_content, make_depth_runs
from dbde_tpu_torch.ops import (
    band,
    pack_words,
    pad_and_tile,
    tile_depths_mins,
    tile_layout,
    unpack_words_to_tiles,
)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dbde_tpu_torch", "csrc")

# n tiles of 64 row-major pixels; words are (n, 16) u32.  A tile's 64 bytes
# are its 16 words' little-endian bytes, so memcpy is the kernels' layout.
WRAPPER = r"""
#include <string.h>
#include <algorithm>
#include <vector>
#include "dbde_tile.cuh"
extern "C" {
void tm_depth_min(const uint8_t* px, int n, uint8_t* depth, uint8_t* mn) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16], d, m;
    memcpy(tile, px + 64 * t, 64);
    dbde_tile_depth_min(tile, &d, &m);
    depth[t] = (uint8_t)d;
    mn[t] = (uint8_t)m;
  }
}
void tm_depth_min_u16x2(const uint8_t* px, int n, uint8_t* depth, uint8_t* mn) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16], d, m;
    memcpy(tile, px + 64 * t, 64);
    dbde_tile_depth_min_u16x2(tile, &d, &m);
    depth[t] = (uint8_t)d;
    mn[t] = (uint8_t)m;
  }
}
// K2's and K6's stage pack: tile t staged at stream word 16t (a stage of 1024 tiles),
// read back in stream order
void tm_stage(const uint8_t* px, int n, const uint8_t* depth, const uint8_t* mn,
              uint32_t* words) {
  std::vector<uint32_t> stage(DBDE_STAGE_WORDS);
  for (int t0 = 0; t0 < n; t0 += 1024) {
    for (uint32_t k = 0; k < DBDE_STAGE_WORDS; ++k) stage[dbde_stage_slot(k)] = words[16 * t0 + k];
    for (int t = t0; t < n && t < t0 + 1024; ++t) {
      uint32_t tile[16];
      memcpy(tile, px + 64 * t, 64);
      dbde_stage_tile(tile, mn[t], depth[t], stage.data(), 16u * (uint32_t)(t - t0));
    }
    for (int k = 0; k < 16 * 1024 && 16 * t0 + k < 16 * n; ++k)
      words[16 * t0 + k] = stage[dbde_stage_slot((uint32_t)k)];
  }
}
void tm_unpack(const uint32_t* words, int n, const uint8_t* depth, const uint8_t* mn,
               uint8_t* px) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16];
    dbde_load_unpack(words + 16 * t, 0, 16, mn[t], depth[t], tile);
    memcpy(px + 64 * t, tile, 64);
  }
}
void tm_pack8(const uint8_t* px, int n, const uint8_t* mn, uint32_t* words) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16];
    memcpy(tile, px + 64 * t, 64);
    dbde_pack8(tile, mn[t], words + 16 * t);
  }
}
void tm_unpack8(const uint32_t* words, int n, const uint8_t* mn, uint8_t* px) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16];
    dbde_unpack8(words + 16 * t, mn[t], tile);
    memcpy(px + 64 * t, tile, 64);
  }
}
void tm_bytes(const uint32_t* a, const uint32_t* b, int n, uint32_t* sub, uint32_t* add) {
  for (int i = 0; i < n; ++i) {
    sub[i] = dbde_sub_bytes(a[i], b[i]);
    add[i] = dbde_add_bytes(a[i], b[i]);
  }
}
int tm_lookback_step(uint32_t flag, uint32_t value, uint32_t* base) {
  return dbde_lookback_step(dbde_status(flag, value), base);
}
// K6's warp-wide look-back over one window, lane by lane: the two ballots,
// the fold and the sum of the lanes that count.  Returns the fold's outcome;
// adds to *base unless it is 0.
int tm_window_fold(const uint64_t* w, int n, uint32_t* base) {
  uint32_t published = 0, prefix = 0;
  for (int lane = 0; lane < 32; ++lane) {
    const uint32_t flag = lane < n ? (uint32_t)(w[lane] >> 32) : 0u;
    if (flag == DBDE_STATUS_AGGREGATE || flag == DBDE_STATUS_PREFIX) published |= 1u << lane;
    if (flag == DBDE_STATUS_PREFIX) prefix |= 1u << lane;
  }
  int count = 0;
  const int step = dbde_window_fold(published, prefix, n, &count);
  if (step == 0) return 0;
  for (int lane = 0; lane < count; ++lane) *base += (uint32_t)w[lane];
  return step;
}
// The same window walked one status word at a time, as one thread would.
int tm_window_serial(const uint64_t* w, int n, uint32_t* base) {
  for (int k = 0; k < n; ++k) {
    const int step = dbde_lookback_step(w[k], base);
    if (step != 1) return step;
  }
  return 1;
}
void tm_copy_split(const uint32_t* dst, uint32_t total, uint32_t* split) {
  dbde_copy_split(dst, total, split, split + 1, split + 2);
}
// Stage `total` stream words as K6 does and copy them out to dst with
// `nthreads` threads, one after another.
void tm_copy_out(const uint32_t* words, uint32_t total, uint32_t* dst, int nthreads) {
  std::vector<uint32_t> stage(DBDE_STAGE_WORDS, 0xA5A5A5A5u);
  for (uint32_t k = 0; k < total; ++k) stage[dbde_stage_slot(k)] = words[k];
  for (int tid = 0; tid < nthreads; ++tid) dbde_copy_out(stage.data(), total, dst, tid, nthreads);
}
// K6 on one frame of tiles_W, block by block (1024 tiles, 512 threads of
// two consecutive tiles each), with the kernel's functions and status
// words: every block's first half (one read of each tile, depths, minima,
// local scan, published aggregate, pack into its stage) in the order
// `first`, then every block's warp-window look-back, published prefix and
// copy-out in the order `second`.  Returns n64, or -1 if a look-back met an
// unpublished block.
int tm_encode_tiles(const uint32_t* tw, int tp, int T, const int* first, const int* second,
                    uint8_t* depth, uint8_t* mn, uint32_t* payload) {
  const int nb = tp / 1024;
  std::vector<uint64_t> status(nb, 0);
  std::vector<uint32_t> total(nb);
  std::vector<std::vector<uint32_t>> stage(nb);
  for (int q = 0; q < nb; ++q) {
    const int g = first[q];
    stage[g].assign(DBDE_STAGE_WORDS, 0xA5A5A5A5u);
    uint32_t off = 0;
    for (int tid = 0; tid < 512; ++tid) {
      for (int i = 0; i < 2; ++i) {
        const int t = g * 1024 + 2 * tid + i;
        uint32_t d = 0, m = 0, tile[16];
        for (int ww = 0; ww < 16; ++ww) tile[ww] = tw[(size_t)ww * tp + t];
        if (t < T) dbde_tile_depth_min_u16x2(tile, &d, &m);
        depth[t] = (uint8_t)d;
        mn[t] = (uint8_t)m;
        dbde_stage_tile(tile, m, d, stage[g].data(), off);
        off += 2 * d;
      }
    }
    total[g] = off;
    status[g] = dbde_status(g ? DBDE_STATUS_AGGREGATE : DBDE_STATUS_PREFIX, off);
  }
  int n64 = -1;
  for (int q = 0; q < nb; ++q) {
    const int g = second[q];
    uint32_t base = 0;
    for (int hi = g - 1; g > 0; hi -= 32) {
      const int n = hi + 1 < 32 ? hi + 1 : 32;
      uint64_t w[32];
      for (int lane = 0; lane < n; ++lane) w[lane] = status[hi - lane];
      const int step = tm_window_fold(w, n, &base);
      if (step == 0) return -1;
      if (step == 2) break;
    }
    status[g] = dbde_status(DBDE_STATUS_PREFIX, base + total[g]);
    if (g == nb - 1) n64 = (int)((base + total[g]) / 2);
    for (int tid = 0; tid < 512; ++tid)
      dbde_copy_out(stage[g].data(), total[g], payload + base, tid, 512);
  }
  return n64;
}
// Stage `total` words of src with dbde_copy_in, `nthreads` threads one
// after another, and read them back in stream order.
void tm_copy_in(const uint32_t* src, uint32_t total, uint32_t* words, int nthreads) {
  std::vector<uint32_t> stage(DBDE_STAGE_WORDS, 0xA5A5A5A5u);
  for (int tid = 0; tid < nthreads; ++tid) dbde_copy_in(src, total, stage.data(), tid, nthreads);
  for (uint32_t k = 0; k < total; ++k) words[k] = stage[dbde_stage_slot(k)];
}
// Tile t's words staged at stream word 16t (a stage of 1024 tiles), then
// unpacked from the stage.
void tm_unstage(const uint32_t* words, int n, const uint8_t* depth, const uint8_t* mn,
                uint8_t* px) {
  std::vector<uint32_t> stage(DBDE_STAGE_WORDS);
  for (int t0 = 0; t0 < n; t0 += 1024) {
    for (uint32_t k = 0; k < DBDE_STAGE_WORDS && 16 * t0 + k < 16u * n; ++k)
      stage[dbde_stage_slot(k)] = words[16 * t0 + k];
    for (int t = t0; t < n && t < t0 + 1024; ++t) {
      uint32_t tile[16];
      dbde_unstage_tile(stage.data(), 16u * (uint32_t)(t - t0), mn[t], depth[t], tile);
      memcpy(px + 64 * t, tile, 64);
    }
  }
}
uint32_t tm_sum_bytes(const uint8_t* d, uint32_t n, int nthreads) {
  uint32_t sum = 0;
  for (int tid = 0; tid < nthreads; ++tid) sum += dbde_sum_bytes(d, n, tid, nthreads);
  return sum;
}
// K2's and K3's chunk g of a frame as the kernels place it: the words
// before it (each of 512 threads' share of the earlier depths), and thread
// i's tiles g*1024+i and g*1024+512+i at off[2i] and off[2i+1] (the scan in
// tile order).  Returns the chunk's words.
static uint32_t band_chunk(const uint8_t* drow, int T, int g, uint32_t* base,
                           uint32_t off[1024]) {
  uint32_t before = 0, words = 0;
  for (int tid = 0; tid < 512; ++tid) before += dbde_sum_bytes(drow, (uint32_t)g * 1024, tid, 512);
  for (int half = 0; half < 2; ++half)
    for (int tid = 0; tid < 512; ++tid) {
      const int t = g * 1024 + half * 512 + tid;
      off[2 * tid + half] = words;
      if (t < T) words += 2u * drow[t];
    }
  *base = 2 * before;
  return words;
}
// K2 on B (H, W) frames with rows of S payload words, block by block: the
// chunks of every frame in the order `order`, each with the kernel's steps
// -- its threads' tiles (dbde_load_tile at `vec`), the chunk's place, the
// stage pack and the copy-out.
void tm_encode_band(const uint8_t* img, int B, int H, int W, int vec, const uint8_t* depths,
                    const uint8_t* mins, const int* order, uint32_t* payload, int S,
                    int32_t* n64) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles, nb = (T + 1023) / 1024;
  std::vector<uint32_t> stage(DBDE_STAGE_WORDS);
  uint32_t off[1024];
  for (int b = 0; b < B; ++b)
    for (int q = 0; q < nb; ++q) {
      const int g = order[q];
      const uint8_t* drow = depths + (size_t)b * T;
      uint32_t base;
      const uint32_t total = band_chunk(drow, T, g, &base, off);
      std::fill(stage.begin(), stage.end(), 0xA5A5A5A5u);
      for (int tid = 0; tid < 512; ++tid)
        for (int half = 0; half < 2; ++half) {
          const int t = g * 1024 + half * 512 + tid;
          if (t >= T) continue;
          uint32_t tile[16];
          dbde_load_tile(img + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
          dbde_stage_tile(tile, mins[(size_t)b * T + t], drow[t], stage.data(),
                          off[2 * tid + half]);
        }
      for (int tid = 0; tid < 512; ++tid)
        dbde_copy_out(stage.data(), total, payload + (size_t)b * S + base, tid, 512);
      if (g == nb - 1) n64[b] = (int32_t)((base + total) / 2);
    }
}
// K3 likewise: the chunk's place, the copy-in of its stream words, the
// stage unpack and the tile stores; or, for a chunk that does not fit the
// stage or runs past word S, each tile's words from the payload clamped at
// word S-1.
void tm_decode_band(const uint8_t* depths, const uint8_t* mins, const uint32_t* payload, int S,
                    int B, int H, int W, int vec, const int* order, uint8_t* out) {
  const int w_tiles = (W + 7) / 8, T = ((H + 7) / 8) * w_tiles, nb = (T + 1023) / 1024;
  std::vector<uint32_t> stage(DBDE_STAGE_WORDS);
  uint32_t off[1024];
  for (int b = 0; b < B; ++b)
    for (int q = 0; q < nb; ++q) {
      const int g = order[q];
      const uint8_t* drow = depths + (size_t)b * T;
      const uint32_t* src = payload + (size_t)b * S;
      uint32_t base;
      const uint32_t total = band_chunk(drow, T, g, &base, off);
      const bool staged = total <= DBDE_STAGE_WORDS && (uint64_t)base + total <= (uint64_t)S;
      std::fill(stage.begin(), stage.end(), 0xA5A5A5A5u);
      if (staged)
        for (int tid = 0; tid < 512; ++tid) dbde_copy_in(src + base, total, stage.data(), tid, 512);
      for (int tid = 0; tid < 512; ++tid)
        for (int half = 0; half < 2; ++half) {
          const int t = g * 1024 + half * 512 + tid;
          if (t >= T) continue;
          const uint32_t o = off[2 * tid + half], d = drow[t], m = mins[(size_t)b * T + t];
          uint32_t tile[16];
          if (staged)
            dbde_unstage_tile(stage.data(), o, m, d, tile);
          else
            dbde_load_unpack(src, base + o, (uint32_t)S, m, d, tile);
          dbde_store_tile(out + (size_t)b * H * W, H, W, t / w_tiles, t % w_tiles, vec, tile);
        }
    }
}
// K7 on one frame: each block sums the depths before it, scans its own and
// unpacks each tile from its words of the stride-S payload.
void tm_decode_tiles(const uint8_t* depth, const uint8_t* mn, const uint32_t* payload, int S,
                     int tp, uint32_t* tw) {
  for (int g = 0; g < tp / 1024; ++g) {
    uint32_t off = 0;
    for (int t = 0; t < g * 1024; ++t) off += 2u * depth[t];
    for (int t = g * 1024; t < (g + 1) * 1024; ++t) {
      uint32_t tile[16];
      dbde_load_unpack(payload, off, (uint32_t)S, mn[t], depth[t], tile);
      dbde_tile_w_store(tw, tp, t, tile);
      off += 2u * depth[t];
    }
  }
}
}
"""
SENTINEL = 0xDEADBEEF


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the tile-math library")
    d = tmp_path_factory.mktemp("tile_math")
    src, so = d / "tile_math.cpp", d / "libtile_math.so"
    src.write_text(WRAPPER)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    str(src), "-o", str(so)], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tm_depth_min.argtypes = [P, I, P, P]
    lib.tm_depth_min_u16x2.argtypes = [P, I, P, P]
    lib.tm_stage.argtypes = [P, I, P, P, P]
    lib.tm_unpack.argtypes = [P, I, P, P, P]
    lib.tm_pack8.argtypes = [P, I, P, P]
    lib.tm_unpack8.argtypes = [P, I, P, P]
    lib.tm_bytes.argtypes = [P, P, I, P, P]
    lib.tm_lookback_step.argtypes = [ctypes.c_uint32, ctypes.c_uint32, P]
    lib.tm_lookback_step.restype = I
    lib.tm_window_fold.argtypes = [P, I, P]
    lib.tm_window_serial.argtypes = [P, I, P]
    lib.tm_window_fold.restype = lib.tm_window_serial.restype = I
    lib.tm_copy_split.argtypes = [P, ctypes.c_uint32, P]
    lib.tm_copy_out.argtypes = [P, ctypes.c_uint32, P, I]
    lib.tm_encode_tiles.argtypes = [P, I, I, P, P, P, P, P]
    lib.tm_encode_tiles.restype = I
    lib.tm_decode_tiles.argtypes = [P, P, P, I, I, P]
    lib.tm_copy_in.argtypes = [P, ctypes.c_uint32, P, I]
    lib.tm_unstage.argtypes = [P, I, P, P, P]
    lib.tm_sum_bytes.argtypes = [P, ctypes.c_uint32, I]
    lib.tm_sum_bytes.restype = ctypes.c_uint32
    lib.tm_encode_band.argtypes = [P, I, I, I, I, P, P, P, P, I, P]
    lib.tm_decode_band.argtypes = [P, P, P, I, I, I, I, I, P, P]
    for fn in (lib.tm_depth_min, lib.tm_depth_min_u16x2, lib.tm_stage, lib.tm_unpack, lib.tm_pack8, lib.tm_unpack8,
               lib.tm_bytes, lib.tm_copy_split, lib.tm_copy_out, lib.tm_decode_tiles,
               lib.tm_copy_in, lib.tm_unstage, lib.tm_encode_band, lib.tm_decode_band):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _exact_depth_tiles(k: int, n: int = 64, seed: int = 0) -> np.ndarray:
    """(n, 64) u8 tiles of depth exactly k, minima over the whole legal range."""
    rng = np.random.default_rng(seed + k)
    span = (1 << k) - 1 if k else 0
    res = rng.integers(0, span + 1, (n, 64))
    res[:, 0], res[:, 63] = 0, span
    res[1] = span  # then every pixel but one at the top of the range
    res[1, 5] = 0
    lo = rng.integers(0, 256 - span, (n, 1))
    lo[0], lo[-1] = 0, 255 - span
    return (lo + res).astype(np.uint8)


def _cases():
    yield from ((f"depth{k}", _exact_depth_tiles(k)) for k in range(9))
    frames = make_adversarial(40, 24, 2, maxd=8, seed=9)
    yield "adversarial", pad_and_tile(torch.from_numpy(frames)).reshape(-1, 64).numpy()


CASES = dict(_cases())


@pytest.mark.parametrize("name", list(CASES))
def test_tile_math_matches_plain(lib, name):
    tiles = np.ascontiguousarray(CASES[name])
    n = tiles.shape[0]
    depth, mn = np.empty(n, np.uint8), np.empty(n, np.uint8)
    lib.tm_depth_min(_ptr(tiles), n, _ptr(depth), _ptr(mn))
    pd, pm = tile_depths_mins(torch.from_numpy(tiles))
    np.testing.assert_array_equal(depth, pd.numpy())
    np.testing.assert_array_equal(mn, pm.numpy())
    if name.startswith("depth"):
        assert (depth == int(name[5:])).all()
    d16, m16 = np.empty(n, np.uint8), np.empty(n, np.uint8)  # K6's form
    lib.tm_depth_min_u16x2(_ptr(tiles), n, _ptr(d16), _ptr(m16))
    np.testing.assert_array_equal(d16, depth)
    np.testing.assert_array_equal(m16, mn)

    words = np.full((n, 16), SENTINEL, np.uint32)  # K2's and K6's pack, into the stage
    lib.tm_stage(_ptr(tiles), n, _ptr(depth), _ptr(mn), _ptr(words))
    plain = (pack_words(torch.from_numpy(tiles), torch.from_numpy(depth), torch.from_numpy(mn))
             .numpy().astype(np.uint32))
    live = np.arange(16) < 2 * depth[:, None].astype(np.int64)
    np.testing.assert_array_equal(words[live], plain[live])
    # the kernels' store contract: nothing past the tile's own 2*depth words
    assert (words[~live] == SENTINEL).all()

    back = np.empty_like(tiles)
    lib.tm_unpack(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(back))
    np.testing.assert_array_equal(back, tiles)
    unstaged = np.empty_like(tiles)  # K3's unpack, from its stage
    lib.tm_unstage(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(unstaged))
    np.testing.assert_array_equal(unstaged, tiles)
    plain_back = unpack_words_to_tiles(torch.from_numpy(depth), torch.from_numpy(mn),
                                       torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(back, plain_back.numpy())


def test_unpack_illegal_depth_broadcasts_min(lib):
    """A corrupt depth (> 8) decodes to the tile minimum, as depth 0 does,
    in the kernels and the plain version alike."""
    rng = np.random.default_rng(7)
    n = 12
    words = rng.integers(0, 1 << 32, (n, 16), dtype=np.uint32)
    depth = np.array([0, 9, 15, 255] * 3, np.uint8)
    mn = rng.integers(0, 256, n).astype(np.uint8)
    back = np.empty((n, 64), np.uint8)
    lib.tm_unpack(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(back))
    np.testing.assert_array_equal(back, np.repeat(mn[:, None], 64, axis=1))
    lib.tm_unstage(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(back))
    np.testing.assert_array_equal(back, np.repeat(mn[:, None], 64, axis=1))
    plain = unpack_words_to_tiles(torch.from_numpy(depth), torch.from_numpy(mn),
                                  torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(back, plain.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_depth8_whole_tile_form(lib, name):
    """The uniform kernels' pack/unpack (bytewise min subtract/add) against
    the general depth-8 pack, the port's plain uniform version and the
    tiles themselves.  Defined for every tile at its own minimum."""
    tiles = np.ascontiguousarray(CASES[name])
    n = tiles.shape[0]
    depth, mn = np.empty(n, np.uint8), np.empty(n, np.uint8)
    lib.tm_depth_min(_ptr(tiles), n, _ptr(depth), _ptr(mn))
    words = np.empty((n, 16), np.uint32)
    lib.tm_pack8(_ptr(tiles), n, _ptr(mn), _ptr(words))
    general = np.empty((n, 16), np.uint32)  # the stage pack at depth 8
    lib.tm_stage(_ptr(tiles), n, _ptr(np.full(n, 8, np.uint8)), _ptr(mn), _ptr(general))
    np.testing.assert_array_equal(words, general)
    plain = (pack_words(torch.from_numpy(tiles), torch.full((n,), 8), torch.from_numpy(mn))
             .numpy().astype(np.uint32))
    np.testing.assert_array_equal(words, plain)
    back = np.empty_like(tiles)
    lib.tm_unpack8(_ptr(words), n, _ptr(mn), _ptr(back))
    np.testing.assert_array_equal(back, tiles)


def test_bytewise_sub_add_wrap_per_byte(lib):
    """dbde_sub_bytes / dbde_add_bytes are four independent u8 operations
    modulo 256: no borrow or carry crosses a byte, on any input."""
    rng = np.random.default_rng(11)
    edge = np.array([0, 0xFFFFFFFF, 0x80808080, 0x7F7F7F7F, 0x01010101, 0xFF00FF00], np.uint32)
    a = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint32), np.repeat(edge, 6)])
    b = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint32), np.tile(edge, 6)])
    sub, add = np.empty_like(a), np.empty_like(a)
    lib.tm_bytes(_ptr(a), _ptr(b), len(a), _ptr(sub), _ptr(add))
    ab, bb = a.view(np.uint8), b.view(np.uint8)
    np.testing.assert_array_equal(sub.view(np.uint8), ab - bb)  # numpy u8 wraps
    np.testing.assert_array_equal(add.view(np.uint8), ab + bb)


def test_lookback_step(lib):
    """K6's look-back: an unpublished block (flag 0) leaves the base alone
    and says wait; an aggregate adds and goes on; a prefix adds and ends."""
    base = ctypes.c_uint32(7)
    step = lib.tm_lookback_step
    assert step(0, 99, ctypes.byref(base)) == 0 and base.value == 7
    assert step(1, 5, ctypes.byref(base)) == 1 and base.value == 12
    assert step(2, 30, ctypes.byref(base)) == 2 and base.value == 42
    assert step(3, 1, ctypes.byref(base)) == 0 and base.value == 42


def _status(flags, values) -> np.ndarray:
    return (np.asarray(flags, np.uint64) << np.uint64(32)) | np.asarray(values, np.uint64)


def _windows(kind: str, rng):
    """(32 status words, n) windows: lane k is the k-th predecessor back."""
    for n in range(1, 33):
        values = rng.integers(0, 1 << 20, 32)
        if kind == "aggregate runs":  # no prefix: all aggregates, or one hole
            yield _status(np.full(32, 1), values), n
            for hole in range(n):
                flags = np.ones(32, np.int64)
                flags[hole] = rng.choice([0, 3])
                yield _status(flags, values), n
        elif kind == "prefix at every lane":  # aggregates before it, anything after
            for p in range(n):
                flags = rng.integers(0, 4, 32)
                flags[:p], flags[p] = 1, 2
                yield _status(flags, values), n
        elif kind == "unpublished lanes":  # a prefix, holes before and after it
            for p in range(n):
                flags = rng.choice([0, 1, 1, 1, 2, 3], 32)
                flags[p] = 2
                yield _status(flags, values), n
        else:  # "random": any flags, the lanes past n included
            for _ in range(8):
                yield _status(rng.choice([0, 1, 1, 2, 3], 32), values), n


@pytest.mark.parametrize("kind", ["aggregate runs", "prefix at every lane", "unpublished lanes",
                                  "random"])
def test_window_fold_matches_serial_lookback(lib, kind):
    """K6's warp-window fold has the serial look-back's outcome on every
    window (wait, go on, done) and, unless it waits, its base: unpublished
    lanes, runs of aggregates, a prefix at every lane, and windows shorter
    than 32 as chunks 1..31 see them."""
    rng = np.random.default_rng(len(kind))
    outcomes = set()
    for w, n in _windows(kind, rng):
        w = np.ascontiguousarray(w)
        fold, serial = ctypes.c_uint32(5), ctypes.c_uint32(5)
        got = lib.tm_window_fold(_ptr(w), n, ctypes.byref(fold))
        want = lib.tm_window_serial(_ptr(w), n, ctypes.byref(serial))
        assert got == want, (kind, n, w >> np.uint64(32))
        if got:
            assert fold.value == serial.value
        else:
            assert fold.value == 5
        outcomes.add(got)
    assert outcomes == ({0, 1} if kind == "aggregate runs" else {0, 1, 2} if kind == "random"
                        else {0, 2} if kind == "unpublished lanes" else {2})


@pytest.mark.parametrize("mis", range(4))
def test_copy_out_split(lib, mis):
    """K6's copy-out to a destination ``mis`` words past a 16-byte boundary:
    a head of at most 3 words up to the boundary, 16-byte groups, a tail of
    at most 3; every word lands in [base, base + total) and no other word
    of a sentinel-filled row changes, at totals 0-40 and 16384."""
    row = np.full(16400, SENTINEL, np.uint32)
    assert row.ctypes.data % 16 == 0
    rng = np.random.default_rng(mis)
    split = np.empty(3, np.uint32)
    for total in [*range(41), 16384]:
        words = rng.integers(0, 1 << 32, max(total, 1), dtype=np.uint32)
        base = 4 + mis
        dst = row.ctypes.data + 4 * base
        lib.tm_copy_split(dst, total, _ptr(split))
        head, body, tail = (int(v) for v in split)
        assert head + 4 * body + tail == total and head <= 3 and tail <= 3
        assert head == min((4 - mis) % 4, total)
        if body:
            assert (base + head) % 4 == 0
        for nthreads in (512, 3):
            row[:] = SENTINEL
            lib.tm_copy_out(_ptr(words), total, dst, nthreads)
            np.testing.assert_array_equal(row[base : base + total], words[:total])
            assert (row[:base] == SENTINEL).all() and (row[base + total:] == SENTINEL).all()


# one frame each: block seams crossed by runs of every depth (and a whole
# block of flat tiles), a last block holding a single real tile, and a
# full stage (every tile depth 8) with 1023 real tiles in the last block
TILE_FRAMES = {
    "depth runs 16x40000": lambda: make_depth_runs(40000, 16, 1, seed=5),
    "T mod 1024 = 1, 8x8200": lambda: make_adversarial(8200, 8, 1, seed=6),
    "all depth 8, T mod 1024 = 1023, 8x16376": lambda: make_content(16376, 8, 1, kind="random"),
}


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("name", list(TILE_FRAMES))
def test_tiles_kernels_block_by_block(lib, name, order):
    """K6 and K7 run block by block on the CPU, with the blocks in any
    order (K6's first half -- read, depths, scan, aggregate, pack to the
    stage -- for every block, then its second half -- warp-window
    look-back, prefix, copy-out): the same depths, minima, n64 and stream
    as the plain version,
    nothing written past 2*n64, and a short-stride, garbage-padded payload
    decodes back to tiles_W."""
    frame = TILE_FRAMES[name]()
    tw = tile_layout.image_to_tiles_w(torch.from_numpy(frame))
    T = pad_and_tile(torch.from_numpy(frame)).shape[1]
    tp = tw.shape[2]
    nb = tp // tile_layout.TILES_BLOCK
    blocks = np.arange(nb, dtype=np.int32)
    first = {"forward": blocks, "reverse": blocks[::-1],
             "shuffled": np.random.default_rng(nb).permutation(blocks)}[order].copy()
    second = first[::-1].copy() if order == "shuffled" else first
    words = np.ascontiguousarray(tw[0].numpy())
    depth, mn = np.empty(tp, np.uint8), np.empty(tp, np.uint8)
    payload = np.full(16 * T, SENTINEL, np.uint32)
    n64 = lib.tm_encode_tiles(_ptr(words), tp, T, _ptr(first), _ptr(second), _ptr(depth),
                              _ptr(mn), _ptr(payload))
    pd, pm, pp, pn = tile_layout.encode_tiles_plain(tw, T)
    assert n64 == int(pn[0])
    np.testing.assert_array_equal(depth, pd[0].numpy())
    np.testing.assert_array_equal(mn, pm[0].numpy())
    np.testing.assert_array_equal(payload[: 2 * n64], pp[0, : 2 * n64].numpy())
    assert (payload[2 * n64:] == SENTINEL).all()

    S = 2 * n64 + 3
    short = np.random.default_rng(1).integers(0, 1 << 32, S, dtype=np.uint32)
    short[: 2 * n64] = payload[: 2 * n64]
    back = np.empty_like(words)
    lib.tm_decode_tiles(_ptr(depth), _ptr(mn), _ptr(short), S, tp, _ptr(back))
    np.testing.assert_array_equal(back, words)
    plain = tile_layout.decode_tiles_plain(pd, pm, torch.from_numpy(short[None]))
    np.testing.assert_array_equal(back, plain[0].numpy())


def test_unstage_any_words_matches_unpack(lib):
    """K3's stage unpack and the per-tile unpack agree on any words (a
    corrupt stream) at every depth, minima that wrap modulo 256 included."""
    rng = np.random.default_rng(12)
    n = 2 * 1024 + 40  # three stage loads, the last one partial
    words = rng.integers(0, 1 << 32, (n, 16), dtype=np.uint32)
    depth = rng.integers(0, 11, n).astype(np.uint8)
    mn = rng.integers(0, 256, n).astype(np.uint8)
    want, got = np.empty((n, 64), np.uint8), np.empty((n, 64), np.uint8)
    lib.tm_unpack(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(want))
    lib.tm_unstage(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(got))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mis", range(4))
def test_copy_in_split(lib, mis):
    """K3's copy-in from a source ``mis`` words past a 16-byte boundary: the
    split covers exactly ``total`` words (head and tail at most 3, the body
    from the boundary) and the stage holds them in stream order, at totals
    0-40 and 16384, with 512 threads and with 3."""
    rng = np.random.default_rng(10 + mis)
    row = rng.integers(0, 1 << 32, 16400, dtype=np.uint32)
    assert row.ctypes.data % 16 == 0
    split = np.empty(3, np.uint32)
    base = 4 + mis
    src = row.ctypes.data + 4 * base
    for total in [*range(41), 16384]:
        lib.tm_copy_split(src, total, _ptr(split))
        head, body, tail = (int(v) for v in split)
        assert head + 4 * body + tail == total and head <= 3 and tail <= 3
        assert head == min((4 - mis) % 4, total)
        if body:
            assert (base + head) % 4 == 0
        for nthreads in (512, 3):
            words = np.full(max(total, 1), SENTINEL, np.uint32)
            lib.tm_copy_in(src, total, _ptr(words), nthreads)
            np.testing.assert_array_equal(words[:total], row[base : base + total])


def test_sum_bytes_any_alignment(lib):
    """The sum of a frame's earlier depths, as K2's and K3's threads share
    it: equal to the plain sum at every start off the 16-byte grid and
    every length up to a few blocks' worth."""
    rng = np.random.default_rng(13)
    buf = rng.integers(0, 256, 4200, dtype=np.uint8)
    assert buf.ctypes.data % 16 == 0
    for start in range(16):
        for n in [*range(40), 1024, 2047, 3072 + 5]:
            got = lib.tm_sum_bytes(buf.ctypes.data + start, n, 512)
            assert got == int(buf[start : start + n].astype(np.int64).sum()), (start, n)
        assert lib.tm_sum_bytes(buf.ctypes.data + start, 4000, 16) == int(buf[start:start + 4000].sum())


# K2 and K3 block by block.  Ragged H and W (the edge rule), T not a
# multiple of 1024 or of 16, depth runs across block seams, a flat frame
# (n64 0), a whole stage at depth 8, a single tile, and a frame of 37
# chunks.
BAND_FRAMES = {
    "camera 2x43x1931, T 1452": lambda: make_content(1931, 43, 2),
    "adversarial 2x21x8200, T mod 1024 = 3": lambda: make_adversarial(8200, 21, 2, maxd=8, seed=14),
    "depth runs 2x16x40000 across block seams": lambda: make_depth_runs(40000, 16, 2, seed=15),
    "flat 1x24x2048": lambda: np.full((1, 24, 2048), 77, np.uint8),
    "all depth 8, 1x8x16376, T mod 1024 = 1023": lambda: make_content(16376, 8, 1, kind="random"),
    "one tile 2x5x3": lambda: make_adversarial(3, 5, 2, seed=16),
    "camera 3x64x256": lambda: make_content(256, 64, 3),
    "depth runs 1x8x300000, 37 chunks": lambda: make_depth_runs(300000, 8, 1, seed=19),
}
_BAND_PLAIN = {}


def _band_plain(name):
    """(frames, depths, mins, plain payload, plain n64) of BAND_FRAMES[name],
    the payload into sentinel rows of stride 16*T + 1 (rows 4, 8 and 12
    bytes off the 16-byte grid)."""
    if name not in _BAND_PLAIN:
        frames = np.ascontiguousarray(BAND_FRAMES[name]())
        x = torch.from_numpy(frames)
        d, m = band.encode_depths_plain(x)
        B, T = d.shape
        fill = torch.from_numpy(np.full((B, 16 * T + 1), SENTINEL, np.uint32))
        p, n64 = band.encode_payload_plain(x, d, m, out=fill)
        _BAND_PLAIN[name] = (frames, d.numpy(), m.numpy(), p.numpy(), n64.numpy())
    return _BAND_PLAIN[name]


def _aligned(shape, dtype, fill) -> np.ndarray:
    """A C-contiguous array at a 16-byte-aligned address."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.empty(n + 16, np.uint8)
    a = raw[-raw.ctypes.data % 16:][:n].view(dtype).reshape(shape)
    a[...] = fill
    return a


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("name", list(BAND_FRAMES))
def test_band_kernels_block_by_block(lib, name, order):
    """K2 and K3 run block by block on the CPU with the kernels' own steps,
    the blocks in any order, at every row access the frame allows (bytes,
    8-byte rows): the payload and n64 of the plain version into rows off
    the 16-byte grid, nothing written past 2*n64, and the frames back from
    that payload and from the shortest stride with garbage after each
    frame's stream."""
    frames, d, m, want, want_n64 = _band_plain(name)
    B, H, W = frames.shape
    T = d.shape[1]
    nb = -(-T // 1024)
    blocks = np.arange(nb, dtype=np.int32)
    order_ = {"forward": blocks, "reverse": blocks[::-1],
              "shuffled": np.random.default_rng(nb).permutation(blocks)}[order].copy()
    img = _aligned(frames.shape, np.uint8, frames)
    for vec in range(2 if W % 8 == 0 else 1):
        payload = _aligned((B, 16 * T + 1), np.uint32, SENTINEL)
        n64 = np.full(B, -1, np.int32)
        lib.tm_encode_band(_ptr(img), B, H, W, vec, _ptr(d), _ptr(m), _ptr(order_),
                           _ptr(payload), 16 * T + 1, _ptr(n64))
        np.testing.assert_array_equal(n64, want_n64)
        np.testing.assert_array_equal(payload, want)  # the sentinels past 2*n64 too
        for b in range(B):
            assert (payload[b, 2 * n64[b]:] == SENTINEL).all()

        S = max(2 * int(n64.max()), 1)
        short = np.random.default_rng(17).integers(0, 1 << 32, (B, S), dtype=np.uint32)
        for b in range(B):
            short[b, : 2 * n64[b]] = payload[b, : 2 * n64[b]]
        for src in (payload, _aligned(short.shape, np.uint32, short)):
            out = _aligned(frames.shape, np.uint8, 0)
            lib.tm_decode_band(_ptr(d), _ptr(m), _ptr(src), src.shape[1], B, H, W, vec,
                               _ptr(order_), _ptr(out))
            np.testing.assert_array_equal(out, frames)


def test_band_decode_corrupt_depths_matches_plain(lib):
    """K3 on a corrupt depth map (depths above 8, a stream longer than the
    stride, chunks that overflow the stage): each tile's words from the
    payload clamped at word S-1, the frames of the plain version."""
    rng = np.random.default_rng(18)
    B, H, W = 2, 24, 2944  # T 1104: a whole chunk and a partial one
    T = (H // 8) * (W // 8)
    d = rng.integers(0, 9, (B, T)).astype(np.uint8)
    d[0, :40] = rng.integers(9, 256, 40)  # frame 0: chunk 0 does not fit the stage
    d[1, 1030:1034] = 200  # frame 1: the second chunk runs past word S
    m = rng.integers(0, 256, (B, T)).astype(np.uint8)
    S = 2 * int(d[1, :1030].astype(np.int64).sum()) + 5
    payload = rng.integers(0, 1 << 32, (B, S), dtype=np.uint32)
    want = band.decode_frames_plain(torch.from_numpy(d), torch.from_numpy(m),
                                    torch.from_numpy(payload), H, W).numpy()
    out = np.empty((B, H, W), np.uint8)
    order = np.arange(2, dtype=np.int32)
    lib.tm_decode_band(_ptr(d), _ptr(m), _ptr(payload), S, B, H, W, 1, _ptr(order), _ptr(out))
    np.testing.assert_array_equal(out, want)
