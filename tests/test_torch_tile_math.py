"""The CUDA kernels' per-tile arithmetic, run on the CPU.

``dbde_tpu_torch/csrc/dbde_tile.cuh`` holds the depth/min, pack and unpack
code that the kernels inline, the tiles backend's layout loads and stores
and the status words of K6's look-back; it compiles under g++ as well.
This test builds it into a small ctypes library and holds it against the
port's plain PyTorch versions (themselves held against the JAX package in
test_torch_ops.py and test_torch_tiles.py), tolerance 0; K6 and K7 run
there block by block, in any block order.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dbde_tpu_torch.bench_core import make_adversarial, make_depth_runs
from dbde_tpu_torch.ops import (
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
void tm_pack(const uint8_t* px, int n, const uint8_t* depth, const uint8_t* mn,
             uint32_t* words) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16];
    memcpy(tile, px + 64 * t, 64);
    dbde_pack_store(tile, mn[t], depth[t], words + 16 * t);
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
// K6 on one frame of tiles_W, block by block (1024 tiles each), with the
// kernel's tile functions and status words: every block's first half
// (depths, minima, local scan, published aggregate) in the order `first`,
// then every block's look-back, published prefix and stores in the order
// `second`.  Returns n64, or -1 if a look-back met an unpublished block.
int tm_encode_tiles(const uint32_t* tw, int tp, int T, const int* first, const int* second,
                    uint8_t* depth, uint8_t* mn, uint32_t* payload) {
  const int nb = tp / 1024;
  std::vector<uint64_t> status(nb, 0);
  std::vector<uint32_t> off(tp), total(nb);
  for (int q = 0; q < nb; ++q) {
    const int g = first[q];
    uint32_t run = 0;
    for (int t = g * 1024; t < (g + 1) * 1024; ++t) {
      uint32_t d = 0, m = 0, tile[16];
      if (t < T) {
        dbde_tile_w_load(tw, tp, t, tile);
        dbde_tile_depth_min(tile, &d, &m);
      }
      depth[t] = (uint8_t)d;
      mn[t] = (uint8_t)m;
      off[t] = run;
      run += 2 * d;
    }
    total[g] = run;
    status[g] = dbde_status(g ? DBDE_STATUS_AGGREGATE : DBDE_STATUS_PREFIX, run);
  }
  int n64 = -1;
  for (int q = 0; q < nb; ++q) {
    const int g = second[q];
    uint32_t base = 0;
    for (int p = g - 1; p >= 0; --p) {
      const int step = dbde_lookback_step(status[p], &base);
      if (step == 0) return -1;
      if (step == 2) break;
    }
    status[g] = dbde_status(DBDE_STATUS_PREFIX, base + total[g]);
    if (g == nb - 1) n64 = (int)((base + total[g]) / 2);
    for (int t = g * 1024; t < (g + 1) * 1024; ++t) {
      uint32_t tile[16];
      if (!depth[t]) continue;
      dbde_tile_w_load(tw, tp, t, tile);
      dbde_pack_store(tile, mn[t], depth[t], payload + base + off[t]);
    }
  }
  return n64;
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
    lib.tm_pack.argtypes = [P, I, P, P, P]
    lib.tm_unpack.argtypes = [P, I, P, P, P]
    lib.tm_pack8.argtypes = [P, I, P, P]
    lib.tm_unpack8.argtypes = [P, I, P, P]
    lib.tm_bytes.argtypes = [P, P, I, P, P]
    lib.tm_lookback_step.argtypes = [ctypes.c_uint32, ctypes.c_uint32, P]
    lib.tm_lookback_step.restype = I
    lib.tm_encode_tiles.argtypes = [P, I, I, P, P, P, P, P]
    lib.tm_encode_tiles.restype = I
    lib.tm_decode_tiles.argtypes = [P, P, P, I, I, P]
    for fn in (lib.tm_depth_min, lib.tm_pack, lib.tm_unpack, lib.tm_pack8, lib.tm_unpack8,
               lib.tm_bytes, lib.tm_decode_tiles):
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

    words = np.full((n, 16), SENTINEL, np.uint32)
    lib.tm_pack(_ptr(tiles), n, _ptr(depth), _ptr(mn), _ptr(words))
    plain = (pack_words(torch.from_numpy(tiles), torch.from_numpy(depth), torch.from_numpy(mn))
             .numpy().astype(np.uint32))
    live = np.arange(16) < 2 * depth[:, None].astype(np.int64)
    np.testing.assert_array_equal(words[live], plain[live])
    # the kernels' store contract: nothing past the tile's own 2*depth words
    assert (words[~live] == SENTINEL).all()

    back = np.empty_like(tiles)
    lib.tm_unpack(_ptr(words), n, _ptr(depth), _ptr(mn), _ptr(back))
    np.testing.assert_array_equal(back, tiles)
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
    general = np.empty((n, 16), np.uint32)
    lib.tm_pack(_ptr(tiles), n, _ptr(np.full(n, 8, np.uint8)), _ptr(mn), _ptr(general))
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


# one frame each: block seams crossed by runs of every depth (and a whole
# block of flat tiles), and a last block holding a single real tile
TILE_FRAMES = {
    "depth runs 16x40000": lambda: make_depth_runs(40000, 16, 1, seed=5),
    "T mod 1024 = 1, 8x8200": lambda: make_adversarial(8200, 8, 1, seed=6),
}


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("name", list(TILE_FRAMES))
def test_tiles_kernels_block_by_block(lib, name, order):
    """K6 and K7 run block by block on the CPU, with the blocks in any
    order: the same depths, minima, n64 and stream as the plain version,
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
