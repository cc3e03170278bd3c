"""The CUDA kernels' per-tile arithmetic, run on the CPU.

``dbde_tpu_torch/csrc/dbde_tile.cuh`` holds the depth/min, pack and unpack
code that the kernels inline; it compiles under g++ as well.  This test
builds it into a small ctypes library and holds it against the port's
plain PyTorch versions (themselves held against the JAX package in
test_torch_ops.py), tolerance 0.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dbde_tpu.bench_core import make_adversarial
from dbde_tpu_torch.ops import pack_words, pad_and_tile, tile_depths_mins, unpack_words_to_tiles

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dbde_tpu_torch", "csrc")

# n tiles of 64 row-major pixels; words are (n, 16) u32.  A tile's 64 bytes
# are its 16 words' little-endian bytes, so memcpy is the kernels' layout.
WRAPPER = r"""
#include <string.h>
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
             uint32_t* words, int* nwords) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16];
    memcpy(tile, px + 64 * t, 64);
    nwords[t] = dbde_pack(tile, mn[t], depth[t], words + 16 * t);
  }
}
void tm_unpack(const uint32_t* words, int n, const uint8_t* depth, const uint8_t* mn,
               uint8_t* px) {
  for (int t = 0; t < n; ++t) {
    uint32_t tile[16];
    dbde_unpack(words + 16 * t, mn[t], depth[t], tile);
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
    lib.tm_pack.argtypes = [P, I, P, P, P, P]
    lib.tm_unpack.argtypes = [P, I, P, P, P]
    lib.tm_pack8.argtypes = [P, I, P, P]
    lib.tm_unpack8.argtypes = [P, I, P, P]
    lib.tm_bytes.argtypes = [P, P, I, P, P]
    for fn in (lib.tm_depth_min, lib.tm_pack, lib.tm_unpack, lib.tm_pack8, lib.tm_unpack8,
               lib.tm_bytes):
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
    nwords = np.empty(n, np.int32)
    lib.tm_pack(_ptr(tiles), n, _ptr(depth), _ptr(mn), _ptr(words), _ptr(nwords))
    np.testing.assert_array_equal(nwords, 2 * depth.astype(np.int32))
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
    lib.tm_pack(_ptr(tiles), n, _ptr(np.full(n, 8, np.uint8)), _ptr(mn), _ptr(general),
                _ptr(np.empty(n, np.int32)))
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
