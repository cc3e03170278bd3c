"""The port's plain tile ops against the JAX package's, on the CPU.

Tolerance 0: the codec is integer-valued.  Inputs come from numpy seeds and
go through both packages unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbde_tpu.bench_core import make_adversarial
from dbde_tpu.ops import bitpack as jbitpack
from dbde_tpu.ops import payload as jpayload
from dbde_tpu.ops import tiling as jtiling
from dbde_tpu_torch.ops import (
    compact_payload,
    gather_windows,
    pack_words,
    pad_and_tile,
    tile_depths_mins,
    unpack_words_to_tiles,
    untile,
    word_offsets,
)

U32 = 0xFFFFFFFF
# ragged on both edges, every depth 0..8 present (make_adversarial)
B, H, W = 3, 21, 43


def _u32(t: torch.Tensor) -> np.ndarray:
    """Port words (int64 holding u32, or torch.uint32) → numpy u32."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32).to(torch.int64)
    return (t & U32).numpy().astype(np.uint32)


@jax.jit
def _jax_pipeline(images):
    tiles = jtiling.pad_and_tile(images)
    depth, mn, words = jbitpack.pack_tiles_to_words(tiles)
    offsets, total = jpayload.word_offsets(depth)
    flat = jpayload.compact_payload(words, offsets, total)
    windows = jpayload.gather_windows(flat, offsets)
    back = jbitpack.unpack_words_to_tiles(depth, mn, windows)
    return dict(tiles=tiles, depth=depth, mn=mn, words=words, offsets=offsets,
                total=total, flat=flat, windows=windows, back=back,
                images=jtiling.untile(back, H, W))


@pytest.fixture(scope="module")
def case():
    frames = make_adversarial(W, H, B, maxd=8, seed=5)
    ref = {k: np.array(v) for k, v in _jax_pipeline(jnp.asarray(frames)).items()}
    return torch.from_numpy(frames), ref


def test_pad_and_tile_untile(case):
    x, ref = case
    tiles = pad_and_tile(x)
    np.testing.assert_array_equal(tiles.numpy(), ref["tiles"])
    np.testing.assert_array_equal(untile(tiles, H, W).numpy(), x.numpy())


def test_tile_depths_mins(case):
    x, ref = case
    depth, mn = tile_depths_mins(pad_and_tile(x))
    np.testing.assert_array_equal(depth.numpy(), ref["depth"])
    np.testing.assert_array_equal(mn.numpy(), ref["mn"])
    assert set(np.unique(ref["depth"])) == set(range(9))


def test_pack_words(case):
    x, ref = case
    tiles = pad_and_tile(x)
    depth, mn = tile_depths_mins(tiles)
    np.testing.assert_array_equal(_u32(pack_words(tiles, depth, mn)), ref["words"])


def test_word_offsets(case):
    x, ref = case
    offsets, total = word_offsets(torch.from_numpy(ref["depth"].astype(np.uint8)))
    assert offsets.dtype == total.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), ref["offsets"])
    np.testing.assert_array_equal(total.numpy(), ref["total"])


def test_compact_payload(case):
    x, ref = case
    depths = torch.from_numpy(ref["depth"].astype(np.uint8))
    offsets, _ = word_offsets(depths)
    words = torch.from_numpy(ref["words"].astype(np.int64))
    flat = compact_payload(words, depths, offsets)
    assert flat.dtype == torch.uint32
    np.testing.assert_array_equal(_u32(flat), ref["flat"])


def test_compact_payload_writes_only_live_words(case):
    """Into a sentinel-filled buffer: every word at or past 2*n64 is untouched."""
    x, ref = case
    depths = torch.from_numpy(ref["depth"].astype(np.uint8))
    offsets, total = word_offsets(depths)
    sentinel = np.full((B, 16 * depths.shape[1] + 7), 0xDEADBEEF, np.uint32)
    out = compact_payload(torch.from_numpy(ref["words"].astype(np.int64)), depths, offsets,
                          torch.from_numpy(sentinel.copy()))
    got = _u32(out)
    for b in range(B):
        n = int(total[b])
        np.testing.assert_array_equal(got[b, :n], ref["flat"][b, :n])
        np.testing.assert_array_equal(got[b, n:], sentinel[b, n:])


def test_gather_windows(case):
    x, ref = case
    offsets = torch.from_numpy(ref["offsets"])
    windows = gather_windows(torch.from_numpy(ref["flat"]), offsets)
    np.testing.assert_array_equal(_u32(windows), ref["windows"])


def test_unpack_words_to_tiles(case):
    x, ref = case
    tiles = unpack_words_to_tiles(torch.from_numpy(ref["depth"].astype(np.uint8)),
                                  torch.from_numpy(ref["mn"]),
                                  torch.from_numpy(ref["windows"].astype(np.int64)))
    np.testing.assert_array_equal(tiles.numpy(), ref["back"])
    np.testing.assert_array_equal(untile(tiles, H, W).numpy(), ref["images"])
    np.testing.assert_array_equal(ref["images"], x.numpy())


@pytest.mark.parametrize("k", range(1, 9))
def test_static_depth_closed_forms(k):
    """pack_words/unpack_words_to_tiles at depth k against the JAX package's
    static-k closed forms (bitpack._pack_words_static/_unpack_words_static)."""
    rng = np.random.default_rng(100 + k)
    res = rng.integers(0, 1 << k, (5, 64)).astype(np.uint32)
    res[0] = (1 << k) - 1  # every residual at its maximum
    mn = rng.integers(0, 256 - (1 << k) + 1, (5,)).astype(np.uint8)
    tiles = (res + mn[:, None]).astype(np.uint8)
    want = np.asarray(jbitpack._pack_words_static(jnp.asarray(res), k))
    depth = torch.full((5,), k, dtype=torch.int32)
    words = pack_words(torch.from_numpy(tiles), depth, torch.from_numpy(mn))
    np.testing.assert_array_equal(_u32(words), want)
    np.testing.assert_array_equal(
        np.asarray(jbitpack._unpack_words_static(jnp.asarray(want), k)), res)
    back = unpack_words_to_tiles(depth, torch.from_numpy(mn), torch.from_numpy(want.astype(np.int64)))
    np.testing.assert_array_equal(back.numpy(), tiles)
