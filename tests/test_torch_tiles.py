"""The port's tiles backend (``DbdeCodec(backend="tiles")``, K6/K7's plain
versions and the tile-layout transforms) on the CPU, against the JAX
package's layout transforms and XLA codec and the numpy oracle, byte for
byte (tolerance 0: the codec is integer-valued).

The JAX side runs no Pallas kernel here: its tile-layout transforms are
plain jnp, and its tiles kernels are held against ``ref_numpy`` by the JAX
package's own tests; these tests hold the port against the XLA codec and
``ref_numpy`` instead.  Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbde_tpu import ref_numpy as ref
from dbde_tpu.codec import DbdeCodec as JaxCodec
from dbde_tpu.codec import pack_frames_bytes as jax_pack_frames_bytes
from dbde_tpu.ops import pallas_kernels as jax_tiles
from dbde_tpu_torch.bench_core import make_adversarial, make_depth_runs
from dbde_tpu_torch.codec import DbdeCodec, pack_frames_bytes
from dbde_tpu_torch.ops import tile_layout as tl


def _uniform_depth_frame(depth: int, H: int, W: int) -> np.ndarray:
    """A frame whose tiles are all exactly ``depth`` (the content of
    tests/test_jax_codec.py's uniform-depth case, with pinned extremes);
    depth 0 is a flat frame, whose stream is empty."""
    rng = np.random.default_rng(depth)
    span = (1 << depth) - 1 if depth else 0
    lo = 0 if depth == 8 else 100
    img = (lo + rng.integers(0, span + 1, size=(H, W))).astype(np.uint8)
    img[::8, ::8], img[7::8, 7::8] = lo, lo + span
    return img


def _depths_and_partial_group_tail() -> np.ndarray:
    """Depths 0-8, one frame each, then tests/test_band_codec.py's round-3
    pattern: a row of flat tiles ending in a depth-8 tile, so a store past
    a tile's own words would land on the next tile's."""
    H, W = 32, 1024
    frames = [_uniform_depth_frame(d, H, W) for d in range(9)]
    base = np.random.default_rng(3).integers(0, 256, (H, W)).astype(np.uint8)
    for F in (1, 80, 127):
        img = base.copy()
        img[8:16, : 8 * F] = 77
        frames.append(img)
    return np.stack(frames)


def _last_block(W: int) -> np.ndarray:
    """One row of tiles, T = W / 8: an adversarial frame and one whose
    depth runs cross every block seam."""
    return np.concatenate([make_adversarial(W, 8, 1, seed=W),
                           make_depth_runs(W, 8, 1, seed=W)])


GEOMETRIES = {
    "ragged 2x21x43": lambda: make_adversarial(43, 21, 2, maxd=8, seed=1),
    "depths 0-8 and a partial group tail 12x32x1024": _depths_and_partial_group_tail,
    # a last block of one real tile
    "T mod 1024 = 1, 2x8x8200": lambda: _last_block(8200),
    # a last block of 1023, and a third block of flat tiles only
    "T mod 1024 = 1023, 2x8x32760": lambda: _last_block(32760),
}


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def case(request):
    """(frames, the JAX package's XLA encode of them): one compile a geometry."""
    frames = GEOMETRIES[request.param]()
    B, H, W = frames.shape
    return frames, JaxCodec(H, W, backend="xla").encode(frames)


def test_layout_transforms_match_jax(case):
    frames, _ = case
    B, H, W = frames.shape
    tw = tl.image_to_tiles_w(torch.from_numpy(frames))
    want = np.asarray(jax_tiles.image_to_tiles_w(jnp.asarray(frames)))
    assert tw.dtype == torch.uint32 and tw.shape[2] % tl.TILES_BLOCK == 0
    np.testing.assert_array_equal(tw.numpy(), want)
    np.testing.assert_array_equal(tl.tiles_w_to_image(tw, H, W).numpy(), frames)
    np.testing.assert_array_equal(
        np.asarray(jax_tiles.tiles_w_to_image(jnp.asarray(want), H, W)), frames)


def test_encode_tiles_plain_matches_jax_xla_and_oracle(case):
    """Depths, minima, n64 and each frame's stream equal the JAX package's
    XLA codec's and the oracle's; pad tiles are depth 0, minimum 0."""
    frames, jenc = case
    B, H, W = frames.shape
    T = ref.tile_image(frames[0]).shape[0]
    d, m, p, n64 = tl.encode_tiles_plain(tl.image_to_tiles_w(torch.from_numpy(frames)), T)
    assert d.shape == m.shape == (B, tl.pad_tiles(T)) and p.shape == (B, 16 * T)
    assert not d[:, T:].any() and not m[:, T:].any()
    np.testing.assert_array_equal(d[:, :T].numpy(), np.asarray(jenc.depths))
    np.testing.assert_array_equal(m[:, :T].numpy(), np.asarray(jenc.mins))
    np.testing.assert_array_equal(n64.numpy(), np.asarray(jenc.n64))
    jpay = jenc.payload_host()
    for b in range(B):
        live = 2 * int(n64[b])
        assert p[b, :live].numpy().tobytes() == jpay[b, :live].tobytes()
        assert p[b, :live].numpy().tobytes() == ref.pack_image(frames[b])[12 + 2 * T:]


@pytest.mark.parametrize("slack", [0, 5])
def test_decode_tiles_plain_short_stride_with_garbage(case, slack):
    """Any payload stride S >= 2*max(n64), with random garbage after each
    frame's 2*n64 words, decodes back to tiles_W and the frames."""
    frames, _ = case
    B, H, W = frames.shape
    tw = tl.image_to_tiles_w(torch.from_numpy(frames))
    T = ref.tile_image(frames[0]).shape[0]
    d, m, p, n64 = tl.encode_tiles_plain(tw, T)
    S = max(2 * int(n64.max()) + slack, 1)
    rng = np.random.default_rng(slack)
    short = rng.integers(0, 1 << 32, (B, S), dtype=np.uint32)
    for b in range(B):
        short[b, : 2 * int(n64[b])] = p[b, : 2 * int(n64[b])].numpy()
    out = tl.decode_tiles_plain(d, m, torch.from_numpy(short))
    np.testing.assert_array_equal(out.numpy(), tw.numpy())
    np.testing.assert_array_equal(tl.tiles_w_to_image(out, H, W).numpy(), frames)


def test_tiles_backend_records(case):
    """The tiles backend writes the band backend's, the JAX XLA codec's and
    the oracle's records, and decodes them back."""
    frames, jenc = case
    B, H, W = frames.shape
    tiles = DbdeCodec(H, W, device="cpu", backend="tiles")
    enc = tiles.encode(frames)
    recs = pack_frames_bytes(enc, indices=range(2, 2 + B))
    assert recs == pack_frames_bytes(DbdeCodec(H, W, device="cpu").encode(frames),
                                     indices=range(2, 2 + B))
    assert recs == jax_pack_frames_bytes(jenc, indices=range(2, 2 + B))
    for b in range(B):
        assert recs[b] == ref.pack_frame(2 + b, frames[b])
    depths, mins, payload, _ = enc.to_numpy()
    np.testing.assert_array_equal(tiles.decode(depths, mins, payload), frames)


def test_wrappers_take_the_plain_version_on_the_cpu():
    frames = make_adversarial(40, 16, 2, seed=5)
    tw = tl.image_to_tiles_w(torch.from_numpy(frames))
    got = tl.encode_tiles(tw, 10)
    want = tl.encode_tiles_plain(tw, 10)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                           w.view(torch.int32) if w.dtype == torch.uint32 else w)
    out = tl.decode_tiles(got[0], got[1], got[2])
    assert torch.equal(out.view(torch.int32), tw.view(torch.int32))


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        DbdeCodec(8, 8, device="cpu", backend="xla")
    with pytest.raises(ValueError, match="unknown backend"):
        DbdeCodec(8, 8, device="cpu", backend="pallas")
