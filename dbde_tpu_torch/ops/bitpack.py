"""Variable-depth tile pack/unpack in plain PyTorch.

Counterpart of :mod:`dbde_tpu.ops.bitpack`, with the same closed form:
pixel ``i`` of a depth-``k`` tile occupies bits ``[i*k, i*k + k)`` of the
tile's payload, so u32 word ``j = (i*k) >> 5`` at shift ``(i*k) & 31``,
straddling into word ``j+1`` for k ∈ {3, 5, 6, 7}.  The JAX version runs
one static variant per depth and selects; here the depth is a tensor and
the word index and shift are computed per pixel, so one scatter (pack) or
one gather (unpack) serves every depth.

PyTorch's uint32 has no shifts or adds, so words are carried as int64
holding u32 values and every left shift is masked with ``& 0xFFFFFFFF``.
The dense layout is (..., T, 16): each tile's words left-justified in a
16-word (= depth-8) slot, zero past ``2*depth``.
"""

from __future__ import annotations

import torch

MAX_WORDS_PER_TILE = 16  # depth 8 → 64 pixels * 8 bits / 32 = 16 u32 words
U32_MASK = 0xFFFFFFFF


def tile_depths_mins(tiles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, 64) u8 tiles → per-tile (depth i32 in [0, 8], min u8).

    Depth rule parity (dbde_util.cpp:48,57,66-68): 0 iff flat, 8 iff
    range ≥ 128, else bit_length(max - min).
    """
    mn = tiles.amin(dim=-1)
    rng = tiles.amax(dim=-1).to(torch.int32) - mn.to(torch.int32)
    depth = sum((rng > (1 << i) - 1).to(torch.int32) for i in range(8))
    return depth, mn


def _bit_positions(depth: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """depth (..., T) → (k, word j, shift sh), each (..., T, 64) int64."""
    k = depth.to(torch.int64)[..., None]
    bit = torch.arange(64, device=depth.device) * k
    return k, bit >> 5, bit & 31


def pack_words(tiles: torch.Tensor, depth: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    """(..., T, 64) u8 tiles at the given per-tile depth/min → dense words
    (..., T, 16) int64 holding u32 values.  ``depth`` must be each tile's
    own depth (every residual < 2**depth)."""
    res = tiles.to(torch.int64) - mn.to(torch.int64)[..., None]
    k, j, sh = _bit_positions(depth)
    words = torch.zeros(tiles.shape[:-1] + (MAX_WORDS_PER_TILE + 1,),
                        dtype=torch.int64, device=tiles.device)
    # the pieces of one word cover disjoint bits, so a sum is their OR
    words.scatter_add_(-1, j, (res << sh) & U32_MASK)
    straddle = torch.where(sh + k > 32, res >> (32 - sh), 0)
    words.scatter_add_(-1, j + 1, straddle)
    return words[..., :MAX_WORDS_PER_TILE]


def unpack_words_to_tiles(depths: torch.Tensor, mins: torch.Tensor,
                          words: torch.Tensor) -> torch.Tensor:
    """(depths, mins, dense words (..., T, 16) holding u32 values) →
    (..., T, 64) u8 tiles.

    Depth-0 tiles broadcast the minimum (dbde_util.cpp:218-226), as do
    depths above 8, which select no variant in the JAX version.  The
    minimum is added modulo 256, as the JAX version's u8 cast does.
    """
    w = words.to(torch.int64) & U32_MASK
    depth = torch.where(depths.to(torch.int64) <= 8, depths.to(torch.int64), 0)
    k, j, sh = _bit_positions(depth)
    v = torch.gather(w, -1, j) >> sh
    hi = torch.gather(w, -1, (j + 1).clamp_(max=MAX_WORDS_PER_TILE - 1)) << (32 - sh)
    v = torch.where(sh + k > 32, v | hi, v) & ((1 << k) - 1)
    return ((v + mins.to(torch.int64)[..., None]) & 0xFF).to(torch.uint8)
