"""The tile-layout codec path (``DbdeCodec(backend="tiles")``): the layout
transforms, the kernels K6 and K7, their plain versions and wrappers.

Counterpart of :mod:`dbde_tpu.ops.pallas_kernels`.  Frames cross into the
kernels as ``tiles_W``, (B, 16, Tp) u32: word ``2r + hx`` of tile t holds
pixels (r, 4hx .. 4hx+3) of the tile, lowest byte first, and the tile
count is padded with zero tiles to Tp, a multiple of :data:`TILES_BLOCK`.
The layout is word-major, so thread t reading word ww of tile t makes
coalesced loads.

  K6 ``encode_tiles``: tiles_W → per-tile depths and minima (B, Tp) u8,
     the frame's compacted payload stream (B, S) u32 and n64 (B,) i32, in
     one launch.  Replaces ``pallas_kernels.py:79 _encode_kernel``.
  K7 ``decode_tiles``: depths and minima (B, Tp) u8 and the payload
     (B, S) u32, any S ≥ 2·n64 → tiles_W.  Replaces
     ``pallas_kernels.py:189 _decode_kernel``.

The transforms :func:`image_to_tiles_w` and :func:`tiles_w_to_image` run
outside the kernels, as they do outside Pallas in JAX: plain torch
reshapes and permutes through an int32 view (torch has no uint32
arithmetic on the CPU).  A CPU tensor runs the plain version, a CUDA
tensor the kernel or raises.
"""

from __future__ import annotations

import torch

from ..format import tile_grid
from . import build
from .bitpack import MAX_WORDS_PER_TILE, pack_words, tile_depths_mins, unpack_words_to_tiles
from .launch import check, cuda_batch, launch
from .payload import compact_payload, gather_windows, word_offsets

TILES_BLOCK = 1024  # tiles a kernel block takes; Tp is a multiple of it


def pad_tiles(t: int) -> int:
    """Tile count ``t`` rounded up to a multiple of :data:`TILES_BLOCK`."""
    return -(-t // TILES_BLOCK) * TILES_BLOCK


def pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., T) → (..., n) with zeros after T (``x`` itself when T == n)."""
    if x.shape[-1] == n:
        return x
    out = torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    out[..., : x.shape[-1]] = x
    return out


# -- layout transforms ---------------------------------------------------------


def image_to_tiles_w(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) u8 frames → tiles_W (B, 16, Tp) u32, ragged edges padded
    right then down with the edge value (the format's rule), pad tiles zero."""
    B, H, W = images.shape
    h, w = tile_grid(W, H)
    if (8 * h, 8 * w) != (H, W):
        rows = torch.arange(8 * h, device=images.device).clamp_(max=H - 1)
        cols = torch.arange(8 * w, device=images.device).clamp_(max=W - 1)
        images = images[:, rows][:, :, cols]
    elif not images.is_contiguous() or images.storage_offset() % 4:
        images = images.clone()  # the int32 view needs aligned, contiguous rows
    x32 = images.view(torch.int32).reshape(B, h, 8, w, 2)  # word (y, x // 4)
    tw = x32.permute(0, 2, 4, 1, 3).reshape(B, 16, h * w)  # a copy: the permute moves data
    return pad_last(tw, pad_tiles(h * w)).view(torch.uint32)


def tiles_w_to_image(tw: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """tiles_W (B, 16, Tp) u32 → contiguous (B, H, W) u8 frames."""
    B = tw.shape[0]
    h, w = tile_grid(W, H)
    x32 = tw.view(torch.int32)[:, :, : h * w].reshape(B, 8, 2, h, w).permute(0, 3, 1, 4, 2)
    x = x32.contiguous().view(torch.uint8).reshape(B, 8 * h, 8 * w)
    return x[:, :H, :W].contiguous()


def _tiles_w_to_tiles(tw: torch.Tensor, T: int) -> torch.Tensor:
    """tiles_W (B, 16, Tp) u32 → the first T tiles as (B, T, 64) u8 pixels:
    a tile's 16 words, lowest byte first, are its 64 pixels row-major."""
    return tw.view(torch.int32)[:, :, :T].transpose(1, 2).contiguous().view(torch.uint8)


def _tiles_to_tiles_w(tiles: torch.Tensor) -> torch.Tensor:
    """(B, Tp, 64) u8 tiles → tiles_W (B, 16, Tp) u32."""
    return tiles.contiguous().view(torch.int32).transpose(1, 2).contiguous().view(torch.uint32)


# -- plain versions --------------------------------------------------------------


def encode_tiles_plain(tiles_w: torch.Tensor, tiles: int, out: torch.Tensor | None = None):
    """tiles_W (B, 16, Tp) u32 holding ``tiles`` real tiles → (depths (B, Tp)
    u8, mins (B, Tp) u8, payload (B, S) u32, n64 (B,) i32).  Pad tiles are
    depth 0 and minimum 0 and store no words; each real tile stores its
    ``2*depth`` words at its place in the frame's stream and nothing else
    (``out`` defaults to a zeroed (B, 16*tiles))."""
    B, _, tp = tiles_w.shape
    px = _tiles_w_to_tiles(tiles_w, tiles)
    depth, mn = tile_depths_mins(px)
    depth = depth.to(torch.uint8)
    offsets, total = word_offsets(depth)
    payload = compact_payload(pack_words(px, depth, mn), depth, offsets, out)
    return pad_last(depth, tp), pad_last(mn, tp), payload, total // 2


def decode_tiles_plain(depths: torch.Tensor, mins: torch.Tensor,
                       payload: torch.Tensor) -> torch.Tensor:
    """(depths, mins (B, Tp) u8, payload (B, S) u32) → tiles_W (B, 16, Tp)
    u32.  Tile t's words start at ``2 * Σ_{s<t} depth[s]``; a tile of
    depth 0 (or above 8) is its minimum everywhere."""
    offsets, _ = word_offsets(depths)
    px = unpack_words_to_tiles(depths, mins, gather_windows(payload, offsets))
    return _tiles_to_tiles_w(px)


# -- kernel wrappers ---------------------------------------------------------------


def encode_tiles(tiles_w: torch.Tensor, tiles: int, out: torch.Tensor | None = None):
    """K6: tiles_W (B, 16, Tp) u32 holding ``tiles`` real tiles → (depths
    (B, Tp) u8, mins (B, Tp) u8, payload (B, S) u32, n64 (B,) i32), as
    :func:`encode_tiles_plain`.  ``out`` is (B, S) u32 with S ≥ 16*tiles;
    the default is uninitialised (B, 16*tiles).  Words at or past ``2*n64``
    of each frame are left as they were.  Kernel: ``dbde_encode_tiles``."""
    if tiles_w.device.type == "cpu":
        return encode_tiles_plain(tiles_w, tiles, out)
    dev = tiles_w.device
    B, _, tp = tiles_w.shape
    cuda_batch(dev, B)
    check("tiles_w", tiles_w, torch.uint32, (B, 16, tp), dev)
    if tp % TILES_BLOCK or not 0 < tiles <= tp:
        raise ValueError(f"tiles_w holds Tp={tp} tiles (a multiple of {TILES_BLOCK} "
                         f"expected) for {tiles} real ones")
    if out is None:
        out = torch.empty((B, tiles * MAX_WORDS_PER_TILE), dtype=torch.uint32, device=dev)
    elif out.ndim != 2 or out.shape[1] < tiles * MAX_WORDS_PER_TILE:
        raise ValueError(f"out must be (B, S) with S >= {tiles * MAX_WORDS_PER_TILE}, "
                         f"got {tuple(out.shape)}")
    check("out", out, torch.uint32, (B, out.shape[1]), dev)
    depths, mins = torch.empty((2, B, tp), dtype=torch.uint8, device=dev)  # one allocation
    n64 = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        # the chained scan's status word per (frame, block) and the block
        # ticket after them, zeroed for every launch
        status = torch.zeros((B * (tp // TILES_BLOCK) + 1,), dtype=torch.int64, device=dev)
        launch("encode_tiles", build.load().dbde_encode_tiles, dev,
               tiles_w.data_ptr(), depths.data_ptr(), mins.data_ptr(), out.data_ptr(),
               n64.data_ptr(), status.data_ptr(), B, tp, tiles, out.shape[1])
    return depths, mins, out, n64


def decode_tiles(depths: torch.Tensor, mins: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """K7: (depths, mins (B, Tp) u8, payload (B, S) u32 with S ≥ 2*n64) →
    tiles_W (B, 16, Tp) u32, as :func:`decode_tiles_plain`.  Reads only
    each tile's ``2*depth`` words.  Kernel: ``dbde_decode_tiles``."""
    if depths.device.type == "cpu":
        return decode_tiles_plain(depths, mins, payload)
    dev = depths.device
    B, tp = depths.shape
    cuda_batch(dev, B)
    if tp % TILES_BLOCK:
        raise ValueError(f"depths must have Tp = a multiple of {TILES_BLOCK} columns, got {tp}")
    check("depths", depths, torch.uint8, (B, tp), dev)
    check("mins", mins, torch.uint8, (B, tp), dev)
    if payload.ndim != 2 or payload.shape[1] < 1:
        raise ValueError(f"payload must be (B, S) with S >= 1, got {tuple(payload.shape)}")
    check("payload", payload, torch.uint32, (B, payload.shape[1]), dev)
    out = torch.empty((B, 16, tp), dtype=torch.uint32, device=dev)
    if B:
        launch("decode_tiles", build.load().dbde_decode_tiles, dev,
               depths.data_ptr(), mins.data_ptr(), payload.data_ptr(), out.data_ptr(),
               B, tp, payload.shape[1], int(depths.data_ptr() % 16 == 0))
    return out
