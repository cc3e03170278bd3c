"""Frame ↔ 8×8-tile layout transforms in plain PyTorch.

Counterpart of :mod:`dbde_tpu.ops.tiling`.  Ragged edges follow the
format's right-then-down rule (dbde_util.cpp:105-135): a pixel past the
edge takes the value at the clamped coordinates ``(min(y, H-1),
min(x, W-1))``, which is what an index clamp on both axes gives.
"""

from __future__ import annotations

import torch

from ..format import tile_grid


def pad_and_tile(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) u8 → (B, T, 64) u8; tiles row-major, pixels row-major in-tile."""
    B, H, W = images.shape
    h, w = tile_grid(W, H)
    rows = torch.arange(8 * h, device=images.device).clamp_(max=H - 1)
    cols = torch.arange(8 * w, device=images.device).clamp_(max=W - 1)
    padded = images[:, rows][:, :, cols]
    return padded.reshape(B, h, 8, w, 8).permute(0, 1, 3, 2, 4).reshape(B, h * w, 64)


def untile(tiles: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, T, 64) u8 → contiguous (B, H, W) u8 (drops the padded margin)."""
    B = tiles.shape[0]
    h, w = tile_grid(W, H)
    padded = tiles.reshape(B, h, w, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, 8 * h, 8 * w)
    return padded[:, :H, :W].contiguous()
