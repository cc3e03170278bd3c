"""The plain reference: DBDE frame data from frames, in plain PyTorch.

The benchmark's own copy of the port's numpy oracle (``ref_numpy``),
vectorised over tiles so that it runs at the cells' sizes, on any device.
It imports nothing of the measured program.  The algorithm
(dbde_util.cpp:137-196, README.md:50-67 of the reference library):

  * the H×W u8 frame is cut into ceil(H/8) × ceil(W/8) tiles of 8×8,
    the ragged edges padded right with each row's last value, then down
    with the last row;
  * per tile, ``depth = bit_length(max - min)``; the 64 residuals ``pixel
    - min`` are packed LSB-first at ``depth`` bits each into exactly
    ``depth`` little-endian u64 words, tiles back to back in row-major
    tile order;
  * frame data is ``i32 h·w``, the depths, ``i32 h·w``, the minima, ``i32
    n64 = Σ depths``, the payload; a record is a 20-byte frame header
    (``u32 2``, ``u64 index``, ``f64 elapsed_ns``) and its frame data.

``bits`` below 8 is the control: each pixel is cut to its ``bits`` most
significant bits before encoding, a lossy precision that the
configurations' guarantee (lossless 8-bit frames) rules out.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

VIDEO_HEADER_BYTES = 28
FRAME_HEADER_BYTES = 20


def video_header(height: int, width: int, frame_hz: float) -> bytes:
    return struct.pack("<IQQd", 3, height, width, float(frame_hz))


def frame_header(index: int) -> bytes:
    return struct.pack("<IQd", 2, index, 0.0)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return (height + 7) // 8, (width + 7) // 8


def tiles(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W) u8 → (B, h·w, 64) u8 tiles, edge-padded right then down."""
    B, H, W = frames.shape
    h, w = tile_grid(W, H)
    x = torch.cat([frames, frames[:, :, -1:].expand(B, H, 8 * w - W)], dim=2)
    x = torch.cat([x, x[:, -1:, :].expand(B, 8 * h - H, 8 * w)], dim=1)
    return x.reshape(B, h, 8, w, 8).permute(0, 1, 3, 2, 4).reshape(B, h * w, 64)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """bit_length of values in [0, 255]: 0 if flat, 8 if the range is ≥ 128."""
    x = x.to(torch.int32)
    return sum((x > (1 << i) - 1).to(torch.int32) for i in range(8))


def payload_bytes(res: torch.Tensor, depths: torch.Tensor) -> torch.Tensor:
    """(T, 64) residuals and (T,) depths of one frame → its payload bytes,
    ``8·Σ depths`` u8, each tile's ``64·depth`` bits LSB-first at the byte
    offset ``8·Σ`` of the earlier tiles' depths."""
    depths = depths.to(torch.int64)
    offsets = 8 * (torch.cumsum(depths, 0) - depths)
    out = torch.zeros(int(8 * depths.sum()), dtype=torch.uint8, device=res.device)
    weights = 1 << torch.arange(8, device=res.device, dtype=torch.int32)
    for d in range(1, 9):
        idx = torch.nonzero(depths == d).flatten()
        if idx.numel() == 0:
            continue
        r = res[idx].to(torch.int32)
        bits = (r[:, :, None] >> torch.arange(d, device=res.device, dtype=torch.int32)) & 1
        packed = (bits.reshape(-1, 8 * d, 8) * weights).sum(-1).to(torch.uint8)
        out[offsets[idx][:, None] + torch.arange(8 * d, device=res.device)] = packed
    return out


def frame_data(frames: torch.Tensor, bits: int = 8) -> list[tuple[bytes, int]]:
    """(B, H, W) u8 frames → [(frame data bytes, n64)] one a frame."""
    if bits < 8:
        frames = frames & ((0xFF << (8 - bits)) & 0xFF)
    t = tiles(frames)
    mins = t.min(dim=2).values
    depths = bit_length(t.max(dim=2).values.to(torch.int32) - mins.to(torch.int32))
    res = t - mins[:, :, None]
    T = t.shape[1]
    count = struct.pack("<i", T)
    out = []
    for b in range(t.shape[0]):
        n64 = int(depths[b].sum())
        payload = payload_bytes(res[b], depths[b]).cpu().numpy().tobytes()
        out.append((b"".join((count, depths[b].to(torch.uint8).cpu().numpy().tobytes(),
                              count, mins[b].cpu().numpy().tobytes(),
                              struct.pack("<i", n64), payload)), n64))
    return out


def encode_source(src: np.ndarray, device: torch.device, bits: int = 8,
                  block: int = 8) -> list[tuple[bytes, int]]:
    """Frame data of every source frame, computed ``block`` frames at a
    time on ``device``."""
    out = []
    for i in range(0, src.shape[0], block):
        out += frame_data(torch.from_numpy(np.ascontiguousarray(src[i:i + block])).to(device),
                          bits)
    return out
