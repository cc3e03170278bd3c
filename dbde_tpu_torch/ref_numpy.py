"""Pure-numpy reference model of the DBDE pixel codec.

This is the slow, obviously-correct oracle that the port's kernels and
plain PyTorch versions are held against (``chip_smoke.py`` reads its bytes
and its depth maps); the port's own copy of :mod:`dbde_tpu.ref_numpy`, so
that the port imports nothing of the JAX package.  It mirrors the public
surface of the reference library (dbde_util.h:21-37) but in
array-in/array-out Python style.

Algorithm (README.md:50-67 of the reference):
  * the H×W u8 image is cut into ceil(H/8) × ceil(W/8) tiles of 8×8 pixels,
    ragged edges constant-padded right-then-down with the last valid value;
  * per tile: ``depth = bit_length(max - min)`` bits per pixel are kept
    (0 if flat, 8 if range ≥ 128), the minimum is subtracted, and the 64
    residuals are bit-packed LSB-first into exactly ``depth`` little-endian
    u64 words;
  * frame data is three length-prefixed arrays: ``i32 h·w``, per-tile depths,
    ``i32 h·w``, per-tile minima, ``i32 n64 = Σ depths``, payload u64s.

Encode loop parity: dbde_util.cpp:137-180.  Decode parity (including the
strict count validation that returns an error on any mismatch):
dbde_util.cpp:291-328.
"""

from __future__ import annotations

import struct

import numpy as np

from .format import (
    FRAME_HEADER_BYTES,
    FrameHeader,
    VideoHeader,
    packed_image_size,
    tile_grid,
    unpack_frame_header,
    unpack_video_header,
)

__all__ = [
    "tile_image",
    "untile_image",
    "tile_depths_mins",
    "pack_image",
    "unpack_image",
    "pack_frame",
    "unpack_frame",
    "encode_video",
    "decode_video",
]


def tile_image(image: np.ndarray) -> np.ndarray:
    """(H, W) u8 → (h*w, 64) u8 tiles, row-major tiles, row-major in-tile.

    Ragged edges are constant-padded: rightward with each row's last valid
    value, then downward with the last (already padded) row — numpy ``edge``
    padding on both axes is exactly that rule (dbde_util.cpp:105-135).
    """
    H, W = image.shape
    h, w = tile_grid(W, H)
    padded = np.pad(image, ((0, 8 * h - H), (0, 8 * w - W)), mode="edge")
    return padded.reshape(h, 8, w, 8).transpose(0, 2, 1, 3).reshape(h * w, 64)


def untile_image(tiles: np.ndarray, W: int, H: int) -> np.ndarray:
    """(h*w, 64) u8 tiles → (H, W) u8 image (drops the padded margin)."""
    h, w = tile_grid(W, H)
    padded = tiles.reshape(h, w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * h, 8 * w)
    return np.ascontiguousarray(padded[:H, :W])


def _bit_length_u8(x: np.ndarray) -> np.ndarray:
    """Vectorized bit_length for values in [0, 255] (depth selection rule,
    dbde_util.cpp:48,57,66-68: 0 if flat, 8 if range ≥ 128, else bit_length)."""
    x = x.astype(np.int32)
    return sum((x > (1 << i) - 1) for i in range(8)).astype(np.uint8)


def tile_depths_mins(tiles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (depth, min) arrays from (T, 64) u8 tiles."""
    mn = tiles.min(axis=1)
    mx = tiles.max(axis=1)
    return _bit_length_u8(mx.astype(np.int32) - mn.astype(np.int32)), mn


def _pack_tile_payload(residuals: np.ndarray, depth: int) -> bytes:
    """64 residuals at ``depth`` bits each → exactly ``8*depth`` bytes,
    LSB-first within little-endian u64 words (README.md:54,114)."""
    if depth == 0:
        return b""
    bitpos = np.arange(64 * depth)
    bits = (residuals[bitpos // depth] >> (bitpos % depth)) & 1
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _unpack_tile_payload(payload: bytes, depth: int, minval: int) -> np.ndarray:
    """Inverse of :func:`_pack_tile_payload` → (64,) u8 pixels (min re-added)."""
    if depth == 0:
        return np.full(64, minval, dtype=np.uint8)
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8), bitorder="little")
    res = bits.reshape(64, depth) @ (1 << np.arange(depth))
    return (res + minval).astype(np.uint8)


def pack_image(image: np.ndarray) -> bytes:
    """Encode one (H, W) u8 image to DBDE frame data bytes.

    Layout parity with dbde_util.cpp:137-180: ``i32 h·w``, depths, ``i32 h·w``,
    minima, ``i32 n64``, payload.  Returns ``12 + 2·h·w + 8·n64`` bytes.
    """
    image = np.asarray(image, dtype=np.uint8)
    H, W = image.shape
    h, w = tile_grid(W, H)
    tiles = tile_image(image)
    depths, mins = tile_depths_mins(tiles)
    res = tiles - mins[:, None]  # u8 wraparound-free: tiles >= min
    payload = b"".join(
        _pack_tile_payload(res[t], int(depths[t])) for t in range(h * w)
    )
    n64 = int(depths.astype(np.int64).sum())
    out = b"".join(
        (
            struct.pack("<i", h * w),
            depths.tobytes(),
            struct.pack("<i", h * w),
            mins.tobytes(),
            struct.pack("<i", n64),
            payload,
        )
    )
    assert len(out) == packed_image_size(W, H, n64)
    return out


def unpack_image(buf: bytes, W: int, H: int, offset: int = 0) -> tuple[np.ndarray | None, int]:
    """Decode frame data at ``offset`` → (image, bytes_consumed).

    Error parity with dbde_util.cpp:295-303: any count mismatch (depth array
    size, min array size, or ``n64 != Σ depths``) → ``(None, 0)``.
    """
    h, w = tile_grid(W, H)
    T = h * w
    if len(buf) - offset < 12 + 2 * T:
        return None, 0  # truncated (stricter than the reference, which reads OOB)
    (nb,) = struct.unpack_from("<i", buf, offset)
    if nb != T:
        return None, 0
    depths = np.frombuffer(buf, dtype=np.uint8, count=T, offset=offset + 4)
    (nm,) = struct.unpack_from("<i", buf, offset + 4 + T)
    if nm != T:
        return None, 0
    mins = np.frombuffer(buf, dtype=np.uint8, count=T, offset=offset + 8 + T)
    (n64,) = struct.unpack_from("<i", buf, offset + 8 + 2 * T)
    if n64 != int(depths.astype(np.int64).sum()):
        return None, 0
    if len(buf) - (offset + 12 + 2 * T) < 8 * n64:
        return None, 0  # truncated payload
    pos = offset + 12 + 2 * T
    tiles = np.empty((T, 64), dtype=np.uint8)
    for t in range(T):
        d = int(depths[t])
        tiles[t] = _unpack_tile_payload(buf[pos : pos + 8 * d], d, int(mins[t]))
        pos += 8 * d
    return untile_image(tiles, W, H), pos - offset


def pack_frame(index: int, image: np.ndarray, elapsed_ns: int = 0) -> bytes:
    """20-byte frame header + frame data (dbde_util.cpp:190-196).

    Note the reference's ``dbde_pack_frame`` always writes ``elapsed_ns = 0``
    (SURVEY §5 quirk 2); we default to that but allow setting it.
    """
    return FrameHeader(index=index, elapsed_ns=elapsed_ns).pack() + pack_image(image)


def unpack_frame(buf: bytes, W: int, H: int, offset: int = 0) -> tuple[FrameHeader, np.ndarray | None, int]:
    """Parse header + frame data → (header, image, bytes_consumed).

    On corrupt frame data, ``u64s`` is set to the sentinel and the cursor does
    not advance past the header (dbde_util.cpp:339-345 parity: consumed = 0).
    """
    fh, pos = unpack_frame_header(buf, offset)
    image, n = unpack_image(buf, W, H, pos)
    if n == 0:
        fh.u64s = 0xFFFFFFFF
        return fh, None, 0
    return fh, image, (pos - offset) + n


def encode_video(frames, frame_hz: float = 1.0, indices=None, hz_as_integer: bool = False) -> bytes:
    """Whole-file encode: video header + per-frame (header, data)."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    H, W = frames[0].shape
    out = [VideoHeader(height=H, width=W, frame_hz=frame_hz).pack(hz_as_integer)]
    for i, f in enumerate(frames):
        idx = indices[i] if indices is not None else i
        out.append(pack_frame(idx, f))
    return b"".join(out)


def decode_video(buf: bytes, hz_as_integer: bool = False):
    """Whole-file decode → (VideoHeader, list[FrameHeader], list[image])."""
    vh, pos = unpack_video_header(buf, 0, hz_as_integer)
    if not vh.ok:
        return vh, [], []
    headers, images = [], []
    W, H = int(vh.width), int(vh.height)
    while len(buf) - pos >= FRAME_HEADER_BYTES:
        fh, img, n = unpack_frame(buf, W, H, pos)
        if n == 0 or not fh.ok:
            break
        headers.append(fh)
        images.append(img)
        pos += n
    return vh, headers, images
