"""The codec's main-path kernels: wrappers, plain versions and launch counts.

Counterpart of the main-path entry points of
:mod:`dbde_tpu.ops.pallas_band` (``encode_depths_kernel``,
``encode_payload_kernel``, ``decode_band_kernel``, and the uniform
depth-8 pair ``encode_payload_u8_kernel`` / ``decode_band_u8_kernel``).  The kernels are CUDA
C++ in ``csrc/dbde_kernels.cu``; they read and write u8 frames (B, H, W)
directly at any width, so none of the TPU's row folding, u32 image layout
or 1024-wide padding exists here.  K2 and K3 find each tile's place in the
frame's stream themselves, from the depths; only the plain versions scan
(:func:`.payload.word_offsets`).

Which pair serves a batch is chosen on the device: K1 can write the
batch's flag ``mixed``, a (1,) int32 tensor that is nonzero iff some tile
is not depth 8 (:func:`mixed_flag` computes it from any depths).  Given
that flag, K2 and K3 do nothing where it is 0 and K4 and K5 nothing where
it is not, so a caller launches both kernels of a step into the same
outputs and never reads the flag back.  Without a flag each kernel runs.

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain PyTorch version, a CUDA tensor to the kernel.  The plain versions
read the flag on the host and give the same bytes and ``n64``.  If the kernel fails to
build or to launch, the wrapper raises; nothing falls back.  Each wrapper
counts its kernel launches in :data:`LAUNCHES` (shared with
:mod:`.tile_layout`).
"""

from __future__ import annotations

import torch

from ..format import tile_grid
from . import build
from .bitpack import MAX_WORDS_PER_TILE, pack_words, tile_depths_mins, unpack_words_to_tiles
from .launch import LAUNCHES, check, cuda_batch, launch, reset_launches  # noqa: F401
from .payload import compact_payload, gather_windows, word_offsets
from .tiling import pad_and_tile, untile


# -- the flag and the plain versions -----------------------------------------


def mixed_flag(depths: torch.Tensor) -> torch.Tensor:
    """(1,) int32 on the depths' device: 1 if some tile of the batch is not
    depth 8, else 0 -- K1's flag, computed there without a read-back."""
    return (depths != 8).any().to(torch.int32).reshape(1)


def _runs(mixed: torch.Tensor | None, general: bool) -> bool:
    """Whether a gated step runs: always without a flag; a general kernel
    (K2, K3) where the flag is nonzero, a uniform one (K4, K5) where it is 0.
    The plain versions read the flag on the host."""
    return mixed is None or (int(mixed.reshape(-1)[0]) != 0) == general


def _frames_out(out, B: int, H: int, W: int, device) -> torch.Tensor:
    if out is None:
        return torch.empty((B, H, W), dtype=torch.uint8, device=device)
    check("out", out, torch.uint8, (B, H, W), device)
    return out


def encode_depths_plain(images: torch.Tensor, mixed=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) u8 → (depths, mins), each (B, T) u8; with ``mixed``, the
    batch's flag is written there."""
    depth, mn = tile_depths_mins(pad_and_tile(images))
    depths = depth.to(torch.uint8)
    if mixed is not None:
        mixed.copy_(mixed_flag(depths))
    return depths, mn


def encode_payload_plain(images, depths, mins, out=None, n64=None,
                         mixed=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack every tile at its depth and store its ``2*depth`` words at its
    place in the frame's stream, the exclusive scan of ``2*depths``, in
    ``out`` (B, S) u32 (default: zeroed (B, 16*T)), and the frames' word
    totals / 2 in ``n64`` (B,) i32.  Writes nothing where ``mixed`` is 0.
    Returns (payload, n64)."""
    B, T = depths.shape
    if out is None:
        out = torch.zeros((B, T * MAX_WORDS_PER_TILE), dtype=torch.uint32, device=images.device)
    if n64 is None:
        n64 = torch.empty((B,), dtype=torch.int32, device=images.device)
    if _runs(mixed, general=True):
        offsets, total = word_offsets(depths)
        words = pack_words(pad_and_tile(images), depths, mins)
        compact_payload(words, depths, offsets, out)
        n64.copy_(total // 2)
    return out, n64


def decode_frames_plain(depths, mins, payload, H: int, W: int, out=None,
                        mixed=None) -> torch.Tensor:
    """(depths, mins (B, T) u8, payload (B, S) u32) → (B, H, W) u8 frames,
    in ``out`` if given; writes nothing where ``mixed`` is 0."""
    out = _frames_out(out, depths.shape[0], H, W, depths.device)
    if _runs(mixed, general=True):
        offsets, _ = word_offsets(depths)
        tiles = unpack_words_to_tiles(depths, mins, gather_windows(payload, offsets))
        out.copy_(untile(tiles, H, W))
    return out


def encode_payload_u8_plain(images, mins, out=None, n64=None, mixed=None) -> torch.Tensor:
    """Every tile at depth 8: tile t's residual bytes (pixel - min mod 256)
    are words ``[16*t, 16*t + 16)`` of ``out`` (B, S) u32 (default (B, 16*T)).
    Residual i is byte i of the tile's little-endian words, so the words are
    the residual bytes viewed as u32.  With ``n64`` (B,) i32, each frame's
    n64, 8*T, is written there.  Writes nothing where ``mixed`` is nonzero."""
    B, H, W = images.shape
    h, w = tile_grid(W, H)
    T = h * w
    if out is None:
        out = torch.empty((B, T * MAX_WORDS_PER_TILE), dtype=torch.uint32, device=images.device)
    if _runs(mixed, general=False):
        tiles = pad_and_tile(images)
        words = (tiles - mins[..., None]).reshape(B, T * 64).view(torch.int32)  # u8 wraps
        out.view(torch.int32)[:, : T * MAX_WORDS_PER_TILE] = words
        if n64 is not None:
            n64.fill_(8 * T)
    return out


def decode_frames_u8_plain(mins, payload, H: int, W: int, out=None, mixed=None) -> torch.Tensor:
    """Inverse of :func:`encode_payload_u8_plain`: (mins (B, T) u8, payload
    (B, S) u32 with S >= 16*T) → (B, H, W) u8 frames, in ``out`` if given;
    writes nothing where ``mixed`` is nonzero."""
    B, T = mins.shape
    out = _frames_out(out, B, H, W, mins.device)
    if _runs(mixed, general=False):
        words = payload.view(torch.int32)[:, : T * MAX_WORDS_PER_TILE].contiguous()
        tiles = words.view(torch.uint8).reshape(B, T, 64) + mins[..., None]  # u8 wraps
        out.copy_(untile(tiles, H, W))
    return out


# -- kernel wrappers ---------------------------------------------------------


def _cuda_tiles(device: torch.device, B: int, H: int, W: int) -> int:
    cuda_batch(device, B)
    h, w = tile_grid(W, H)
    return h * w


def _vec(t: torch.Tensor, W: int) -> int:
    """Whole rows of 8-byte words: the kernels may load/store a tile row as one u64."""
    return int(W % 8 == 0 and t.data_ptr() % 8 == 0)


def _pvec(payload: torch.Tensor) -> int:
    """16-byte-aligned rows: the uniform kernels may move 4 payload words at once."""
    return int(payload.data_ptr() % 16 == 0 and payload.shape[1] % 4 == 0)


def _flag_ptr(mixed: torch.Tensor | None, device) -> int | None:
    if mixed is None:
        return None
    check("mixed", mixed, torch.int32, (1,), device)
    return mixed.data_ptr()


def encode_depths(images: torch.Tensor, mixed: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode phase A: (B, H, W) u8 frames → per-tile (depths, mins), each
    (B, T) u8.  With ``mixed``, a (1,) int32 tensor on the same device, the
    batch's flag is written there (nonzero iff some tile is not depth 8).
    Kernel: ``dbde_encode_depths``."""
    if images.device.type == "cpu":
        return encode_depths_plain(images, mixed)
    B, H, W = images.shape
    dev = images.device
    T = _cuda_tiles(dev, B, H, W)
    check("images", images, torch.uint8, (B, H, W), dev)
    flag = _flag_ptr(mixed, dev)
    depths = torch.empty((B, T), dtype=torch.uint8, device=dev)
    mins = torch.empty_like(depths)
    if B:
        lib = build.load()
        launch("encode_depths", lib.dbde_encode_depths, dev,
               images.data_ptr(), depths.data_ptr(), mins.data_ptr(), flag, B, H, W,
               _vec(images, W))
    return depths, mins


def _payload_out(out, B: int, T: int, dev) -> torch.Tensor:
    if out is None:
        return torch.empty((B, T * MAX_WORDS_PER_TILE), dtype=torch.uint32, device=dev)
    if out.ndim != 2 or out.shape[1] < T * MAX_WORDS_PER_TILE:
        raise ValueError(f"out must be (B, S) with S >= {T * MAX_WORDS_PER_TILE}, got {tuple(out.shape)}")
    check("out", out, torch.uint32, (B, out.shape[1]), dev)
    return out


def encode_payload(images: torch.Tensor, depths: torch.Tensor, mins: torch.Tensor,
                   out: torch.Tensor | None = None, n64: torch.Tensor | None = None,
                   mixed: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode phase B: pack each tile and store its ``2*depth`` u32 words at
    its place in the frame's stream, which the kernel finds from ``depths``
    (K1's, 0 to 8).  ``out`` is (B, S) u32 with S ≥ 16*T; the default is
    uninitialised (B, 16*T).  Words at or past ``2*n64`` of each frame are
    left as they were.  ``n64`` (B,) i32 receives the frames' word totals
    / 2 (default: a new tensor).  With ``mixed``, the kernel writes nothing
    where the flag is 0.  Returns (payload, n64).
    Kernel: ``dbde_encode_payload``."""
    if images.device.type == "cpu":
        return encode_payload_plain(images, depths, mins, out, n64, mixed)
    B, H, W = images.shape
    dev = images.device
    T = _cuda_tiles(dev, B, H, W)
    check("images", images, torch.uint8, (B, H, W), dev)
    check("depths", depths, torch.uint8, (B, T), dev)
    check("mins", mins, torch.uint8, (B, T), dev)
    flag = _flag_ptr(mixed, dev)
    out = _payload_out(out, B, T, dev)
    if n64 is None:
        n64 = torch.empty((B,), dtype=torch.int32, device=dev)
    check("n64", n64, torch.int32, (B,), dev)
    if B:
        lib = build.load()
        launch("encode_payload", lib.dbde_encode_payload, dev,
               images.data_ptr(), depths.data_ptr(), mins.data_ptr(), out.data_ptr(),
               n64.data_ptr(), flag, B, H, W, out.shape[1], _vec(images, W))
    return out, n64


def decode_frames(depths: torch.Tensor, mins: torch.Tensor, payload: torch.Tensor,
                  H: int, W: int, out: torch.Tensor | None = None,
                  mixed: torch.Tensor | None = None) -> torch.Tensor:
    """Decode: (depths, mins (B, T) u8, payload (B, S) u32 with S ≥ 2*n64)
    → (B, H, W) u8 frames, in ``out`` if given.  Reads no payload word past
    a frame's stream (``2*n64``, twice the sum of its depths), and none at
    or past S.  With ``mixed``, the kernel writes nothing where the flag is
    0.  Kernel: ``dbde_decode``."""
    if depths.device.type == "cpu":
        return decode_frames_plain(depths, mins, payload, H, W, out, mixed)
    B = depths.shape[0]
    dev = depths.device
    T = _cuda_tiles(dev, B, H, W)
    check("depths", depths, torch.uint8, (B, T), dev)
    check("mins", mins, torch.uint8, (B, T), dev)
    if payload.ndim != 2 or payload.shape[1] < 1:
        raise ValueError(f"payload must be (B, S) with S >= 1, got {tuple(payload.shape)}")
    check("payload", payload, torch.uint32, (B, payload.shape[1]), dev)
    flag = _flag_ptr(mixed, dev)
    out = _frames_out(out, B, H, W, dev)
    if B:
        lib = build.load()
        launch("decode", lib.dbde_decode, dev,
               depths.data_ptr(), mins.data_ptr(), payload.data_ptr(), out.data_ptr(), flag,
               B, H, W, payload.shape[1], _vec(out, W))
    return out


def encode_payload_u8(images: torch.Tensor, mins: torch.Tensor,
                      out: torch.Tensor | None = None, n64: torch.Tensor | None = None,
                      mixed: torch.Tensor | None = None) -> torch.Tensor:
    """Encode phase B for a batch whose tiles are all depth 8: tile t's 16
    u32 words at ``out[b, 16*t:]``, no offsets needed.  ``out`` is (B, S)
    u32 with S ≥ 16*T; the default is uninitialised (B, 16*T).  With ``n64``
    (B,) i32, each frame's n64, 8*T, is written there.  With ``mixed``, the
    kernel writes nothing where the flag is nonzero.
    Kernel: ``dbde_encode_payload_u8``."""
    if images.device.type == "cpu":
        return encode_payload_u8_plain(images, mins, out, n64, mixed)
    B, H, W = images.shape
    dev = images.device
    T = _cuda_tiles(dev, B, H, W)
    check("images", images, torch.uint8, (B, H, W), dev)
    check("mins", mins, torch.uint8, (B, T), dev)
    flag = _flag_ptr(mixed, dev)
    out = _payload_out(out, B, T, dev)
    if n64 is not None:
        check("n64", n64, torch.int32, (B,), dev)
    if B:
        lib = build.load()
        launch("encode_payload_u8", lib.dbde_encode_payload_u8, dev,
               images.data_ptr(), mins.data_ptr(), out.data_ptr(),
               None if n64 is None else n64.data_ptr(), flag, B, H, W,
               out.shape[1], _vec(images, W), _pvec(out))
    return out


def decode_frames_u8(mins: torch.Tensor, payload: torch.Tensor, H: int, W: int,
                     out: torch.Tensor | None = None,
                     mixed: torch.Tensor | None = None) -> torch.Tensor:
    """Decode a batch whose tiles are all depth 8: (mins (B, T) u8, payload
    (B, S) u32 with S ≥ 16*T) → (B, H, W) u8 frames, in ``out`` if given.
    With ``mixed``, the kernel writes nothing where the flag is nonzero.
    Kernel: ``dbde_decode_u8``."""
    if mins.device.type == "cpu":
        return decode_frames_u8_plain(mins, payload, H, W, out, mixed)
    B = mins.shape[0]
    dev = mins.device
    T = _cuda_tiles(dev, B, H, W)
    check("mins", mins, torch.uint8, (B, T), dev)
    if payload.ndim != 2 or payload.shape[1] < T * MAX_WORDS_PER_TILE:
        raise ValueError(f"payload must be (B, S) with S >= {T * MAX_WORDS_PER_TILE}, "
                         f"got {tuple(payload.shape)}")
    check("payload", payload, torch.uint32, (B, payload.shape[1]), dev)
    flag = _flag_ptr(mixed, dev)
    out = _frames_out(out, B, H, W, dev)
    if B:
        lib = build.load()
        launch("decode_u8", lib.dbde_decode_u8, dev,
               mins.data_ptr(), payload.data_ptr(), out.data_ptr(), flag, B, H, W,
               payload.shape[1], _vec(out, W), _pvec(payload))
    return out
