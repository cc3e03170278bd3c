"""Bit-exact host-side serde for the DBDE container format.

DBDE ("Dynamic Bit Depth Encoding") is a fixed-rate-camera scientific-imaging
video compression format.  A file is a 28-byte video header followed by zero or
more frames, each a 20-byte frame header plus variable-length frame data.  All
multi-byte values are little-endian.

This module owns everything that lives at the *byte* level on the host:
header dataclasses, their (de)serialization, and the frame-data layout
constants.  The pixel-level codec lives in :mod:`dbde_tpu_torch.ref_numpy`
(oracle) and :mod:`dbde_tpu_torch.ops` (PyTorch and CUDA).  The port's own
copy of :mod:`dbde_tpu.format`, so that the port imports nothing of the JAX
package.

Format parity notes (reference: the reference C library's dbde_util.cpp):
  * The video header is ``i32 u64s(=3), u64 height, u64 width, f64 frame_hz``
    (dbde_util.cpp:198-209).  An alternative build stores ``frame_hz`` as a
    rounded u64 (``DBDE_HZ_AS_INTEGER``, dbde_util.cpp:203-207); we expose that
    as the ``hz_as_integer`` flag.
  * The frame header is ``i32 u64s(=2), u64 index, u64 elapsed_ns`` — but the
    reference serializes ``elapsed_ns`` through a ``double`` cast both ways
    (dbde_util.cpp:186,334), so on disk it is the IEEE-754 f64 bits of the
    *numeric value*.  We reproduce that quirk bit-exactly (exact below 2^53).
  * Parsers flag a bad ``u64s`` count with the sentinel value 0xFFFFFFFF
    (dbde_util.cpp:335,357) rather than raising; we keep that behavior and
    additionally expose ``.ok``.
  * The reference's ``DBDE_INVERT_ENDIAN`` build flag (dbde_util.cpp:15-19)
    is intentionally dropped: it byte-swaps in-memory SIMD row lanes on
    big-endian hosts and has no effect on the on-disk format, which is
    little-endian everywhere (README.md:27); GPU hosts are little-endian.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

VIDEO_HEADER_BYTES = 28
FRAME_HEADER_BYTES = 20
U64S_SENTINEL = 0xFFFFFFFF  # reference stores -1 into a u32 field

# Hard caps the reference's file walker enforces (dbde_util.cpp:374-378).
MAX_DIM = 0x37FFFFFF
MAX_PIXELS = 0x37FFFFFF


def tile_grid(width: int, height: int) -> tuple[int, int]:
    """Number of 8x8 tiles down (h) and across (w): ceil(H/8), ceil(W/8)."""
    return (height + 7) // 8, (width + 7) // 8


def packed_image_size(width: int, height: int, n64: int) -> int:
    """Byte size of an encoded image: 12 + 2*h*w + 8*n64 (dbde_util.cpp:140,179)."""
    h, w = tile_grid(width, height)
    return 12 + 2 * h * w + 8 * n64


def max_packed_image_size(width: int, height: int) -> int:
    """Worst case (all tiles depth 8): every tile stores 8 u64s."""
    h, w = tile_grid(width, height)
    return 12 + 2 * h * w + 8 * (8 * h * w)


def worst_case_frame_size(width: int, height: int) -> int:
    """Worst-case whole-frame bound used by the reference's streaming walker:
    ``npix + npix/8 + 32`` (dbde_util.cpp:395-396, 410).  NOTE: the reference
    knowingly under-estimates for tiny ragged frames (SURVEY §5 quirk 4); use
    :func:`max_packed_image_size` + ``FRAME_HEADER_BYTES`` for a true bound."""
    npix = width * height
    return npix + npix // 8 + 32


@dataclass
class VideoHeader:
    height: int
    width: int
    frame_hz: float = 1.0
    u64s: int = 3

    @property
    def ok(self) -> bool:
        return self.u64s == 3

    def pack(self, hz_as_integer: bool = False) -> bytes:
        if hz_as_integer:
            # (long long)(hz + 0.5): add-then-truncate (dbde_util.cpp:204)
            hz = int(self.frame_hz + 0.5)
            return struct.pack("<IQQQ", self.u64s, self.height, self.width, hz)
        return struct.pack("<IQQd", self.u64s, self.height, self.width, self.frame_hz)


def unpack_video_header(buf: bytes, offset: int = 0, hz_as_integer: bool = False) -> tuple[VideoHeader, int]:
    """Parse 28 bytes; ``u64s != 3`` → sentinel (dbde_util.cpp:347-359).

    Returns (header, new_offset).  Always consumes 28 bytes, like the C code.
    """
    if hz_as_integer:
        u64s, height, width, hz_i = struct.unpack_from("<IQQQ", buf, offset)
        hz = float(hz_i)
    else:
        u64s, height, width, hz = struct.unpack_from("<IQQd", buf, offset)
    if u64s != 3:
        u64s = U64S_SENTINEL
    return VideoHeader(height=height, width=width, frame_hz=hz, u64s=u64s), offset + VIDEO_HEADER_BYTES


@dataclass
class FrameHeader:
    index: int
    elapsed_ns: int = 0
    u64s: int = 2

    @property
    def ok(self) -> bool:
        return self.u64s == 2

    def pack(self) -> bytes:
        # elapsed_ns is written through a double cast (dbde_util.cpp:186):
        # the f64 *numeric value* of the u64, not its raw bits.
        return struct.pack("<IQd", self.u64s, self.index, float(self.elapsed_ns))


def unpack_frame_header(buf: bytes, offset: int = 0) -> tuple[FrameHeader, int]:
    """Parse 20 bytes; ``u64s != 2`` → sentinel (dbde_util.cpp:330-337)."""
    u64s, index, elapsed_f = struct.unpack_from("<IQd", buf, offset)
    if u64s != 2:
        u64s = U64S_SENTINEL
    # reference converts back with a u64 cast, i.e. truncation toward zero
    return FrameHeader(index=index, elapsed_ns=int(elapsed_f), u64s=u64s), offset + FRAME_HEADER_BYTES
