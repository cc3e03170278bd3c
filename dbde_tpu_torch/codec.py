"""Public codec API in PyTorch: batched DBDE encode/decode on one device.

Counterpart of :mod:`dbde_tpu.codec` with the same contract:

  * :class:`DbdeCodec` — per-(H, W) encode/decode over frame batches;
  * :func:`pack_frames_bytes` / :func:`unpack_frames_bytes` /
    :func:`record_iovecs` — host glue between encoded arrays and the
    on-disk frame-data layout (numpy; the port keeps its own copy, as it
    does of every host module it needs).

On a CUDA device the codec runs the kernels; on the CPU it runs their
plain PyTorch versions.  Two backends, as in the JAX package:

  * ``"band"`` (the default) works on the frames as they are
    (:mod:`.ops.band`, K1–K5).  A batch whose tiles are all depth 8 takes
    the uniform pair (K4 encode, K5 decode), chosen exactly from the
    batch's own depths; every other batch takes K2 and K3.
  * ``"tiles"`` moves the frames into the word-major tile layout first
    (:mod:`.ops.tile_layout`): one fused encode K6 and one decode K7 a
    batch, with no depth-8 dispatch.

The codec keeps no state between calls, so one instance may serve several
threads.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from .format import FrameHeader, packed_image_size, tile_grid
from .ops import band, tile_layout
from .ops.bitpack import MAX_WORDS_PER_TILE

BACKENDS = ("band", "tiles")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def resolve_device(device) -> torch.device:
    """A CPU or CUDA ``torch.device``, a CUDA one with its index; raises for
    a CUDA device when none is visible, and for any other type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the kernels need a GPU (device='cpu' "
                               "runs the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def all_depth8(depths) -> bool:
    """True iff the batch has tiles and every one is depth 8, the case of
    the uniform kernels.  Host arrays are checked on the host; a device
    tensor is reduced on the device and the flag read back, which waits
    for the kernels that produce it."""
    if isinstance(depths, torch.Tensor):
        return depths.numel() > 0 and bool(torch.all(depths == 8))
    d = np.asarray(depths)
    return d.size > 0 and bool((d == 8).all())


@dataclass
class EncodedBatch:
    """Encoded frames on the codec's device: one row per frame."""

    depths: torch.Tensor  # (B, T) u8
    mins: torch.Tensor  # (B, T) u8
    # (B, S) torch.uint32; only the first 2*n64 words of each row are
    # meaningful (the rest is whatever the buffer held)
    payload: torch.Tensor
    n64: torch.Tensor  # (B,) i32 — number of payload u64 words per frame
    # the JAX codec's deferred-verification fields: this codec runs no
    # speculative variant, so every payload is valid as returned
    depth_bound: int | None = None
    depth_exact: int | None = None

    def payload_host(self, max_words: int | None = None) -> np.ndarray:
        """Payload as a (B, S) u32 host array; with ``max_words``, only the
        first ``max_words`` words per frame are sliced on the device and
        copied."""
        p = self.payload
        if max_words is not None and max_words < p.shape[1]:
            p = p[:, :max_words]
        return p.cpu().numpy()

    @classmethod
    def from_numpy(cls, depths, mins, payload, n64, device) -> "EncodedBatch":
        """Host arrays (as :meth:`to_numpy` or the JAX package give them) →
        a batch on ``device``."""
        def put(a, dtype):  # a copy: the caller's arrays may be read-only
            return torch.from_numpy(np.array(a, dtype)).to(device)

        return cls(depths=put(depths, np.uint8), mins=put(mins, np.uint8),
                   payload=put(payload, np.uint32), n64=put(n64, np.int32))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """→ (depths (B,T) u8, mins (B,T) u8, payload (B,S) u32, n64 (B,) i32)."""
        return (_host(self.depths), _host(self.mins), self.payload_host(), _host(self.n64))


class DbdeCodec:
    """DBDE codec for a fixed frame geometry on one device.

    >>> codec = DbdeCodec(height=480, width=640)            # CUDA kernels
    >>> enc = codec.encode(frames_u8)                       # (B, H, W) u8
    >>> out = codec.decode(enc.depths, enc.mins, enc.payload)

    ``device="cpu"`` runs the plain PyTorch versions of the kernels;
    ``backend`` is ``"band"`` or ``"tiles"`` (see the module docstring).
    """

    def __init__(self, height: int, width: int, device="cuda", backend: str = "band"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
        self.backend = backend
        self.height = int(height)
        self.width = int(width)
        self.device = resolve_device(device)
        h, w = tile_grid(self.width, self.height)
        self.tiles = h * w
        self.max_payload_words = self.tiles * MAX_WORDS_PER_TILE

    def _put(self, a, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype).contiguous()
        np_dtype = {torch.uint8: np.uint8, torch.uint32: np.uint32}[dtype]
        arr = np.ascontiguousarray(a, np_dtype)
        if not arr.flags.writeable:  # e.g. np.asarray of a jax array: torch needs writable memory
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    def _frames(self, images) -> tuple[torch.Tensor, bool]:
        x = self._put(images, torch.uint8)
        single = x.ndim == 2
        if single:
            x = x[None]
        if x.ndim != 3 or tuple(x.shape[-2:]) != (self.height, self.width):
            raise ValueError(f"expected frames of shape (*, {self.height}, {self.width}), "
                             f"got {tuple(x.shape)}")
        return x, single

    def encode(self, images, defer_verify: bool = False) -> EncodedBatch:
        """(B, H, W) or (H, W) u8 frames (numpy or tensor) → :class:`EncodedBatch`.

        ``defer_verify`` is accepted for the JAX codec's contract and has no
        effect: the payload is always valid as returned."""
        x, _ = self._frames(images)
        if self.backend == "tiles":
            T = self.tiles
            d, m, payload, n64 = tile_layout.encode_tiles(tile_layout.image_to_tiles_w(x), T)
            return EncodedBatch(depths=d[:, :T].contiguous(), mins=m[:, :T].contiguous(),
                                payload=payload, n64=n64)
        depths, mins = band.encode_depths(x)
        if all_depth8(depths):  # static layout: tile t at word 16*t
            payload = band.encode_payload_u8(x, mins)
            n64 = torch.full((x.shape[0],), 8 * self.tiles, dtype=torch.int32, device=self.device)
            return EncodedBatch(depths=depths, mins=mins, payload=payload, n64=n64)
        payload, n64 = band.encode_payload(x, depths, mins)
        return EncodedBatch(depths=depths, mins=mins, payload=payload, n64=n64)

    def encode_general(self, images) -> EncodedBatch:
        """Same as :meth:`encode` (there is no specialised variant to bypass)."""
        return self.encode(images)

    def decode_dispatch(self, depths, mins, payload) -> torch.Tensor:
        """Launch the decode; returns the pending (B, H, W) u8 device tensor
        for :meth:`materialize`.  ``payload`` is (B, S) u32 with any stride
        S ≥ 2*max(n64).  With host ``depths`` (as the reader passes them)
        nothing waits for the device; depths already on the device are
        checked there for the uniform case, which waits for them."""
        m = self._put(mins, torch.uint8)
        p = self._put(payload, torch.uint32)
        if self.backend == "tiles":
            tp = tile_layout.pad_tiles(self.tiles)
            d = tile_layout.pad_last(self._put(depths, torch.uint8), tp)
            tw = tile_layout.decode_tiles(d, tile_layout.pad_last(m, tp), p)
            return tile_layout.tiles_w_to_image(tw, self.height, self.width)
        if all_depth8(depths):
            return band.decode_frames_u8(m, p, self.height, self.width)
        d = self._put(depths, torch.uint8)
        return band.decode_frames(d, m, p, self.height, self.width)

    def materialize(self, pending: torch.Tensor) -> np.ndarray:
        """Pending decode → (B, H, W) u8 numpy (waits for the device)."""
        return pending.cpu().numpy()

    def decode(self, depths, mins, payload) -> np.ndarray:
        """Encoded arrays → (B, H, W) u8 numpy frames."""
        return self.materialize(self.decode_dispatch(depths, mins, payload))

    def roundtrip(self, images):
        """Encode then decode; returns (frames numpy, n64 numpy)."""
        x, single = self._frames(images)
        enc = self.encode(x)
        out, n64 = self.decode(enc.depths, enc.mins, enc.payload), _host(enc.n64)
        return (out[0], n64[0]) if single else (out, n64)


# ---------------------------------------------------------------------------
# Host byte glue: encoded arrays ↔ on-disk frame-data layout
# ---------------------------------------------------------------------------


RECORD_IOVECS_PER_FRAME = 7


def record_iovecs(depths, mins, payload, n64, indices=None, elapsed_ns=None) -> list:
    """Per-frame record buffers for vectored IO — 7 per frame: 20 B header,
    ``i32 h·w``, depths row, ``i32 h·w``, minima row, ``i32 n64``, payload
    prefix (layout parity with dbde_util.cpp:137-196, little-endian).

    The array rows are zero-copy views into the caller's host arrays; they
    must stay unmodified until the write consumes them.
    """
    depths = np.ascontiguousarray(depths, np.uint8)
    mins = np.ascontiguousarray(mins, np.uint8)
    payload = np.ascontiguousarray(payload, np.uint32)
    n64 = np.asarray(n64)
    B, T = depths.shape
    count = struct.pack("<i", T)
    iov = []
    for b in range(B):
        idx = int(indices[b]) if indices is not None else b
        ns = int(elapsed_ns[b]) if elapsed_ns is not None else 0
        n = int(n64[b])
        iov += [
            FrameHeader(index=idx, elapsed_ns=ns).pack(),
            count,
            depths[b].data,
            count,
            mins[b].data,
            struct.pack("<i", n),
            payload[b, : 2 * n].data,
        ]
    return iov


def pack_frames_bytes(enc: EncodedBatch, indices=None, elapsed_ns=None) -> list[bytes]:
    """EncodedBatch → list of per-frame bytes (20 B header + frame data)."""
    n64 = _host(enc.n64)
    # copy only the live payload prefix (the buffer is worst-case sized)
    mx = 2 * int(n64.max()) if len(n64) else 0
    iov = record_iovecs(_host(enc.depths), _host(enc.mins), enc.payload_host(mx),
                        n64, indices, elapsed_ns)
    k = RECORD_IOVECS_PER_FRAME
    return [b"".join(iov[k * b : k * (b + 1)]) for b in range(len(n64))]


def unpack_frames_bytes(buf: bytes, W: int, H: int, offsets: list[int],
                        stride_words: int | None = None):
    """Parse frame-data records at byte ``offsets`` → stacked numpy arrays.

    Returns (depths (B,T) u8, mins (B,T) u8, payload (B,S) u32, n64 (B,)),
    ready for :meth:`DbdeCodec.decode` (S defaults to the worst case 16*T).
    Raises ValueError on count-field mismatches (the reference's hard-error
    parity, dbde_util.cpp:295-303).
    """
    h, w = tile_grid(W, H)
    T = h * w
    B = len(offsets)
    S = stride_words if stride_words is not None else T * MAX_WORDS_PER_TILE
    depths = np.empty((B, T), np.uint8)
    mins = np.empty((B, T), np.uint8)
    payload = np.zeros((B, S), np.uint32)
    n64s = np.empty((B,), np.int32)
    for b, off in enumerate(offsets):
        (nb,) = struct.unpack_from("<i", buf, off)
        if nb != T:
            raise ValueError(f"frame {b}: depth count {nb} != {T}")
        depths[b] = np.frombuffer(buf, np.uint8, T, off + 4)
        (nm,) = struct.unpack_from("<i", buf, off + 4 + T)
        if nm != T:
            raise ValueError(f"frame {b}: min count {nm} != {T}")
        mins[b] = np.frombuffer(buf, np.uint8, T, off + 8 + T)
        (n64,) = struct.unpack_from("<i", buf, off + 8 + 2 * T)
        if n64 != int(depths[b].astype(np.int64).sum()):
            raise ValueError(f"frame {b}: n64 {n64} != sum of depths")
        payload[b, : 2 * n64] = np.frombuffer(buf, np.uint32, 2 * n64, off + 12 + 2 * T)
        n64s[b] = n64
    return depths, mins, payload, n64s


def frame_data_size(depths_row: np.ndarray, W: int, H: int) -> int:
    """Encoded byte size of one frame's data block."""
    return packed_image_size(W, H, int(np.asarray(depths_row).astype(np.int64).sum()))
