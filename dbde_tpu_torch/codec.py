"""Public codec API in PyTorch: batched DBDE encode/decode on one device.

Counterpart of :mod:`dbde_tpu.codec` with the same contract:

  * :class:`DbdeCodec` — per-(H, W) encode/decode over frame batches;
  * :func:`pack_frames_bytes` / :func:`unpack_frames_bytes` /
    :func:`record_iovecs` — host glue between encoded arrays and the
    on-disk frame-data layout (numpy; the port keeps its own copy, as it
    does of every host module it needs).  :func:`record_iovecs` is the
    one place the write side lays out a record.

On a CUDA device the codec runs the kernels; on the CPU it runs their
plain PyTorch versions.  Two backends, as in the JAX package:

  * ``"band"`` (the default) works on the frames as they are
    (:mod:`.ops.band`, K1–K5).  A batch whose tiles are all depth 8 takes
    the uniform pair (K4 encode, K5 decode), chosen exactly from the
    batch's own depths; every other batch takes K2 and K3.  On encode the
    choice is made on the device: K1 writes the batch's flag, and K2 and
    K4 are both launched, each doing nothing unless the flag selects it.
    On decode, host depths (as the reader passes them) are checked on the
    host; depths on the device choose K3 or K5 there, as encode does.
  * ``"tiles"`` moves the frames into the word-major tile layout first
    (:mod:`.ops.tile_layout`): one fused encode K6 and one decode K7 a
    batch, with no depth-8 dispatch.

The CUDA path is asynchronous, as the JAX codec is: :meth:`DbdeCodec.encode`
and :meth:`DbdeCodec.decode_dispatch` return before the device has run
the batch, and read nothing back from it.  Host data reaches the device
from pinned memory with ``non_blocking`` copies on the device's current
stream, ahead of the kernels; copies back go through pinned memory
(:class:`HostCopy`) and reach a caller in pageable arrays of its own.  A
CPU codec copies nothing: its tensors share the caller's memory, as a
plain PyTorch call would.

The codec keeps no state between calls, so one instance may serve several
threads.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import trace
from .format import FrameHeader, packed_image_size, tile_grid
from .ops import band, tile_layout
from .ops.bitpack import MAX_WORDS_PER_TILE

BACKENDS = ("band", "tiles")


_NP_DTYPES = {torch.uint8: np.uint8, torch.int32: np.int32, torch.uint32: np.uint32}
_PINNED_STATS = threading.Lock()  # one measured allocation at a time: the stats are the process's


def _host_allocs() -> tuple[int, float]:
    """(blocks, µs) torch's pinned-memory cache has allocated from CUDA so
    far (0, 0 where the installed torch does not say)."""
    stats = torch.cuda.host_memory_stats()
    return stats.get("num_host_alloc", 0), stats.get("host_alloc_time.total", 0)


def _pinned(shape, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised CPU tensor in pinned memory from torch's
    pinned-memory cache.  While a profiler records, what the cache had to
    allocate from CUDA for it is counted: ``pinned.allocs`` blocks,
    ``pinned.alloc_us`` µs (:mod:`.trace`).  The cache's statistics are
    the process's, so while a profiler records, the allocations of all
    threads are measured one at a time."""
    if not trace.enabled():
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    with _PINNED_STATS:
        blocks, us = _host_allocs()
        out = torch.empty(shape, dtype=dtype, pin_memory=True)
        blocks_after, us_after = _host_allocs()
    trace.count("pinned.allocs", blocks_after - blocks)
    trace.count("pinned.alloc_us", us_after - us)
    return out


class HostCopy:
    """Tensors copied to the host without waiting: on a CUDA device, each
    into pinned memory from torch's pinned-memory cache with a
    ``non_blocking`` copy enqueued on ``stream`` (default: the device's
    current stream), after the event ``after`` if one is given.

    :meth:`wait` waits for these copies alone and returns numpy views of
    that pinned memory, for a holder that drops them soon (the writer,
    once the batch's records are written): the memory returns to the cache
    when the views and this object are dropped, and the cache hands it out
    again only then.  :meth:`keep` returns copies in pageable memory that
    are the caller's to keep, so pinned memory in use stays bounded by the
    copies in flight.  CPU tensors are returned as they are."""

    def __init__(self, tensors, stream=None, after=None):
        self.event = None
        self.host = list(tensors)
        if not self.host or self.host[0].device.type == "cpu":
            return
        stream = stream or torch.cuda.current_stream(self.host[0].device)
        if after is not None:
            stream.wait_event(after)
        with torch.cuda.stream(stream):
            for i, t in enumerate(tensors):
                t.record_stream(stream)  # the allocator must not reuse it before the copy
                self.host[i] = _pinned(t.shape, t.dtype)
                self.host[i].copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(stream)
        trace.count("copy.d2h_bytes", sum(h.nbytes for h in self.host))

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            with trace.span("copy.wait"):  # the host blocked on the card
                self.event.synchronize()
        return [h.numpy() for h in self.host]

    def keep(self) -> list[np.ndarray]:
        """:meth:`wait`, then each array copied into pageable memory."""
        arrays = self.wait()
        if self.event is None:
            return arrays
        with trace.span("copy.keep"):
            return [torch.empty(h.shape, dtype=h.dtype).copy_(h).numpy() for h in self.host]


def record_event(device: torch.device):
    """An event recorded on ``device``'s current stream, after the work
    enqueued there so far (None on the CPU, whose calls finish before they
    return).  A copy back that waits for it (``HostCopy(after=...)``)
    reads that work's output on whatever stream the copy runs."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def pinned_cache_bytes(device: torch.device) -> int:
    """Bytes of pinned memory in torch's pinned-memory cache, blocks in use
    and free alike, where :class:`HostCopy` and :meth:`DbdeCodec.stage`
    take theirs (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.host_memory_stats().get("allocated_bytes.current", 0)


def _host(a, after=None) -> np.ndarray:
    """A tensor or array → a host array for immediate use: on a CUDA
    device a view of pinned memory that goes back to torch's pinned cache
    once dropped (:meth:`HostCopy.wait`), copied after the event
    ``after``."""
    return HostCopy([a], after=after).wait()[0] if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A host array or CPU tensor → a contiguous CPU tensor of ``dtype``,
    sharing its memory where it already is one."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype).contiguous()
    arr = np.ascontiguousarray(a, _NP_DTYPES[dtype])
    if not arr.flags.writeable:  # e.g. np.asarray of a jax array: torch needs writable memory
        arr = arr.copy()
    return torch.from_numpy(arr)


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
    for the kernels that produce it (the codec never does that: it gives
    device depths to :func:`.ops.band.mixed_flag` instead)."""
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
    # recorded on the encode's stream after its kernels (None on the CPU
    # and for arrays from the host): the copies back wait for it, so they
    # may run on any stream
    event: torch.cuda.Event | None = None

    def payload_host(self, max_words: int | None = None) -> np.ndarray:
        """Payload as a (B, S) u32 host array, the caller's to keep; with
        ``max_words``, only the first ``max_words`` words per frame are
        sliced on the device and copied."""
        p = self.payload
        if max_words is not None and max_words < p.shape[1]:
            p = p[:, :max_words]
        return HostCopy([p], after=self.event).keep()[0]

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
        return tuple(HostCopy([self.depths, self.mins, self.payload, self.n64],
                              after=self.event).keep())


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
        # the CUDA path's stream for copies back that must not queue behind
        # later work on the compute stream (the writer's drain)
        self._d2h = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        trace.count("codec.instances", 1)

    def stage(self, a, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
        """Host data → a CPU tensor for this codec's copies: on a CUDA codec
        a copy in new pinned memory from torch's pinned-memory cache, which
        hands it out again only after the copies that read it have
        completed, so the caller may reuse ``a`` at once; on a CPU codec
        ``a`` itself (its calls finish before they return).  A numpy array
        of ``dtype`` is copied from where it is, a strided view (a shard's
        band) too, in one copy."""
        with trace.span("codec.stage"):
            if self.device.type == "cpu":
                return _host_tensor(a, dtype)
            src = (a if isinstance(a, np.ndarray) and a.dtype == _NP_DTYPES[dtype]
                   else _host_tensor(a, dtype).numpy())
            staged = _pinned(src.shape, dtype)
            np.copyto(staged.numpy(), src)  # one memcpy, like a pageable cudaMemcpy's
            trace.count("codec.staged_bytes", staged.nbytes)
            return staged

    def host_empty(self, shape, dtype) -> np.ndarray:
        """An uninitialised host array for data bound for this codec: in
        pinned memory on a CUDA codec, so that its copy waits for nothing."""
        if self.device.type == "cpu":
            return np.empty(shape, dtype)
        torch_dtype = {v: k for k, v in _NP_DTYPES.items()}[np.dtype(dtype).type]
        return _pinned(shape, torch_dtype).numpy()

    def _put(self, *items) -> list[torch.Tensor]:
        """(array or tensor, dtype) pairs → contiguous tensors of those
        dtypes on the codec's device.

        Device tensors are cast on the current stream.  On a CUDA codec,
        host data goes through pinned memory: a pinned CPU tensor, or a
        numpy view of pinned memory (:meth:`host_empty`, the reader's
        pool), is copied from where it is; anything else is first copied
        by :meth:`stage`.  The copies are ``non_blocking`` on the current
        stream, ahead of the kernels that read them, so nothing here waits
        for the device.  The caller keeps memory of its own that is pinned
        unchanged until the batch's output is materialized (the reader's
        release gate)."""
        with trace.span("codec.put"):
            out = []
            for a, dtype in items:
                if isinstance(a, torch.Tensor) and a.device.type != "cpu":
                    out.append(a.to(device=self.device, dtype=dtype).contiguous())
                    continue
                src = _host_tensor(a, dtype)
                if self.device.type == "cuda":
                    if not src.is_pinned():
                        src = self.stage(src, dtype)
                    src = torch.empty(src.shape, dtype=dtype, device=self.device).copy_(
                        src, non_blocking=True)
                out.append(src)
            return out

    def copy_to_host(self, tensors, after=None) -> HostCopy:
        """Copy device tensors back on the codec's device-to-host stream,
        after the event ``after`` (the copy then waits for nothing enqueued
        since on the compute stream)."""
        return HostCopy(tensors, self._d2h, after)

    def _frames(self, images) -> tuple[torch.Tensor, bool]:
        (x,) = self._put((images, torch.uint8))
        single = x.ndim == 2
        if single:
            x = x[None]
        if x.ndim != 3 or tuple(x.shape[-2:]) != (self.height, self.width):
            raise ValueError(f"expected frames of shape (*, {self.height}, {self.width}), "
                             f"got {tuple(x.shape)}")
        return x, single

    def encode(self, images, defer_verify: bool = False) -> EncodedBatch:
        """(B, H, W) or (H, W) u8 frames (numpy or tensor) → :class:`EncodedBatch`.

        Returns without waiting for the device.  Host frames in pageable
        memory are first copied into pinned memory, so the caller may reuse
        its buffer at once; frames already pinned are copied from where
        they are and must stay unchanged until the batch is done
        (:meth:`stage` makes such a copy).  ``defer_verify`` is accepted
        for the JAX codec's contract and has no effect: this codec runs no
        speculative variant, so the payload is always valid as returned."""
        with trace.span("codec.encode"):
            x, _ = self._frames(images)
            if self.backend == "tiles":
                T = self.tiles
                d, m, payload, n64 = tile_layout.encode_tiles(tile_layout.image_to_tiles_w(x), T)
                return EncodedBatch(depths=d[:, :T].contiguous(), mins=m[:, :T].contiguous(),
                                    payload=payload, n64=n64, event=record_event(self.device))
            mixed = torch.empty((1,), dtype=torch.int32, device=self.device)
            depths, mins = band.encode_depths(x, mixed)
            # K2, then K4 (static layout: tile t at word 16*t), into the same
            # payload and n64: the flag lets exactly one of them write
            payload, n64 = band.encode_payload(x, depths, mins, mixed=mixed)
            band.encode_payload_u8(x, mins, out=payload, n64=n64, mixed=mixed)
            return EncodedBatch(depths=depths, mins=mins, payload=payload, n64=n64,
                                event=record_event(self.device))

    def encode_general(self, images) -> EncodedBatch:
        """Same as :meth:`encode` (there is no specialised variant to bypass)."""
        return self.encode(images)

    def decode_dispatch(self, depths, mins, payload) -> torch.Tensor:
        """Launch the decode without waiting; returns the pending (B, H, W)
        u8 device tensor for :meth:`materialize`.  ``payload`` is (B, S)
        u32 with any stride S ≥ 2*max(n64).  Host ``depths`` (as the reader
        passes them) choose K3 or K5 on the host; depths on the device
        choose on the device (both kernels launched, gated by the batch's
        flag) where S ≥ 16*T, else take K3.  Host arrays must stay
        unchanged until :meth:`materialize` of the result returns."""
        with trace.span("codec.decode_dispatch"):
            H, W = self.height, self.width
            on_device = isinstance(depths, torch.Tensor) and depths.device.type != "cpu"
            if self.backend == "band" and not on_device:
                uniform, items = self._band_inputs(depths, mins, payload)
                return self._band_kernels(uniform, self._put(*items))
            d, m, p = self._put((depths, torch.uint8), (mins, torch.uint8), (payload, torch.uint32))
            if self.backend == "tiles":
                tp = tile_layout.pad_tiles(self.tiles)
                tw = tile_layout.decode_tiles(tile_layout.pad_last(d, tp),
                                              tile_layout.pad_last(m, tp), p)
                return tile_layout.tiles_w_to_image(tw, H, W)
            if p.shape[1] < self.max_payload_words:
                return band.decode_frames(d, m, p, H, W)
            mixed = band.mixed_flag(d)
            out = band.decode_frames(d, m, p, H, W, mixed=mixed)
            return band.decode_frames_u8(m, p, H, W, out=out, mixed=mixed)

    def _band_inputs(self, depths, mins, payload) -> tuple[bool, list]:
        """The band decode from host depths: (whether every tile is depth 8,
        the (array, dtype) pairs it puts on the card: minima and payload,
        and the depths first unless every tile is depth 8, as K5 reads
        none)."""
        uniform = all_depth8(depths)
        items = [(mins, torch.uint8), (payload, torch.uint32)]
        return uniform, items if uniform else [(depths, torch.uint8)] + items

    def _band_kernels(self, uniform: bool, on_card) -> torch.Tensor:
        """K5 from (minima, payload) on the card where ``uniform``, else K3
        from (depths, minima, payload)."""
        if uniform:
            return band.decode_frames_u8(*on_card, self.height, self.width)
        return band.decode_frames(*on_card, self.height, self.width)

    def materialize(self, pending: torch.Tensor, after=None) -> np.ndarray:
        """Pending decode → (B, H, W) u8 numpy, the caller's to keep.  On a
        CUDA codec the frames come back through pinned memory, on the
        current stream after the work enqueued there so far, and are then
        copied into pageable memory.

        ``pending`` is a bare tensor, as the JAX codec's is a bare array,
        so it follows torch's rule for a tensor used on another stream:
        materialize it on the stream of its dispatch, after the caller's
        own ``wait_stream``, or with ``after``, an event recorded on the
        dispatch's stream after it (:func:`record_event`), which the copy
        waits for, as the reader does."""
        return HostCopy([pending], after=after).keep()[0]

    def decode(self, depths, mins, payload) -> np.ndarray:
        """Encoded arrays → (B, H, W) u8 numpy frames."""
        return self.materialize(self.decode_dispatch(depths, mins, payload))

    def roundtrip(self, images):
        """Encode then decode; returns (frames numpy, n64 numpy)."""
        x, single = self._frames(images)
        enc = self.encode(x)
        out, n64 = self.decode(enc.depths, enc.mins, enc.payload), HostCopy([enc.n64]).keep()[0]
        return (out[0], n64[0]) if single else (out, n64)


# ---------------------------------------------------------------------------
# Host byte glue: encoded arrays ↔ on-disk frame-data layout
# ---------------------------------------------------------------------------


RECORD_IOVECS_PER_FRAME = 7  # with one band a frame


def record_iovecs(depths, mins, payload, n64, indices=None, elapsed_ns=None) -> list:
    """Per-frame record buffers for vectored IO, the port's one definition
    of the record layout (dbde_util.cpp:137-196, little-endian): 20 B
    header, ``i32 h·w``, depths, ``i32 h·w``, minima, ``i32 n64``, payload
    prefix.

    Each frame's fields come in bands: ``depths[b]``, ``mins[b]`` and
    ``payload[b]`` are sequences of C-contiguous 1-D arrays, frame ``b``'s
    bands in order (the payload's u32 pieces cut to their live words),
    written back to back after their ``i32`` length: 7 + 3·(bands − 1)
    buffers a frame.  A single-card batch is one band a frame
    (:func:`one_band`).  The arrays go in as zero-copy views; they must
    stay unmodified until the write consumes them.
    """
    iov = []
    for b in range(len(n64)):
        idx = int(indices[b]) if indices is not None else b
        ns = int(elapsed_ns[b]) if elapsed_ns is not None else 0
        iov.append(FrameHeader(index=idx, elapsed_ns=ns).pack())
        for bands in (depths[b], mins[b]):
            iov.append(struct.pack("<i", sum(map(len, bands))))
            iov += map(memoryview, bands)
        iov.append(struct.pack("<i", int(n64[b])))
        iov += map(memoryview, payload[b])
    return iov


def one_band(depths: np.ndarray, mins: np.ndarray, payload: np.ndarray, n64) -> tuple:
    """A single-card batch's (B, T) depths and minima and (B, S) u32
    payload as :func:`record_iovecs` takes them: one band a frame, each
    payload cut to its first ``2*n64`` words."""
    return ([[row] for row in depths], [[row] for row in mins],
            [[payload[b, : 2 * int(n)]] for b, n in enumerate(n64)])


def pack_frames_bytes(enc: EncodedBatch, indices=None, elapsed_ns=None) -> list[bytes]:
    """EncodedBatch → list of per-frame bytes (20 B header + frame data)."""
    n64 = _host(enc.n64, enc.event)
    # copy only the live payload prefix (the buffer is worst-case sized)
    mx = 2 * int(n64.max()) if len(n64) else 0
    fields = one_band(_host(enc.depths, enc.event), _host(enc.mins, enc.event),
                      _host(enc.payload[:, :mx], enc.event), n64)
    iov = record_iovecs(*fields, n64, indices, elapsed_ns)
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
