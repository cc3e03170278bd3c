"""Streaming DBDE file reader/writer on the PyTorch codec.

Counterpart of :mod:`dbde_tpu.stream` (the reference's file walker,
dbde_util.cpp:362-426, redesigned for a batched device codec), with its
own classes:

  * :class:`DbdeReader` — scans frame records on the host (records are
    self-delimiting through their ``n64`` field), batches B frames of
    fields and dispatches one decode per batch on ``device``.  Up to
    ``pipeline`` batches ahead are parsed and dispatched before the current
    one is materialized, so host parsing and the host→device copies
    overlap device compute and the copies back.
  * :class:`DbdeWriter` — encodes frame batches on ``device`` and writes
    records from the host, keeping ``pipeline`` batches in flight; into a
    file descriptor the records go from a thread of their own, so the
    ``writev`` of one batch overlaps the staging of the next.

``device`` is a torch device: ``"cpu"`` runs the codec's plain PyTorch
versions, the default runs the CUDA kernels.  Both classes are context
managers that close and free what they hold.

On a CUDA device every copy between host and device is a ``non_blocking``
copy from or into pinned memory (:mod:`.codec`), so the host thread waits
only where it needs a batch's results, and then for that batch alone.
What keeps pinned memory from being overwritten while a copy reads it:

  * the writer copies the caller's frames into a pinned buffer from
    torch's pinned-memory cache, which hands a buffer out again only once
    the copies that read it have completed;
  * the reader's release gate: its parse slots are pinned and pooled, and
    a slot returns to the pool only after the batch decoded from it is
    materialized.  The copies from the slot run on the stream current at
    the batch's dispatch, ahead of the decode; an event recorded there
    after the decode is what the batch's copy back waits for, on whatever
    stream is current when it is materialized, so a released slot is no
    longer read by any copy and the frames never depend on the caller's
    current stream.
"""

from __future__ import annotations

import collections
import io
import mmap
import os
import queue
import stat
import struct
import threading
from typing import Iterator

import numpy as np

from . import trace
from .codec import (DbdeCodec, HostCopy, one_band, record_event, record_iovecs,
                    unpack_frames_bytes)
from .format import (
    FRAME_HEADER_BYTES,
    MAX_DIM,
    MAX_PIXELS,
    VIDEO_HEADER_BYTES,
    FrameHeader,
    VideoHeader,
    max_packed_image_size,
    tile_grid,
    unpack_frame_header,
    unpack_video_header,
)
from .native import binding as native_binding

__all__ = ["DbdeReader", "DbdeWriter", "read_video", "write_video", "scan_record_size"]


def scan_record_size(buf, offset: int, T: int) -> int | None:
    """Byte size of the frame record (header + data) at ``offset``.

    Validates the three count fields like the reference decoder
    (dbde_util.cpp:295-303) but without touching the payload.  Returns None
    if the buffer is too short or the record is corrupt.
    """
    if len(buf) - offset < FRAME_HEADER_BYTES + 12 + 2 * T:
        return None
    (u64s,) = struct.unpack_from("<I", buf, offset)
    if u64s != 2:
        return None
    base = offset + FRAME_HEADER_BYTES
    (nb,) = struct.unpack_from("<i", buf, base)
    if nb != T:
        return None
    (nm,) = struct.unpack_from("<i", buf, base + 4 + T)
    if nm != T:
        return None
    (n64,) = struct.unpack_from("<i", buf, base + 8 + 2 * T)
    depths = np.frombuffer(buf, np.uint8, T, base + 4)
    if n64 != int(depths.astype(np.int64).sum()) or n64 < 0:
        return None
    size = FRAME_HEADER_BYTES + 12 + 2 * T + 8 * n64
    if len(buf) - offset < size:
        return None
    return size


try:
    _IOV_MAX = min(os.sysconf("SC_IOV_MAX"), 1024)
except (AttributeError, OSError, ValueError):
    _IOV_MAX = 1024


class _GatedPool:
    """Release-gated parse-buffer pool for the reader's device pipeline.

    A slot returns to the free list only when the consumer releases it,
    which the reader does after materializing the batch decoded from it
    (see the module docstring).  Steady state allocates ``pipeline + 1``
    slots per array-shape key (pinned on a CUDA device) and reuses them
    from then on.
    """

    def __init__(self):
        self._free: dict = {}

    def acquire(self, key):
        lst = self._free.get(key)
        return lst.pop() if lst else None

    def release(self, key, slot) -> None:
        self._free.setdefault(key, []).append(slot)


def _writev_all(fd: int, iov: list) -> int:
    """``os.writev`` a whole buffer list (in chunks of IOV_MAX, resuming
    partial writes).  The kernel's gather copy into the page cache is the
    only pass over the bytes: no host-side assembly buffer."""
    with trace.span("stream.writev"):
        views = [memoryview(b).cast("B") for b in iov]
        total = 0
        i = 0
        while i < len(views):
            n = os.writev(fd, views[i : i + _IOV_MAX])
            if n <= 0 and any(v.nbytes for v in views[i : i + _IOV_MAX]):
                raise OSError("writev wrote 0 bytes")
            total += n
            while i < len(views) and n >= views[i].nbytes:
                n -= views[i].nbytes
                i += 1
            if i < len(views) and n:
                views[i] = views[i][n:]
    trace.count("stream.writev_bytes", total)
    return total


class _Sink:
    """The thread that writes a writer's records into its file descriptor,
    batch after batch in the order handed over, while the writer's thread
    stages and encodes the next batches (:class:`DbdeWriter`'s, and
    :func:`~dbde_tpu_torch.parallel.write_video_sharded`'s for one call).

    At most one batch waits behind the one being written: :meth:`put`
    blocks until the thread takes the waiting one.  The thread calls
    ``_writev_all`` (looked up at each call, so a wrapper set on it later
    is the one called), on host memory alone: no torch or CUDA call.  A
    batch's arrays stay in :attr:`_held` on the writer's thread until the
    thread has written them and dropped every reference of its own, so
    pinned memory goes back to torch's cache from the writer's thread
    and only once no write reads it.  Between hand-offs at most two
    batches are held, whether written, being written or queued.  A failed
    write stops all later ones; its error is raised by the next
    :meth:`put`, or by :meth:`close` where no ``put`` raised it.  Each
    write is a span under the root ``root`` (:mod:`.trace`): ``writer.sink``
    unless the writer names its own."""

    def __init__(self, fd: int, root: str = trace.SINK_ROOT):
        self._fd = fd
        self._root = root
        self._jobs: queue.Queue = queue.Queue(maxsize=1)
        self._held: collections.deque = collections.deque()  # arrays of each batch handed over
        self._done: collections.deque = collections.deque()  # one entry a batch written or dropped
        self._error: BaseException | None = None
        self._raised = False
        self._thread = threading.Thread(target=self._run, name="dbde-sink", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            iov = self._jobs.get()
            if iov is None:
                return
            if self._error is None:
                try:
                    with trace.span(self._root):
                        _writev_all(self._fd, iov)
                except BaseException as e:  # handed to the writer's thread
                    self._error = e
            del iov  # before the batch is reported done: the writer's thread frees it
            self._done.append(None)

    @property
    def failed(self) -> bool:
        """Whether a write failed: nothing more is written."""
        return self._error is not None

    def _collect(self) -> None:
        while self._done:
            self._done.popleft()
            self._held.popleft()

    def put(self, iov: list, arrays) -> None:
        """Hand over a batch's record buffers ``iov``; ``arrays`` are what
        they view, kept alive until they are written."""
        self._collect()
        if self._error is not None:
            self._raised = True
            raise self._error
        self._held.append(arrays)
        with trace.span("writer.sink_wait"):
            self._jobs.put(iov)
        self._collect()

    def close(self) -> None:
        """Return once every batch handed over is written (or dropped after
        a failed write); raise the failure where no :meth:`put` did."""
        with trace.span("writer.sink_wait"):
            self._jobs.put(None)
            self._thread.join()
        self._collect()
        if self._error is not None and not self._raised:
            self._raised = True
            raise self._error


class DbdeReader:
    """Batched streaming reader over a ``.dbde`` file, decoding on ``device``.

    >>> with DbdeReader("video.dbde", batch_size=16) as r:
    ...     for headers, frames in r:   # frames: (b, H, W) u8 numpy
    ...         ...

    ``pipeline`` batches are in flight on the device.  ``reuse_buffers=N``
    rotates :meth:`iter_raw`'s parse arrays through N slots (a batch's
    arrays are overwritten N batches later: keep 0 if the consumer retains
    them); decoding always pools through the release gate instead.
    """

    def __init__(self, path_or_file, batch_size: int = 8, device="cuda",
                 use_native: bool = True, hz_as_integer: bool = False,
                 pipeline: int = 2, readahead: bool = True, reuse_buffers: int = 0):
        self._own_file = isinstance(path_or_file, (str, os.PathLike))
        self._f = open(path_or_file, "rb") if self._own_file else path_or_file
        self._reader_thread = None
        self._mm = None
        try:
            self._open(batch_size, device, use_native, hz_as_integer, pipeline,
                       readahead, reuse_buffers)
        except BaseException:
            self.close()
            raise

    def _open(self, batch_size, device, use_native, hz_as_integer, pipeline,
              readahead, reuse_buffers) -> None:
        self.batch_size = int(batch_size)
        self.pipeline = max(1, int(pipeline))
        self._readahead = bool(readahead)
        self._gather_scratch = {"nslots": int(reuse_buffers)} if reuse_buffers else None
        self._native = (native_binding if use_native and native_binding.native_available()
                        else None)
        raw = self._f.read(VIDEO_HEADER_BYTES)
        if len(raw) < VIDEO_HEADER_BYTES:
            raise ValueError("file too short for a video header")
        # hz_as_integer: the reference's DBDE_HZ_AS_INTEGER read variant
        # (dbde_util.cpp:352-356), frame_hz stored as a rounded u64
        self.header, _ = unpack_video_header(raw, hz_as_integer=hz_as_integer)
        if not self.header.ok:
            raise ValueError(f"bad video header (u64s={self.header.u64s})")
        self.height = int(self.header.height)
        self.width = int(self.header.width)
        # the reference walker's geometry caps (dbde_util.cpp:374-378)
        if not (0 < self.height <= MAX_DIM and 0 < self.width <= MAX_DIM
                and self.height * self.width <= MAX_PIXELS):
            raise ValueError("bad frame geometry")
        h, w = tile_grid(self.width, self.height)
        self.tiles = h * w
        # worst-case record + slack, times a batch of lookahead
        self._chunk = max(1 << 20, (max_packed_image_size(self.width, self.height) + 64)
                          * self.batch_size)
        self._buf = bytearray()
        self._pos = 0
        self._eof = False
        # a regular file is walked zero-copy through mmap: no readahead
        # thread and no append/compact copies.  Pipes, sockets and BytesIO
        # keep the buffered path.
        try:
            if stat.S_ISREG(os.fstat(self._f.fileno()).st_mode):
                self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
                self._buf = self._mm
                self._pos = VIDEO_HEADER_BYTES
                self._eof = True  # the map is the whole file; never refill
        except (OSError, ValueError, io.UnsupportedOperation):
            self._mm = None
        self.frames_read = 0
        self._codec = DbdeCodec(height=self.height, width=self.width, device=device)

    # -- host record scanning ------------------------------------------------

    def _start_readahead(self) -> None:
        """Background file reader: overlaps file IO with parsing and device
        work (the reference's memmove+fread refill, made asynchronous)."""
        self._chunks = queue.Queue(maxsize=4)
        stop = self._stop_read = threading.Event()
        f = self._f

        def run():
            while not stop.is_set():
                data = f.read(self._chunk)
                while not stop.is_set():
                    try:
                        self._chunks.put(data, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if not data:
                    return

        self._reader_thread = threading.Thread(target=run, daemon=True)
        self._reader_thread.start()

    def _fill(self) -> None:
        """Append more file bytes.  Never compacts (record offsets collected
        by the current batch must stay valid); compaction happens between
        batches in :meth:`_read_batch_arrays`."""
        if self._eof:
            return
        if self._readahead:
            if self._reader_thread is None:
                self._start_readahead()
            data = self._chunks.get()
        else:
            data = self._f.read(self._chunk)
        if not data:
            self._eof = True
        else:
            self._buf.extend(data)

    def _next_record(self):
        """→ (FrameHeader, record offset, record size) or None at EOF/corruption."""
        while True:
            if self._native is not None:
                size = self._native.record_size(self._buf, self._pos, self.tiles) or None
            else:
                size = scan_record_size(self._buf, self._pos, self.tiles)
            if size is not None:
                off = self._pos
                self._pos += size
                fh, _ = unpack_frame_header(self._buf, off)
                return fh, off, size
            if self._eof:
                return None
            self._fill()

    def _read_batch_arrays(self, pool: _GatedPool | None = None):
        """Parse up to batch_size records → (headers, (depths, mins,
        payload, n64)), or None at the end.

        The native scanner and gather when available (zero-copy over the
        read buffer), the numpy parser otherwise.  With ``pool``, the
        arrays come from a release-gated slot and the result grows a third
        element, ``release``, a zero-argument callable that returns the
        slot.
        """
        with trace.span("reader.parse"):
            if self._pos > 0 and self._mm is None:
                # compact between batches; the mmap path keeps absolute offsets
                del self._buf[: self._pos]
                self._pos = 0
            headers, offsets, max_n64 = [], [], 0
            if self._native is not None and self._mm is not None:
                # the map is the whole file, so a short scan is the end (or a
                # corrupt record): no refill to try
                offs, sizes = self._native.scan_records(
                    self._buf, self._pos, self.tiles, self.batch_size)
                for off, size in zip(offs, sizes):
                    fh, _ = unpack_frame_header(self._buf, off)
                    headers.append(fh)
                    offsets.append(off + FRAME_HEADER_BYTES)
                    max_n64 = max(max_n64, (size - FRAME_HEADER_BYTES - 12 - 2 * self.tiles) // 8)
                    self._pos = off + size
            else:
                while len(headers) < self.batch_size:
                    rec = self._next_record()
                    if rec is None:
                        break
                    fh, off, size = rec
                    headers.append(fh)
                    offsets.append(off + FRAME_HEADER_BYTES)
                    max_n64 = max(max_n64, (size - FRAME_HEADER_BYTES - 12 - 2 * self.tiles) // 8)
            if not headers:
                return None
            # payload stride: the live words rounded up to 65536, so the
            # host→device copy stays near the encoded size
            stride = min(16 * self.tiles, -(-2 * max_n64 // 65536) * 65536 or 2)
            if pool is not None and self._native is not None:
                B = len(headers)
                key = (B, self.tiles, stride)
                slot = pool.acquire(key)
                if slot is None:
                    empty = self._codec.host_empty
                    slot = (empty((B, self.tiles), np.uint8), empty((B, self.tiles), np.uint8),
                            empty((B, stride), np.uint32), empty((B,), np.int32))
                arrays = self._native.gather_fields(self._buf, offsets, self.tiles,
                                                    stride, out=slot)
                return headers, arrays, lambda: pool.release(key, slot)
            if self._native is not None:
                arrays = self._native.gather_fields(self._buf, offsets, self.tiles, stride,
                                                    scratch=self._gather_scratch)
            else:
                buf = self._buf if self._mm is not None else bytes(self._buf)
                arrays = unpack_frames_bytes(buf, self.width, self.height, offsets, stride)
            if pool is not None:
                return headers, arrays, lambda: None  # fresh arrays: nothing to gate
            return headers, arrays

    # -- iteration -----------------------------------------------------------

    def __iter__(self) -> Iterator[tuple[list[FrameHeader], np.ndarray]]:
        pending = collections.deque()
        pool = _GatedPool()

        def dispatch() -> bool:
            with trace.span("reader.dispatch"):
                batch = self._read_batch_arrays(pool=pool)
                if batch is None:
                    return False
                headers, (depths, mins, payload, _), release = batch
                frames = self._codec.decode_dispatch(depths, mins, payload)
                pending.append((headers, frames, record_event(self._codec.device), release))
                return True

        while len(pending) < self.pipeline and dispatch():
            pass
        while pending:
            dispatch()  # parse + dispatch the next batch while this one runs
            headers, frames, done, release = pending.popleft()
            self.frames_read += len(headers)
            # after the dispatch's event, on the stream current now: the
            # caller may have switched streams since
            with trace.span("reader.materialize"):
                out = self._codec.materialize(frames, after=done)
                release()  # decode output copied back ⇒ the slot's copies are done
            yield headers, out

    def iter_raw(self):
        """Yield (headers, (depths, mins, payload, n64)) batches without
        decoding: the walker for consumers of the encoded fields.  Array
        shapes as :func:`dbde_tpu_torch.codec.unpack_frames_bytes` gives
        them, at the reader's short payload stride."""
        while True:
            batch = self._read_batch_arrays()
            if batch is None:
                return
            headers, arrays = batch
            self.frames_read += len(headers)
            yield headers, arrays

    def read_all(self) -> tuple[list[FrameHeader], np.ndarray]:
        headers, chunks = [], []
        for hs, frames in self:
            headers.extend(hs)
            chunks.append(frames)
        if not chunks:
            return [], np.empty((0, self.height, self.width), np.uint8)
        return headers, np.concatenate(chunks, axis=0)

    def close(self) -> None:
        if self._reader_thread is not None:
            self._stop_read.set()
            try:
                self._chunks.get_nowait()  # unblock a pending put
            except queue.Empty:
                pass
            self._reader_thread.join(timeout=2.0)
            self._reader_thread = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._own_file and self._f is not None:
            self._f.close()
        self._f = None
        self._buf = bytearray()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DbdeWriter:
    """Batched streaming writer producing a ``.dbde`` file, encoding on ``device``.

    ``pipeline`` batches stay in flight: :meth:`write` enqueues a batch's
    copy to the device, its encode and the copy back of its ``n64``,
    depths and minima, and waits only when a batch ``pipeline`` writes
    old is to be drained, and then for that batch alone.  Draining copies
    back the batch's live payload words (``2*max(n64)`` a frame, on the
    codec's device-to-host stream, so it waits for no later batch) and
    writes its records.

    Records (:func:`~dbde_tpu_torch.codec.record_iovecs`) reach the sink
    by one of two paths: a vectored ``writev`` straight from the encoded
    host arrays when the sink has a file descriptor, on a thread of the
    writer's own (:class:`_Sink`), so that it overlaps the next batches'
    staging; otherwise one ``write`` of the joined records on the caller's
    thread.  With a file descriptor, :meth:`close` returns once every
    record is in the file, and a failed write is raised by the next
    :meth:`write` or by :meth:`close`; no later record is written.
    ``use_native`` is accepted for the JAX writer's signature and changes
    nothing the writer does.

    A writer is used from one thread at a time.  Several writers may run
    at once on one card, each on a thread of its own (one a camera): they
    share the card, torch's pinned-memory cache and the kernel library,
    and each enqueues its copies and kernels on its thread's current
    stream.
    """

    def __init__(self, path_or_file, height: int, width: int, frame_hz: float = 1.0,
                 device="cuda", hz_as_integer: bool = False, use_native: bool = True,
                 pipeline: int = 2):
        # the codec first: a bad device raises before the file is created
        self._codec = DbdeCodec(height=height, width=width, device=device)
        self._own_file = isinstance(path_or_file, (str, os.PathLike))
        self._f = open(path_or_file, "wb") if self._own_file else path_or_file
        try:
            self._fd = self._f.fileno()
        except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
            self._fd = None  # BytesIO and friends → one write of the joined records
        self.height, self.width = int(height), int(width)
        self.header = VideoHeader(height=self.height, width=self.width, frame_hz=frame_hz)
        self._f.write(self.header.pack(hz_as_integer))
        self._sink = None
        if self._fd is not None:
            self._f.flush()  # the records bypass the file object's buffer
            self._sink = _Sink(self._fd)
        self.frames_written = 0
        self.pipeline = max(1, int(pipeline))  # batches in flight on the device
        self._pending = collections.deque()

    def write(self, frames: np.ndarray, indices=None, elapsed_ns=None) -> None:
        """Queue a (B, H, W) or (H, W) u8 batch for encoding.  The frames are
        copied before this returns, so the caller may reuse its array at
        once."""
        with trace.span("writer.write"), trace.off_cpu("writer.offcpu_us"):
            frames = np.asarray(frames, dtype=np.uint8)
            if frames.ndim == 2:
                frames = frames[None]
            B = frames.shape[0]
            if indices is None:
                indices = range(self.frames_written, self.frames_written + B)
            indices = [int(i) for i in indices]
            ns = [int(x) for x in elapsed_ns] if elapsed_ns is not None else [0] * B
            self.frames_written += B
            enc = self._codec.encode(self._codec.stage(frames), defer_verify=True)
            fields = HostCopy([enc.n64, enc.depths, enc.mins])  # after the encode, on its stream
            self._pending.append((enc, fields, indices, ns))
            while len(self._pending) > self.pipeline:
                self._drain_one()

    def _drain_one(self) -> None:
        with trace.span("writer.drain"):
            enc, fields, indices, ns = self._pending.popleft()
            n64, depths, mins = fields.wait()  # this batch's encode and copies, nothing later
            live = 2 * int(n64.max()) if len(n64) else 0
            (payload,) = self._codec.copy_to_host([enc.payload[:, :live]],
                                                  after=fields.event).wait()
            with trace.span("codec.records"):
                iov = record_iovecs(*one_band(depths, mins, payload, n64), n64, indices, ns)
            if self._sink is not None:
                self._sink.put(iov, (depths, mins, payload))  # views of these arrays
            else:
                self._f.write(b"".join(iov))

    def close(self) -> None:
        with trace.span("writer.close"):
            try:
                while self._pending and not (self._sink is not None and self._sink.failed):
                    self._drain_one()
            finally:
                self._pending.clear()
                try:
                    if self._sink is not None:
                        sink, self._sink = self._sink, None
                        sink.close()
                finally:
                    if self._own_file and self._f is not None:
                        self._f.close()
                    self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path, frames, frame_hz: float = 1.0, device="cuda", batch_size: int = 16) -> None:
    """Encode a (N, H, W) u8 stack to a .dbde file."""
    frames = np.asarray(frames, dtype=np.uint8)
    N, H, W = frames.shape
    with DbdeWriter(path, height=H, width=W, frame_hz=frame_hz, device=device) as wr:
        for i in range(0, N, batch_size):
            wr.write(frames[i : i + batch_size])


def read_video(path, device="cuda", batch_size: int = 16, hz_as_integer: bool = False):
    """Decode a whole .dbde file → (VideoHeader, [FrameHeader], (N, H, W) u8)."""
    with DbdeReader(path, batch_size=batch_size, device=device,
                    hz_as_integer=hz_as_integer) as r:
        headers, frames = r.read_all()
        return r.header, headers, frames
