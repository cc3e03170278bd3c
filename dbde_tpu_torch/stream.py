"""Streaming DBDE file reader/writer on the PyTorch codec.

The record walk, readahead, release-gated parse pool, vectored writes and
iterators are those of :mod:`dbde_tpu.stream`; the classes here subclass
them and swap in :class:`dbde_tpu_torch.codec.DbdeCodec`.  Only the two
methods that reach the JAX package's codec module are overridden:
``_read_batch_arrays`` (its numpy parse fallback) and ``_drain_one``
(record assembly from the encoded batch).

The pool's release gate holds as in the base class: a parse slot is
released only after ``materialize``, and the host→device copy of a parsed
batch (``torch.from_numpy(...).to(device)`` from pageable memory) has
finished reading the host buffer by the time it returns.
"""

from __future__ import annotations

import numpy as np

from dbde_tpu import stream as _base
from dbde_tpu.format import FRAME_HEADER_BYTES, unpack_frame_header

from .codec import DbdeCodec, _host, pack_frames_bytes, record_iovecs, unpack_frames_bytes

__all__ = ["DbdeReader", "DbdeWriter", "read_video", "write_video"]


class DbdeReader(_base.DbdeReader):
    """Batched streaming reader over a ``.dbde`` file, decoding on ``device``.

    >>> with DbdeReader("video.dbde", batch_size=16) as r:
    ...     for headers, frames in r:   # frames: (b, H, W) u8 numpy
    ...         ...
    """

    def __init__(self, path_or_file, batch_size: int = 8, device="cuda", **kwargs):
        super().__init__(path_or_file, batch_size=batch_size, device=False, **kwargs)
        try:
            self._codec = DbdeCodec(height=self.height, width=self.width, device=device)
        except BaseException:
            self.close()
            raise
        self._device = True

    def _read_batch_arrays(self, pooled: bool = True, pool=None):
        """Parse up to batch_size records → (headers, depths, mins, payload);
        the base class's method with this package's numpy parser."""
        if self._pos > 0 and self._mm is None:
            # compact between batches (offsets below stay valid); the mmap
            # path keeps absolute offsets and never compacts
            del self._buf[: self._pos]
            self._pos = 0
        headers, offsets, max_n64 = [], [], 0
        if self._native is not None and self._mm is not None:
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
                slot = (np.empty((B, self.tiles), np.uint8),
                        np.empty((B, self.tiles), np.uint8),
                        np.empty((B, stride), np.uint32),
                        np.empty((B,), np.int32))
            arrays = self._native.gather_fields(self._buf, offsets, self.tiles,
                                                stride, out=slot)
            return headers, arrays, lambda: pool.release(key, slot)
        if self._native is not None:
            scratch = self._gather_scratch if pooled else None
            arrays = self._native.gather_fields(self._buf, offsets, self.tiles, stride,
                                                scratch=scratch)
        else:
            buf = self._buf if self._mm is not None else bytes(self._buf)
            arrays = unpack_frames_bytes(buf, self.width, self.height, offsets, stride)
        if pool is not None:
            return headers, arrays, lambda: None  # fresh arrays: nothing to gate
        return headers, arrays


class DbdeWriter(_base.DbdeWriter):
    """Batched streaming writer producing a ``.dbde`` file, encoding on ``device``."""

    def __init__(self, path_or_file, height: int, width: int, frame_hz: float = 1.0,
                 device="cuda", **kwargs):
        codec = DbdeCodec(height=height, width=width, device=device)  # before the file opens
        super().__init__(path_or_file, height, width, frame_hz=frame_hz, device=False, **kwargs)
        self._codec = codec
        self._device = True

    def _drain_one(self) -> None:
        enc, frames, indices, ns = self._pending.popleft()
        if self._fd is None and self._native is None:
            for rec in pack_frames_bytes(enc, indices=indices, elapsed_ns=ns):
                self._f.write(rec)
            return
        n64 = _host(enc.n64)
        payload = enc.payload_host(2 * int(n64.max()) if len(n64) else 0)
        depths, mins = _host(enc.depths), _host(enc.mins)
        if self._fd is not None:
            # vectored write straight from the host arrays (see record_iovecs)
            iov = record_iovecs(depths, mins, payload, n64, indices, ns)
            self._f.flush()
            _base._writev_all(self._fd, iov)
        else:
            # zero-copy view over the writer's reused scratch buffer —
            # written out before the next _drain_one touches it
            self._f.write(self._native.assemble_records(
                depths, mins, payload, n64, indices=indices, elapsed_ns=ns,
                scratch=self._asm_scratch))


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
