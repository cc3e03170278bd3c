"""The comparison that decides ``correct``, made once the window has closed.

Every number compared is exact, so every limit is 0:

  * ``records_wrong``: records of the files kept from the write half
    (the newest complete file, the last partial one and one complete file
    drawn from the seed) whose bytes differ from the plain reference's
    record of the same source frame, index and all; a video header that
    differs counts as one;
  * ``records_lost``: records those files should hold and do not, plus
    any that they hold beyond them (a walk that cannot go on counts the
    rest as lost);
  * ``frames_wrong``: frames of the read half's sample (a reservoir drawn
    from the seed) that differ from the source frame their header names;
  * ``frames_lost``: frames the read half's passes should have handed
    back and did not, or handed back out of their place: each pass
    yields the file's frames 0, 1, 2, … in order, a pass cut by the
    clock a prefix of them.
"""

from __future__ import annotations

import mmap
import struct

import numpy as np

from . import reference

LIMITS = {"records_wrong": 0, "records_lost": 0, "frames_wrong": 0, "frames_lost": 0}


def _same(buf, offset: int, expected: bytes) -> bool:
    if offset + len(expected) > len(buf):
        return False
    got = np.frombuffer(buf, np.uint8, len(expected), offset)
    return bool(np.array_equal(got, np.frombuffer(expected, np.uint8)))


def check_file(fd: int, frames: int, ref_data: list, height: int, width: int,
               frame_hz: float) -> tuple[int, int, int]:
    """One kept file against the reference → (records compared, wrong, lost)."""
    h, w = reference.tile_grid(width, height)
    T = h * w
    fixed = reference.FRAME_HEADER_BYTES + 12 + 2 * T
    with open(fd, "rb", closefd=False) as f:
        size = f.seek(0, 2)
        if size == 0:
            return 0, 0, frames
        buf = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
    try:
        wrong = 0 if _same(buf, 0, reference.video_header(height, width, frame_hz)) else 1
        pos, found = reference.VIDEO_HEADER_BYTES, 0
        while pos + fixed <= len(buf):
            (n64,) = struct.unpack_from("<i", buf, pos + fixed - 4)
            rec = fixed + 8 * n64
            if n64 < 0 or pos + rec > len(buf):
                break
            if found < frames:
                data, _ = ref_data[found % len(ref_data)]
                ok = (_same(buf, pos, reference.frame_header(found))
                      and _same(buf, pos + reference.FRAME_HEADER_BYTES, data))
                wrong += not ok
            found += 1
            pos += rec
        lost = abs(frames - found) + (pos != len(buf))
        return min(found, frames), wrong, lost
    finally:
        buf.close()


def check_passes(passes, file_frames: int) -> tuple[int, int]:
    """The read half's frame indices, pass by pass → (frames handed back,
    frames lost)."""
    handed, lost = 0, 0
    for indices, complete in passes:
        idx = np.array(indices, np.int64)
        handed += idx.size
        want = file_frames if complete else idx.size
        n = min(want, idx.size)
        lost += int((idx[:n] != np.arange(n)).sum()) + abs(want - idx.size)
    return handed, lost


def check_sample(items, src: np.ndarray) -> tuple[int, int]:
    """Sampled (frame indices, frames) batches → (frames compared, frames
    wrong)."""
    compared, wrong = 0, 0
    n_src = src.shape[0]
    for indices, frames in items:
        frames = np.asarray(frames)
        for j, index in enumerate(indices):
            compared += 1
            ok = (j < frames.shape[0] and frames.shape[1:] == src.shape[1:]
                  and np.array_equal(frames[j], src[index % n_src]))
            wrong += not ok
    return compared, wrong
