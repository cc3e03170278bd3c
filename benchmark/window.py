"""The measured window: a write half, then a read half of what was written.

An entry (``entries/<name>.py``) gives the two halves the program's calls:
a writer that takes batches of frames (or a whole stack a file) and a
reader that yields ``(headers, frames)`` batches.  This module runs them
against the clock, the same way for every entry:

  * the write half writes files of ``file_frames`` frames, cycling
    through the source frames (file frame ``i`` is source frame ``i %
    n``), until ``--seconds / 2`` have passed; it ends when the last
    file's ``close()`` returns;
  * the read half reads the newest complete file, pass after pass, until
    the same time has passed, and ends when the reader is closed.

Per call it records the host time the caller is blocked: a writer's
open counts into its file's first ``write``, its close into the last; a
reader's open into its file's first batch, its close into the last.  The
frames handed back are offered to a reservoir drawn from the seed, which
the check compares once the window has closed; nothing is compared
inside it.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import reference

now = time.perf_counter
CONTROL_BITS = 7  # the control's precision: the nearest below the configurations' 8 bits


@dataclass
class Half:
    frames: int = 0
    batches: int = 0
    wall_s: float = 0.0
    latencies: list = field(default_factory=list)  # seconds blocked, one a call
    passes: list = field(default_factory=list)  # read: (frame indices, complete)
    spans: dict = field(default_factory=dict)  # traced: target → (seconds, calls)
    pieces: list = field(default_factory=list)  # (frames, seconds) of each file or pass


class Sample:
    """A uniform reservoir of ``k`` items, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def write_batches(run, deadline: float, open_writer) -> Half:
    """Batches of ``batch`` frames through ``open_writer(path)``'s
    ``write``, file after file, until ``deadline``."""
    B, n_src = run.params["batch"], run.src.shape[0]
    per_file = run.params["file_frames"] // B
    half, t0 = Half(), now()
    while True:
        f = run.files.start()
        t = t_file = now()
        with run.spans.step("open"):
            writer = open_writer(f.path)
        blocked = now() - t
        for b in range(per_file):
            s = (b * B) % n_src
            t = now()
            with run.spans.step("write"):
                writer.write(run.src[s:s + B])
            half.latencies.append(now() - t + blocked)
            blocked = 0.0
            f.frames += B
            half.frames += B
            half.batches += 1
            if now() >= deadline:
                break
        t = now()
        with run.spans.step("close"):
            writer.close()
        half.latencies[-1] += now() - t
        half.pieces.append((f.frames, now() - t_file))
        run.files.finish(f, f.frames == run.params["file_frames"])
        if now() >= deadline:
            break
    half.wall_s = now() - t0
    return half


def write_stacks(run, deadline: float, write_file) -> Half:
    """The whole source stack a file through ``write_file(path, frames)``,
    file after file, until ``deadline``."""
    n_src = run.src.shape[0]
    half, t0 = Half(), now()
    while True:
        f = run.files.start()
        t = now()
        with run.spans.step("write_file"):
            write_file(f.path, run.src)
        half.latencies.append(now() - t)
        half.pieces.append((n_src, now() - t))
        f.frames = n_src
        half.frames += n_src
        half.batches += -(-n_src // run.params["batch"])
        run.files.finish(f, True)
        if now() >= deadline:
            break
    half.wall_s = now() - t0
    return half


def read_passes(run, deadline: float, open_reader) -> Half:
    """Batches from ``open_reader(path)`` → (iterator, close), pass after
    pass over the read target, until ``deadline``."""
    path = run.files.read_target().path
    half, t0 = Half(), now()
    done = False
    while not done:
        t = t_pass = now()
        with run.spans.step("open"):
            it, close = open_reader(path)
        blocked = now() - t
        seen: list = []  # the pass's frame indices: ints, which the collector never scans
        while True:
            t = now()
            with run.spans.step("next"):
                item = next(it, None)
            if item is None:  # the end of the file: its wait is the last batch's
                if seen:
                    half.latencies[-1] += now() - t
                break
            headers, frames = item
            half.latencies.append(now() - t + blocked)
            blocked = 0.0
            half.frames += len(headers)
            half.batches += 1
            index = [h.index for h in headers]
            seen += index
            run.sample.offer((index, frames))
            if now() >= deadline:
                done = True
                break
        t = now()
        with run.spans.step("close"):
            close()
        if seen:
            half.latencies[-1] += now() - t
        half.passes.append((seen, not done))
        half.pieces.append((len(seen), now() - t_pass))
        done = done or now() >= deadline
    half.wall_s = now() - t0
    return half


class ControlWriter:
    """The plain reference in the writer's place, at ``bits`` bits a
    pixel: the control, which the check must find wrong."""

    def __init__(self, path, height: int, width: int, frame_hz: float, device, bits: int):
        self._f = open(path, "wb")
        self._f.write(reference.video_header(height, width, frame_hz))
        self._device, self._bits, self.frames_written = device, bits, 0

    def write(self, frames: np.ndarray) -> None:
        data = reference.frame_data(torch.from_numpy(np.ascontiguousarray(frames))
                                    .to(self._device), self._bits)
        for d, _ in data:
            self._f.write(reference.frame_header(self.frames_written) + d)
            self.frames_written += 1

    def close(self) -> None:
        self._f.close()
