"""Several cameras on one card: one ``DbdeWriter`` a camera, each camera
on a thread of its own, as an acquisition host runs them (``cameras`` in
the configuration).

``prepare`` starts one persistent thread a camera and swaps ``run.files``
for :class:`CameraFiles`, one registry of files a camera.  ``warm`` runs
the stream entry's warm-up (one small file written and read) on each
camera's thread, then has every camera write ``WARM_FILES`` whole files
at once, so that the window starts in the steady state (see
:func:`warm`).  ``write_half`` releases the threads together; each
writes batches back to back into files of its own until the deadline
(``window.write_batches``, a closed loop, as every cell).  The halves
merge: frames and batches add up, every camera's call latencies go into
one list, and the wall time runs from the release to the last camera's
``close``.  ``read_half`` is the stream entry's: one ``DbdeReader``
passing over the newest complete file, on the main thread.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor

from .. import window
from ..sink import Files, MemFile
from . import stream as single

RELEASE_TIMEOUT_S = 120.0  # a camera that never reaches the start line fails the run
WARM_FILES = 8  # whole files a camera writes in the warm-up: 4 cameras open 32 writers


class CameraFiles:
    """The window's files of several cameras: one :class:`..sink.Files` a
    camera, each used from its camera's thread alone, so each camera
    keeps its newest complete file, its partial one and one complete file
    drawn from a seed of its own (drawn from the harness's generator), and
    the check covers every camera."""

    def __init__(self, rng: random.Random, cameras: int):
        self.parts = [Files(rng.getrandbits(64)) for _ in range(cameras)]

    @property
    def frames_per_file(self) -> list[int]:
        return [n for part in self.parts for n in part.frames_per_file]

    def kept(self) -> list[MemFile]:
        return [f for part in self.parts for f in part.kept()]

    def read_target(self) -> MemFile:
        """The newest complete file of the camera that completed the most
        (the first such camera), else the first camera's partial one."""
        done = [part for part in self.parts if part.newest is not None]
        if done:
            return max(done, key=lambda part: part.complete).newest
        return self.parts[0].read_target()

    def begin_window(self) -> None:
        """Forget the files written so far (the warm-up's) in what the
        window counts: their frames, and the complete files the seed's draw
        chooses from.  They stay alive until each camera's next complete
        file replaces them."""
        for part in self.parts:
            part.frames_per_file.clear()
            part.complete = 0

    def settle(self) -> None:
        for part in self.parts:
            part.settle()

    def close(self) -> None:
        for part in self.parts:
            part.close()


def prepare(run) -> None:
    n = int(run.params["cameras"])
    old = run.files
    # each camera's files draw from the generator the harness seeded with --seed
    run.files = CameraFiles(old._rng, n)
    old.close()
    run.cameras = [ThreadPoolExecutor(1, thread_name_prefix=f"camera-{c}") for c in range(n)]
    for camera in run.cameras:  # each thread started now, and kept for the run
        camera.submit(lambda: None).result()


def cards(run) -> list[int]:
    return single.cards(run)


def _write_files(run, files, count: int) -> None:
    """``count`` whole files of the source frames, batch after batch."""
    B, n_src, per_file = run.params["batch"], run.src.shape[0], run.params["file_frames"]
    open_writer = single._open_writer(run)
    for _ in range(count):
        f = files.start()
        writer = open_writer(f.path)
        for s in range(0, per_file, B):
            writer.write(run.src[s % n_src:s % n_src + B])
        writer.close()
        f.frames = per_file
        files.finish(f, True)


def warm(run) -> None:
    """The stream entry's warm-up on each camera's own thread, all at once;
    then every camera writes ``WARM_FILES`` whole files at once into its
    registry, which then forgets them (:meth:`CameraFiles.begin_window`):
    they stay alive until the window's files replace them, so the window
    starts with as many files alive, and as much shared memory in use, as
    it keeps.  Without those files the first seconds of the window ran at
    55–85% of the rate that followed: each new writer's codec takes the
    next of torch's 32 pooled CUDA streams, so the device's cached
    segments grew from 28 to 54 until 32 writers had opened, and the
    pinned-memory cache and the shared-memory pages the sinks write into
    grew with them (measured on an H100)."""
    for done in [camera.submit(single.warm, run) for camera in run.cameras]:
        done.result()
    for done in [camera.submit(_write_files, run, part, WARM_FILES)
                 for camera, part in zip(run.cameras, run.files.parts)]:
        done.result()
    run.files.begin_window()


def _host() -> str:
    cores = len(os.sched_getaffinity(0))
    try:
        with open("/proc/meminfo") as f:
            avail = next(line.split()[1] for line in f if line.startswith("MemAvailable:"))
        return f"{cores} cores usable, MemAvailable {int(avail) / 2**20:.1f} GiB"
    except (OSError, StopIteration):
        return f"{cores} cores usable"


def _program_write_calls(run):
    """The program's own count of ``DbdeWriter.write`` calls in the window,
    where a traced run's program records them (else None)."""
    if not run.spans.enabled:
        return None
    try:
        from dbde_tpu_torch import trace
    except ImportError:
        return None
    return trace.totals().get(("writer.write", "writer.write"), {}).get("calls")


def write_half(run, deadline: float):
    open_writer = single._open_writer(run)
    release = threading.Barrier(len(run.cameras) + 1)

    def camera(c: int):
        mine = dataclasses.replace(run, files=run.files.parts[c])
        release.wait(timeout=RELEASE_TIMEOUT_S)
        half = window.write_batches(mine, deadline, open_writer)
        return half, window.now()

    futures = [cam.submit(camera, c) for c, cam in enumerate(run.cameras)]
    release.wait(timeout=RELEASE_TIMEOUT_S)
    t0 = window.now()
    results = [f.result() for f in futures]
    merged = window.Half()
    for half, _ in results:
        merged.frames += half.frames
        merged.batches += half.batches
        merged.latencies += half.latencies
        merged.pieces += half.pieces
    merged.wall_s = max(end for _, end in results) - t0
    each = " ".join(f"{half.frames / (end - t0):.1f}" for half, end in results)
    print(f"cameras: {len(results)} on one card; frames/s each {each}; aggregate "
          f"{merged.frames / merged.wall_s:.1f}; write calls {merged.batches} (the program "
          f"counted {_program_write_calls(run)}); host: {_host()}", flush=True)
    return merged


def read_half(run, deadline: float):
    return single.read_half(run, deadline)
