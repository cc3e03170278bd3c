"""Tests of the four-camera cell (``cam2048x4.concurrent``) beyond what
``test_benchmark.py`` runs on every cell, on the CPU at tiny frames:

    python -m pytest benchmark/test_cameras.py -q

  * the registry keeps, for each camera, its newest complete file, its
    partial one and one complete file drawn from the seed, and deletes
    the rest, and leaves the warm-up's files out of the window;
  * a misrouted record, one camera's batch written into another camera's
    file, comes out not correct.
"""

from __future__ import annotations

import itertools
import os
import random
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import rehearse  # noqa: E402
from benchmark.entries.cameras import CameraFiles  # noqa: E402
from dbde_tpu_torch import stream as program_stream  # noqa: E402

CELL = "cam2048x4.concurrent"


def _run(*extra) -> dict:
    return rehearse.run_cell("--workload", CELL, "--seed", "4294967311", "--seconds", "4",
                             "--rehearse", *extra)


def test_registry_keeps_each_cameras_files():
    files = CameraFiles(random.Random(3), 2)
    try:
        made = []
        for camera, complete in [(0, True), (1, True), (0, True), (1, False), (0, True),
                                 (1, False), (0, False)]:
            part = files.parts[camera]
            f = part.start()
            f.frames = 4 if complete else 1
            made.append((camera, f, os.fstat(f.fd).st_ino))
            part.finish(f, complete)
        zero, one = files.parts
        assert zero.newest is made[4][1] and one.newest is made[1][1]
        assert zero.partial is made[6][1] and one.partial is made[5][1]
        assert zero.pick in (made[0][1], made[2][1], made[4][1]) and one.pick is made[1][1]
        assert files.read_target() is made[4][1]  # camera 0 completed the most
        kept = files.kept()
        assert {id(f) for f in kept} == {id(f) for f in (*zero.kept(), *one.kept())}
        assert sorted(files.frames_per_file) == [1, 1, 1, 4, 4, 4, 4]
        files.settle()
        for _, f, ino in made:  # the dropped files are closed (their fd may be reused)
            try:
                still_open = os.fstat(f.fd).st_ino == ino
            except OSError:
                still_open = False
            assert still_open == any(f is g for g in kept)
    finally:
        files.close()


def test_warm_up_files_are_left_out_of_the_window():
    """The warm-up's files stay alive into the window, uncounted, and go
    once each camera's first file of the window is complete."""
    files = CameraFiles(random.Random(5), 2)
    try:
        warm = []
        for part in files.parts:
            for _ in range(3):
                f = part.start()
                f.frames = 4
                warm.append(f)
                part.finish(f, True)
        files.begin_window()
        assert files.frames_per_file == [] and all(p.complete == 0 for p in files.parts)
        assert all(p.newest in warm for p in files.parts)  # alive until replaced
        window = []
        for part in files.parts:
            f = part.start()
            f.frames = 4
            window.append(f)
            part.finish(f, True)
        assert files.frames_per_file == [4, 4]
        assert sorted(id(f) for f in files.kept()) == sorted(id(f) for f in window)
    finally:
        files.close()


def test_sound_run_writes_every_camera():
    result = _run("--trace", "1")
    assert result["correct"], result["checks"]
    # the device metrics (cameras.idle_write, cameras.encode_roofline) need a card
    assert set(result["metrics"]) == {"cameras.stage_ms", "cameras.wait_ms", "cameras.sink_ms",
                                      "cameras.offcpu_ms", "cameras.sink_wait_ms"}


def test_misrouted_record_is_not_correct(monkeypatch):
    """Every fifth writev of any sink goes into another camera's file,
    the one written most recently by another sink: that camera's file
    gains a batch and this one's loses it."""
    writev = program_stream._writev_all
    close = program_stream._Sink.close
    lock = threading.Lock()
    live: dict = {}  # fd → the order in which it was last written
    calls = itertools.count()

    def misrouted(fd, iov):
        with lock:
            n = next(calls)
            live[fd] = n
            others = sorted((g for g in live if g != fd), key=live.get)
            if n % 5 == 4 and others:
                return writev(others[-1], iov)  # under the lock: its sink is not closing it
        return writev(fd, iov)

    def sink_close(self):
        close(self)
        with lock:
            live.pop(self._fd, None)

    monkeypatch.setattr(program_stream, "_writev_all", misrouted)
    monkeypatch.setattr(program_stream._Sink, "close", sink_close)
    result = _run()
    assert not result["correct"], (result["checks"], result["attempted"])
    assert result["checks"]["records_wrong"]["value"] + \
        result["checks"]["records_lost"]["value"] > 0
