"""``DbdeWriter`` and ``DbdeReader`` on one device, batch by batch."""

from __future__ import annotations

import os

from dbde_tpu_torch.stream import DbdeReader, DbdeWriter

from .. import window
from ..sink import MemFile


def prepare(run) -> None:
    pass


def cards(run) -> list[int]:
    return [run.device.index] if run.device.type == "cuda" else []


def _open_writer(run):
    p = run.params
    if run.control:
        return lambda path: window.ControlWriter(path, run.rows, run.cols, p["frame_hz"],
                                                 run.device, window.CONTROL_BITS)
    return lambda path: DbdeWriter(path, height=run.rows, width=run.cols,
                                   frame_hz=p["frame_hz"], device=run.device,
                                   pipeline=p["pipeline"])


def _open_reader(run):
    p = run.params

    def open_reader(path):
        rd = DbdeReader(path, batch_size=p["batch"], device=run.device, pipeline=p["pipeline"])
        it = iter(rd)

        def close():
            it.close()
            rd.close()

        return it, close

    return open_reader


def warm(run) -> None:
    B = run.params["batch"]
    f = MemFile(0)
    try:
        writer = _open_writer(run)(f.path)
        for b in range(run.params["pipeline"] + 2):  # the last source frames, backwards
            s = (-(b + 1) * B) % run.src.shape[0]
            writer.write(run.src[s:s + B])
        writer.close()
        it, close = _open_reader(run)(f.path)
        for _ in it:
            pass
        close()
    finally:
        os.close(f.fd)


def write_half(run, deadline: float):
    return window.write_batches(run, deadline, _open_writer(run))


def read_half(run, deadline: float):
    return window.read_passes(run, deadline, _open_reader(run))
