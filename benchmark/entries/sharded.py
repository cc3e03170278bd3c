"""``write_video_sharded`` and ``iter_video_sharded`` on a mesh of cards,
one slot a card where there are as many cards as slots."""

from __future__ import annotations

import os

from dbde_tpu_torch.parallel import (
    iter_video_sharded,
    make_mesh,
    mesh_slots,
    visible_devices,
    write_video_sharded,
)

from .. import window
from ..sink import MemFile


def prepare(run) -> None:
    n_data, n_tiles = run.params["mesh"]
    run.mesh = make_mesh(n_data, n_tiles,
                         devices=mesh_slots(n_data * n_tiles, visible_devices(run.device)))


def cards(run) -> list[int]:
    return sorted({d.index for d in run.mesh.devices.flat if d.type == "cuda"})


def _write_file(run):
    p = run.params
    if run.control:
        def write_file(path, frames):
            writer = window.ControlWriter(path, run.rows, run.cols, p["frame_hz"],
                                          run.device, window.CONTROL_BITS)
            for i in range(0, frames.shape[0], p["batch"]):
                writer.write(frames[i:i + p["batch"]])
            writer.close()

        return write_file
    return lambda path, frames: write_video_sharded(path, frames, run.mesh,
                                                    frame_hz=p["frame_hz"],
                                                    batch_size=p["batch"])


def _open_reader(run):
    p = run.params

    def open_reader(path):
        gen = iter_video_sharded(path, run.mesh, batch_size=p["batch"], pipeline=p["pipeline"])
        return gen, gen.close

    return open_reader


def warm(run) -> None:
    f = MemFile(0)
    try:
        _write_file(run)(f.path, run.src[-2 * run.params["batch"]:])
        it, close = _open_reader(run)(f.path)
        for _ in it:
            pass
        close()
    finally:
        os.close(f.fd)


def write_half(run, deadline: float):
    return window.write_stacks(run, deadline, _write_file(run))


def read_half(run, deadline: float):
    return window.read_passes(run, deadline, _open_reader(run))
