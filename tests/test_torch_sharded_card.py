"""The sharded writer on the cards: 16-frame batches of 2048² camera
frames on a 2x2 mesh laid over the visible cards, written from the
shards' pinned copies back by the call's sink thread, must give the
single-card writer's file byte for byte, so every pinned array outlives
the write that reads it, also behind a slowed sink while the next batch
is staged into pinned memory and encoded.

It imports no JAX, and runs on the GPU machine without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_sharded_card.py -q
"""

import threading
import time

import pytest
import torch

from dbde_tpu_torch import stream, write_video
from dbde_tpu_torch.bench_core import make_content
from dbde_tpu_torch.parallel import (
    make_mesh,
    mesh_slots,
    sharding,
    visible_devices,
    write_video_sharded,
)


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the GPU machine)")
    return visible_devices()


@pytest.mark.requires_cuda
def test_sharded_file_on_the_cards_is_write_videos(cards, tmp_path):
    frames = make_content(2048, 2048, 32)
    mesh = make_mesh(2, 2, devices=mesh_slots(4, cards))
    sharded, single = tmp_path / "sharded.dbde", tmp_path / "single.dbde"
    write_video_sharded(sharded, frames, mesh, frame_hz=1000.0, batch_size=16)
    write_video(single, frames, frame_hz=1000.0, device=cards[0], batch_size=16)
    assert sharded.read_bytes() == single.read_bytes()


@pytest.mark.requires_cuda
def test_sharded_file_behind_a_slow_sink_is_write_videos(cards, tmp_path, monkeypatch):
    """Each write waits 0.2 s before it starts, so the caller stages and
    encodes the next batches into pinned memory from torch's cache while
    the earlier batches' pinned shard copies wait for their write."""
    frames = make_content(2048, 2048, 64)
    mesh = make_mesh(2, 2, devices=mesh_slots(4, cards))
    sharded, single = tmp_path / "sharded.dbde", tmp_path / "single.dbde"
    write_video(single, frames, frame_hz=1000.0, device=cards[0], batch_size=16)
    writev, encode_shards = stream._writev_all, sharding._encode_shards
    writing, overlapped, pinned = [], [], []

    def slow(fd, iov):
        writing.append(True)
        time.sleep(0.2)
        try:
            return writev(fd, iov)
        finally:
            writing.pop()

    def spy_encode(*args):
        overlapped.append(bool(writing))
        return encode_shards(*args)

    def spy_copy_fields(*args):
        shards = copy_fields(*args)
        pinned.extend(torch.from_numpy(a).is_pinned() for row in shards for s in row for a in s)
        return shards

    copy_fields = sharding._copy_fields
    monkeypatch.setattr(stream, "_writev_all", slow)
    monkeypatch.setattr(sharding, "_encode_shards", spy_encode)
    monkeypatch.setattr(sharding, "_copy_fields", spy_copy_fields)
    write_video_sharded(sharded, frames, mesh, frame_hz=1000.0, batch_size=16)
    assert sharded.read_bytes() == single.read_bytes()
    assert any(overlapped)  # a batch encoded while an earlier one was being written
    assert pinned and all(pinned)  # the records were written from pinned memory
    assert not [t for t in threading.enumerate() if t.name == "dbde-sink" and t.is_alive()]
