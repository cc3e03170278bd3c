"""The sharded writer on the cards: two 16-frame batches of 2048² camera
frames on a 2x2 mesh laid over the visible cards, written from the
shards' pinned copies back, must give the single-card writer's file byte
for byte, so every pinned array outlives the write that reads it.

It imports no JAX, and runs on the GPU machine without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_sharded_card.py -q
"""

import pytest
import torch

from dbde_tpu_torch import write_video
from dbde_tpu_torch.bench_core import make_content
from dbde_tpu_torch.parallel import make_mesh, mesh_slots, visible_devices, write_video_sharded


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
