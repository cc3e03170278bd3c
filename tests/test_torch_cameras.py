"""Several cameras on one device: one ``DbdeWriter`` a camera, each on a
thread of its own, all writing at once, as acquisition software runs
them.  Each camera's content is its own (its seed, brightness, noise and
depths), so a record that crossed from one writer to another shows; each
file must equal the numpy oracle's encode of that camera's frames, byte
for byte, whether the records go through a file descriptor (the sink
thread) or into a ``BytesIO`` (assembled on the caller's thread).

The CUDA case runs on the GPU machine, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cameras.py -q
"""

import io
import sys
import threading

import numpy as np
import pytest
import torch

from dbde_tpu_torch import DbdeWriter
from dbde_tpu_torch import ref_numpy as ref

CAMERAS, N, H, W, B = 4, 24, 40, 56, 4  # six batches a camera; 5x7 tiles


def _camera_frames(camera: int) -> np.ndarray:
    """Camera ``camera``'s frames: smooth light and noise of its own level
    (depths 2-6 by camera), every third frame random bytes (depth 8)."""
    rng = np.random.default_rng(1000 + camera)
    light = 40.0 + 50.0 * camera + 20.0 * np.sin(np.arange(W) / 9.0)[None, None, :]
    frames = np.clip(light + rng.normal(0.0, 1.0 + 4.0 * camera, (N, H, W)), 0, 255)
    frames = frames.astype(np.uint8)
    frames[camera::3] = rng.integers(0, 256, frames[camera::3].shape, dtype=np.uint8)
    return frames


FRAMES = [_camera_frames(c) for c in range(CAMERAS)]


def _write_at_once(device, sink: str, tmp_path) -> list[bytes]:
    """Each camera's file, written by its own thread's ``DbdeWriter``; the
    threads start together and switch often."""
    files: list = [None] * CAMERAS
    errors: list = []
    start = threading.Barrier(CAMERAS)

    def camera(c: int) -> None:
        try:
            target = str(tmp_path / f"cam{c}.dbde") if sink == "fd" else io.BytesIO()
            start.wait(timeout=10)
            with DbdeWriter(target, H, W, frame_hz=100.0, device=device, pipeline=2) as wr:
                for s in range(0, N, B):
                    wr.write(FRAMES[c][s:s + B])
            files[c] = (tmp_path / f"cam{c}.dbde").read_bytes() if sink == "fd" \
                else target.getvalue()
        except BaseException as e:  # re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=camera, args=(c,), name=f"camera-{c}")
               for c in range(CAMERAS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in threads if t.is_alive()], "a camera thread hung"
    if errors:
        raise errors[0]
    return files


def test_cameras_differ():
    """The content tells the cameras apart: no two files would be equal."""
    files = {ref.encode_video(list(f), frame_hz=100.0) for f in FRAMES}
    assert len(files) == CAMERAS


@pytest.mark.parametrize("sink", ["fd", "bytesio"])
def test_four_writers_on_four_threads(sink, tmp_path):
    files = _write_at_once(torch.device("cpu"), sink, tmp_path)
    for c in range(CAMERAS):
        assert files[c] == ref.encode_video(list(FRAMES[c]), frame_hz=100.0), f"camera {c}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sink", ["fd", "bytesio"])
def test_four_writers_on_four_threads_on_a_card(cuda, sink, tmp_path):
    files = _write_at_once(cuda, sink, tmp_path)
    torch.cuda.synchronize(cuda)
    for c in range(CAMERAS):
        assert files[c] == ref.encode_video(list(FRAMES[c]), frame_hz=100.0), f"camera {c}"
