"""Entry points of the port: a one-device compile check and a
multi-device dry run, the counterparts of ``entry`` and
``dryrun_multichip`` in the repository's ``__graft_entry__.py``.

Both run on CUDA devices unless the caller passes ``device="cpu"``, which
runs the kernels' plain versions.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from . import ref_numpy
from .codec import resolve_device
from .ops import band
from .parallel import (iter_video_sharded, make_mesh, mesh_slots, sharded_roundtrip_step,
                       visible_devices, write_video_sharded)


def entry(device="cuda"):
    """→ (fn, example_args): ``fn(images)`` encodes then decodes a (B, H, W)
    u8 batch through the band kernels, K1 (depths and minima), K2 (pack)
    and K3 (decode), and returns the (frames, n64) tensors on
    ``device``; the example is a (2, 512, 1024) batch of depth-6 content."""
    dev = resolve_device(device)

    def step(images):
        x = torch.as_tensor(images, dtype=torch.uint8, device=dev).contiguous()
        H, W = x.shape[1:]
        depths, mins = band.encode_depths(x)
        payload, n64 = band.encode_payload(x, depths, mins)
        return band.decode_frames(depths, mins, payload, H, W), n64

    rng = np.random.default_rng(0)
    example = (rng.integers(0, 64, size=(2, 512, 1024)) + 90).astype(np.uint8)
    return step, (example,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded path once on a mesh of ``n_devices`` slots, laid over
    the visible devices of ``device``'s type in turn (one card fills every
    slot itself): ``n_tiles`` is 2 when ``n_devices`` is even, the rest is
    the data axis.  Checks, raising on a failure:

      * ``sharded_roundtrip_step`` of a (2·n_data, 16·n_tiles, 256) batch
        returns the frames exactly, with a positive global n64 (the JAX
        package's dry run takes W=1024 to reach its band shard bodies; the
        port's band path is its only one, at every width);
      * ``write_video_sharded`` of all but the last frame (a tail that does
        not fill the data axis) writes the numpy oracle's bytes;
      * ``iter_video_sharded`` reads the frames back exactly.

    Prints one line.
    """
    kind = torch.device(device).type
    visible = visible_devices(device)
    n_tiles = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_tiles
    mesh = make_mesh(n_data=n_data, n_tiles=n_tiles, devices=mesh_slots(n_devices, visible))

    rng = np.random.default_rng(1)
    B, H, W = 2 * n_data, 16 * n_tiles, 256  # 2 tile rows a band
    frames = (rng.integers(0, 32, size=(B, H, W)) + 40).astype(np.uint8)
    out, n64 = sharded_roundtrip_step(frames, mesh)
    np.testing.assert_array_equal(out, frames)
    if n64 <= 0:
        raise AssertionError(f"global n64 {n64} of content with depths 5")

    fframes = frames[: B - 1] if B > 1 else frames  # a ragged tail
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "dryrun.dbde"
        write_video_sharded(p, fframes, mesh, frame_hz=5.0, batch_size=max(n_data, 2))
        if p.read_bytes() != ref_numpy.encode_video(list(fframes), frame_hz=5.0):
            raise AssertionError("sharded writer bytes differ from the numpy oracle's")
        got = np.concatenate([chunk for _, chunk in iter_video_sharded(
            p, mesh, batch_size=max(n_data, 2))])
        np.testing.assert_array_equal(got, fframes)

    print(f"dryrun_multichip ok: mesh=({n_data}x{n_tiles}) over {len(visible)} "
          f"{kind} device(s), backend=band, frames={frames.shape}, n64={n64}, "
          f"file-layer: write_video_sharded byte-parity + iter_video_sharded "
          f"pixel-parity on {fframes.shape[0]} frames", flush=True)
