"""Seeded frame content, made on the device in a few large calls.

The benchmark's own copy of the port's synthetic content
(``make_content``'s camera model and random bytes), drawn from a
``torch.Generator`` seeded with ``--seed`` on the device the cell runs
on, so that one seed gives the same frames on every run.

Models (the configuration's ``content``, overlaid by the traffic's):

  * ``camera``: smooth illumination over the whole sensor, ``base + amp ·
    sin(2πx/W) · cos(2πy/H)``, a slow drift of ``drift · sin(2πf/n)``
    over the ``n`` source frames, and Gaussian noise of ``sigma``; the
    region of interest cuts rows and columns out of the sensor's
    illumination.  With ``sigma`` 3 the tiles are depths 4–5.
  * ``random``: uniform bytes; every 8×8 tile is depth 8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_BYTES = 1 << 28  # float32 noise drawn at a time


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def frames(n: int, geometry: dict, content: dict, seed: int,
           device: torch.device) -> np.ndarray:
    """``n`` source frames, (n, rows, cols) u8 in pageable host memory, as
    a camera's acquisition library hands them over.  ``geometry`` has the
    sensor's ``sensor_height``/``sensor_width`` and the region's ``row0``,
    ``rows``, ``col0``, ``cols``."""
    gen = generator(seed, device)
    rows, cols = geometry["rows"], geometry["cols"]
    model = content["model"]
    if model == "random":
        out = torch.randint(0, 256, (n, rows, cols), generator=gen, device=device,
                            dtype=torch.uint8)
        return out.cpu().numpy()
    if model != "camera":
        raise ValueError(f"unknown content model {model!r}")
    f32 = dict(device=device, dtype=torch.float32)
    yy = torch.arange(geometry["row0"], geometry["row0"] + rows, **f32)[:, None]
    xx = torch.arange(geometry["col0"], geometry["col0"] + cols, **f32)[None]
    light = (content["base"] + content["amp"]
             * torch.sin(2 * math.pi * xx / geometry["sensor_width"])
             * torch.cos(2 * math.pi * yy / geometry["sensor_height"]))
    drift = content["drift"] * torch.sin(2 * math.pi * torch.arange(n, **f32) / n)
    out = torch.empty((n, rows, cols), dtype=torch.uint8, device=device)
    step = max(1, CHUNK_BYTES // (4 * rows * cols))
    for i in range(0, n, step):
        k = min(step, n - i)
        noise = torch.randn((k, rows, cols), generator=gen, **f32)
        noise.mul_(content["sigma"]).add_(light).add_(drift[i:i + k, None, None])
        out[i:i + k] = noise.clamp_(0, 255).to(torch.uint8)  # truncation, as astype
    return out.cpu().numpy()
