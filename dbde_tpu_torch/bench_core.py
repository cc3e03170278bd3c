"""Synthetic frame content for the port's checks and profiles.

The port's own copy of ``make_content`` and ``make_adversarial`` from
:mod:`dbde_tpu.bench_core`, the same content from the same seeds, so that
``chip_smoke.py``, ``profile_paths`` and the tests measure what the JAX
package's bench measured without importing it; and ``make_depth_runs``,
content for the seams between the tiles backend's blocks of 1024 tiles.
"""

from __future__ import annotations

import numpy as np


def _tiles_at_depths(d: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(frames, th, tw) target depths → (frames, 8*th, 8*tw) u8 frames whose
    tiles realize exactly those depths, minima over the whole legal range."""
    frames, th, tw = d.shape
    span = np.where(d == 0, 0, (1 << d) - 1)  # realized tile range
    lo = rng.integers(0, 256 - span)  # tile min, legal for the range
    res = rng.integers(0, span[..., None, None] + 1,
                       size=(frames, th, tw, 8, 8))
    res[..., 0, 0] = 0          # pin the range exactly: one pixel at min,
    res[..., 7, 7] = span       # one at min+range (edge tiles may crop these)
    tiles = (lo[..., None, None] + res).astype(np.uint8)
    return tiles.transpose(0, 1, 3, 2, 4).reshape(frames, th * 8, tw * 8)


def make_depth_runs(width: int, height: int, frames: int, run: int = 700,
                    cycle=(0, 8, 3, 0, 0, 5, 8, 1), seed: int = 0) -> np.ndarray:
    """Frames whose tiles (in row-major tile order) come in runs of ``run``
    equal depths, the depths taken in turn from ``cycle``, each frame's runs
    shifted by ``run // 3`` tiles.  With the default run of 700 the runs
    cross the seams between blocks of 1024 tiles at every depth, and once
    the frame has more than 3072 tiles the two zero runs cover the whole
    third block (a block of flat tiles, which stores no words)."""
    rng = np.random.default_rng(seed)
    th, tw = -(-height // 8), -(-width // 8)
    t = np.arange(th * tw)[None] + (run // 3) * np.arange(frames)[:, None]
    d = np.asarray(cycle, np.int64)[(t // run) % len(cycle)].reshape(frames, th, tw)
    return np.ascontiguousarray(_tiles_at_depths(d, rng)[:, :height, :width])


def make_content(width: int, height: int, frames: int, kind: str = "camera",
                 sigma: float | None = None) -> np.ndarray:
    """Synthesize benchmark frames, (frames, height, width) u8.

    ``camera``: smooth illumination + shot-like noise → mixed tile depths
    (the format's design target: scientific imaging at fixed rate).
    ``random``: incompressible, all tiles depth 8 (the reference's worst case).
    ``flat``: all tiles depth 0 (payload-free best case).
    ``lowlight``: dim illumination + read-noise-scale noise → depths 2-3.

    ``sigma`` overrides the noise scale of the camera/lowlight families;
    ignored for flat/random.
    """
    if kind not in ("camera", "random", "flat", "lowlight"):
        raise ValueError(f"unknown content kind {kind!r}")
    rng = np.random.default_rng(0)
    if kind == "flat":
        return np.full((frames, height, width), 128, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, size=(frames, height, width)).astype(np.uint8)
    amp, def_sigma = (16.0, 0.8) if kind == "lowlight" else (64.0, 3.0)
    sigma = def_sigma if sigma is None else float(sigma)
    yy, xx = np.mgrid[0:height, 0:width]
    base = (
        96
        + amp * np.sin(2 * np.pi * xx / width)[None] * np.cos(2 * np.pi * yy / height)[None]
        + 8 * np.sin(2 * np.pi * np.arange(frames) / max(frames, 1))[:, None, None]
    )
    noise = rng.normal(0, sigma, size=(frames, height, width))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def make_adversarial(width: int, height: int, frames: int, maxd: int = 8,
                     seed: int = 0) -> np.ndarray:
    """Frames whose 8x8 tiles each realize an exact target depth <= maxd.

    Depth weights favor the corner cases that have bitten the kernels:
    depth 0 (flat broadcast path) and maxd (a depth-8 tile ending a run of
    shallow ones, where a store past a tile's own words lands on the next
    tile's), with minima drawn over the full legal range per depth so
    add-min sees extreme values."""
    rng = np.random.default_rng(seed)
    th, tw = -(-height // 8), -(-width // 8)
    weights = np.ones(maxd + 1)
    weights[0] = 3.0
    weights[maxd] = 3.0
    d = rng.choice(np.arange(maxd + 1), size=(frames, th, tw),
                   p=weights / weights.sum()).astype(np.int64)
    return np.ascontiguousarray(_tiles_at_depths(d, rng)[:, :height, :width])
