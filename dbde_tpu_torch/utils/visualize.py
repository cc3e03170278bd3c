"""Frame visualization helpers (the reference's debug visualizers, fixed).

The port's own copy of :mod:`dbde_tpu.utils.visualize`, with the same
output byte for byte: equivalents of ``dbde_print_ascii``
(dbde_util_test.cpp:12-49, which accumulates into un-zeroed malloc'd
memory; this one does not) and ``dbde_dump_pgm`` (dbde_util_test.cpp:51-64).
Numpy only.
"""

from __future__ import annotations

import re

import numpy as np

# 11 brightness levels, rendered two chars wide like the reference
_GLYPHS = [" ", ".", ":", "-", "=", "+", "*", "#", "%", "@", "$"]


def ascii_preview(image: np.ndarray, size: int = 32, x0: int = 0, y0: int = 0) -> str:
    """Box-downsample a region to ``size``×``size`` and render 11-level ASCII."""
    image = np.asarray(image)
    H, W = image.shape
    region = image[y0:H, x0:W].astype(np.float64)
    h, w = region.shape
    by = max(1, h // size)
    bx = max(1, w // size)
    ny, nx = h // by, w // bx
    if ny == 0 or nx == 0:
        return ""
    box = region[: ny * by, : nx * bx].reshape(ny, by, nx, bx).mean(axis=(1, 3))
    lo, hi = box.min(), box.max()
    scale = (box - lo) / (hi - lo) if hi > lo else np.zeros_like(box)
    idx = np.minimum((scale * len(_GLYPHS)).astype(int), len(_GLYPHS) - 1)
    return "\n".join("".join(_GLYPHS[v] * 2 for v in row) for row in idx)


def write_pgm(path, image: np.ndarray) -> None:
    """Write one u8 frame as an ASCII PGM (``P2``), like the reference."""
    image = np.asarray(image, dtype=np.uint8)
    H, W = image.shape
    with open(path, "w") as f:
        f.write(f"P2\n{W} {H}\n255\n")
        for row in image:
            f.write(" ".join(str(int(v)) for v in row))
            f.write("\n")


def read_pgm(path) -> np.ndarray:
    """Read an ASCII (P2) or binary (P5) PGM into a u8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P2":
        tokens = data.split()
        W, H, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
        vals = np.array(tokens[4 : 4 + W * H], dtype=np.int64)
        return (vals * 255 // max(maxval, 1)).astype(np.uint8).reshape(H, W)
    if data[:2] == b"P5":
        # header: P5 <ws> W <ws> H <ws> maxval <exactly one ws byte> raster.
        # The raster must not be tokenized (its first byte may itself be a
        # whitespace value), and maxval scales: <256 means 1 byte/pixel,
        # >=256 means 2 bytes/pixel big-endian (PGM spec) — both mapped onto
        # the u8 range like the P2 branch.
        m = re.match(rb"P5\s+(\d+)\s+(\d+)\s+(\d+)\s", data)
        if not m:
            raise ValueError("malformed P5 PGM header")
        W, H, maxval = (int(x) for x in m.groups())
        raster = data[m.end():]
        if maxval < 256:
            vals = np.frombuffer(raster[: W * H], dtype=np.uint8).astype(np.int64)
        else:
            vals = np.frombuffer(raster[: 2 * W * H], dtype=">u2").astype(np.int64)
        return (vals * 255 // max(maxval, 1)).astype(np.uint8).reshape(H, W)
    raise ValueError("not a P2/P5 PGM file")
