"""The sharded file path's host legs: where a sharded step's time goes.

    python -m dbde_tpu_torch.probe_sharded [WxH] [batch] [n_tiles ...] [--device cuda|cpu]

The port's counterpart of ``tools/probe_sharded_io.py`` (defaults
``2048x2048 16 4 8``), in three parts:

  1. the JAX tool's legs as they are: ``split_payload_host`` and
     ``assemble_payload_padded`` on camera-statistics depths (Poisson(2.2)
     capped at 5, ``np.random.default_rng(0)``) and a random payload,
     fresh and pooled, the best of 5 after a warm-up, for each
     ``n_tiles`` (:func:`time_glue`);
  2. one instrumented pass of ``write_video_sharded`` (:data:`WRITE_LEGS`):
     each batch's tail pad and row pad, the codecs made per shard, each
     shard's band made contiguous, staged into pinned memory, copied to
     its card, encoded (K1, K2 and K4), the two rounds of copies back,
     the host assembly of the streams and the records' ``writev``;
  3. one instrumented pass of ``iter_video_sharded`` at ``pipeline=1``
     (:data:`READ_LEGS`): the parse, the zero-record pad, the split into
     segments, the codecs, each shard's fields made contiguous and staged,
     copied to its card, decoded (K3, or K5 for a shard all depth 8), the
     copies back and their placing into the output.

The JAX package's sharded step is one ``shard_map`` program, so its tool
timed only the host glue around it; the port runs the step as a host loop
over the shards, whose legs parts 2 and 3 time.  Each leg runs to its end
on every card of the mesh (synchronised) before the next starts, so no two
overlap as they do in the real step; the legs are composed from the
functions that step calls, shard after shard in its order.  Beside them,
the uninstrumented span of the same frames through ``write_video_sharded``
and ``iter_video_sharded(pipeline=1)`` (after a warm-up pass, before and
after the instrumented passes) and the ratio of the legs' sum to it.  The
instrumented file must be byte-equal to ``write_video_sharded``'s and its
read must return the frames, or the probe raises.

The meshes (:func:`default_meshes`): 1x1 and 2x2 laid over the visible
cards (``parallel.mesh_slots``; on one card every slot is that card), and
4x1 where four or more are visible.  The frames: three batches and one
frame of camera content.  ``--device cpu`` runs the plain versions on a
mesh of CPU slots.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .bench_core import make_content
from .codec import record_iovecs, resolve_device
from .format import VideoHeader, tile_grid
from .parallel import sharding
from .parallel.sharding import (
    Mesh,
    assemble_payload_padded,
    iter_video_sharded,
    make_mesh,
    mesh_slots,
    segment_slot_words,
    split_payload_host,
    visible_devices,
    write_video_sharded,
)
from .stream import DbdeReader, _writev_all
from .utils.profiling import card_name

WRITE_LEGS = ("pad", "codecs", "slice", "stage", "h2d", "kernels", "totals", "fields",
              "assemble", "write")
READ_LEGS = ("parse", "pad", "split", "codecs", "slice+stage", "h2d", "kernels",
             "copies back", "place")
FRAME_HZ = 1000.0


# -- part 1: the JAX tool's legs --------------------------------------------------


def glue_inputs(W: int, H: int, B: int):
    """The JAX tool's inputs: (depths (B, T) u8 with camera statistics,
    a random (B, max words) u32 payload), from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    h, w = tile_grid(W, H)
    depths = np.minimum(rng.poisson(2.2, (B, h * w)), 5).astype(np.uint8)
    words = 2 * depths.astype(np.int64).sum(1)
    payload = rng.integers(0, 1 << 32, (B, int(words.max())), dtype=np.uint32)
    return depths, payload


def _best(fn, reps: int = 5) -> float:
    """Seconds of the fastest of ``reps`` calls of ``fn``, after one warm-up
    (the allocator's first pages)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def time_glue(W: int, H: int, B: int, tile_variants) -> list[dict]:
    """Part 1: for each ``n_tiles``, ``split_payload_host`` and
    ``assemble_payload_padded`` fresh and pooled (seconds), the live bytes
    they move and the slot size; ``{"n_tiles", "skipped"}`` where the tile
    rows do not split into ``n_tiles`` bands."""
    depths, payload = glue_inputs(W, H, B)
    h = tile_grid(W, H)[0]
    live = 4 * 2 * int(depths.astype(np.int64).sum())
    rows = []
    for n_tiles in tile_variants:
        if h % n_tiles:
            rows.append({"n_tiles": n_tiles, "skipped": f"{h} tile rows do not split in {n_tiles}"})
            continue
        segs = split_payload_host(payload, depths, H, W, n_tiles)
        totals = (2 * depths.reshape(B, n_tiles, -1).astype(np.int64).sum(-1)).T
        pay, _ = assemble_payload_padded(segs, totals)
        rows.append({
            "n_tiles": n_tiles, "live_bytes": live,
            "slot_bytes": 4 * segment_slot_words(W, H, n_tiles),
            "split fresh": _best(lambda: split_payload_host(payload, depths, H, W, n_tiles)),
            "split pooled": _best(lambda: split_payload_host(payload, depths, H, W, n_tiles,
                                                             out=segs)),
            "assemble fresh": _best(lambda: assemble_payload_padded(segs, totals)),
            "assemble reused": _best(lambda: assemble_payload_padded(segs, totals, out=pay)),
        })
    return rows


def glue_lines(W: int, H: int, B: int, rows) -> list[str]:
    """Part 1's lines, as the JAX tool prints them."""
    depths, _ = glue_inputs(W, H, B)
    words = 2 * depths.astype(np.int64).sum(1)
    lines = [f"geom {B}x{H}x{W}: T={depths.shape[1]} tiles, mean depth {depths.mean():.2f}, "
             f"{words.mean() / 1e3:.0f}k words/frame ({words.mean() * 4 / 1e6:.1f} MB/frame live)"]
    for r in rows:
        if "skipped" in r:
            lines.append(f"n_tiles={r['n_tiles']}: skipped ({r['skipped']})")
            continue
        gb = r["live_bytes"] / 1e9
        lines.append(
            f"n_tiles={r['n_tiles']} (slot {r['slot_bytes'] / 1e6:.2f} MB/shard): "
            f"split {r['split fresh'] * 1e3:.2f} ms/batch fresh / "
            f"{r['split pooled'] * 1e3:.2f} pooled ({gb / r['split pooled']:.1f} GB/s), "
            f"assemble {r['assemble fresh'] * 1e3:.2f} fresh / "
            f"{r['assemble reused'] * 1e3:.2f} reused ({gb / r['assemble reused']:.1f} GB/s)")
    return lines


# -- parts 2 and 3: the sharded step's legs ---------------------------------------


class Legs:
    """Host seconds by leg, summed over batches: each leg's call runs to its
    end on every card of the mesh before the clock stops."""

    def __init__(self, names, mesh: Mesh):
        self.seconds = dict.fromkeys(names, 0.0)
        self.calls = dict.fromkeys(names, 0)
        self._cards = sorted({d.index for d in mesh.devices.flat if d.type == "cuda"})

    def __call__(self, name: str, fn):
        t0 = time.perf_counter()
        result = fn()
        for index in self._cards:
            torch.cuda.synchronize(index)
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1
        return result

    def check(self, batches: int) -> None:
        """Raise unless every leg was timed in each of ``batches`` batches."""
        for name, calls in self.calls.items():
            if calls < batches or not self.seconds[name] >= 0.0:
                raise RuntimeError(f"leg {name!r} was timed {calls} times for {batches} "
                                   f"batches ({self.seconds[name]} s)")


def write_legs(path, frames: np.ndarray, mesh: Mesh, batch_size: int) -> tuple[Legs, int]:
    """Part 2: ``write_video_sharded`` of ``frames`` to ``path``, each batch
    split into :data:`WRITE_LEGS`, shard after shard in the step's order
    (each band's copies dropped before the next band's, as the step drops
    them).  Returns (the legs, the batches)."""
    N, H, W = frames.shape
    n_data, n_tiles = mesh.devices.shape
    h, _, h_loc = sharding._band_geometry(W, H, n_tiles)
    L = 8 * h_loc
    legs, pay_buf, batches = Legs(WRITE_LEGS, mesh), None, 0
    step = sharding._write_step(batch_size, n_data)
    with open(path, "wb") as f:
        f.write(VideoHeader(height=H, width=W, frame_hz=FRAME_HZ).pack())
        f.flush()
        for i in range(0, N, step):
            batch = frames[i:i + step]
            n = len(batch)
            images = legs("pad", lambda: sharding._pad_rows(sharding._pad_data(batch, n_data),
                                                            8 * h))
            B, B_loc = len(images), len(images) // n_data
            codecs = legs("codecs", lambda: sharding._shard_codecs(mesh, L, W))
            grid = []
            for d, row in enumerate(codecs):
                grid.append([])
                for t, codec in enumerate(row):
                    shard = legs("slice", lambda: np.ascontiguousarray(
                        sharding._band(images, d, t, B_loc, L)))
                    staged = legs("stage", lambda: codec.stage(shard))
                    (x,) = legs("h2d", lambda: codec._put((staged, torch.uint8)))
                    del shard, staged
                    grid[-1].append((codec, legs("kernels", lambda: codec.encode(x))))
            totals, _ = legs("totals", lambda: sharding._copy_totals(grid))
            depths, mins, payload = legs("fields",
                                         lambda: sharding._copy_fields(grid, totals, B, H, W))
            pay, n64, pay_buf = legs("assemble",
                                     lambda: sharding._assemble(payload, totals, pay_buf))
            legs("write", lambda: _writev_all(f.fileno(), record_iovecs(
                depths[:n], mins[:n], pay[:n], n64[:n], indices=range(i, i + n))))
            batches += 1
    legs.check(batches)
    return legs, batches


def read_legs(path, mesh: Mesh, batch_size: int) -> tuple[Legs, int, np.ndarray]:
    """Part 3: ``iter_video_sharded(path, mesh, batch_size, pipeline=1)``,
    each batch split into :data:`READ_LEGS`, shard after shard in the
    step's order.  Returns (the legs, the batches, the frames read)."""
    n_data, n_tiles = mesh.devices.shape
    legs, batches, out_all = Legs(READ_LEGS, mesh), 0, []
    with DbdeReader(path, batch_size=max(batch_size, n_data), device=mesh.devices[0, 0]) as rd:
        H, W = rd.height, rd.width
        _, w, h_loc = sharding._band_geometry(W, H, n_tiles)
        L, T_loc = 8 * h_loc, h_loc * w
        raw, seg_pool = rd.iter_raw(), {}
        while (item := legs("parse", lambda: next(raw, None))) is not None:
            headers, arrays = item
            depths, mins, payload = legs("pad", lambda: sharding._pad_records(*arrays[:3],
                                                                               n_data))
            free = seg_pool.setdefault(len(depths), [])
            segments = legs("split", lambda: split_payload_host(
                payload, depths, H, W, n_tiles, out=free.pop() if free else None))
            codecs = legs("codecs", lambda: sharding._shard_codecs(mesh, L, W))
            B_loc, S = len(depths) // n_data, segments.shape[1] // n_tiles
            pending = []
            for d, row in enumerate(codecs):
                pending.append([])
                for t, codec in enumerate(row):
                    uniform, items = codec._band_inputs(*sharding._shard_fields(
                        depths, mins, segments, d, t, B_loc, T_loc, S))
                    staged = legs("slice+stage",
                                  lambda: [(codec.stage(a, dtype), dtype) for a, dtype in items])
                    on_card = legs("h2d", lambda: codec._put(*staged))
                    del staged
                    pending[-1].append(legs("kernels", lambda: sharding._dispatched(
                        codec, codec._band_kernels(uniform, on_card))))
            copies = legs("copies back", lambda: [[copy.wait()[0] for copy in row]
                                                  for row in sharding._copy_back(pending)])

            def place():
                out = sharding._shard_out(pending)
                for d, row in enumerate(copies):
                    for t, shard in enumerate(row):
                        sharding._place(out, d, t, shard)
                return out[:, :H, :W][:len(headers)]

            out_all.append(legs("place", place))
            seg_pool[len(depths)].append(segments)
            batches += 1
    legs.check(batches)
    return legs, batches, np.concatenate(out_all)


def _digest(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _spans(path, frames: np.ndarray, mesh: Mesh, batch_size: int) -> tuple[float, float, str]:
    """Host seconds of ``write_video_sharded`` and of
    ``iter_video_sharded(pipeline=1)`` of ``frames``, and the file's sha256;
    the read must return the frames."""
    t0 = time.perf_counter()
    write_video_sharded(path, frames, mesh, frame_hz=FRAME_HZ, batch_size=batch_size)
    t1 = time.perf_counter()
    got = [c for _, c in iter_video_sharded(path, mesh, batch_size=batch_size, pipeline=1)]
    t2 = time.perf_counter()
    if not np.array_equal(np.concatenate(got), frames):
        raise RuntimeError("iter_video_sharded did not return the frames")
    return t1 - t0, t2 - t1, _digest(path)


def probe_mesh(frames: np.ndarray, mesh: Mesh, batch_size: int) -> dict:
    """Parts 2 and 3 on ``mesh``: after a warm-up pass, the uninstrumented
    spans, the legs of one instrumented write and read, the spans again.  Raises unless the
    instrumented file equals ``write_video_sharded``'s and its read returns
    the frames.  Returns {"mesh", "devices", "frames", "write"/"read":
    {"legs": {leg: s}, "batches", "spans": [s before, s after]}}."""
    result = {"mesh": "x".join(map(str, mesh.devices.shape)),
              "devices": [str(d) for d in mesh.devices.flat], "frames": len(frames)}
    with tempfile.TemporaryDirectory() as tmp:
        _spans(os.path.join(tmp, "warm-up.dbde"), frames, mesh, batch_size)
        spans = [_spans(os.path.join(tmp, "before.dbde"), frames, mesh, batch_size)]
        path = os.path.join(tmp, "legs.dbde")
        wlegs, wb = write_legs(path, frames, mesh, batch_size)
        if _digest(path) != spans[0][2]:
            raise RuntimeError("the instrumented write's file differs from write_video_sharded's")
        rlegs, rb, got = read_legs(path, mesh, batch_size)
        if not np.array_equal(got, frames):
            raise RuntimeError("the instrumented read did not return the frames")
        spans.append(_spans(os.path.join(tmp, "after.dbde"), frames, mesh, batch_size))
    for i, (leg, legs, batches) in enumerate((("write", wlegs, wb), ("read", rlegs, rb))):
        result[leg] = {"legs": legs.seconds, "batches": batches,
                       "spans": [s[i] for s in spans]}
    return result


def mesh_lines(result: dict, label: str = "") -> list[str]:
    """One line for the write legs and one for the read legs of
    :func:`probe_mesh`'s result: each leg's ms a batch and share of the
    legs' sum, the sum, the uninstrumented span a batch and their ratio."""
    lines = []
    for leg, what in (("write", "write_video_sharded"), ("read", "iter_video_sharded(pipeline=1)")):
        r = result[leg]
        total, nb = sum(r["legs"].values()), r["batches"]
        span = sum(r["spans"]) / len(r["spans"])
        parts = ", ".join(f"{k} {v / nb * 1e3:.3f} ms ({v / total:.1%})"
                          for k, v in r["legs"].items())
        lines.append(
            f"{label}probe {leg}, {result['mesh']} mesh on {','.join(result['devices'])}, "
            f"{result['frames']} frames, {nb} batches, each leg synchronised: {parts}; "
            f"legs {total / nb * 1e3:.3f} ms a batch; {what} span "
            + ", ".join(f"{s / nb * 1e3:.3f}" for s in r["spans"])
            + f" ms a batch (before, after); legs/span {total / span:.3f}")
    return lines


def default_meshes(devices) -> list[Mesh]:
    """1x1 and 2x2 laid over ``devices`` in turn, and 4x1 where there are
    four or more."""
    shapes = [(1, 1), (2, 2)] + ([(4, 1)] if len(devices) >= 4 else [])
    return [make_mesh(nd, nt, devices=mesh_slots(nd * nt, devices)) for nd, nt in shapes]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dbde_tpu_torch.probe_sharded",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("geometry", nargs="?", default="2048x2048", help="WxH")
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("n_tiles", nargs="*", type=int, default=[4, 8],
                   help="bands for part 1 (default 4 8)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels, every visible card) or cpu (the plain versions)")
    args = p.parse_args(argv)
    W, H = (int(x) for x in args.geometry.split("x"))
    device = resolve_device(args.device)
    for line in glue_lines(W, H, args.batch, time_glue(W, H, args.batch, args.n_tiles)):
        print(line, flush=True)
    devices = visible_devices(device)
    frames = make_content(W, H, 3 * args.batch + 1)
    for mesh in default_meshes(devices):
        for line in mesh_lines(probe_mesh(frames, mesh, args.batch)):
            print(line, flush=True)
    if device.type == "cuda":
        print("cards: " + "; ".join(f"{d} {card_name(d.index)}" for d in devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
