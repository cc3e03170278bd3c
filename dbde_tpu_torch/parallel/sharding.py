"""Sharding of the DBDE codec over a mesh of devices, driven by one process.

Counterpart of :mod:`dbde_tpu.parallel.sharding`, with the same public
names and the same host arrays.  Two mesh axes:

  * ``"data"`` splits a batch's frames (each shard encodes and decodes its
    own frames; nothing crosses devices);
  * ``"tiles"`` splits each frame into horizontal bands of whole 8-pixel
    tile rows.  The only coupling between shards in the whole format is
    the stream offset of each band: the exclusive prefix of the per-shard
    word totals over the ``tiles`` axis.

The JAX mesh is single-controller: one process drives every device
through ``shard_map``.  The port keeps that model.  A :class:`Mesh` is an
``(n_data, n_tiles)`` grid of ``torch.device``; this process runs each
shard's :class:`~dbde_tpu_torch.codec.DbdeCodec` on its device in turn
(launches are asynchronous, so shards on distinct cards overlap), with no
process group and no collective.  The word-total prefix is a
``torch.stack`` of a data row's totals on the row's first device and one
``cumsum`` there; with the n64 sum of :func:`sharded_roundtrip_step`, the
only steps that move data between devices (peer copies, which torch orders
after the work on both cards' current streams).  Copies back to the host
are enqueued for every shard before the first is waited for, so no card's
copy queues behind another's.  A device may appear more than once in a
mesh: its shards then run one after another on its current stream.
:func:`mesh_slots` lays a mesh's slots over the visible cards in turn.
Each call builds one grid of codecs, one a shard: the file writer and
walker once for the whole file, whose geometry is fixed, and the
one-batch functions once for their batch.

Each shard runs the band kernels through the codec, which reads nothing
back: K1, then K2 and K4, gated on the device by the shard's own flag so
that K4 writes where the shard's band is all depth 8 and K2 elsewhere.
Its decode from host depths is K3, or K5 where the shard's depths are all
8 (checked on the host, exact, per shard); the round-trip step decodes
from the depths on the device, launching K3 and K5 gated the same way.
On CPU devices the plain versions run instead.  The tiles backend (K6/K7)
has no sharded path, as in the JAX package.

On a CUDA mesh the writer copies each byte once on the host each way:
every shard's band goes from the caller's frames straight into pinned
memory, and each record is written from the shards' pinned copies back,
its depths, minima and payload prefix band by band, with no assembly.
:func:`encode_sharded` places the shards' fields into whole-batch
arrays, each payload segment in a worst-case slot of 16 words a tile;
:func:`assemble_payload_padded` and :func:`split_payload_host` convert
between such segments and a file's ragged streams.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from .. import trace
from ..codec import DbdeCodec, HostCopy, _host, record_event, record_iovecs, resolve_device
from ..format import VideoHeader, tile_grid
from ..ops.bitpack import MAX_WORDS_PER_TILE
from ..stream import DbdeReader, _Sink


class Mesh:
    """A ("data", "tiles") grid of torch devices: ``devices`` is an
    ``(n_data, n_tiles)`` object array, ``shape`` the axis sizes by name."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        n_data, n_tiles = self.devices.shape
        return {"data": n_data, "tiles": n_tiles}


def visible_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh of ``device``'s type is laid over: every visible
    CUDA card for a CUDA ``device`` (this raises when none is visible:
    there is no CPU fallback), the CPU itself for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_slots(n: int, devices) -> list:
    """``n`` mesh slots laid over ``devices`` in turn (as a rule
    :func:`visible_devices`): slot ``i`` on ``devices[i % len(devices)]``.
    So ``n`` slots over ``n`` or more cards each have a card of their own,
    and one device fills every slot itself (``[device] * n``)."""
    return [devices[i % len(devices)] for i in range(n)]


def make_mesh(n_data: int | None = None, n_tiles: int = 1, devices=None) -> Mesh:
    """Build a ("data", "tiles") mesh from ``devices`` (default: every
    visible CUDA device; with none visible this raises, there is no CPU
    fallback), filled row by row.  A device may be listed more than once;
    :func:`mesh_slots` lays a mesh of any size over the visible cards."""
    devices = visible_devices() if devices is None else devices
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_tiles
    if n_data < 1 or n_tiles < 1 or n_data * n_tiles > len(devices):
        raise ValueError(f"mesh {n_data}x{n_tiles} needs 1 to {len(devices)} devices")
    grid = np.empty((n_data, n_tiles), dtype=object)
    for i, dev in enumerate(devices[: n_data * n_tiles]):
        grid.flat[i] = dev
    return Mesh(grid)


def _band_geometry(W: int, H: int, n_tiles: int) -> tuple[int, int, int]:
    """(h, w, h_loc): the frame's tile grid and the tile rows of each band."""
    h, w = tile_grid(W, H)
    if h % n_tiles != 0:
        raise ValueError(
            f"tile rows ({h}) must divide evenly into {n_tiles} bands for "
            "bit-exact sharded encode; pick n_tiles dividing ceil(H/8)"
        )
    return h, w, h // n_tiles


def _check_backend(backend: str) -> None:
    """Raise unless ``backend`` is "auto" or "band": the band kernels per
    shard, the port's one sharded path."""
    if backend in ("auto", "band"):
        return
    if backend == "xla":
        raise ValueError("the port has no 'xla' shard body: its plain versions run on a "
                         "mesh of CPU devices (make_mesh(devices=[torch.device('cpu')] * n))")
    raise ValueError(f"unknown sharded backend {backend!r}")


def _local_batch(B: int, n_data: int) -> int:
    if B % n_data:
        raise ValueError(f"a batch of {B} frames does not split over {n_data} data shards")
    return B // n_data


def segment_slot_words(W: int, H: int, n_tiles: int, backend: str = "auto") -> int:
    """Per-shard payload segment slot size in u32 words: the stride that
    :func:`encode_sharded` and :func:`split_payload_host` emit, 16 words a
    tile.  :func:`decode_sharded` takes any stride from its array."""
    _check_backend(backend)
    _, w, h_loc = _band_geometry(W, H, n_tiles)
    return MAX_WORDS_PER_TILE * h_loc * w


# ---------------------------------------------------------------------------
# per-shard encode and the one cross-device step
# ---------------------------------------------------------------------------


def _pad_rows(images: np.ndarray, rows: int) -> np.ndarray:
    """Edge-pad (B, H, W) frames to ``rows`` rows: repeat the last row."""
    H = images.shape[1]
    if rows == H:
        return images
    return np.concatenate([images, np.repeat(images[:, -1:], rows - H, axis=1)], axis=1)


def _pad_data(batch: np.ndarray, n_data: int) -> np.ndarray:
    """A batch padded to whole data shards with repeats of its last frame
    (the writer's tail; the file drops them)."""
    pad = -batch.shape[0] % n_data
    return np.concatenate([batch, np.repeat(batch[-1:], pad, 0)]) if pad else batch


def _shard_codecs(mesh: Mesh, H: int, W: int) -> list[list[DbdeCodec]]:
    """The codec grid of ``mesh`` for (H, W) frames: one codec a shard, on
    its device, for its band of whole tile rows (``8*h_loc`` pixel rows of
    the frames edge-padded to whole tile rows)."""
    _, _, h_loc = _band_geometry(W, H, mesh.devices.shape[1])
    return [[DbdeCodec(8 * h_loc, W, device=dev) for dev in row] for row in mesh.devices]


def _band(images: np.ndarray, d: int, t: int, B_loc: int, L: int) -> np.ndarray:
    """Shard (d, t)'s band of padded frames: frames ``[d*B_loc, (d+1)*B_loc)``,
    pixel rows ``[t*L, (t+1)*L)`` (a view, contiguous only where ``L`` is
    every row)."""
    return images[d * B_loc:(d + 1) * B_loc, t * L:(t + 1) * L]


def _encode_shards(images: np.ndarray, codecs):
    """Encode every shard's band on its codec of the grid ``codecs``
    (:func:`_shard_codecs`) → rows of (codec, EncodedBatch).

    H is edge-padded first to whole tile rows (the format's rule: repeat
    the last row), so shard (d, t) holds frames ``[d*B_loc, (d+1)*B_loc)``
    and pixel rows ``[t*L, (t+1)*L)`` of the padded frames, ``L`` its
    codec's height."""
    with trace.span("sharded.encode"):
        B_loc = _local_batch(images.shape[0], len(codecs))
        L = codecs[0][0].height
        images = _pad_rows(images, L * len(codecs[0]))
        return [[(codec, codec.encode(codec.stage(_band(images, d, t, B_loc, L))))
                 for t, codec in enumerate(row)]
                for d, row in enumerate(codecs)]


def _totals_bases(row) -> tuple[torch.Tensor, torch.Tensor]:
    """A data row's (totals, bases), each (n_tiles, B_loc) i32, on the row's
    first device: the u32 word count of every shard's segment and its
    exclusive prefix over the ``tiles`` axis (the JAX package's
    ``all_gather`` of one scalar per shard)."""
    first = row[0][1].n64.device
    totals = torch.stack([2 * enc.n64.to(first) for _, enc in row])
    return totals, torch.cumsum(totals, 0, dtype=torch.int32) - totals


def encode_sharded(images, mesh: Mesh, backend: str = "auto"):
    """(B, H, W) u8 frames → sharded encoded arrays, on the host.

    ``B`` is split over ``data``; tile rows are split into ``tiles`` bands.
    Requires ``ceil(H/8) % n_tiles == 0`` (equal bands of whole tile rows),
    so that band-major tile order is the frame's row-major tile order and
    the bytes are the single-device encoding's.

    Returns (depths (B,T) u8, mins (B,T) u8, payload (B, n_tiles*S_local)
    u32 per-shard segments, totals (n_tiles, B) i32 segment word counts,
    bases (n_tiles, B) i32 global word offsets, Hp).  Each shard's segment
    is copied from its device only up to that shard's largest total; slot
    words past a frame's own total are unspecified.
    """
    _check_backend(backend)
    images = np.asarray(images, dtype=np.uint8)
    H, W = images.shape[1:]
    grid = _encode_shards(images, _shard_codecs(mesh, H, W))
    totals, bases = _copy_totals(grid)
    depths, mins, payload = _place_fields(_copy_fields(grid, totals), H, W)
    return depths, mins, payload, totals, bases, 8 * tile_grid(W, H)[0]


# The copies back of an encode, in two rounds, each enqueued for every
# shard before the first is waited for: the totals, which size each
# shard's live payload, then every shard's depths, minima and live payload
# prefix.


def _copy_totals(grid) -> tuple[np.ndarray, np.ndarray]:
    """The first round: every data row's (totals, bases), each (n_tiles, B)
    i32 on the host."""
    with trace.span("sharded.totals"):
        sums = [copy.wait() for copy in [HostCopy(_totals_bases(row)) for row in grid]]
        return (np.concatenate([t for t, _ in sums], axis=1),
                np.concatenate([b for _, b in sums], axis=1))


def _copy_fields(grid, totals: np.ndarray):
    """The second round → rows, as ``grid``, of each shard's (depths
    (B_loc, T_loc) u8, mins (B_loc, T_loc) u8, payload (B_loc, live) u32),
    its payload copied up to its largest total: on a CUDA device views of
    pinned memory, which goes back to torch's cache once they are dropped
    (:meth:`HostCopy.wait`); on the CPU the tensors' own arrays."""
    with trace.span("sharded.fields"):
        B_loc = grid[0][0][1].depths.shape[0]
        copies = []
        for d, row in enumerate(grid):
            copies.append([])
            for t, (_, enc) in enumerate(row):
                live = int(totals[t, d * B_loc:(d + 1) * B_loc].max(initial=0))
                copies[-1].append(HostCopy([enc.depths, enc.mins, enc.payload[:, :live]]))
        return [[tuple(copy.wait()) for copy in row] for row in copies]


def _place_fields(shards, H: int, W: int):
    """:func:`_copy_fields`'s rows → (depths (B, T) u8, mins (B, T) u8,
    payload (B, n_tiles*S_local) u32 segments): each shard's fields in
    their place, its live payload at the head of its slot."""
    n_tiles = len(shards[0])
    B_loc, T_loc = shards[0][0][0].shape
    B = len(shards) * B_loc
    depths = np.empty((B, n_tiles * T_loc), np.uint8)
    mins = np.empty((B, n_tiles * T_loc), np.uint8)
    payload = np.empty((B, n_tiles, segment_slot_words(W, H, n_tiles)), np.uint32)
    for d, row in enumerate(shards):
        for t, (dep, mn, live) in enumerate(row):
            frames, tiles = slice(d * B_loc, (d + 1) * B_loc), slice(t * T_loc, (t + 1) * T_loc)
            depths[frames, tiles], mins[frames, tiles] = dep, mn
            payload[frames, t, :live.shape[1]] = live
    return depths, mins, payload.reshape(B, -1)


# ---------------------------------------------------------------------------
# per-shard decode
# ---------------------------------------------------------------------------


def decode_sharded_dispatch(depths, mins, segments, mesh: Mesh, H: int, W: int,
                            Hp: int, backend: str = "auto", uniform8: bool = False):
    """Launch every shard's decode → an opaque pending value for
    :func:`decode_sharded_materialize`.

    ``segments`` is (B, n_tiles*S) u32 at any per-shard stride S ≥ each
    shard's live words (the stride is ``segments.shape[1] // n_tiles``), so
    segments made at another stride, such as the JAX package's, decode too.
    Each shard gets its host depths, so its K3/K5 choice waits for nothing.
    ``Hp`` and ``uniform8`` are accepted for the JAX package's contract and
    change nothing: the band geometry follows from H, and the uniform
    choice is exact per shard.  Each shard's event is recorded on its
    card's current stream after its decode, and its copy back waits for
    it, so the value may be materialized under any current stream.
    """
    _check_backend(backend)
    return _decode_shards(depths, mins, segments, _shard_codecs(mesh, H, W))


def _decode_shards(depths, mins, segments, codecs):
    """:func:`decode_sharded_dispatch` on the codec grid ``codecs``
    (:func:`_shard_codecs`), which a walk builds once."""
    n_data, n_tiles = len(codecs), len(codecs[0])
    depths, mins, segments = _host(depths), _host(mins), _host(segments)
    B_loc = _local_batch(depths.shape[0], n_data)
    if segments.ndim != 2 or segments.shape[1] % n_tiles:
        raise ValueError(f"segments must be (B, n_tiles*S), got {segments.shape} "
                         f"for {n_tiles} bands")
    S = segments.shape[1] // n_tiles
    T_loc = codecs[0][0].tiles
    return [[_dispatched(codec, codec.decode_dispatch(
                *_shard_fields(depths, mins, segments, d, t, B_loc, T_loc, S)))
             for t, codec in enumerate(row)]
            for d, row in enumerate(codecs)]


def _shard_fields(depths, mins, segments, d: int, t: int, B_loc: int, T_loc: int, S: int):
    """Shard (d, t)'s (depths, minima, segment) views of the host arrays."""
    frames, tiles = slice(d * B_loc, (d + 1) * B_loc), slice(t * T_loc, (t + 1) * T_loc)
    return depths[frames, tiles], mins[frames, tiles], segments[frames, t * S:(t + 1) * S]


def _dispatched(codec: DbdeCodec, frames: torch.Tensor):
    """A shard's pending decode and the event recorded after it on its
    card's current stream (None on the CPU)."""
    return frames, record_event(codec.device)


def _copy_back(pending) -> list[list[HostCopy]]:
    """Every shard's copy to the host, enqueued after its dispatch's event."""
    return [[HostCopy([frames], after=done) for frames, done in row] for row in pending]


def _place(out: np.ndarray, d: int, t: int, band: np.ndarray) -> None:
    """Shard (d, t)'s decoded band into its place in the uncropped output."""
    B_loc, L = band.shape[:2]
    out[d * B_loc:(d + 1) * B_loc, t * L:(t + 1) * L] = band


def _shard_out(pending) -> np.ndarray:
    """The uncropped (B, n_tiles*L, W) u8 output of a pending decode."""
    B_loc, L, Wd = pending[0][0][0].shape
    return np.empty((len(pending) * B_loc, len(pending[0]) * L, Wd), np.uint8)


def decode_sharded_materialize(pending, H: int, W: int) -> np.ndarray:
    """Wait for a :func:`decode_sharded_dispatch` value → (B, H, W) u8:
    every shard copied to the host into its place, cropped to the frame.
    Every shard's copy goes through pinned memory (:class:`HostCopy`),
    waits for its dispatch's event and is enqueued before the first is
    waited for."""
    out = _shard_out(pending)
    for d, row in enumerate(_copy_back(pending)):
        for t, copy in enumerate(row):
            _place(out, d, t, copy.wait()[0])
    return out[:, :H, :W]


def decode_sharded(depths, mins, segments, mesh: Mesh, H: int, W: int, Hp: int,
                   backend: str = "auto", uniform8: bool = False) -> np.ndarray:
    """Inverse of :func:`encode_sharded`; → (B, H, W) u8 numpy."""
    return decode_sharded_materialize(
        decode_sharded_dispatch(depths, mins, segments, mesh, H, W, Hp, backend, uniform8),
        H, W)


def sharded_roundtrip_step(images, mesh: Mesh, backend: str = "auto"):
    """One full sharded encode → decode step: each shard decodes its own
    segment on its device, with no host round trip of the payload.  Any H
    works: the frames are edge-padded to whole bands of tile rows first,
    as the JAX package's step pads them.  Returns ((B, H, W) u8 numpy,
    global n64 of the padded frames, summed over every shard)."""
    _check_backend(backend)
    images = np.asarray(images, dtype=np.uint8)
    B, H, W = images.shape
    unit = 8 * mesh.shape["tiles"]
    Hpad = -(-H // unit) * unit
    grid = _encode_shards(_pad_rows(images, Hpad), _shard_codecs(mesh, Hpad, W))
    pending = [[_dispatched(codec, codec.decode_dispatch(enc.depths, enc.mins, enc.payload))
                for codec, enc in row] for row in grid]
    first = mesh.devices[0, 0]
    n64 = torch.stack([enc.n64.sum(dtype=torch.int64).to(first)
                       for row in grid for _, enc in row]).sum()
    return decode_sharded_materialize(pending, H, W), int(n64)


# ---------------------------------------------------------------------------
# host glue: sharded segments ↔ the file's flat per-frame streams
# ---------------------------------------------------------------------------


def assemble_payload_host(segments, totals) -> list[np.ndarray]:
    """Per-frame flat u32 payloads from sharded segments (host ragged concat).

    segments: (B, n_tiles*S_local) u32; totals: (n_tiles, B) i32.
    """
    pay, n64 = assemble_payload_padded(segments, totals)
    return [pay[b, : 2 * int(n64[b])].copy() for b in range(pay.shape[0])]


def assemble_payload_padded(segments, totals, out=None):
    """Sharded segments → one padded (B, mx) u32 payload matrix + n64 (B,).

    Each frame's flat stream is its shards' live prefixes back to back,
    written into an uninitialised row-padded matrix (consumers such as
    :func:`~dbde_tpu_torch.codec.record_iovecs` read only ``2*n64`` words
    a row), one copy per (frame, shard).

    ``out``: an optional reusable (≥B, ≥mx) u32 buffer; rows may be wider
    than mx.  Returns (matrix (B, ≥mx) u32, n64 (B,) i64); allocates when
    ``out`` is absent or too small.
    """
    totals = np.asarray(totals)
    n_tiles = totals.shape[0]
    segments = np.asarray(segments)
    B = segments.shape[0]
    segments = segments.reshape(B, n_tiles, -1)
    counts = totals.T.astype(np.int64)  # (B, n_tiles)
    bases = np.cumsum(counts, axis=1) - counts
    words = counts.sum(1)
    mx = int(words.max()) if B else 0
    if out is not None and out.shape[0] >= B and out.shape[1] >= mx:
        pay = out[:B]
    else:
        pay = np.empty((B, mx), np.uint32)
    for b in range(B):
        row = pay[b]
        for s in range(n_tiles):
            c = counts[b, s]
            row[bases[b, s] : bases[b, s] + c] = segments[b, s, :c]
    return pay, words // 2


def split_payload_host(payload, depths, H: int, W: int, n_tiles: int,
                       backend: str = "auto", out=None) -> np.ndarray:
    """File-flat per-frame payloads → per-shard worst-case segments.

    The inverse of :func:`assemble_payload_host`, from per-band depth sums
    alone: shard ``s`` of frame ``b`` owns tile rows ``[s*h_loc,
    (s+1)*h_loc)``, so its segment is the ``2*Σ depths``-word slice of the
    flat stream at the exclusive prefix of the earlier shards' counts.

    payload: (B, S) u32 flat streams (any S ≥ each frame's 2*n64);
    depths: (B, T) u8.  Returns (B, n_tiles*S_local) u32 segments for
    :func:`decode_sharded`.  Slot words past each shard's live count are
    uninitialised: the decode reads only each tile's ``2*depth`` words, so
    the output never depends on them (``tests/test_torch_parallel.py``).

    ``out``: an optional reusable (B, n_tiles*S_local) u32 buffer
    (:func:`iter_video_sharded` pools them).
    """
    with trace.span("sharded.split"):
        depths = np.asarray(depths)
        payload = np.asarray(payload)
        B, T = depths.shape
        _, w, h_loc = _band_geometry(W, H, n_tiles)
        counts = 2 * depths.reshape(B, n_tiles, h_loc * w).astype(np.int64).sum(-1)
        bases = np.cumsum(counts, axis=1) - counts
        S_local = segment_slot_words(W, H, n_tiles, backend)
        if out is None or out.shape != (B, n_tiles * S_local):
            out = np.empty((B, n_tiles * S_local), np.uint32)
        segs = out.reshape(B, n_tiles, S_local)
        for b in range(B):
            src = payload[b]
            for s in range(n_tiles):
                c = counts[b, s]
                segs[b, s, :c] = src[bases[b, s] : bases[b, s] + c]
        return out


# ---------------------------------------------------------------------------
# sharded file layer: the stream walker and writer coupled to the mesh codec
# ---------------------------------------------------------------------------


def _write_step(batch_size: int, n_data: int) -> int:
    """The writer's batch: ``batch_size`` rounded down to whole data shards."""
    return max(batch_size - batch_size % n_data, n_data)


def _record_iovecs(shards, totals: np.ndarray, n: int, first: int) -> list:
    """The records of a batch's first ``n`` frames, indices from ``first``,
    straight from :func:`_copy_fields`'s rows
    (:func:`~dbde_tpu_torch.codec.record_iovecs`, bound here by import,
    so that a patch of this module's name reaches this writer alone):
    each frame's depths and minima rows and payload prefixes of
    ``totals[t, b]`` words, band by band.  The shards' arrays must stay
    alive and unchanged until the write returns."""
    with trace.span("sharded.assemble"):
        B_loc = shards[0][0][0].shape[0]
        rows = [(shards[b // B_loc], b % B_loc, totals[:, b]) for b in range(n)]
        return record_iovecs([[dep[j] for dep, _, _ in row] for row, j, _ in rows],
                             [[mn[j] for _, mn, _ in row] for row, j, _ in rows],
                             [[live[j, :k] for (_, _, live), k in zip(row, words)]
                              for row, j, words in rows],
                             totals[:, :n].sum(axis=0) // 2, indices=range(first, first + n))


def _inplace_bytes(iov, shards) -> int:
    """The bytes of ``iov`` that lie in the shards' arrays, so that a copy
    made on the way to the write does not count."""
    arrays = [a for row in shards for shard in row for a in shard]
    return sum(v.nbytes for v in iov if not isinstance(v, bytes)
               and any(np.may_share_memory(np.asarray(v), a) for a in arrays))


def write_video_sharded(path, frames, mesh: Mesh, frame_hz: float = 1.0,
                        backend: str = "auto", batch_size: int = 16,
                        hz_as_integer: bool = False) -> None:
    """Encode a (N, H, W) u8 stack to a ``.dbde`` file on a device mesh.

    Each batch is split over the mesh (frames over ``data``, tile-row bands
    over ``tiles``); every shard's fields are copied back and its records
    written from those copies band by band (:func:`_record_iovecs`),
    byte-identical to the single-device writer's.  A tail batch that does
    not fill the data axis is padded with repeats of its last frame, which
    are dropped at the file.

    The records are written by a sink thread of the call's own
    (:class:`~dbde_tpu_torch.stream._Sink`, its spans under the root
    ``sharded.write``), batch after batch, while this thread stages,
    encodes and copies back the next batch; each batch's shard copies are
    held here until their write returns.  A failed write is raised from
    here and stops all later ones; an error of this thread's is raised as
    it is, once the sink thread has ended.
    """
    with trace.span("sharded.write"):
        _check_backend(backend)
        frames = np.asarray(frames, dtype=np.uint8)
        N, H, W = frames.shape
        n_data = mesh.shape["data"]
        step = _write_step(batch_size, n_data)
        codecs = _shard_codecs(mesh, H, W)
        with open(path, "wb") as f:
            f.write(VideoHeader(height=H, width=W, frame_hz=frame_hz).pack(hz_as_integer))
            f.flush()  # the records below bypass the buffer via writev on the fd
            sink = _Sink(f.fileno(), root="sharded.write")
            try:
                for i in range(0, N, step):
                    batch = frames[i : i + step]
                    grid = _encode_shards(_pad_data(batch, n_data), codecs)
                    totals, _ = _copy_totals(grid)
                    shards = _copy_fields(grid, totals)
                    iov = _record_iovecs(shards, totals, batch.shape[0], i)
                    if trace.enabled():
                        trace.count("sharded.inplace_bytes", _inplace_bytes(iov, shards))
                    sink.put(iov, shards)  # held until their write returns
            except BaseException:
                with contextlib.suppress(Exception):  # this thread's error, not the sink's
                    sink.close()
                raise
            sink.close()


def _pad_records(depths, mins, payload, n_data: int):
    """A parsed batch padded to whole data shards with zero records (depth
    0 everywhere; the walker crops them after the decode)."""
    pad = -depths.shape[0] % n_data
    if not pad:
        return depths, mins, payload
    z8 = np.zeros((pad, depths.shape[1]), np.uint8)
    return (np.concatenate([depths, z8]), np.concatenate([mins, z8]),
            np.concatenate([payload, np.zeros((pad, payload.shape[1]), np.uint32)]))


def _walker(path, mesh: Mesh, batch_size: int, hz_as_integer: bool) -> DbdeReader:
    """The stream reader that parses a sharded walk's records on the host
    (its own codec stays idle)."""
    return DbdeReader(path, batch_size=max(batch_size, mesh.shape["data"]),
                      device=mesh.devices[0, 0], hz_as_integer=hz_as_integer)


def iter_video_sharded(path, mesh: Mesh, backend: str = "auto",
                       batch_size: int = 16, hz_as_integer: bool = False,
                       pipeline: int = 2, uniform8: bool = False):
    """Bounded-memory sharded file walker: yield (headers, (n, H, W) u8)
    batches of a ``.dbde`` file decoded across a device mesh.

    The stream reader parses the records on the host
    (:meth:`~dbde_tpu_torch.stream.DbdeReader.iter_raw`; its own codec
    stays idle), each batch's flat payloads are split into per-shard
    segments (:func:`split_payload_host`), and every shard's decode is
    launched on the walk's one codec grid before the previous batch is
    waited for: up to ``pipeline`` batches are in flight, so the next
    batch's parse and split overlap the device work.  Memory is
    O(pipeline · batch).  ``uniform8`` is accepted for the JAX package's
    contract and changes nothing (as in :func:`decode_sharded_dispatch`).

    A tail batch that does not fill the data axis is padded with zero
    records (depth 0 everywhere) and cropped after the decode.  A segment
    buffer returns to its pool only after its batch materialized, which
    implies its host→device copies are done.  Each shard's copy back waits
    for the event recorded at its dispatch
    (:func:`decode_sharded_dispatch`), so the frames do not depend on the
    stream current at each ``next()``.
    """
    with _walker(path, mesh, batch_size, hz_as_integer) as rd:
        yield from _walk(rd, mesh, backend, pipeline)


def _walk(rd: DbdeReader, mesh: Mesh, backend: str, pipeline: int = 2):
    """:func:`iter_video_sharded` over the records of the open reader ``rd``."""
    _check_backend(backend)
    n_data, n_tiles = mesh.devices.shape
    H, W = rd.height, rd.width
    codecs = _shard_codecs(mesh, H, W)
    raw = rd.iter_raw()
    pending = collections.deque()
    seg_pool: dict = {}  # batch rows → free segment buffers

    def dispatch() -> bool:
        with trace.span("sharded.dispatch"):
            item = next(raw, None)
            if item is None:
                return False
            headers, arrays = item
            depths, mins, payload = _pad_records(*arrays[:3], n_data)
            free = seg_pool.setdefault(depths.shape[0], [])
            segments = split_payload_host(payload, depths, H, W, n_tiles, backend,
                                          out=free.pop() if free else None)
            pending.append((headers, _decode_shards(depths, mins, segments, codecs), segments))
            return True

    while len(pending) < pipeline and dispatch():
        pass
    while pending:
        dispatch()  # parse + split + launch the next batch while this one runs
        headers, out, segments = pending.popleft()
        with trace.span("sharded.materialize"):
            frames = decode_sharded_materialize(out, H, W)[:len(headers)]
            seg_pool[segments.shape[0]].append(segments)  # decoded ⇒ copies done
        yield headers, frames


def read_video_sharded(path, mesh: Mesh, backend: str = "auto",
                       batch_size: int = 16, hz_as_integer: bool = False):
    """Decode a whole ``.dbde`` file on a device mesh →
    (VideoHeader, [FrameHeader], (N, H, W) u8); the whole-video wrapper of
    :func:`iter_video_sharded`, on the one reader of its walk."""
    headers_all, chunks = [], []
    with _walker(path, mesh, batch_size, hz_as_integer) as rd:
        for headers, frames in _walk(rd, mesh, backend):
            headers_all.extend(headers)
            chunks.append(frames)
        header, H, W = rd.header, rd.height, rd.width
    frames = np.concatenate(chunks) if chunks else np.empty((0, H, W), np.uint8)
    return header, headers_all, frames
