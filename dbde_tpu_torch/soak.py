"""Randomized differential soak of the port, and the sharded round-trip
step's device time on one card and on distinct cards.

    python -m dbde_tpu_torch.soak [--cases N] [--seed S] [--seconds T] [--case I]
                                  [--device cuda|cpu]

The port's counterpart of ``tools/tpu_soak.py`` and of part (c) of
``tools/tpu_sharded_check.py``, written for the port's own hazards rather
than the TPU's: K2, K3 and K6 each find their place in the frame's stream
in blocks of 1024 tiles and stage a block's stream in shared memory; the
kernels load tile rows as 8-byte words only where ``W % 8 == 0`` and move
payload words 16 bytes at a time only on aligned rows; K1's batch flag
chooses K2 or K4 (and K3 or K5) on the device; the kernels index frames as
``(size_t)b * H * W``; and the stream layer copies through pinned memory
without waiting.

A plan of cases is drawn from ``np.random.default_rng(seed)`` (:func:`plan`);
case ``i`` is the same whether it runs alone (``--case i``) or in the whole
plan.  The first ``len(REGIMES)`` cases take each regime once, in order;
after that regimes rotate.  Each case draws a batch (B ≤ 16, apart from the
batch past 2**31 bytes) of one of :data:`CONTENTS` and checks, with
tolerance 0 (:func:`run_case`):

  * every kernel K1–K7 against its plain version on the same tensors, into
    sentinel-filled outputs, at aligned rows and rows off the 16-byte grid;
  * ``DbdeCodec`` of both backends, ``"band"`` (K1, then K2 and K4 gated)
    and ``"tiles"`` (the layout and K6), from host frames: depths, minima,
    n64 and stream equal to the plain versions', and the record bytes
    (``codec.pack_frames_bytes``) equal to records built from those arrays
    and, for the batch's last frame, to ``ref_numpy.pack_image`` (its first
    64 tile rows where the frame is over 1 MB: their depths, minima and
    payload words are a prefix of the frame's);
  * decode by every route of ``DbdeCodec.decode_dispatch``, each equal to
    the frames and launching the kernels the route should (:data:`ROUTES`);
  * in a share of the cases, ``DbdeWriter``/``DbdeReader`` at random
    pipelines 1–3 and batch sizes, the caller overwriting its frames right
    after each ``write()``: the file equal to ``ref_numpy.encode_video``,
    read back exact;
  * in a share of the cases, the sharded path on a random ``(n_data,
    n_tiles)`` mesh laid over every visible card in turn
    (``parallel.mesh_slots``; on one card, or the CPU, every slot is that
    device), with B not a multiple of ``n_data`` and H not of
    ``8 * n_tiles``;
  * in the caller's-stream regime, the writer, an encode and a
    ``decode_dispatch`` under streams of the caller's (a new stream made
    current on each card, behind a device sleep), their results read back
    on the streams current before, and ``DbdeReader`` and
    ``iter_video_sharded`` with each ``next()`` in turn under the caller's
    streams and under the earlier ones (:func:`next_switching_streams`).

The first difference raises :class:`SoakFailure`, which names it: the
frame and the word, tile, pixel or byte, with both values.  ``main`` prints
it with the case, the seed, the backend and the route, and exits 1.  On a
CUDA device ``main`` then runs :func:`check_sharded_step_time` (check (c),
one card) and :func:`check_distinct_cards` (check (d), where two or more
cards are visible).

On the CPU (``--device cpu``) every kernel wrapper runs its plain version,
so the checks hold the codec's glue and the plain versions against the
numpy oracle; there is no fallback from CUDA to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import os
import struct
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from . import ref_numpy
from .bench_core import make_adversarial, make_content, make_uniform8
from .codec import (DbdeCodec, EncodedBatch, pack_frames_bytes, pinned_cache_bytes,
                    record_event, resolve_device)
from .format import VIDEO_HEADER_BYTES, FrameHeader, VideoHeader, tile_grid
from .ops import band, tile_layout
from .ops.bitpack import MAX_WORDS_PER_TILE
from .parallel import (
    assemble_payload_host,
    decode_sharded,
    encode_sharded,
    iter_video_sharded,
    make_mesh,
    mesh_slots,
    read_video_sharded,
    sharded_roundtrip_step,
    visible_devices,
    write_video_sharded,
)
from .stream import DbdeReader, DbdeWriter
from .utils.profiling import card_name, measure_device_cards, measure_device_seconds

PAST_2_31 = "past 2**31 bytes"
CALLERS_STREAM = "caller's stream"
DEVICE_CONTENT = "made on the device, mixed then all depth 8"
# the last two came after the first ten, so that those cases stay as they were
REGIMES = ("one column", "narrow", "medium", "wide", "seam 0", "seam 1", "seam 1023",
           "16x2048x2048", "2x4096x4096", PAST_2_31, CALLERS_STREAM, "over 4096")
CONTENTS = ("adversarial shallow", "adversarial 8", "uniform 8", "flat",
            "uniform 8 but one tile", "uniform 8 but one frame")
UNIFORM = ("uniform 8", "uniform 8 but one tile", "uniform 8 but one frame")
STREAM_REGIMES = ("one column", "narrow", "medium")
SHARDED_REGIMES = ("one column", "narrow", "medium", "wide")
RESIDUE_REGIMES = ("narrow", "medium", "wide", "seam 0", "seam 1", "seam 1023",  # W % 8 drawn
                   CALLERS_STREAM, "over 4096")
# decode routes of DbdeCodec.decode_dispatch, by backend
ROUTES = {"band": ("host depths", "device depths, stride 16*T", "device depths, narrow stride",
                   "rows off the 16-byte grid"),
          "tiles": ("host depths", "rows off the 16-byte grid")}
SENTINEL = 0xDEADBEEF
ORACLE_BYTES = 1 << 20  # frames over this are checked against ref_numpy in their first rows
ORACLE_TILE_ROWS = 64
STREAM_PIXELS = 1 << 16  # a stream case's frames hold at most this many pixels
# the device sleep at the head of the caller's streams: about 10 ms of an
# H100's clock, so that what is enqueued behind it is still pending when
# the next call runs on another stream
SLEEP_CYCLES = 20_000_000
STEP_TIME_LIMIT = 1.15  # sharded step / single-device round trip (tools/tpu_sharded_check.py:79)
# check (d): a card's busy time in the step on distinct cards / the single
# card's round trip.  Each card holds a share of the frames, so above 1.0
# means the slots piled onto one card
CARD_BUSY_LIMIT = 1.0
ENCODE = {"band": {"encode_depths": 1, "encode_payload": 1, "encode_payload_u8": 1},
          "tiles": {"encode_tiles": 1}}


class SoakFailure(AssertionError):
    """A check found a difference: ``what`` was compared, ``where`` is the
    first place it differs, with the value found and the one wanted."""

    def __init__(self, what: str, where: str, got, want):
        self.what, self.where, self.got, self.want = what, where, got, want
        super().__init__(f"{what}: first difference at {where}: got {got}, want {want}")


@dataclass(frozen=True)
class Case:
    """One drawn case: a batch of ``B`` frames of ``H``×``W`` of ``content``
    (``maxd``: the shallow content's deepest tile; ``seed``: the content's),
    with an optional stream check ``(frames, writer batch, writer pipeline,
    reader batch, reader pipeline)`` and an optional mesh ``(n_data,
    n_tiles)``."""

    index: int
    regime: str
    B: int
    H: int
    W: int
    content: str
    maxd: int
    seed: int
    stream: tuple[int, int, int, int, int] | None = None
    mesh: tuple[int, int] | None = None

    def describe(self) -> str:
        h, w = tile_grid(self.W, self.H)
        text = (f"{self.regime}: {self.B}x{self.H}x{self.W} (T {h * w}, T mod 1024 "
                f"{h * w % 1024}, W mod 8 {self.W % 8}), {self.content}")
        if self.content in ("adversarial shallow", "uniform 8 but one frame"):
            text += f" maxd {self.maxd}"
        if self.stream:
            n, wb, wp, rb, rp = self.stream
            text += (f"; stream {n} frames, writer batch {wb} pipeline {wp}, "
                     f"reader batch {rb} pipeline {rp}")
        if self.mesh:
            text += f"; mesh {self.mesh[0]}x{self.mesh[1]}"
        return text


# -- the plan -------------------------------------------------------------------


def _width(rng: np.random.Generator, lo: int, hi: int, residue: int) -> int:
    """A width in [lo, hi] with ``W % 8 == residue``."""
    first, last = -(-(lo - residue) // 8), (hi - residue) // 8
    return 8 * int(rng.integers(first, last + 1)) + residue


def _seam_geometry(rng: np.random.Generator, rest: int, residue: int) -> tuple[int, int]:
    """(H, W) whose tile count T is ``rest`` mod 1024 (one to five blocks of
    1024 tiles), ragged at the bottom and, unless ``residue`` is 0, right."""
    T = 1024 * int(rng.integers(1, 5)) + rest
    h = int(rng.choice([d for d in range(1, 65) if T % d == 0]))
    return 8 * h - int(rng.integers(0, 8)), 8 * (T // h) - (8 - residue) % 8


def _draw(rng: np.random.Generator, i: int, residues: np.ndarray, k: int) -> Case:
    """Case ``i``; ``k`` counts the widths drawn at a residue so far."""
    regime = REGIMES[i % len(REGIMES)]
    first = i < len(REGIMES)
    content = CONTENTS[i % len(CONTENTS)] if first else str(rng.choice(CONTENTS))
    maxd = int(rng.integers(1, 6))
    seed = int(rng.integers(1 << 31))
    B = int(rng.integers(1, 17))
    residue = int(residues[k % 8])
    if regime == "one column":
        W, H = int(rng.integers(1, 8)), int(rng.integers(1, 8 if first else 601))
    elif regime == "narrow":
        W, H = _width(rng, 8, 64, residue), int(rng.integers(1, 601))
    elif regime == "medium":
        W, H = _width(rng, 65, 1024, residue), int(rng.integers(1, 601))
    elif regime == "wide":
        W, H = _width(rng, 1025, 4096, residue), int(rng.integers(1, 301))
    elif regime == "over 4096":
        W, H = _width(rng, 4097, 8192, residue), int(rng.integers(1, 301))
        B = int(rng.integers(1, 3))
    elif regime == CALLERS_STREAM:
        W, H = _width(rng, 8, 1024, residue), int(rng.integers(1, 601))
    elif regime.startswith("seam"):
        H, W = _seam_geometry(rng, int(regime.split()[1]), residue)
    else:
        B, H, W = {"16x2048x2048": (16, 2048, 2048), "2x4096x4096": (2, 4096, 4096),
                   PAST_2_31: (520, 2048, 2048)}[regime]
        if regime == PAST_2_31:
            content = DEVICE_CONTENT
    stream = mesh = None
    callers = regime == CALLERS_STREAM  # always a stream and a mesh
    if callers or regime in STREAM_REGIMES and (first or rng.random() < 0.5):
        H = min(H, max(1, STREAM_PIXELS // W))
        wb = int(rng.integers(1, 9))
        n = wb * int(rng.integers(1, 4)) + (int(rng.integers(1, wb)) if wb > 1 else 1)
        if first and not callers:
            wp, rp = 1 + STREAM_REGIMES.index(regime), 1 + (STREAM_REGIMES.index(regime) + 2) % 3
        else:
            wp, rp = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        stream = (n, wb, wp, int(rng.integers(1, 9)), rp)
    if callers or regime in SHARDED_REGIMES and (i > 0 if first else rng.random() < 0.5):
        n_data, n_tiles = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        if first and regime == "narrow":
            n_data = int(rng.integers(2, 5))
        if first and regime == "medium":
            n_tiles = int(rng.integers(2, 5))
        mesh = (n_data, n_tiles)
        unit = 8 * n_tiles  # whole bands of tile rows, the last one ragged
        H = unit * max(1, H // unit) - int(rng.integers(1, 8))
        while n_data > 1 and B % n_data == 0:
            B -= 1
    if content in UNIFORM:  # no single-pixel edge tiles: every tile can reach depth 8
        W += W % 8 == 1
        H += H % 8 == 1
    if content == "uniform 8 but one frame" and B == 1:
        B = 2 if mesh is None else mesh[0] + 1
    return Case(i, regime, B, H, W, content, maxd, seed, stream, mesh)


def plan(seed: int, n: int) -> list[Case]:
    """The first ``n`` cases of the plan for ``seed``."""
    rng = np.random.default_rng(seed)
    residues = rng.permutation(8)
    cases, k = [], 0
    for i in range(n):
        case = _draw(rng, i, residues, k)
        # the next residue once this one is drawn (uniform content moves W % 8 off 1)
        k += case.W % 8 == residues[k % 8] and case.regime in RESIDUE_REGIMES
        cases.append(case)
    return cases


# -- content ----------------------------------------------------------------------


def make_frames(case: Case, B: int | None = None) -> np.ndarray:
    """The case's (B, H, W) u8 frames on the host, from its seed."""
    B = case.B if B is None else B
    H, W, seed = case.H, case.W, case.seed
    rng = np.random.default_rng(seed)
    if case.content == "adversarial shallow":
        return make_adversarial(W, H, B, maxd=case.maxd, seed=seed)
    if case.content == "adversarial 8":
        return make_adversarial(W, H, B, maxd=8, seed=seed)
    if case.content == "flat":  # every tile depth 0: n64 is 0
        return np.repeat(rng.integers(0, 256, (B, 1, 1), dtype=np.uint8), H * W, 1).reshape(B, H, W)
    frames = make_uniform8(W, H, B, seed=seed)
    f = int(rng.integers(B))
    if case.content == "uniform 8 but one tile":
        h, w = tile_grid(W, H)
        ty, tx = int(rng.integers(h)), int(rng.integers(w))
        frames[f, 8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8] = rng.integers(0, 256)
    elif case.content == "uniform 8 but one frame":
        frames[f] = make_adversarial(W, H, 1, maxd=case.maxd, seed=seed + 1)[0]
    return frames


def device_frames(case: Case, device: torch.device, uniform: bool) -> torch.Tensor:
    """The case's frames made on ``device`` with a seeded ``torch.Generator``:
    random bytes, every tile depth 8 where ``uniform`` (each tile's extremes
    pinned as ``make_uniform8`` pins them), else masked to a random depth
    0–8 a tile row."""
    B, H, W = case.B, case.H, case.W
    g = torch.Generator(device=device)
    g.manual_seed(case.seed)
    x = torch.randint(0, 256, (B, H, W), dtype=torch.uint8, device=device, generator=g)
    if uniform:
        x[:, 0::8, 0::4] = 0
        x[:, 1::8, 1::4] = 255
        return x
    depth = torch.randint(0, 9, (B, -(-H // 8), 1), device=device, generator=g)
    mask = ((torch.ones_like(depth) << depth) - 1).to(torch.uint8)
    mask = mask.repeat_interleave(8, dim=1)[:, :H]
    return x.bitwise_and_(mask)


# -- comparisons ----------------------------------------------------------------


def _comparable(a) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    return t.view(torch.int32) if t.dtype == torch.uint32 else t  # torch compares no uint32


def _value(t: torch.Tensor, idx) -> int:
    v = int(t[idx])
    return v & 0xFFFFFFFF if t.dtype == torch.int32 and v < 0 else v


def expect_equal(what: str, got, want, unit: str, live=None) -> None:
    """Raise :class:`SoakFailure` at the first element where ``got`` and
    ``want`` (tensors or arrays of one shape, frame first) differ, naming
    the frame and the ``unit`` (word, tile, pixel).  ``live``, a (B,)
    count, limits each frame's row to its first ``live[b]`` elements."""
    g = _comparable(got)
    w = _comparable(want).to(g.device)
    if g.shape != w.shape:
        raise SoakFailure(what, "the shape", tuple(g.shape), tuple(w.shape))
    if live is None and torch.equal(g, w):
        return
    ne = g != w
    if live is not None:
        live = torch.as_tensor(np.asarray(live) if not isinstance(live, torch.Tensor) else live)
        ne &= torch.arange(g.shape[1], device=g.device) < live.to(g.device)[:, None]
    if not bool(ne.any()):
        return
    idx = tuple(int(i) for i in np.unravel_index(int(torch.argmax(ne.reshape(-1).to(torch.uint8))),
                                                 tuple(ne.shape)))
    if len(idx) == 1:
        where = f"{unit} {idx[0]}"
    elif len(idx) == 2:
        where = f"frame {idx[0]}, {unit} {idx[1]}"
    else:
        where = f"frame {idx[0]}, {unit} {idx[1:]}"
    raise SoakFailure(what, where, _value(g, idx), _value(w, idx))


def expect_bytes(what: str, got: bytes, want: bytes) -> None:
    """Raise :class:`SoakFailure` at the first byte where ``got`` and
    ``want`` differ (or where the shorter ends)."""
    if got == want:
        return
    n = min(len(got), len(want))
    ne = np.frombuffer(got, np.uint8, n) != np.frombuffer(want, np.uint8, n)
    if ne.any():
        i = int(np.argmax(ne))
        raise SoakFailure(what, f"byte {i}", hex(got[i]), hex(want[i]))
    raise SoakFailure(what, f"byte {n} (the end of the shorter)", len(got), len(want))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _sentinels(B: int, S: int, device) -> torch.Tensor:
    return torch.from_numpy(np.full((B, S), SENTINEL, np.uint32)).to(device)


def _garbage_after(payload: np.ndarray, n64: np.ndarray, S: int, rng) -> np.ndarray:
    """(B, S) u32: each frame's stream (``2*n64`` words of ``payload``), then
    random words."""
    out = rng.integers(0, 1 << 32, (payload.shape[0], S), dtype=np.uint32)
    for b, n in enumerate(n64):
        out[b, : 2 * n] = payload[b, : 2 * n]
    return out


def _off_grid(p: torch.Tensor, S: int) -> torch.Tensor:
    """``p`` (B, ≤ S) copied into rows of stride ``S`` that start one word
    past a 16-byte boundary, the rest of each row zero."""
    B = p.shape[0]
    buf = torch.zeros((B * S + 1,), dtype=torch.int32, device=p.device)
    buf[1:].view(B, S)[:, : p.shape[1]].copy_(p.view(torch.int32))
    return buf.view(torch.uint32)[1:].view(B, S)


def records(depths: np.ndarray, mins: np.ndarray, payload: np.ndarray,
            n64: np.ndarray) -> list[bytes]:
    """Each frame's record (20-byte header at index b, then the frame data
    of dbde_util.cpp:137-180), built from host arrays with ``struct``
    alone: the soak's expectation for ``codec.pack_frames_bytes``."""
    T = depths.shape[1]
    count = struct.pack("<i", T)
    return [FrameHeader(index=b).pack() + count + depths[b].tobytes() + count + mins[b].tobytes()
            + struct.pack("<i", int(n)) + payload[b, : 2 * int(n)].tobytes()
            for b, n in enumerate(n64)]


def oracle_bytes(frame: np.ndarray) -> tuple[bytes, bool]:
    """``ref_numpy.pack_image`` of ``frame``, or of its first
    :data:`ORACLE_TILE_ROWS` tile rows where it is over
    :data:`ORACLE_BYTES` (ref_numpy takes about 10 µs a tile); and whether
    that was the whole frame."""
    whole = frame.size <= ORACLE_BYTES
    return ref_numpy.pack_image(frame if whole else frame[: 8 * ORACLE_TILE_ROWS]), whole


def check_oracle(what: str, frame: np.ndarray, record: bytes) -> None:
    """One frame's record (header and data) against ``ref_numpy``: byte for
    byte where :func:`oracle_bytes` took the whole frame, else its depths,
    minima and payload words in the first tile rows."""
    blob, whole = oracle_bytes(frame)
    if whole:
        expect_bytes(f"{what} vs ref_numpy.pack_image", record[20:], blob)
        return
    H, W = frame.shape
    h, w = tile_grid(W, H)
    T, t = h * w, min(h, ORACLE_TILE_ROWS) * w
    data = record[20:]
    n = struct.unpack_from("<i", blob, 8 + 2 * t)[0]
    for name, got, want in (("depths", data[4:4 + t], blob[4:4 + t]),
                            ("minima", data[8 + T:8 + T + t], blob[8 + t:8 + 2 * t]),
                            ("payload", data[12 + 2 * T:12 + 2 * T + 8 * n], blob[12 + 2 * t:])):
        expect_bytes(f"{what} {name} of the first {ORACLE_TILE_ROWS} tile rows vs "
                     "ref_numpy.pack_image", got, want)


# -- one case ---------------------------------------------------------------------


class Tally:
    """The cases the soak ran, counted by regime, content, W % 8, backend
    and route, and where the current case is (backend and route), for the
    failure report."""

    def __init__(self):
        self.counts = collections.defaultdict(collections.Counter)
        self.backend = self.route = "-"
        self.seen: set[tuple[str, str]] = set()  # the current case's (backend, route)

    def at(self, backend: str, route: str) -> None:
        self.backend, self.route = backend, route
        self.seen.add((backend, route))

    def count(self, case: Case) -> None:
        """Count a case that passed, with the backends and routes it ran."""
        for key, value in (("regime", case.regime), ("content", case.content),
                           ("W mod 8", case.W % 8)):
            self.counts[key][value] += 1
        self.counts["backend"].update({backend for backend, _ in self.seen})
        self.counts["route"].update(f"{backend}: {route}" for backend, route in self.seen)
        self.seen.clear()


def _launches(device, fn, want: dict, what: str):
    """``fn()``, whose kernel launches on a CUDA device must be ``want``
    (the plain versions on the CPU launch nothing)."""
    before = dict(band.LAUNCHES)
    out = fn()
    got = {k: v - before[k] for k, v in band.LAUNCHES.items() if v != before[k]}
    if device.type == "cuda" and got != want:
        raise SoakFailure(f"{what}: kernel launches", "the launch counts", got, want)
    return out


@dataclass
class Plain:
    """The plain versions' results for a batch (host arrays)."""

    depths: np.ndarray
    mins: np.ndarray
    payload: np.ndarray  # (B, 16*T) u32, sentinels past each frame's stream
    n64: np.ndarray


def check_kernels(x: torch.Tensor, tally: Tally, rng) -> Plain:
    """K1–K7 against their plain versions on the tensors ``x`` (B, H, W) u8
    on the case's device, into sentinel-filled outputs, and the decodes
    against ``x``.  Returns the plain versions' results."""
    B, H, W = x.shape
    dev = x.device
    h, w = tile_grid(W, H)
    T, S = h * w, h * w * MAX_WORDS_PER_TILE
    tally.at("K1-K7", "each against its plain version")
    flag, flag_p = (torch.full((1,), -1, dtype=torch.int32, device=dev) for _ in range(2))
    d, m = band.encode_depths(x, flag)
    dp, mp = band.encode_depths_plain(x, flag_p)
    expect_equal("K1 depths vs plain", d, dp, "tile")
    expect_equal("K1 minima vs plain", m, mp, "tile")
    expect_equal("K1 batch flag vs plain", flag, flag_p, "flag")
    for stride in (S + 1, S):  # rows 4, 8 and 12 bytes off the 16-byte grid; aligned rows
        pk, nk = band.encode_payload(x, d, m, out=_sentinels(B, stride, dev))
        pp, np_ = band.encode_payload_plain(x, d, m, out=_sentinels(B, stride, dev))
        expect_equal(f"K2 payload at stride {stride} vs plain", pk, pp, "word")
        expect_equal(f"K2 n64 at stride {stride} vs plain", nk, np_, "frame")
        out_k = band.decode_frames(d, m, pk, H, W)
        expect_equal(f"K3 frames from stride {stride} vs plain", out_k,
                     band.decode_frames_plain(d, m, pk, H, W), "pixel")
        expect_equal(f"K3 frames from stride {stride}", out_k, x, "pixel")
    plain = Plain(_host(dp), _host(mp), _host(pp), _host(np_))  # at the aligned stride
    # the reader's case: a short stride with garbage after each frame's stream
    S_short = max(1, 2 * int(plain.n64.max(initial=0))) + 3
    short = torch.from_numpy(_garbage_after(plain.payload, plain.n64, S_short, rng)).to(dev)
    out_k = band.decode_frames(d, m, short, H, W)
    expect_equal("K3 frames from a short stride vs plain", out_k,
                 band.decode_frames_plain(d, m, short, H, W), "pixel")
    expect_equal("K3 frames from a short stride", out_k, x, "pixel")
    for stride in (S, S + 3):  # 16-byte payload moves; word moves
        n4, n4p = (torch.full((B,), -7, dtype=torch.int32, device=dev) for _ in range(2))
        pk4 = band.encode_payload_u8(x, m, out=_sentinels(B, stride, dev), n64=n4)
        pp4 = band.encode_payload_u8_plain(x, m, out=_sentinels(B, stride, dev), n64=n4p)
        expect_equal(f"K4 payload at stride {stride} vs plain", pk4, pp4, "word")
        expect_equal(f"K4 n64 at stride {stride} vs plain", n4, n4p, "frame")
        out_k = band.decode_frames_u8(m, pk4, H, W)
        expect_equal(f"K5 frames from stride {stride} vs plain", out_k,
                     band.decode_frames_u8_plain(m, pk4, H, W), "pixel")
        expect_equal(f"K5 frames from stride {stride}", out_k, x, "pixel")
    tw = tile_layout.image_to_tiles_w(x)
    tw_off = torch.empty(tw.numel() + 1, dtype=torch.uint32, device=dev)[1:].view(tw.shape)
    tw_off.copy_(tw)  # 4 bytes off the 8-byte grid: K6's word loads
    p6 = tile_layout.encode_tiles_plain(tw, T, out=_sentinels(B, S, dev))
    for label, src in (("aligned", tw), ("off the 8-byte grid", tw_off)):
        k6 = tile_layout.encode_tiles(src, T, out=_sentinels(B, S, dev))
        for name, a, b_, unit in zip(("depths", "minima", "payload", "n64"), k6, p6,
                                     ("tile", "tile", "word", "frame")):
            expect_equal(f"K6 {name} from tiles_W {label} vs plain", a, b_, unit)
    d6, m6, pay6, _ = k6
    expect_equal("K6 payload vs K2's", pay6, pp, "word")
    for label, src in (("its stream", pay6), ("a short stride", short)):
        tk = tile_layout.decode_tiles(d6, m6, src)
        expect_equal(f"K7 tiles_W from {label} vs plain", tk,
                     tile_layout.decode_tiles_plain(d6, m6, src), "word")
        expect_equal(f"K7 frames from {label}", tile_layout.tiles_w_to_image(tk, H, W), x, "pixel")
    return plain


def check_codec(frames: np.ndarray, x: torch.Tensor, plain: Plain, tally: Tally, rng) -> None:
    """``DbdeCodec`` of both backends from the host frames: encode against
    the plain versions, the records against :func:`records` and the last
    frame against ``ref_numpy``, and decode by each route in
    :data:`ROUTES`, each equal to the frames with the launches it should
    make."""
    B, H, W = frames.shape
    dev = x.device
    T = plain.depths.shape[1]
    S = T * MAX_WORDS_PER_TILE
    n64 = plain.n64
    uniform = plain.depths.size > 0 and bool((plain.depths == 8).all())
    want_records = records(plain.depths, plain.mins, plain.payload, n64)
    mx = 2 * int(n64.max(initial=0))
    host_payload = _garbage_after(plain.payload, n64, max(1, mx) + int(rng.integers(0, 4)), rng)
    for backend in ROUTES:
        codec = DbdeCodec(H, W, device=dev, backend=backend)
        tally.at(backend, "encode from host frames")
        enc = _launches(dev, lambda: codec.encode(frames), ENCODE[backend], f"{backend} encode")
        expect_equal(f"{backend} encode depths vs plain", enc.depths, plain.depths, "tile")
        expect_equal(f"{backend} encode minima vs plain", enc.mins, plain.mins, "tile")
        expect_equal(f"{backend} encode n64 vs plain", enc.n64, n64, "frame")
        expect_equal(f"{backend} encode payload vs plain", enc.payload, plain.payload, "word",
                     live=2 * n64.astype(np.int64))
        got = pack_frames_bytes(enc)
        for b in range(B):
            expect_bytes(f"{backend} record bytes of frame {b} vs the plain versions' arrays",
                         got[b], want_records[b])
        check_oracle(f"{backend} record of frame {B - 1}", frames[-1], got[-1])

        routes = {"host depths": (lambda: (plain.depths, plain.mins, host_payload),
                                  {"decode_u8": 1} if uniform else {"decode": 1}),
                  "device depths, stride 16*T": (lambda: (enc.depths, enc.mins, enc.payload),
                                                 {"decode": 1, "decode_u8": 1}),
                  "rows off the 16-byte grid": (lambda: (enc.depths, enc.mins,
                                                         _off_grid(enc.payload, S + 1)),
                                                {"decode": 1, "decode_u8": 1})}
        if mx < S:  # a stride below 16*T, where the frames' streams allow it
            routes["device depths, narrow stride"] = (
                lambda: (enc.depths, enc.mins,
                         torch.from_numpy(_garbage_after(plain.payload, n64, max(1, mx),
                                                         rng)).to(dev)),
                {"decode": 1})
        for route in ROUTES[backend]:
            if route not in routes:
                continue
            args, want = routes[route]
            tally.at(backend, route)
            d, m, p = args()
            want = {"decode_tiles": 1} if backend == "tiles" else want
            out = _launches(dev, lambda: codec.decode(d, m, p), want, f"{backend} decode, {route}")
            expect_equal(f"{backend} decode, {route}", out, frames, "pixel")


def check_stream(case: Case, device: torch.device, tally: Tally) -> None:
    """``DbdeWriter`` at the case's pipeline, the caller overwriting its
    frames right after each ``write()``; the file equal to
    ``ref_numpy.encode_video``; ``DbdeReader`` at the case's pipeline reads
    it back exact."""
    n, wb, wp, rb, rp = case.stream
    tally.at("stream", f"writer pipeline {wp}, reader pipeline {rp}")
    frames = make_frames(case, B=n)
    buf = np.empty((wb,) + frames.shape[1:], np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "soak.dbde")
        with DbdeWriter(path, case.H, case.W, frame_hz=30.0, device=device, pipeline=wp) as wr:
            for i in range(0, n, wb):
                k = min(wb, n - i)
                buf[:k] = frames[i:i + k]
                wr.write(buf[:k])
                np.bitwise_not(buf[:k], out=buf[:k])  # the caller reuses its buffer at once
        with open(path, "rb") as f:
            expect_bytes("DbdeWriter file vs ref_numpy.encode_video", f.read(),
                         ref_numpy.encode_video(list(frames), frame_hz=30.0))
        with DbdeReader(path, batch_size=rb, device=device, pipeline=rp) as rd:
            headers, out = rd.read_all()
    expect_equal("DbdeReader frames", out, frames, "pixel")
    if [h.index for h in headers] != list(range(n)):
        raise SoakFailure("DbdeReader frame indices", "the index list",
                          [h.index for h in headers], list(range(n)))


@contextlib.contextmanager
def callers_streams(devices, sleep_cycles: int = SLEEP_CYCLES):
    """Make a new stream current on each CUDA device of ``devices``, with a
    device sleep of ``sleep_cycles`` at its head, for the block: a
    caller's streams, behind which what the block enqueues stays pending
    for a while.  Nothing on the CPU."""
    with contextlib.ExitStack() as stack:
        for dev in dict.fromkeys(d for d in devices if d.type == "cuda"):
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
            with torch.cuda.device(dev):
                torch.cuda._sleep(sleep_cycles)
        yield


def next_switching_streams(iterable, devices, sleep_cycles: int = SLEEP_CYCLES) -> list:
    """Every item of ``iterable``, each ``next()`` in turn under new
    :func:`callers_streams` of ``devices`` and under the streams current
    before: a batch dispatched on one stream is read back on the other."""
    it, items = iter(iterable), []
    for i in itertools.count():
        with callers_streams(devices, sleep_cycles) if i % 2 == 0 else contextlib.nullcontext():
            item = next(it, None)
        if item is None:
            return items
        items.append(item)


def check_callers_stream(case: Case, device: torch.device, tally: Tally) -> None:
    """The case's writer, an encode and a ``decode_dispatch`` of its first
    batch under the caller's streams (:func:`callers_streams`), read back
    on the streams current before (the decode with the event recorded
    after its dispatch): the file equal to ``ref_numpy.encode_video``, the
    batch's records to its first records, the decode to its frames.  Then
    ``DbdeReader`` and ``iter_video_sharded`` on the case's mesh read the
    file back exact, each ``next()`` on the other streams than the last
    (:func:`next_switching_streams`)."""
    n, wb, wp, rb, rp = case.stream
    n_data, n_tiles = case.mesh
    tally.at("caller's stream", f"writer pipeline {wp}, reader pipeline {rp}, "
                                f"mesh {n_data}x{n_tiles}")
    frames = make_frames(case, B=n)
    mesh = make_mesh(n_data, n_tiles,
                     devices=mesh_slots(n_data * n_tiles, visible_devices(device)))
    want = ref_numpy.encode_video(list(frames), frame_hz=30.0)
    codec = DbdeCodec(case.H, case.W, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "callers.dbde")
        with callers_streams([device]):
            with DbdeWriter(path, case.H, case.W, frame_hz=30.0, device=device,
                            pipeline=wp) as wr:
                for i in range(0, n, wb):
                    wr.write(frames[i:i + wb])
            enc = codec.encode(frames[:wb])
            pending = codec.decode_dispatch(enc.depths, enc.mins, enc.payload)
            done = record_event(device)
        expect_equal("decode under the caller's stream, materialized after its event",
                     codec.materialize(pending, after=done), frames[:wb], "pixel")
        first = len(ref_numpy.encode_video(list(frames[:wb]), frame_hz=30.0))
        expect_bytes("records of an encode under the caller's stream vs the oracle's",
                     b"".join(pack_frames_bytes(enc)), want[VIDEO_HEADER_BYTES:first])
        with open(path, "rb") as f:
            expect_bytes("DbdeWriter file under the caller's stream vs ref_numpy.encode_video",
                         f.read(), want)
        with DbdeReader(path, batch_size=rb, device=device, pipeline=rp) as rd:
            batches = next_switching_streams(rd, [device])
        expect_equal("DbdeReader frames, next() on switching streams",
                     np.concatenate([b for _, b in batches]), frames, "pixel")
        batches = next_switching_streams(
            iter_video_sharded(path, mesh, batch_size=rb, pipeline=rp), list(mesh.devices.flat))
    expect_equal("iter_video_sharded frames, next() on switching streams",
                 np.concatenate([b for _, b in batches]), frames, "pixel")


def check_sharded(case: Case, frames: np.ndarray, plain: Plain, device: torch.device,
                  tally: Tally) -> None:
    """The sharded path on the case's mesh, laid over every visible device
    of ``device``'s type (``mesh_slots``): the
    batch padded to whole data shards with repeats of its last frame (as
    ``write_video_sharded`` pads), ``encode_sharded`` →
    ``assemble_payload_host`` equal to the single-device arrays,
    ``decode_sharded`` and ``sharded_roundtrip_step`` exact with the
    single-device n64, and ``write_video_sharded`` of the unpadded batch
    equal to the records, read back exact by ``read_video_sharded``."""
    n_data, n_tiles = case.mesh
    B, H, W = frames.shape
    tally.at("sharded", f"mesh {n_data}x{n_tiles}")
    mesh = make_mesh(n_data, n_tiles,
                     devices=mesh_slots(n_data * n_tiles, visible_devices(device)))
    pad = -B % n_data
    padded = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
    depths, mins, segments, totals, _, Hp = encode_sharded(padded, mesh)
    expect_equal("encode_sharded depths vs plain", depths[:B], plain.depths, "tile")
    expect_equal("encode_sharded minima vs plain", mins[:B], plain.mins, "tile")
    flat = assemble_payload_host(segments, totals)
    for b in range(B):
        expect_equal(f"assemble_payload_host frame {b} vs plain", flat[b][None],
                     plain.payload[b:b + 1, : 2 * int(plain.n64[b])], "word")
    expect_equal("decode_sharded", decode_sharded(depths, mins, segments, mesh, H, W, Hp),
                 padded, "pixel")
    out, n64 = sharded_roundtrip_step(padded, mesh)
    expect_equal("sharded_roundtrip_step frames", out, padded, "pixel")
    want = int(plain.n64.astype(np.int64).sum()) + pad * int(plain.n64[-1])
    if n64 != want:
        raise SoakFailure("sharded_roundtrip_step n64 vs the single-device n64", "the sum",
                          n64, want)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.dbde")
        write_video_sharded(path, frames, mesh, batch_size=B)
        with open(path, "rb") as f:
            expect_bytes("write_video_sharded file vs the records", f.read(),
                         VideoHeader(height=H, width=W, frame_hz=1.0).pack()
                         + b"".join(records(plain.depths, plain.mins, plain.payload, plain.n64)))
        _, _, back = read_video_sharded(path, mesh, batch_size=B)
    expect_equal("read_video_sharded frames", back, frames, "pixel")


def check_past_2_31(case: Case, device: torch.device, tally: Tally, rng) -> None:
    """A batch whose frames are over 2**31 bytes in all, made on the device,
    mixed and then all depth 8: ``DbdeCodec`` of both backends against the
    same frames encoded in sub-batches of 16, decode exact by the device-
    and host-depth routes, the last frame's first tile rows against
    ``ref_numpy``, and the last sub-batch's kernels against their plain
    versions."""
    B, H, W = case.B, case.H, case.W
    for uniform in (False, True):
        kind = "all depth 8" if uniform else "mixed"
        x = device_frames(case, device, uniform)
        codec = DbdeCodec(H, W, device=device)
        tally.at("band", f"encode {B} frames, {kind}")
        enc = _launches(device, lambda: codec.encode(x), ENCODE["band"], "band encode")
        for s in range(0, B, 16):
            sub = codec.encode(x[s:s + 16])
            label = f"band encode of {B} {kind} frames vs frames {s}.. encoded 16 at a time"
            expect_equal(f"{label}: depths", enc.depths[s:s + 16], sub.depths, "tile")
            expect_equal(f"{label}: minima", enc.mins[s:s + 16], sub.mins, "tile")
            expect_equal(f"{label}: n64", enc.n64[s:s + 16], sub.n64, "frame")
            expect_equal(f"{label}: payload", enc.payload[s:s + 16], sub.payload, "word",
                         live=2 * sub.n64.to(torch.int64))
        last = EncodedBatch(enc.depths[-1:], enc.mins[-1:], enc.payload[-1:], enc.n64[-1:])
        check_oracle(f"band record of frame {B - 1} ({kind})", _host(x[-1]),
                     pack_frames_bytes(last)[0])
        tally.at("band", "device depths, stride 16*T")
        out = _launches(device, lambda: codec.decode_dispatch(enc.depths, enc.mins, enc.payload),
                        {"decode": 1, "decode_u8": 1}, "band decode, device depths")
        expect_equal(f"band decode of {B} {kind} frames, device depths", out, x, "pixel")
        del out
        tally.at("band", "host depths")
        out = _launches(device, lambda: codec.decode_dispatch(_host(enc.depths), enc.mins,
                                                              enc.payload),
                        {"decode_u8": 1} if uniform else {"decode": 1}, "band decode, host depths")
        expect_equal(f"band decode of {B} {kind} frames, host depths", out, x, "pixel")
        del out
        tiles = DbdeCodec(H, W, device=device, backend="tiles")
        tally.at("tiles", f"encode {B} frames, {kind}")
        enc_t = _launches(device, lambda: tiles.encode(x), ENCODE["tiles"], "tiles encode")
        for name, a, b_, unit in (("depths", enc_t.depths, enc.depths, "tile"),
                                  ("minima", enc_t.mins, enc.mins, "tile"),
                                  ("n64", enc_t.n64, enc.n64, "frame")):
            expect_equal(f"tiles encode of {B} {kind} frames vs band: {name}", a, b_, unit)
        expect_equal(f"tiles encode of {B} {kind} frames vs band: payload", enc_t.payload,
                     enc.payload, "word", live=2 * enc.n64.to(torch.int64))
        del enc
        tally.at("tiles", "host depths")
        out = _launches(device, lambda: tiles.decode_dispatch(_host(enc_t.depths), enc_t.mins,
                                                              enc_t.payload),
                        {"decode_tiles": 1}, "tiles decode")
        expect_equal(f"tiles decode of {B} {kind} frames", out, x, "pixel")
        del out, enc_t
        check_kernels(x[-16:].contiguous(), tally, rng)
        del x
        if device.type == "cuda":
            torch.cuda.empty_cache()


def run_case(case: Case, device: torch.device, tally: Tally) -> None:
    """Every check of one case (see the module docstring), counted in
    ``tally`` once it passes; raises :class:`SoakFailure` at the first
    difference."""
    rng = np.random.default_rng(case.seed)
    if case.regime == PAST_2_31:
        check_past_2_31(case, device, tally, rng)
    else:
        frames = make_frames(case)
        x = torch.from_numpy(frames).to(device)
        plain = check_kernels(x, tally, rng)
        check_codec(frames, x, plain, tally, rng)
        if case.regime == CALLERS_STREAM:
            check_callers_stream(case, device, tally)
        else:
            if case.stream:
                check_stream(case, device, tally)
            if case.mesh:
                check_sharded(case, frames, plain, device, tally)
    tally.count(case)


# -- (c): the sharded step's device time ----------------------------------------


def check_sharded_step_time(device="cuda") -> dict:
    """``tools/tpu_sharded_check.py`` (c) on the port: on 8 2048² camera
    frames from the host, the device time of ``sharded_roundtrip_step`` on
    a 1×1 mesh must be at most :data:`STEP_TIME_LIMIT` times that of
    ``DbdeCodec.roundtrip`` (``utils/profiling.measure_device_seconds``:
    the union of the device's activities, copies included, so both sides
    pay the same copies from the same host frames).  A 2×2 mesh of the
    same card is measured beside them and not gated.  Both results must
    be the frames.  Raises without a CUDA device; returns the times in
    seconds and the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the sharded step's device time needs a CUDA device, not {dev}")
    card = card_name(dev.index)
    frames = make_content(2048, 2048, 8)
    codec = DbdeCodec(2048, 2048, device=dev)
    meshes = {"1x1": make_mesh(1, 1, devices=[dev]), "2x2": make_mesh(2, 2, devices=[dev] * 4)}
    out, n64 = codec.roundtrip(frames)
    expect_equal("DbdeCodec.roundtrip", out, frames, "pixel")
    for name, mesh in meshes.items():
        out, step_n64 = sharded_roundtrip_step(frames, mesh)
        expect_equal(f"sharded_roundtrip_step on the {name} mesh", out, frames, "pixel")
        if step_n64 != int(n64.astype(np.int64).sum()):
            raise SoakFailure(f"sharded_roundtrip_step n64 on the {name} mesh", "the sum",
                              step_n64, int(n64.astype(np.int64).sum()))
    cards = [dev.index]
    t = {name: measure_device_seconds(lambda: sharded_roundtrip_step(frames, mesh), cards=cards)
         for name, mesh in meshes.items()}
    t["single"] = measure_device_seconds(lambda: codec.roundtrip(frames), cards=cards)
    t["card"] = card
    return t


# -- (d): the sharded step on distinct cards ------------------------------------


def distinct_mesh_shape(count: int) -> tuple[int, int] | None:
    """Check (d)'s mesh for ``count`` visible cards, one slot a card: 2x2
    over four (the first four of more), 2x1 over two or three; None below
    two."""
    if count < 2:
        return None
    return (2, 2) if count >= 4 else (2, 1)


def check_distinct_cards() -> dict | None:
    """Check (d): ``sharded_roundtrip_step`` of 8 2048² camera frames from
    the host on a mesh with one slot a card
    (:func:`distinct_mesh_shape`), against ``DbdeCodec.roundtrip`` on
    cuda:0: the frames and n64 must be exact.  Measures each card's device
    busy time in the step and the step's span on the profiler's shared
    clock (``utils/profiling.measure_device_cards``), beside the single
    card's busy time and span in its round trip.  Returns None where fewer
    than two cards are visible (nothing to run on), else {"mesh", "cards":
    {index: busy s}, "span" s, "single" s, "single_span" s, "names":
    {index: card}}; the caller gates the cards' times
    (:data:`CARD_BUSY_LIMIT`)."""
    shape = distinct_mesh_shape(torch.cuda.device_count())
    if shape is None:
        return None
    cards = visible_devices("cuda")[: shape[0] * shape[1]]
    mesh = make_mesh(*shape, devices=cards)
    frames = make_content(2048, 2048, 8)
    codec = DbdeCodec(2048, 2048, device=cards[0])
    out, n64 = codec.roundtrip(frames)
    expect_equal("DbdeCodec.roundtrip on cuda:0", out, frames, "pixel")
    out, step_n64 = sharded_roundtrip_step(frames, mesh)
    expect_equal(f"sharded_roundtrip_step on {len(cards)} cards", out, frames, "pixel")
    if step_n64 != int(n64.astype(np.int64).sum()):
        raise SoakFailure(f"sharded_roundtrip_step n64 on {len(cards)} cards", "the sum",
                          step_n64, int(n64.astype(np.int64).sum()))
    busy, span = measure_device_cards(lambda: sharded_roundtrip_step(frames, mesh),
                                      [c.index for c in cards])
    single, single_span = measure_device_cards(lambda: codec.roundtrip(frames),
                                               [cards[0].index])
    return {"mesh": shape, "cards": busy, "span": span, "single": single[cards[0].index],
            "single_span": single_span, "names": {c.index: card_name(c.index) for c in cards}}


# -- main ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dbde_tpu_torch.soak", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cases", type=int, default=100, help="cases in the plan")
    p.add_argument("--seed", type=int, default=0, help="the plan's seed")
    p.add_argument("--seconds", type=float, help="start no case after this many seconds")
    p.add_argument("--case", type=int, help="run only this case of the plan")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cases = plan(args.seed, args.cases if args.case is None else args.case + 1)
    if args.case is not None:
        cases = cases[args.case:]
    tally = Tally()
    t0 = time.perf_counter()
    ran = 0
    for case in cases:
        if args.seconds is not None and time.perf_counter() - t0 > args.seconds:
            break
        t = time.perf_counter()
        try:
            run_case(case, device, tally)
        except Exception as exc:
            if not isinstance(exc, SoakFailure):
                traceback.print_exc()
            print(f"SOAK FAILED at case {case.index}, seed {args.seed}: {case.describe()}; "
                  f"backend {tally.backend}, route {tally.route}\n  {exc}\n  reproduce: "
                  f"python -m dbde_tpu_torch.soak --seed {args.seed} --case {case.index} "
                  f"--device {device.type}", flush=True)
            return 1
        ran += 1
        print(f"ok case {case.index}: {case.describe()} ({time.perf_counter() - t:.2f} s)",
              flush=True)
    seconds = time.perf_counter() - t0
    for key in ("regime", "content", "W mod 8", "backend", "route"):
        print(f"cases by {key}: " + ", ".join(f"{k} {v}" for k, v in sorted(
            tally.counts[key].items(), key=lambda kv: str(kv[0]))))
    print(f"{ran} cases in {seconds:.1f} s on {device}; torch's pinned-memory cache holds "
          f"{pinned_cache_bytes(device)} bytes", flush=True)
    if device.type == "cuda":
        try:
            t = check_sharded_step_time(device)
        except SoakFailure as exc:
            print(f"SOAK FAILED in the sharded step check (c): {exc}", flush=True)
            return 1
        ratio, ratio22 = t["1x1"] / t["single"], t["2x2"] / t["single"]
        print(f"sharded step check (c), 8x2048x2048 camera from host frames, device time: "
              f"sharded_roundtrip_step 1x1 mesh {t['1x1'] * 1e3:.4f} ms, DbdeCodec.roundtrip "
              f"{t['single'] * 1e3:.4f} ms, ratio {ratio:.3f} (limit {STEP_TIME_LIMIT}); "
              f"2x2 mesh {t['2x2'] * 1e3:.4f} ms, ratio {ratio22:.3f} (not gated) on {t['card']}",
              flush=True)
        if ratio > STEP_TIME_LIMIT:
            print(f"SOAK FAILED in the sharded step check (c): the 1x1 step's device time is "
                  f"{ratio:.3f}x the single-device round trip's, over {STEP_TIME_LIMIT}",
                  flush=True)
            return 1
        try:
            d = check_distinct_cards()
        except SoakFailure as exc:
            print(f"SOAK FAILED in the distinct-card check (d): {exc}", flush=True)
            return 1
        if d is None:
            print("sharded step check (d): needs two or more cards, 1 visible; not run",
                  flush=True)
        else:
            worst = max(d["cards"].values()) / d["single"]
            cards = ", ".join(f"cuda:{i} {t * 1e3:.4f} ms ({t / d['single']:.3f}x)"
                              for i, t in d["cards"].items())
            names = "; ".join(f"cuda:{i} {name}" for i, name in d["names"].items())
            print(f"sharded step check (d), 8x2048x2048 camera from host frames on a "
                  f"{d['mesh'][0]}x{d['mesh'][1]} mesh of distinct cards, frames and n64 exact; "
                  f"device busy per card: {cards} (limit {CARD_BUSY_LIMIT}x); step span "
                  f"{d['span'] * 1e3:.4f} ms on the profiler's clock; DbdeCodec.roundtrip on "
                  f"cuda:0 {d['single'] * 1e3:.4f} ms busy over a span of "
                  f"{d['single_span'] * 1e3:.4f} ms; on {names}", flush=True)
            if worst > CARD_BUSY_LIMIT:
                print(f"SOAK FAILED in the distinct-card check (d): a card was busy {worst:.3f}x "
                      f"the single card's round trip, over {CARD_BUSY_LIMIT}", flush=True)
                return 1
    print(f"SOAK OK ({ran} cases, seed {args.seed})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
