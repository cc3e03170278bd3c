#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's codec paths once on the visible NVIDIA GPUs.

    python3 chip_smoke.py        # from the repository root; needs CUDA and nvcc

One card is enough; with more visible, the kernels are held on each and
the sharded path lays its meshes over them (one slot a card where they
suffice).  Phases, one line each, in order:
  0  device: the card's name and power limit (nvidia-smi), torch and CUDA;
     each card's name and power limit, and with several cards whether each
     pair has peer access
  1  build: the CUDA kernels, compiled with nvcc from dbde_tpu_torch/csrc
     (one nvcc a source, in parallel), and the stream layer's native IO
     library (g++); the current device of the kernel library's own CUDA
     runtime under torch.cuda.device(i) for each card
  2  each kernel against its plain PyTorch version on the same CUDA
     tensors, exact equality, on cuda:0 at the flagship, narrow, ragged and
     block-seam geometries (on each further card at 16x2048², 8x2048x320
     and two block-seam geometries): K1 encode_depths, K2 encode_payload, K3
     decode, the uniform depth-8 pair K4 encode_payload_u8 and K5
     decode_u8, and the tiles backend's K6 encode_tiles and K7
     decode_tiles.  K1's batch flag ("mixed": some tile not depth 8) must
     be its plain version's; K2 to K5 pass their gate cases (launched alone
     with the flag set against them, into sentinel-filled outputs, they
     write nothing; with it set for them they equal their plain versions,
     K4 writing n64 = 8*T); DbdeCodec.encode, where K1's flag picks K2 or
     K4 on the card, gives K2's stream.  K2, K4 and K6 must leave every
     word past their own untouched; K2's n64 must be the scan's
     (word_offsets), also into rows
     off the 16-byte grid (stride 16*T + 1); K3, K5 and K7 must decode from
     payloads with garbage after each frame's stream, K3 also from those
     rows; where every tile is depth 8 K4's payload must equal K2's; K6's
     depths, minima, n64 and stream must equal K1's and K2's, from an
     aligned tiles_W and one 4 bytes off the 8-byte grid (K6's word loads);
     then K6 50 times on 16 2048² camera and 16 random frames, each result
     equal to the first and to the plain version's
  3  the main path: write_video then read_video of 64 2048² camera frames
     and 16 2048² random frames (every tile depth 8) in batches of 16,
     bit-exact, first records byte-equal to the numpy oracle, each batch's
     encode launching K1, K2 and K4 (one of K2, K4 writing, chosen on the
     card) and its decode K3, or K5 for the random batch; then
     DbdeWriter/DbdeReader at pipeline 2, 1, 1, 2 on the same frames
     (files equal, reads bit-exact, frames/s each)
  3b the tiles backend: DbdeCodec(backend="tiles") encode → record bytes →
     parse → decode of 16 2048² camera and 16 random frames, bit-exact,
     records equal to the band backend's and the first to the numpy
     oracle's, one K6 and one K7 a batch
  3c the sync check: behind a device sleep of about a second, under
     torch.cuda.set_sync_debug_mode("error") and a log of every copy
     between host and device, DbdeCodec.encode of camera, all-depth-8
     and mixed batches, decode_dispatch from a DbdeReader's pooled slots
     and two DbdeWriter.write at pipeline 2 raise nothing, return while the
     device still sleeps, and copy only non_blocking from or into pinned
     memory; a blocking .to(device) of a pageable array does raise; the
     results equal K2's stream, the frames and the codec's records; then
     the stream switch: an encode and a decode_dispatch under the caller's
     stream behind a device sleep, read back on the default stream (the
     decode after its dispatch's event), equal to the frames and to the
     codec's records on the default stream, and DbdeReader and iter_video_sharded (2x2 mesh slots) with
     each next() in turn under the caller's streams and the default ones,
     the frames exact
  4  timing with CUDA events: each kernel and the encode/decode paths of
     both backends against their plain versions at 16×2048² camera and
     random content, each kernel beside its bound; K2 on the random
     content (every tile depth 8) beside K4, for the same bytes; K2 and K3
     at 16×2048×2536 and 2×4096² camera beside their bounds, with the
     bytes their blocks read from L2 to sum the frame's earlier depths;
     then the band and tiles paths side by side at 8×2048×W camera, W ∈
     {320, 256, 192, 128}
  5  the sharded path (dbde_tpu_torch.parallel) on meshes laid over the
     visible cards in turn (parallel.mesh_slots: over four cards each slot
     has its own, on one card every slot is that card): a 2×2 mesh writes 32 camera, 16 random and 1 camera
     2048² frames with write_video_sharded (batch 16; the last batch pads
     the data axis) and walks them back with iter_video_sharded, the file
     equal to write_video's byte for byte and each shard's launches as the
     oracle's depths predict; a 1×4 mesh encodes 4 camera 1081×1920 frames
     (34 tile rows a band) to the numpy oracle's bytes and decodes them;
     sharded_roundtrip_step on the 2×2 mesh with the single-device n64;
     graft_entry.dryrun_multichip(8) and graft_entry.entry(); the sharded
     and single-device write and read times, and the shard encodes through
     DbdeCodec.encode beside K1 + K2 alone; with two or more cards, the
     sharded write and read frames/s on meshes of 1, 2 and 4 distinct cards
     (1x1, 2x1, 4x1, 2x2) beside write_video/read_video, in turns
  6  the CLI on the card, driven in-process through dbde_tpu_torch.cli.main:
     golden (3 frames), info --scan and decode against GOLDEN_8x16_IMAGE;
     at the five geometries of tools/tpu_quickcheck.py (2048² camera and
     random, 3072×64 camera, 2536×2048 camera, 1024×64 flat; two frames
     each) encode (the file equal to the numpy oracle's), decode (equal to
     the raw input) and roundtrip, each command's launches as the content
     predicts; decode --pgm-dir and preview (one frame's decode) on the
     3072×64 file; `python -m dbde_tpu_torch.cli info` as a subprocess
     that imports no jax (on another core meanwhile); then bench in its
     six modes at its defaults (8 frames of 2048²; --stream and --composed
     at 64 frames), each JSON line beside the card's name and power limit,
     and python -m dbde_tpu_torch.bench (bench.py's keys).  The phase
     first starts torch.profiler once, timed on its own, so that the first
     bench does not pay for it
  7  the randomized soak: python -m dbde_tpu_torch.soak --seed 0 --seconds 60
     in a fresh interpreter that imports no jax, every case exact (random
     geometries and contents, both backends, every decode route, the block
     seams, a batch past 2**31 bytes, the stream layer and the sharded
     path), then the sharded round-trip step's device time on a 1x1 mesh
     within 1.15x DbdeCodec.roundtrip's (tools/tpu_sharded_check.py (c)),
     then check (d): with two or more cards, the step on a mesh of distinct
     cards exact and no card busier than the single card's round trip (one
     card: a line saying it needs two); its summary lines are printed
  8  the program's spans (dbde_tpu_torch.trace), in a fresh interpreter:
     DbdeWriter and DbdeReader at pipeline 2 on cuda:0, then
     write_video_sharded and iter_video_sharded on a 2x2 mesh laid over the
     visible cards, each under torch.profiler after one unprofiled pass,
     272 2048² frames (camera, then random), batch 16, files equal to
     write_video's, reads exact; per program span under the write and the
     read roots, its calls, total and self ms a batch and the device idle
     ms under it (the innermost program span open in each gap,
     utils/profiling.idle_by_span), and each counter a batch

Any failure raises, so the script exits non-zero without the final line.
Phase 5's and phase 6's launch counts are lines of their own; then a line
lists the kernels as JSON (launches from phases 3 and 3b); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import filecmp
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from dbde_tpu_torch import (DbdeReader, DbdeWriter, cli, graft_entry, read_video, ref_numpy,
                            write_video)
from dbde_tpu_torch import bench as port_bench
from dbde_tpu_torch import trace
from dbde_tpu_torch.bench_core import make_adversarial, make_content, make_depth_runs
from dbde_tpu_torch.codec import (
    DbdeCodec,
    EncodedBatch,
    all_depth8,
    pack_frames_bytes,
    pinned_cache_bytes,
    record_event,
    unpack_frames_bytes,
)
from dbde_tpu_torch.format import VIDEO_HEADER_BYTES, tile_grid
from dbde_tpu_torch.golden_vectors import GOLDEN_8x16_IMAGE, README_10x10_IMAGE
from dbde_tpu_torch.native import binding as native_binding
from dbde_tpu_torch.ops import band, tile_layout
from dbde_tpu_torch.ops.build import build
from dbde_tpu_torch.ops.build import load as build_load
from dbde_tpu_torch.ops.payload import word_offsets
from dbde_tpu_torch.stream import _GatedPool
from dbde_tpu_torch.parallel import (
    assemble_payload_host,
    decode_sharded,
    encode_sharded,
    iter_video_sharded,
    make_mesh,
    mesh_slots,
    sharded_roundtrip_step,
    visible_devices,
    write_video_sharded,
)
from dbde_tpu_torch.golden_vectors import GOLDEN_8x16_FILE
from dbde_tpu_torch.soak import callers_streams, next_switching_streams
from dbde_tpu_torch.utils.profiling import (PROFILE_SESSIONS, card_name, cuda_event_seconds,
                                            device_intervals, idle_by_span,
                                            measure_device_seconds)
from dbde_tpu_torch.utils.visualize import read_pgm

BAND_SOURCE = "dbde_tpu_torch/csrc/dbde_kernels.cu"
TILES_SOURCE = "dbde_tpu_torch/csrc/dbde_tiles.cu"
# (kernel, LAUNCHES key, source, the TPU kernel it replaces, phase-4 content)
KERNELS = (
    ("dbde_encode_depths", "encode_depths", BAND_SOURCE, "dbde_tpu/ops/pallas_band.py:370", "camera"),
    ("dbde_encode_payload", "encode_payload", BAND_SOURCE, "dbde_tpu/ops/pallas_band.py:419", "camera"),
    ("dbde_decode", "decode", BAND_SOURCE, "dbde_tpu/ops/pallas_band.py:1308", "camera"),
    ("dbde_encode_payload_u8", "encode_payload_u8", BAND_SOURCE,
     "dbde_tpu/ops/pallas_band.py:1017", "random"),
    ("dbde_decode_u8", "decode_u8", BAND_SOURCE, "dbde_tpu/ops/pallas_band.py:1182", "random"),
    ("dbde_encode_tiles", "encode_tiles", TILES_SOURCE, "dbde_tpu/ops/pallas_kernels.py:79", "camera"),
    ("dbde_decode_tiles", "decode_tiles", TILES_SOURCE, "dbde_tpu/ops/pallas_kernels.py:189", "camera"),
)
SENTINEL = 0xDEADBEEF
TOLERANCE = 0  # the codec is integer-valued: kernels and plain versions agree exactly

# The card's peaks for the bound (NVIDIA H100 SXM data sheet): HBM3 at
# 3.35 TB/s; 32-bit integer operations at half the 67 TFLOP/s of fp32 outside
# the tensor cores, since a Hopper SM issues 64 INT32 lanes a clock to 128
# FP32.  The kernels' arithmetic is integer shifts, masks, adds and min/max.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
# least integer operations a tile: depth and minimum (extract, min, max of
# 64 pixels), bit-pack and unpack (shift, or, mask of 64 residuals), the
# uniform pair's bytewise subtract/add of 16 words
OPS_DEPTH_MIN, OPS_PACK, OPS_UNPACK, OPS_BYTEWISE = 256, 192, 256, 96


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:  # no uint32 arithmetic in torch: compare the bits
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((_i64(a) - _i64(b)).abs().max()) if a.numel() else 0


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _sentinels(B: int, S: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.full((B, S), SENTINEL, np.uint32)).to(device)


def _flag(value: int, device: torch.device) -> torch.Tensor:
    """A batch flag ("mixed": nonzero iff some tile is not depth 8) set by hand."""
    return torch.full((1,), value, dtype=torch.int32, device=device)


def check_gates(label: str, x: torch.Tensor, d: torch.Tensor, m: torch.Tensor,
                pk: torch.Tensor, pk4: torch.Tensor) -> dict[str, int]:
    """Phase 2, the gates of K2, K3, K4 and K5 on frames ``x`` with K1's
    depths and minima and K2's and K4's payloads.  Each gated kernel is
    launched alone, into an output filled with sentinels, with the batch
    flag set against it: every sentinel must stay (K2 and K4 also leave
    n64).  Launched with the flag set for it, it must equal its plain
    version with the same flag (K4 also writing n64 = 8*T).  Bytes cannot
    show which kernel of a pair ran, since K2 writes K4's words on an
    all-depth-8 batch: this can.  Returns |kernel - plain| per kernel."""
    B, H, W = x.shape
    T = d.shape[1]
    dev = x.device
    on, off = _flag(1, dev), _flag(0, dev)  # selects K2/K3, selects K4/K5
    no_n64 = torch.full((B,), -7, dtype=torch.int32, device=dev)
    fill = torch.full((B, H, W), 0xA5, dtype=torch.uint8, device=dev)
    against = {
        "encode_payload": lambda o, n: band.encode_payload(x, d, m, out=o, n64=n, mixed=off),
        "encode_payload_u8": lambda o, n: band.encode_payload_u8(x, m, out=o, n64=n, mixed=on),
    }
    for key, fn in against.items():
        out, n64 = _sentinels(B, 16 * T, dev), no_n64.clone()
        fn(out, n64)
        _sync(dev)
        _require(bool((out.cpu().numpy() == SENTINEL).all()) and torch.equal(n64, no_n64),
                 f"{label}: {key} wrote with the flag set against it")
    for key, fn in (("decode", lambda o: band.decode_frames(d, m, pk, H, W, out=o, mixed=off)),
                    ("decode_u8", lambda o: band.decode_frames_u8(m, pk4, H, W, out=o, mixed=on))):
        out = fill.clone()
        fn(out)
        _sync(dev)
        _require(torch.equal(out, fill), f"{label}: {key} wrote with the flag set against it")

    k2, n2 = band.encode_payload(x, d, m, out=_sentinels(B, 16 * T, dev), mixed=on)
    p2, pn2 = band.encode_payload_plain(x, d, m, out=_sentinels(B, 16 * T, dev), mixed=on)
    n4 = no_n64.clone()
    k4 = band.encode_payload_u8(x, m, out=_sentinels(B, 16 * T, dev), n64=n4, mixed=off)
    pn4 = no_n64.clone()
    p4 = band.encode_payload_u8_plain(x, m, out=_sentinels(B, 16 * T, dev), n64=pn4, mixed=off)
    k3 = band.decode_frames(d, m, pk, H, W, out=fill.clone(), mixed=on)
    p3 = band.decode_frames_plain(d, m, pk, H, W, out=fill.clone(), mixed=on)
    k5 = band.decode_frames_u8(m, pk4, H, W, out=fill.clone(), mixed=off)
    p5 = band.decode_frames_u8_plain(m, pk4, H, W, out=fill.clone(), mixed=off)
    _sync(dev)
    _require(n4.cpu().tolist() == [8 * T] * B and torch.equal(k3, x) and torch.equal(k5, x),
             f"{label}: a kernel with the flag set for it did not do its work")
    return {"encode_payload": max(_max_err(k2, p2), _max_err(n2, pn2)),
            "encode_payload_u8": max(_max_err(k4, p4), _max_err(n4, pn4)),
            "decode": _max_err(k3, p3), "decode_u8": _max_err(k5, p5)}


def check_kernels(device: torch.device, geometries, seed: int = 0) -> dict[str, int]:
    """Phase 2: every kernel against its plain version on ``device``.

    ``geometries`` is a list of (label, (B, H, W) u8 numpy frames).  Returns
    the largest |kernel - plain| per kernel over all of them; raises unless
    each is within TOLERANCE and the frames round-trip exactly.  K1's batch
    flag is held against its plain version's, K2 to K5 also pass their
    gate cases (:func:`check_gates`), and ``DbdeCodec.encode`` (K1's flag
    choosing between K2 and K4 on the device) must give K2's stream and n64.
    """
    rng = np.random.default_rng(seed)
    errs = dict.fromkeys(band.LAUNCHES, 0)
    for label, frames in geometries:
        B, H, W = frames.shape
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        flag, flag_p = _flag(-1, device), _flag(-1, device)
        d, m = band.encode_depths(x, flag)
        dp, mp = band.encode_depths_plain(x, flag_p)
        _sync(device)
        e1 = max(_max_err(d, dp), _max_err(m, mp), _max_err(flag, flag_p))
        _require(int(flag) == int(bool((dp != 8).any())), f"{label}: K1's flag is wrong")

        T = d.shape[1]
        pk, nk = band.encode_payload(x, d, m, out=_sentinels(B, 16 * T, device))
        pp, np_ = band.encode_payload_plain(x, d, m, out=_sentinels(B, 16 * T, device))
        # rows 4, 8 and 12 bytes past the 16-byte grid: K2's copy-out and
        # K3's copy-in at every misalignment
        pko, nko = band.encode_payload(x, d, m, out=_sentinels(B, 16 * T + 1, device))
        ppo, _ = band.encode_payload_plain(x, d, m, out=_sentinels(B, 16 * T + 1, device))
        _sync(device)
        e2 = max(_max_err(pk, pp), _max_err(pko, ppo), _max_err(nk, np_), _max_err(nko, np_))
        n64 = nk.cpu().numpy()
        _require(n64.tolist() == (word_offsets(d)[1] // 2).cpu().numpy().tolist()
                 and nko.cpu().numpy().tolist() == n64.tolist(),
                 f"{label}: encode_payload's n64 is not the scan's")
        pk_host, pko_host = pk.cpu().numpy(), pko.cpu().numpy()
        for b in range(B):
            _require((pk_host[b, 2 * int(n64[b]):] == SENTINEL).all()
                     and (pko_host[b, 2 * int(n64[b]):] == SENTINEL).all(),
                     f"{label}: encode_payload wrote past 2*n64 in frame {b}")
        rec = pack_frames_bytes(EncodedBatch(d, m, pk, nk))[0]
        _require(rec[20:] == ref_numpy.pack_image(frames[0]),
                 f"{label}: frame 0 differs from the numpy oracle's bytes")

        e3 = 0
        for src in (pk, pko):
            out_k = band.decode_frames(d, m, src, H, W)
            out_p = band.decode_frames_plain(d, m, src, H, W)
            _sync(device)
            e3 = max(e3, _max_err(out_k, out_p))
            _require(torch.equal(out_k, x), f"{label}: decode did not return the frames")

        # the reader's stride: live words rounded up to 65536, garbage after them
        S = -(-2 * int(n64.max()) // 65536) * 65536 or 2
        short = rng.integers(0, 1 << 32, (B, S), dtype=np.uint32)
        for b in range(B):
            short[b, : 2 * int(n64[b])] = pk_host[b, : 2 * int(n64[b])]
        sp = torch.from_numpy(short).to(device)
        out_k = band.decode_frames(d, m, sp, H, W)
        out_p = band.decode_frames_plain(d, m, sp, H, W)
        _sync(device)
        e3 = max(e3, _max_err(out_k, out_p))
        _require(torch.equal(out_k, x), f"{label}: short-stride decode did not return the frames")

        # the uniform pair: defined for any content (each tile at depth 8
        # with its own minimum); the codec picks it when every tile is 8.
        # Default buffers take the 16-byte path, a stride of 16*T+3 the
        # word path, with sentinels after each frame's 16*T words.
        full = 16 * T
        pk4 = band.encode_payload_u8(x, m)
        pp4 = band.encode_payload_u8_plain(x, m)
        pk4s = band.encode_payload_u8(x, m, out=_sentinels(B, full + 3, device))
        pp4s = band.encode_payload_u8_plain(x, m, out=_sentinels(B, full + 3, device))
        _sync(device)
        e4 = max(_max_err(pk4, pp4), _max_err(pk4s, pp4s))
        _require(torch.equal(pk4s[:, :full], pk4), f"{label}: encode_payload_u8 paths differ")
        _require(bool((pk4s[:, full:].cpu().numpy() == SENTINEL).all()),
                 f"{label}: encode_payload_u8 wrote past 16*T")
        uniform = all_depth8(d)
        if uniform:
            _require(bool((n64 == 8 * T).all()) and torch.equal(pk4.cpu(), pk.cpu()),
                     f"{label}: every tile is depth 8 but K4's payload is not K2's")
        enc = DbdeCodec(H, W, device=device).encode(x)
        _require(enc.n64.cpu().numpy().tolist() == n64.tolist()
                 and all(np.array_equal(enc.payload_host()[b, : 2 * int(n64[b])],
                                        pk_host[b, : 2 * int(n64[b])]) for b in range(B)),
                 f"{label}: DbdeCodec.encode's n64 or stream is not K2's")
        gate_errs = check_gates(label, x, d, m, pk, pk4)
        e5 = 0
        for src in (pk4, pk4s):
            out_k = band.decode_frames_u8(m, src, H, W)
            out_p = band.decode_frames_u8_plain(m, src, H, W)
            _sync(device)
            e5 = max(e5, _max_err(out_k, out_p))
            _require(torch.equal(out_k, x), f"{label}: decode_u8 did not return the frames")

        # the tiles backend: K6 from tiles_W into the same sentinel-filled
        # buffer as K2 must give K2's words exactly (stream and sentinels),
        # with K1's depths and minima and zero pad tiles; K7 must decode it
        # and the garbage-padded short-stride payload
        tw = tile_layout.image_to_tiles_w(x)
        tp = tw.shape[2]
        k6 = tile_layout.encode_tiles(tw, T, out=_sentinels(B, 16 * T, device))
        p6 = tile_layout.encode_tiles_plain(tw, T, out=_sentinels(B, 16 * T, device))
        _sync(device)
        # and from a tiles_W 4 bytes off the 8-byte grid: K6's 4-byte loads
        tw_off = torch.empty(tw.numel() + 1, dtype=torch.uint32, device=device)[1:].view(tw.shape)
        tw_off.copy_(tw)
        k6_off = tile_layout.encode_tiles(tw_off, T, out=_sentinels(B, 16 * T, device))
        _sync(device)
        e6 = max(_max_err(a, b) for a, b in zip(k6, p6))
        e6 = max(e6, *(_max_err(a, b) for a, b in zip(k6_off, p6)))
        d6, m6, pay6, n6 = k6
        _require(torch.equal(pay6.view(torch.int32), pk.view(torch.int32)),
                 f"{label}: encode_tiles' payload buffer is not encode_payload's")
        _require(torch.equal(d6[:, :T], d) and torch.equal(m6[:, :T], m)
                 and not d6[:, T:].any() and not m6[:, T:].any()
                 and n6.cpu().numpy().tolist() == n64.tolist(),
                 f"{label}: encode_tiles' depths, minima or n64 are not encode_depths'")
        e7 = 0
        for src in (pay6, sp):
            tk = tile_layout.decode_tiles(d6, m6, src)
            tpl = tile_layout.decode_tiles_plain(d6, m6, src)
            _sync(device)
            e7 = max(e7, _max_err(tk, tpl))
            _require(torch.equal(tile_layout.tiles_w_to_image(tk, H, W), x),
                     f"{label}: decode_tiles did not return the frames")

        for name, e in zip(errs, (e1, e2, e3, e4, e5, e6, e7)):
            errs[name] = max(errs[name], e, gate_errs.get(name, 0))
        print(f"phase 2 {label} on {device}: max |kernel - plain| K1 {e1} K2 {e2} K3 {e3} K4 {e4} K5 {e5} "
              f"K6 {e6} K7 {e7}; gate cases {gate_errs}; T {T}, Tp {tp}, "
              f"n64 max {int(n64.max())}, stride {S}, all depth 8: {uniform}", flush=True)
    _require(max(errs.values()) <= TOLERANCE, f"kernels disagree with plain: {errs}")
    return errs


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.uint32:  # compare the bits
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def check_k6_repeats(device: torch.device, batches, repeats: int = 50) -> None:
    """Phase 2, repeats: K6 ``repeats`` times on each (label, (B, H, W) u8
    frames), each time into a fresh sentinel-filled buffer; every result
    must equal the first and the first the plain version's.  Races between
    blocks or within a block's shared memory show only now and then."""
    for label, frames in batches:
        B, H, W = frames.shape
        h, w = tile_grid(W, H)
        T = h * w
        tw = tile_layout.image_to_tiles_w(torch.from_numpy(frames).to(device))
        fill = _sentinels(B, 16 * T, device)
        want = tile_layout.encode_tiles_plain(tw, T, out=fill.clone())
        first = tile_layout.encode_tiles(tw, T, out=fill.clone())
        _sync(device)
        _require(all(_same(a, b) for a, b in zip(first, want)),
                 f"{label}: encode_tiles differs from its plain version")
        differ = 0
        for _ in range(repeats - 1):
            got = tile_layout.encode_tiles(tw, T, out=fill.clone())
            differ += not all(_same(a, b) for a, b in zip(got, first))
        _sync(device)
        _require(differ == 0, f"{label}: {differ} of {repeats} encode_tiles runs differ "
                              "from the first")
        print(f"phase 2 K6 repeated {repeats} times on {label}: every result equal to the "
              f"first and to the plain version's", flush=True)


def expected_launches(frames: np.ndarray, batch: int) -> dict[str, int]:
    """Kernel launches of a write_video + read_video of ``frames`` on a GPU:
    each batch's encode runs K1, then K2 and K4, gated on the device so
    that one of them writes; its decode (from the reader's host depths)
    runs K5 if every tile of it is depth 8 (by the numpy oracle's depth
    map), else K3."""
    n = dict.fromkeys(band.LAUNCHES, 0)
    for i in range(0, len(frames), batch):
        uniform = all(int(ref_numpy.tile_depths_mins(ref_numpy.tile_image(f))[0].min()) == 8
                      for f in frames[i : i + batch])
        for key in ("encode_depths", "encode_payload", "encode_payload_u8",
                    "decode_u8" if uniform else "decode"):
            n[key] += 1
    return n


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def check_main_path(device: torch.device, frames: np.ndarray, batch: int):
    """Phase 3: write_video → read_video through the port (both at their
    default pipeline of 2 batches).  Returns (launches per kernel during
    the run, (write seconds, read seconds) on the host clock, file IO
    included, the file's sha256, {the bytes of pinned memory that torch's
    pinned-memory cache holds after read_video, and the bytes it had to
    add during read_video})."""
    N, H, W = frames.shape
    # plain versions on the CPU launch nothing
    expected = expected_launches(frames, batch) if device.type == "cuda" \
        else dict.fromkeys(band.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.dbde")
        band.reset_launches()
        t0 = time.perf_counter()
        write_video(path, frames, frame_hz=1000.0, device=device, batch_size=batch)
        before = pinned_cache_bytes(device)
        t1 = time.perf_counter()
        vh, headers, out = read_video(path, device=device, batch_size=batch)
        seconds = (t1 - t0, time.perf_counter() - t1)
        after = pinned_cache_bytes(device)
        pinned = {"cached after read_video": after, "added by read_video": after - before}
        launches = dict(band.LAUNCHES)
        want = b"".join(ref_numpy.pack_frame(i, frames[i]) for i in range(min(2, N)))
        with open(path, "rb") as f:
            f.seek(VIDEO_HEADER_BYTES)
            got = f.read(len(want))
        digest = _digest(path)
    _require((vh.height, vh.width) == (H, W), "video header geometry")
    _require([h.index for h in headers] == list(range(N)), "frame indices")
    _require(np.array_equal(out, frames), "read_video did not return the written frames")
    _require(got == want, "first records differ from ref_numpy.pack_frame")
    _require(launches == expected, f"launches {launches}, expected {expected}")
    return launches, seconds, digest, pinned


def time_pipelines(device: torch.device, frames: np.ndarray, batch: int, digest: str,
                   depths=(2, 1, 1, 2)) -> dict[int, list[tuple[float, float]]]:
    """Phase 3: ``DbdeWriter`` then ``DbdeReader`` of ``frames`` at each
    pipeline depth of ``depths`` in turn, host clock, file IO included;
    every file must have sha256 ``digest`` (write_video's), every read
    return the frames, and every batch of frames the reader hands back lie
    in pageable memory.  Returns {pipeline: [(write s, read s), ...]}."""
    N, H, W = frames.shape
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, depth in enumerate(depths):
            # a new file each pass, as write_video's: truncating the last
            # pass's file would put freeing its pages in the timed write
            path = os.path.join(tmp, f"pipeline{i}.dbde")
            t0 = time.perf_counter()
            with DbdeWriter(path, H, W, frame_hz=1000.0, device=device, pipeline=depth) as wr:
                for i in range(0, N, batch):
                    wr.write(frames[i : i + batch])
            t1 = time.perf_counter()
            with DbdeReader(path, batch_size=batch, device=device, pipeline=depth) as rd:
                kept = [f for _, f in rd]
                got = np.concatenate(kept)
            t2 = time.perf_counter()
            _require(_digest(path) == digest and np.array_equal(got, frames),
                     f"pipeline {depth}: the file or the frames read back differ")
            _require(not any(torch.from_numpy(k).is_pinned() for k in kept),
                     f"pipeline {depth}: materialize handed back pinned memory")
            os.remove(path)
            out.setdefault(depth, []).append((t1 - t0, t2 - t1))
    return out


def _span_rows(table: dict, idle: dict, batches: int, roots) -> list[str]:
    """Phase 8: one line a program span or counter of ``table``
    (:func:`dbde_tpu_torch.trace.totals`) under ``roots``: calls, total and
    self ms, and the device's idle ms under it (``idle``, by ``(root,
    name)``; "-" without a card), or a counter's value, each a batch."""
    rows = []
    for (root, name), v in sorted(table.items()):
        if root not in roots:
            continue
        if "total_s" in v:
            gap = idle.get((root, name))
            rows.append(f"{root}/{name}: calls {v['calls'] / batches:.2f}, total "
                        f"{1e3 * v['total_s'] / batches:.3f}, self "
                        f"{1e3 * v['self_s'] / batches:.3f}, idle "
                        + ("-" if gap is None else f"{1e-3 * gap / batches:.3f}"))
        else:
            rows.append(f"{root}/{name}: {v['value'] / batches:.6g}")
    return rows


def span_split(device: torch.device, frames: np.ndarray, batch: int, mesh,
               digest: str) -> dict[str, list[str]]:
    """Phase 8: the real pipelined write and read under ``torch.profiler``
    (the program's own spans and counters, :mod:`dbde_tpu_torch.trace`):
    ``DbdeWriter`` then ``DbdeReader`` at pipeline 2 on ``device``, then
    ``write_video_sharded`` and ``iter_video_sharded`` on ``mesh``, each
    after one unprofiled pass of the same calls.  Every file must have
    sha256 ``digest`` (write_video's) and every read return the frames.
    Returns {part: lines}, the parts "stream write", "stream read", "mesh
    write" and "mesh read", each line :func:`_span_rows`' a batch (a
    write part's with the writer's sink thread, root ``writer.sink``, and
    the sharded write's, under ``sharded.write``, whose spans lie outside
    the profiler's timeline and show no idle); the idle
    time comes from each part's cards (none on the CPU), between the
    part's first and last program span (:func:`idle_by_span`)."""
    N, H, W = frames.shape
    n_batches = -(-N // batch)
    stream_cards = [device.index] if device.type == "cuda" else []
    mesh_cards = sorted({d.index for d in mesh.devices.flat if d.type == "cuda"})

    def stream(path):
        with DbdeWriter(path, H, W, frame_hz=1000.0, device=device, pipeline=2) as wr:
            for i in range(0, N, batch):
                wr.write(frames[i : i + batch])
        with DbdeReader(path, batch_size=batch, device=device, pipeline=2) as rd:
            return rd.read_all()[1]

    def sharded(path):
        write_video_sharded(path, frames, mesh, frame_hz=1000.0, batch_size=batch)
        return np.concatenate([f for _, f in iter_video_sharded(path, mesh, batch_size=batch,
                                                                pipeline=2)])

    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, run, cards in (("stream", stream, stream_cards), ("mesh", sharded, mesh_cards)):
            run(os.path.join(tmp, f"{label}-warm.dbde"))
            for c in cards:
                torch.cuda.synchronize(c)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
            # a session whose device records never arrive is run again
            # (utils/profiling.PROFILE_SESSIONS)
            for _ in range(PROFILE_SESSIONS):
                path = os.path.join(tmp, f"{label}.dbde")
                trace.reset()  # sessions back to back add into one table
                with profile(activities=acts) as prof:
                    got = run(path)
                    for c in cards:
                        torch.cuda.synchronize(c)
                table = trace.totals()
                _require(_digest(path) == digest and np.array_equal(got, frames),
                         f"phase 8 {label}: the file or the frames read back differ")
                os.remove(path)
                if not cards or set(cards) <= {iv[0] for iv in device_intervals(prof)}:
                    break
            else:
                raise RuntimeError(f"phase 8 {label}: no device records from cards {cards} in "
                                   f"{PROFILE_SESSIONS} profiler sessions")
            idle = idle_by_span(prof.events(), cards) if cards else {}
            parts[f"{label} write"] = _span_rows(table, idle, n_batches,
                                                 trace.WRITE_ROOTS + (trace.SINK_ROOT,))
            parts[f"{label} read"] = _span_rows(table, idle, n_batches, trace.READ_ROOTS)
    return parts


class TransferLog(TorchDispatchMode):
    """Every copy between host and device made while it is active, as
    (kind, host side pinned, non_blocking): ``copy_`` and ``to``/``cpu``
    (``_to_copy``) alike, from wherever they are called."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
            non_blocking = bool(args[2] if len(args) > 2 else kwargs.get("non_blocking", False))
            if dst.device.type != src.device.type:
                host = dst if dst.device.type == "cpu" else src
                kind = "d2h" if host is dst else "h2d"
                self.copies.append((kind, host.is_pinned(), non_blocking))
        elif func is torch.ops.aten._to_copy.default:
            src, dev = args[0], kwargs.get("device")
            if dev is not None and torch.device(dev).type != src.device.type:
                # a copy to the host lands in new memory: pinned only if asked for
                pinned = src.is_pinned() if src.device.type == "cpu" \
                    else bool(kwargs.get("pin_memory"))
                self.copies.append(("to", pinned, bool(kwargs.get("non_blocking", False))))
        return func(*args, **kwargs)


@contextlib.contextmanager
def sync_debug_error():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: any call
    that makes the host wait for the device through PyTorch raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


SLEEP_CYCLES = 2_000_000_000  # about a second of the card's clock


def check_async(device: torch.device, camera: np.ndarray, random: np.ndarray) -> dict:
    """Phase 3c: the CUDA path reads nothing back and waits for no earlier
    batch.  Behind a device sleep of about a second on the compute stream,
    under ``sync_debug_error`` and a :class:`TransferLog`:

      * ``DbdeCodec.encode`` of ``camera``, ``random`` (every tile depth 8)
        and a mixed batch (``camera`` with its last frame from ``random``);
      * ``decode_dispatch`` of a camera batch from a reader's pooled slots;
      * ``DbdeWriter.write`` of two batches at pipeline 2 into a writer
        already holding two, so that each write also drains the batch two
        writes old.

    None may raise, the sleep must still be running when they have all
    returned (nothing waited for the device), and every copy between host
    and device must be ``non_blocking`` with a pinned host side.  The plain
    ``.to(device)`` of a pageable array must raise under the same mode (the
    check is live).  Then the encodes must equal K2's stream and n64 with
    no flag, the decode the frames and the writer's file the band codec's
    records.  Returns a summary: seconds of the checked calls, copies
    seen by kind, slots pinned."""
    B, H, W = camera.shape
    mixed = np.concatenate([camera[:-1], random[-1:]])
    batches = {"camera": camera, "all depth 8": random, "mixed, one all-depth-8 frame": mixed}
    codec = DbdeCodec(H, W, device=device)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        source, written = os.path.join(tmp, "source.dbde"), os.path.join(tmp, "written.dbde")
        write_video(source, np.concatenate([camera, camera]), device=device, batch_size=B)
        rd = DbdeReader(source, batch_size=B, device=device)
        wr = DbdeWriter(written, H, W, device=device, pipeline=2)
        try:
            pool = _GatedPool()
            first = rd._read_batch_arrays(pool=pool)
            rd._codec.materialize(rd._codec.decode_dispatch(*first[1][:3]))  # warm-up
            slot = rd._read_batch_arrays(pool=pool)[1][:3]  # the pool's second slot
            summary["slots pinned"] = all(torch.from_numpy(a).is_pinned() for a in slot)
            for frames in batches.values():  # warm-up: the caching allocators' blocks
                codec.encode(frames)
            for frames in (camera, random, camera):
                wr.write(frames)
            # a dispatch mode's first use imports modules for seconds of host
            # time, longer than the sleep: not in the checked calls
            with TransferLog():
                torch.ones(1, device=device).cpu()
            _sync(device)
            log = TransferLog()
            with sync_debug_error():
                torch.cuda._sleep(SLEEP_CYCLES)
                asleep = torch.cuda.Event()
                asleep.record()
                t0 = time.perf_counter()
                with log:
                    encs = {k: codec.encode(f) for k, f in batches.items()}
                    pending = rd._codec.decode_dispatch(*slot)
                    wr.write(mixed)
                    wr.write(random)
                summary["seconds"] = time.perf_counter() - t0
                summary["device still asleep"] = not asleep.query()
                try:
                    torch.from_numpy(np.zeros(1 << 20, np.uint8)).to(device)
                    summary["pageable copy raised"] = False
                except RuntimeError:
                    summary["pageable copy raised"] = True
            _sync(device)
            frames_back = rd._codec.materialize(pending)
            wr.close()
        finally:
            rd.close()
            wr.close()
        for label, frames in batches.items():
            x = torch.from_numpy(frames).to(device)
            want_p, want_n = band.encode_payload(x, *band.encode_depths(x))
            n64 = want_n.cpu().numpy()
            got = encs[label]
            _require(got.n64.cpu().numpy().tolist() == n64.tolist() and all(
                np.array_equal(got.payload_host()[b, : 2 * n64[b]],
                               want_p.cpu().numpy()[b, : 2 * n64[b]]) for b in range(B)),
                f"{label}: the encode under the sync check differs from K2's")
        _require(np.array_equal(frames_back, camera),
                 "decode_dispatch from the reader's slots did not return the frames")
        want = b"".join(b"".join(pack_frames_bytes(codec.encode(f), range(i * B, (i + 1) * B)))
                        for i, f in enumerate((camera, random, camera, mixed, random)))
        with open(written, "rb") as f:
            _require(f.read()[VIDEO_HEADER_BYTES:] == want,
                     "the writer's file under the sync check differs from the codec's records")
    kinds = collections.Counter(kind for kind, _, _ in log.copies)
    summary["copies"] = dict(kinds)
    summary["all pinned and non_blocking"] = all(p and nb for _, p, nb in log.copies)
    _require(summary["slots pinned"], "the reader's pool slots are not pinned")
    _require(summary["all pinned and non_blocking"],
             f"a copy between host and device was pageable or blocking: {log.copies}")
    _require(kinds["h2d"] >= 6 and kinds["d2h"] >= 4,
             f"the transfer log saw too few copies: {summary['copies']}")
    _require(summary["device still asleep"],
             f"the checked calls waited for the device ({summary['seconds']:.3f} s)")
    _require(summary["pageable copy raised"],
             "a blocking copy from pageable memory did not raise: the sync check is not live")
    summary["stream switch"] = check_stream_switch(device, camera, random)
    return summary


def check_stream_switch(device: torch.device, camera: np.ndarray, random: np.ndarray) -> str:
    """Phase 3c, the stream switch: an encode of ``random`` and a
    ``decode_dispatch`` of ``camera`` under the caller's stream behind a
    device sleep (``soak.callers_streams``), read back on the default
    stream (the decode after the event recorded at its dispatch): the
    records equal the codec's on the default stream, the frames exact.
    Then ``DbdeReader`` and ``iter_video_sharded`` on 2x2 mesh slots over
    the visible cards read a file of both batches with each ``next()`` in
    turn under the caller's streams and the default ones
    (``soak.next_switching_streams``): the frames exact.  Returns what
    was checked."""
    B, H, W = camera.shape
    codec = DbdeCodec(H, W, device=device)
    want = pack_frames_bytes(codec.encode(random))
    enc_camera = codec.encode(camera)
    _sync(device)
    with callers_streams([device]):
        enc = codec.encode(random)
        pending = codec.decode_dispatch(enc_camera.depths, enc_camera.mins, enc_camera.payload)
        done = record_event(device)
    _require(pack_frames_bytes(enc) == want,
             "an encode under the caller's stream, read back on the default one, differs")
    _require(np.array_equal(codec.materialize(pending, after=done), camera),
             "a decode under the caller's stream, materialized on the default one, differs")
    frames = np.concatenate([camera, random])
    mesh = make_mesh(2, 2, devices=mesh_slots(4, visible_devices(device)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "switch.dbde")
        write_video(path, frames, device=device, batch_size=B)
        for pipeline in (1, 2):
            with DbdeReader(path, batch_size=B, device=device, pipeline=pipeline) as rd:
                got = next_switching_streams(rd, [device])
            _require(np.array_equal(np.concatenate([f for _, f in got]), frames),
                     f"DbdeReader at pipeline {pipeline} on switching streams differs")
            got = next_switching_streams(
                iter_video_sharded(path, mesh, batch_size=B, pipeline=pipeline),
                list(mesh.devices.flat))
            _require(np.array_equal(np.concatenate([f for _, f in got]), frames),
                     f"iter_video_sharded at pipeline {pipeline} on switching streams differs")
    return ("encode and decode_dispatch under the caller's stream read back on the default "
            "one, DbdeReader and iter_video_sharded (2x2 mesh on "
            + ",".join(str(d) for d in mesh.devices.flat)
            + ") at pipelines 1 and 2 with next() on switching streams: exact")


def check_tiles_path(device: torch.device, batches) -> tuple[dict, float]:
    """Phase 3b: each (B, H, W) batch through ``DbdeCodec(backend="tiles")``:
    encode → record bytes → parse at the reader's stride → decode.
    Returns (launches during the run, host seconds of the run)."""
    n = len(batches)
    expected = dict.fromkeys(band.LAUNCHES, 0)
    if device.type == "cuda":
        expected.update(encode_tiles=n, decode_tiles=n)
    records = []
    band.reset_launches()
    t0 = time.perf_counter()
    for frames in batches:
        B, H, W = frames.shape
        codec = DbdeCodec(H, W, device=device, backend="tiles")
        recs = pack_frames_bytes(codec.encode(frames))
        buf = b"".join(r[20:] for r in recs)
        offsets = np.cumsum([0] + [len(r) - 20 for r in recs[:-1]]).tolist()
        max_n64 = max((len(r) - 32 - 2 * codec.tiles) // 8 for r in recs)
        stride = min(16 * codec.tiles, -(-2 * max_n64 // 65536) * 65536 or 2)
        depths, mins, payload, _ = unpack_frames_bytes(buf, W, H, offsets, stride)
        out = codec.decode(depths, mins, payload)
        _require(np.array_equal(out, frames), "the tiles backend did not return the frames")
        records.append(recs)
    seconds = time.perf_counter() - t0
    launches = dict(band.LAUNCHES)
    _require(launches == expected, f"tiles launches {launches}, expected {expected}")
    for frames, recs in zip(batches, records):
        B, H, W = frames.shape
        _require(recs == pack_frames_bytes(DbdeCodec(H, W, device=device).encode(frames)),
                 "the tiles backend's records differ from the band backend's")
        _require(recs[0][20:] == ref_numpy.pack_image(frames[0]),
                 "the tiles backend's first record differs from the numpy oracle's")
    return launches, seconds


def _depth_maps(frames: np.ndarray) -> np.ndarray:
    """(N, h, w) tile depths of each frame, by the numpy oracle."""
    N, H, W = frames.shape
    h, w = tile_grid(W, H)
    return np.stack([ref_numpy.tile_depths_mins(ref_numpy.tile_image(f))[0].reshape(h, w)
                     for f in frames])


def _shard_launches(n: dict, depths: np.ndarray, n_data: int, n_tiles: int,
                    general: str, uniform: str) -> None:
    """Count one launch of ``uniform`` for each shard of a (B, h, w) batch
    of depth maps whose band is all depth 8, else one of ``general``: the
    choice made on the host, from host depths."""
    for rows in np.split(depths, n_data):
        for part in np.split(rows, n_tiles, axis=1):
            n[uniform if part.size and (part == 8).all() else general] += 1


def _gated_launches(n: dict, shards: int, general: str, uniform: str) -> None:
    """Both kernels of a pair launched for each shard, gated on the device."""
    n[general] += shards
    n[uniform] += shards


def expected_sharded_launches(frames: np.ndarray, batch: int, n_data: int,
                              n_tiles: int) -> dict[str, int]:
    """Kernel launches of write_video_sharded then iter_video_sharded of
    ``frames`` in batches of ``batch`` (a multiple of n_data) on a GPU mesh:
    every shard of every batch runs K1, K2 and K4 (gated on the device),
    and decodes from host depths with K5 if its band of its frames is all
    depth 8 (by the numpy oracle's depth map), else K3.  The reader pads a
    short tail batch with records of depth 0."""
    depths = _depth_maps(frames)
    n = dict.fromkeys(band.LAUNCHES, 0)
    for i in range(0, len(frames), batch):
        d = depths[i : i + batch]
        pad = -len(d) % n_data
        n["encode_depths"] += n_data * n_tiles
        _gated_launches(n, n_data * n_tiles, "encode_payload", "encode_payload_u8")
        _shard_launches(n, np.concatenate([d, np.zeros((pad, *d.shape[1:]), d.dtype)]),
                        n_data, n_tiles, "decode", "decode_u8")
    return n


def _roundtrip_launches(frames: np.ndarray, n_data: int, n_tiles: int,
                        device_depths: bool) -> dict[str, int]:
    """Launches of one sharded encode and decode of ``frames`` on a GPU
    mesh: each shard's encode K1, K2 and K4; its decode from host depths K3
    or K5 by its band's depths, from depths on the device both, gated."""
    shards = n_data * n_tiles
    n = dict.fromkeys(band.LAUNCHES, 0)
    n["encode_depths"] = shards
    _gated_launches(n, shards, "encode_payload", "encode_payload_u8")
    if device_depths:
        _gated_launches(n, shards, "decode", "decode_u8")
    else:
        _shard_launches(n, _depth_maps(frames), n_data, n_tiles, "decode", "decode_u8")
    return n


def check_sharded_path(device: torch.device, frames: np.ndarray, batch: int,
                       ragged: np.ndarray, dryrun_devices: int = 8):
    """Phase 5: the sharded path on meshes laid over every visible device
    of ``device``'s type in turn (``mesh_slots``): over four or more cards
    each slot has a card of its own, on one card every slot is that card.

    (a) a 2x2 mesh writes ``frames`` with write_video_sharded in batches of
    ``batch`` and walks the file back with iter_video_sharded: the file is
    write_video's of the same frames byte for byte and the frames come back
    exactly; (b) a 1x4 mesh encodes ``ragged`` (ceil(H/8) a multiple of 4)
    with encode_sharded to ref_numpy.pack_image's depths, minima and
    stream, frame by frame, and decode_sharded returns it; (c)
    sharded_roundtrip_step of ``frames[:batch]`` on the 2x2 mesh returns it
    with the single-device codec's n64; (d) graft_entry's dry run on
    ``dryrun_devices`` slots and entry() on ``device``.  Each part's
    launches must be those the numpy oracle's depths predict ((c) decodes
    from the depths on the device, so K3 and K5 both launch, gated; (d)
    must use K1–K5 and no other kernel: the dry run's codec calls launch
    the gated pairs, entry() K1, K2 and K3).  Returns ({part: launches}, {leg: host seconds}): the
    sharded write and read of (a) beside write_video and read_video of the
    same frames, file IO included."""
    on_gpu = device.type == "cuda"
    none = dict.fromkeys(band.LAUNCHES, 0)
    slots = mesh_slots(4, visible_devices(device))
    mesh22 = make_mesh(2, 2, devices=slots)
    launches, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        single, sharded = os.path.join(tmp, "single.dbde"), os.path.join(tmp, "sharded.dbde")
        t0 = time.perf_counter()
        write_video(single, frames, frame_hz=1000.0, device=device, batch_size=batch)
        seconds["write_video"] = time.perf_counter() - t0
        band.reset_launches()
        t0 = time.perf_counter()
        write_video_sharded(sharded, frames, mesh22, frame_hz=1000.0, batch_size=batch)
        t1 = time.perf_counter()
        chunks = [chunk for _, chunk in iter_video_sharded(sharded, mesh22, batch_size=batch)]
        t2 = time.perf_counter()
        launches["a"] = dict(band.LAUNCHES)
        seconds["write_video_sharded"], seconds["iter_video_sharded"] = t1 - t0, t2 - t1
        _, _, single_out = read_video(single, device=device, batch_size=batch)
        seconds["read_video"] = time.perf_counter() - t2
        _require(filecmp.cmp(single, sharded, shallow=False),
                 "write_video_sharded's file differs from write_video's")
    _require(np.array_equal(np.concatenate(chunks), frames) and np.array_equal(single_out, frames),
             "the sharded or single-device read did not return the written frames")
    want = expected_sharded_launches(frames, batch, 2, 2) if on_gpu else none
    _require(launches["a"] == want, f"sharded file launches {launches['a']}, expected {want}")

    mesh14 = make_mesh(1, 4, devices=slots)
    B, H, W = ragged.shape
    band.reset_launches()
    depth, mins, payload, totals, _, Hp = encode_sharded(ragged, mesh14)
    out = decode_sharded(depth, mins, payload, mesh14, H=H, W=W, Hp=Hp)
    launches["b"] = dict(band.LAUNCHES)
    T = depth.shape[1]
    for i, (frame, stream) in enumerate(zip(ragged, assemble_payload_host(payload, totals))):
        rec = ref_numpy.pack_image(frame)
        _require(depth[i].tobytes() == rec[4 : 4 + T] and mins[i].tobytes() == rec[8 + T : 8 + 2 * T]
                 and stream.tobytes() == rec[12 + 2 * T:],
                 f"1x4 mesh: frame {i} differs from ref_numpy.pack_image")
    _require(np.array_equal(out, ragged), "1x4 mesh: decode_sharded did not return the frames")
    want = _roundtrip_launches(ragged, 1, 4, device_depths=False) if on_gpu else none
    _require(launches["b"] == want, f"1x4 mesh launches {launches['b']}, expected {want}")

    first = frames[:batch]
    band.reset_launches()
    out, n64 = sharded_roundtrip_step(first, mesh22)
    launches["c"] = dict(band.LAUNCHES)
    single_n64 = int(DbdeCodec(*first.shape[1:], device=device).encode(first).n64.sum())
    _require(np.array_equal(out, first) and n64 == single_n64,
             f"sharded_roundtrip_step: n64 {n64} against {single_n64}, or frames differ")
    want = _roundtrip_launches(first, 2, 2, device_depths=True) if on_gpu else none
    _require(launches["c"] == want, f"roundtrip step launches {launches['c']}, expected {want}")

    band.reset_launches()
    graft_entry.dryrun_multichip(dryrun_devices, device=device.type)
    fn, (example,) = graft_entry.entry(device)
    got, n64 = fn(example)
    launches["d"] = dict(band.LAUNCHES)
    _require(np.array_equal(got.cpu().numpy(), example)
             and n64.cpu().numpy().tolist() == _depth_maps(example).sum(axis=(1, 2)).tolist(),
             "graft_entry.entry's step did not return the frames and their n64")
    used = {k for k, v in launches["d"].items() if v}
    # the dry run's codec calls launch the gated pairs; entry() K1, K2, K3
    want = {"encode_depths", "encode_payload", "encode_payload_u8", "decode",
            "decode_u8"} if on_gpu else set()
    _require(used == want, f"dry run and entry launched {launches['d']}")
    return launches, seconds


def time_distinct_meshes(frames: np.ndarray, batch: int) -> dict[str, list[tuple[float, float]]]:
    """Phase 5, where two or more cards are visible: write_video_sharded and
    iter_video_sharded of ``frames`` on meshes of distinct cards (1x1, 2x1,
    4x1 and 2x2, each that the cards fill, one slot a card), beside
    write_video and read_video on cuda:0, host clock, file IO included, in
    turns over two passes (the meshes forward, then back).  Every file must
    equal write_video's and every read return the frames.  Returns {mesh:
    [(write s, read s) a pass]}."""
    cards = visible_devices("cuda")
    shapes = [sh for sh in ((1, 1), (2, 1), (4, 1), (2, 2)) if sh[0] * sh[1] <= len(cards)]
    out: dict[str, list[tuple[float, float]]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        single = os.path.join(tmp, "single.dbde")  # the first write_video's file
        order = ["single", *shapes, *shapes[::-1], "single"]
        for i, shape in enumerate(order):
            # a new file each pass: truncating one would time freeing its pages
            path = single if i == 0 else os.path.join(tmp, f"pass{i}.dbde")
            t0 = time.perf_counter()
            if shape == "single":
                name = "write_video/read_video on cuda:0"
                write_video(path, frames, frame_hz=1000.0, device=cards[0], batch_size=batch)
                t1 = time.perf_counter()
                _, _, got = read_video(path, device=cards[0], batch_size=batch)
            else:
                mesh = make_mesh(*shape, devices=mesh_slots(shape[0] * shape[1], cards))
                name = (f"{shape[0]}x{shape[1]} mesh on cuda:"
                        + ",".join(str(d.index) for d in mesh.devices.flat))
                write_video_sharded(path, frames, mesh, frame_hz=1000.0, batch_size=batch)
                t1 = time.perf_counter()
                got = np.concatenate([c for _, c in iter_video_sharded(path, mesh,
                                                                       batch_size=batch)])
            t2 = time.perf_counter()
            _require(filecmp.cmp(single, path, shallow=False) and np.array_equal(got, frames),
                     f"{name}: the file differs from write_video's or the read from the frames")
            if path != single:
                os.remove(path)
            out.setdefault(name, []).append((t1 - t0, t2 - t1))
    return out


def time_shard_encodes(device: torch.device, frames: np.ndarray, iters: int = 20):
    """Phase 5: ms per call (CUDA events, in turns) of the four shard
    encodes of ``frames`` on a 2x2 mesh of ``device``: through
    ``DbdeCodec.encode`` (K1, then K2 and K4 gated by K1's flag, no
    read-back), and as K1 and K2 alone on each shard.  Returns (codec ms,
    K1 + K2 ms)."""
    B, H, W = frames.shape
    codec = DbdeCodec(H // 2, W, device=device)
    shards = [torch.from_numpy(np.ascontiguousarray(
        frames[d * B // 2:(d + 1) * B // 2, t * H // 2:(t + 1) * H // 2])).to(device)
        for d in range(2) for t in range(2)]

    def checked():
        for x in shards:
            codec.encode(x)

    def unchecked():
        for x in shards:
            d, m = band.encode_depths(x)
            band.encode_payload(x, d, m)

    return _in_turns({"shard encodes": (checked, unchecked)}, iters)["shard encodes"]


def _time_ms(fn, iters: int) -> float:
    return 1e3 * cuda_event_seconds(fn, iters)


def _in_turns(cases: dict, iters: int) -> dict:
    """{name: (a, b)} → {name: (ms of a, ms of b)}, timed b, a, a, b."""
    times = {}
    for name, (a, b) in cases.items():
        b1, a1, a2, b2 = (_time_ms(f, iters) for f in (b, a, a, b))
        times[name] = ((a1 + a2) / 2, (b1 + b2) / 2)
    return times


def time_paths(device: torch.device, frames: np.ndarray, iters: int = 20) -> dict:
    """Phase 4: ms per call of kernel and plain version, measured in turns
    (plain, kernel, kernel, plain) and averaged per version.

    The band encode path is ``DbdeCodec.encode`` (K1 with its flag, then
    K2 and K4 gated by it, no read-back) against the same steps in plain
    versions; "encode path general" is K1 + K2 with no flag, which prices
    the gated launch and, on all-depth-8 content, what K4 saves.  The band decode path is K3, or K5
    when every tile is depth 8; that choice is made once on the host, as
    the reader makes it from host depths.  The tiles
    paths are ``DbdeCodec(backend="tiles")``'s encode (layout transform,
    K6) and decode (padding, K7, layout transform)."""
    B, H, W = frames.shape
    x = torch.from_numpy(frames).to(device)
    codec = DbdeCodec(H, W, device=device)
    tiles = DbdeCodec(H, W, device=device, backend="tiles")
    d, m = band.encode_depths(x)
    p, _ = band.encode_payload(x, d, m)
    buf = torch.empty_like(p)
    uniform = all_depth8(d)
    T = d.shape[1]
    tw = tile_layout.image_to_tiles_w(x)
    d6, m6, p6, _ = tile_layout.encode_tiles(tw, T)
    enc6 = tiles.encode(x)

    def encode_plain():
        mixed = torch.empty((1,), dtype=torch.int32, device=device)
        dd, mm = band.encode_depths_plain(x, mixed)
        pp, nn = band.encode_payload_plain(x, dd, mm, mixed=mixed)
        return band.encode_payload_u8_plain(x, mm, out=pp, n64=nn, mixed=mixed)

    def encode_general(depths_fn, payload_fn):
        dd, mm = depths_fn(x)
        return payload_fn(x, dd, mm)

    def decode(general, u8):
        return u8(m, p, H, W) if uniform else general(d, m, p, H, W)

    def tiles_encode_plain():
        return tile_layout.encode_tiles_plain(tile_layout.image_to_tiles_w(x), T)

    def tiles_decode_plain():
        tp = tw.shape[2]
        out = tile_layout.decode_tiles_plain(tile_layout.pad_last(enc6.depths, tp),
                                             tile_layout.pad_last(enc6.mins, tp), enc6.payload)
        return tile_layout.tiles_w_to_image(out, H, W)

    cases = {
        "encode_depths": (lambda: band.encode_depths(x), lambda: band.encode_depths_plain(x)),
        "encode_payload": (lambda: band.encode_payload(x, d, m, out=buf),
                           lambda: band.encode_payload_plain(x, d, m, out=buf)),
        "decode": (lambda: band.decode_frames(d, m, p, H, W),
                   lambda: band.decode_frames_plain(d, m, p, H, W)),
    }
    if uniform:
        cases.update({
            "encode_payload_u8": (lambda: band.encode_payload_u8(x, m, out=buf),
                                  lambda: band.encode_payload_u8_plain(x, m, out=buf)),
            "decode_u8": (lambda: band.decode_frames_u8(m, p, H, W),
                          lambda: band.decode_frames_u8_plain(m, p, H, W)),
        })
    cases.update({
        "encode_tiles": (lambda: tile_layout.encode_tiles(tw, T, out=buf),
                         lambda: tile_layout.encode_tiles_plain(tw, T, out=buf)),
        "decode_tiles": (lambda: tile_layout.decode_tiles(d6, m6, p6),
                         lambda: tile_layout.decode_tiles_plain(d6, m6, p6)),
        "encode path": (lambda: codec.encode(x), encode_plain),
        "encode path general": (lambda: encode_general(band.encode_depths, band.encode_payload),
                                lambda: encode_general(band.encode_depths_plain,
                                                       band.encode_payload_plain)),
        "decode path": (lambda: decode(band.decode_frames, band.decode_frames_u8),
                        lambda: decode(band.decode_frames_plain, band.decode_frames_u8_plain)),
        "tiles encode path": (lambda: tiles.encode(x), tiles_encode_plain),
        "tiles decode path": (lambda: tiles.decode_dispatch(enc6.depths, enc6.mins, enc6.payload),
                              tiles_decode_plain),
    })
    return _in_turns(cases, iters)


def time_widths(device: torch.device, widths, H: int = 2048, B: int = 8,
                iters: int = 20) -> dict:
    """Phase 4, narrow widths: the band and tiles backends side by side on
    B×H×W camera frames already on the card.  Returns {W: {path: (band ms,
    tiles ms)}} for the encode and decode paths, timed tiles, band, band,
    tiles."""
    out = {}
    for W in widths:
        x = torch.from_numpy(make_content(W, H, B)).to(device)
        bc = DbdeCodec(H, W, device=device)
        tc = DbdeCodec(H, W, device=device, backend="tiles")
        eb, et = bc.encode(x), tc.encode(x)
        _require(pack_frames_bytes(eb) == pack_frames_bytes(et), f"W={W}: backends differ")
        out[W] = _in_turns({
            "encode": (lambda: bc.encode(x), lambda: tc.encode(x)),
            "decode": (lambda: bc.decode_dispatch(eb.depths, eb.mins, eb.payload),
                       lambda: tc.decode_dispatch(et.depths, et.mins, et.payload)),
        }, iters)
    return out


def time_band_sizes(device: torch.device, batches, iters: int = 20) -> dict:
    """Phase 4, other frame sizes: ms per call of K2 and K3 (CUDA events,
    timed K3, K2, K2, K3) on each (label, (B, H, W) u8 frames), after
    checking that they round-trip.  Returns {label: {"encode_payload": ms,
    "decode": ms}}."""
    out = {}
    for label, frames in batches:
        B, H, W = frames.shape
        x = torch.from_numpy(frames).to(device)
        d, m = band.encode_depths(x)
        p, _ = band.encode_payload(x, d, m)
        buf = torch.empty_like(p)
        _require(torch.equal(band.decode_frames(d, m, p, H, W), x),
                 f"{label}: K2 and K3 did not round-trip")
        k2, k3 = _in_turns({"K2 against K3": (lambda: band.encode_payload(x, d, m, out=buf),
                                               lambda: band.decode_frames(d, m, p, H, W))},
                           iters)["K2 against K3"]
        out[label] = {"encode_payload": k2, "decode": k3}
    return out


def prefix_bytes(frames: np.ndarray) -> int:
    """Bytes of depths that K2's or K3's blocks read to sum a frame's
    earlier depths (chunk g of 1024 tiles reads g*1024), over the batch."""
    B, H, W = frames.shape
    h, w = tile_grid(W, H)
    nb = -(-h * w // 1024)
    return B * 1024 * nb * (nb - 1) // 2


def kernel_bound(key: str, frames: np.ndarray, n64_total: int) -> tuple[float, str, int, int]:
    """The least time the card could take for one call of kernel ``key`` on
    ``frames`` with ``n64_total`` payload u64 words over the batch:
    (ms, "bytes" or "operations", bytes moved, integer operations).  Each
    input is read once and each output written once; the payload counts
    its live words only, and K2's and K6's outputs include n64 (4 bytes a
    frame)."""
    B, H, W = frames.shape
    h, w = tile_grid(W, H)
    T = h * w
    tp = tile_layout.pad_tiles(T)
    pix, pay = B * H * W, 8 * n64_total
    nbytes, ops = {
        "encode_depths": (pix + 2 * B * T, OPS_DEPTH_MIN * B * T),
        "encode_payload": (pix + 2 * B * T + pay + 4 * B, OPS_PACK * B * T),
        "decode": (2 * B * T + pay + pix, OPS_UNPACK * B * T),
        "encode_payload_u8": (pix + B * T + 64 * B * T, OPS_BYTEWISE * B * T),
        "decode_u8": (B * T + 64 * B * T + pix, OPS_BYTEWISE * B * T),
        "encode_tiles": (64 * B * tp + 2 * B * tp + pay + 4 * B,
                         (OPS_DEPTH_MIN + OPS_PACK) * B * T),
        "decode_tiles": (2 * B * tp + pay + 64 * B * tp, OPS_UNPACK * B * tp),
    }[key]
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _n64_total(frames: np.ndarray, device: torch.device) -> int:
    d, _ = band.encode_depths(torch.from_numpy(frames).to(device))
    return int(d.to(torch.int64).sum())


# tools/tpu_quickcheck.py's geometries: (W, H, content)
QUICKCHECK = ((2048, 2048, "camera"), (2048, 2048, "random"), (3072, 64, "camera"),
              (2536, 2048, "camera"), (1024, 64, "flat"))
ENCODE_KEYS = ("encode_depths", "encode_payload", "encode_payload_u8")
# --stream and --composed at 64 frames: 4 batches of 16, not one cold batch
BENCH_MODES = ((), ("--content", "random"), ("--latency",), ("--stream", "--frames", "64"),
               ("--host-stream",), ("--composed", "--frames", "64"))
# the keys of bench.py's line, which python -m dbde_tpu_torch.bench prints
PORT_BENCH_CONFIGS = ("camera_2048", "random_2048", "random_2536x2048")


def _cli(argv, launches: dict) -> tuple[int, str, dict]:
    """``cli.main(argv)`` in-process → (exit code, its stdout, its launches),
    the counts set to 0 just before and read just after; ``launches``
    accumulates them."""
    out = io.StringIO()
    band.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    n = dict(band.LAUNCHES)
    for k, v in n.items():
        launches[k] += v
    return rc, out.getvalue(), n


def check_cli(tmp: str, geometries, pgm_geometry: int, device_args=()) -> dict[str, int]:
    """Phase 6: the CLI's file commands in ``tmp``, on the card, or on the
    CPU with ``device_args=("--no-device",)`` (which launches nothing).

    golden → info --scan → decode against GOLDEN_8x16_IMAGE; for each (W,
    H, content) of ``geometries``, two frames of ``make_content``: encode
    (the file must be the numpy oracle's, record by record), decode -o (the
    raw input back), roundtrip, each command's launches as the oracle's
    depths predict; decode --pgm-dir (``read_pgm`` must give the frames
    back) and preview --frame 1 (one frame's decode) on geometry
    ``pgm_geometry``.  Returns the launches summed over the commands."""
    total = dict.fromkeys(band.LAUNCHES, 0)
    on_gpu = not device_args
    none = dict.fromkeys(band.LAUNCHES, 0)

    def run(*argv, what: str):
        rc, text, n = _cli(argv, total)
        _require(rc == 0, f"cli {what} exited {rc}")
        return text, n

    golden, golden_raw = os.path.join(tmp, "g.dbde"), os.path.join(tmp, "g.raw")
    run("golden", "-o", golden, "--frames", "3", what="golden")
    text, _ = run("info", golden, "--scan", what="info --scan")
    _require("frames:    3" in text.splitlines(), f"info --scan printed {text!r}")
    run("decode", golden, "-o", golden_raw, *device_args, what="decode of the golden file")
    _require(np.fromfile(golden_raw, np.uint8).tobytes() == GOLDEN_8x16_IMAGE.tobytes() * 3,
             "the golden file did not decode to GOLDEN_8x16_IMAGE three times")

    for i, (W, H, content) in enumerate(geometries):
        label = f"{W}x{H} {content}"
        frames = make_content(W, H, 2, content)
        raw, enc, dec = (os.path.join(tmp, f"q{i}.{ext}") for ext in ("raw", "dbde", "out"))
        frames.tofile(raw)
        # write_video + read_video launches; encode, decode and roundtrip
        # each take their share (CLI batch 16: one batch of 2 frames)
        both = expected_launches(frames, 16) if on_gpu else none
        want_enc = {k: v if k in ENCODE_KEYS else 0 for k, v in both.items()}
        want_dec = {k: 0 if k in ENCODE_KEYS else v for k, v in both.items()}
        _, n = run("encode", raw, "-o", enc, "--width", str(W), "--height", str(H), *device_args,
                   what=f"encode {label}")
        _require(n == want_enc, f"{label}: encode launched {n}, expected {want_enc}")
        with open(enc, "rb") as f:
            _require(f.read() == ref_numpy.encode_video(frames),
                     f"{label}: the encoded file differs from the numpy oracle's records")
        _, n = run("decode", enc, "-o", dec, *device_args, what=f"decode {label}")
        _require(n == want_dec, f"{label}: decode launched {n}, expected {want_dec}")
        _require(filecmp.cmp(raw, dec, shallow=False), f"{label}: decode -o differs from the input")
        text, n = run("roundtrip", enc, *device_args, what=f"roundtrip {label}")
        _require(text.startswith("OK: 2 frames") and n == both,
                 f"{label}: roundtrip printed {text!r}, launched {n}, expected {both}")
        if i == pgm_geometry:
            pgm_dir = os.path.join(tmp, "pgm")
            run("decode", enc, "--pgm-dir", pgm_dir, *device_args, what=f"decode --pgm-dir {label}")
            for j, frame in enumerate(frames):
                _require(np.array_equal(read_pgm(os.path.join(pgm_dir, f"frame_{j:06d}.pgm")),
                                        frame), f"{label}: PGM {j} is not the frame")
            text, n = run("preview", enc, "--frame", "1", *device_args, what=f"preview {label}")
            one = expected_launches(frames[1:], 16) if on_gpu else none
            want = {k: 0 if k in ENCODE_KEYS else v for k, v in one.items()}
            _require(text.startswith(f"frame 1 ({W}x{H}):") and n == want,
                     f"preview printed {text[:80]!r}, launched {n}, expected {want}")
    return total


def _numbers(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield value


def run_cli_benches(card: str) -> dict[str, int]:
    """Phase 6: ``bench`` in each of BENCH_MODES at the CLI's defaults; every
    number in each result must be positive and run_bench's and
    run_latency_bench's ``device`` the card.  Prints each JSON line beside
    ``card``; returns the launches summed over the modes."""
    total = dict.fromkeys(band.LAUNCHES, 0)
    for mode in BENCH_MODES:
        t0 = time.perf_counter()
        rc, text, _ = _cli(("bench", *mode), total)
        seconds = time.perf_counter() - t0
        line = text.strip().splitlines()[-1]
        result = json.loads(line)
        name = " ".join(mode) or "(default)"
        _require(rc == 0 and all(v > 0 for v in _numbers(result)),
                 f"bench {name}: exit {rc}, a result not positive: {line}")
        _require(result.get("device", card) == card,
                 f"bench {name}: device {result.get('device')!r}, not {card!r}")
        print(f"phase 6 bench {name}: {line} on {card} ({seconds:.1f} s)", flush=True)
    return total


def run_port_bench(card: str) -> dict[str, int]:
    """Phase 6: the port's headline bench, ``main()`` of ``python -m
    dbde_tpu_torch.bench``, in-process: its one JSON line must carry
    bench.py's keys (the camera config at the top level, ``configs``
    holding all three), every number positive and ``device`` the card.
    Prints the line; returns its launches."""
    out = io.StringIO()
    band.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = port_bench.main()
    seconds = time.perf_counter() - t0
    launches = dict(band.LAUNCHES)
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    _require(rc == 0 and set(result.get("configs", ())) == set(PORT_BENCH_CONFIGS)
             and all(v > 0 for v in _numbers(result)) and result.get("device") == card,
             f"python -m dbde_tpu_torch.bench: exit {rc}, line {line}")
    print(f"phase 6 python -m dbde_tpu_torch.bench: {line} on {card} ({seconds:.1f} s)",
          flush=True)
    return launches


ROOT = os.path.dirname(os.path.abspath(__file__))
SOAK = ("-m", "dbde_tpu_torch.soak", "--seed", "0", "--seconds", "60")


def start_cli_subprocess(path: str) -> subprocess.Popen:
    """Start ``python -X importtime -m dbde_tpu_torch.cli info path`` in a
    fresh interpreter; :func:`finish_cli_subprocess` checks it.  Use it as
    a context manager, which waits for it."""
    return subprocess.Popen([sys.executable, "-X", "importtime", "-m", "dbde_tpu_torch.cli",
                             "info", path], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _require_no_jax(importtime: str, what: str) -> None:
    """``-X importtime``'s output (stderr) shows no jax or JAX-package import."""
    roots = {line.rsplit("|", 1)[-1].strip().split(".")[0]
             for line in importtime.splitlines() if line.startswith("import time:")}
    _require(not roots & {"jax", "jaxlib", "dbde_tpu"},
             f"{what} imported {sorted(roots & {'jax', 'jaxlib', 'dbde_tpu'})}")


def finish_cli_subprocess(proc: subprocess.Popen) -> None:
    """The subprocess exited 0 with the header printed, and ``-X
    importtime`` shows no jax or JAX-package import."""
    out, err = proc.communicate(timeout=120)
    _require(proc.returncode == 0 and out.startswith("geometry:"),
             f"python -m dbde_tpu_torch.cli info: exit {proc.returncode}, {err[-2000:]}")
    _require_no_jax(err, "the CLI subprocess")


def run_soak() -> tuple[list[str], int, float]:
    """Phase 7: ``python -m dbde_tpu_torch.soak --seed 0 --seconds 60`` in a
    fresh interpreter under ``-X importtime``.  It must exit 0 with its
    sharded step check (c) and (d) lines and ``SOAK OK`` last, and import
    no jax and nothing of the JAX package.  Returns its lines other than the cases',
    the number of cases and the seconds it took."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", *SOAK], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    summary = [line for line in lines if not line.startswith("ok case ")]
    errors = [line for line in proc.stderr.splitlines() if not line.startswith("import time:")]
    _require(proc.returncode == 0 and summary and summary[-1].startswith("SOAK OK")
             and any(line.startswith("sharded step check (c)") for line in summary)
             and any(line.startswith("sharded step check (d)") for line in summary),
             f"the soak: exit {proc.returncode}\n" + "\n".join(summary[-20:] + errors[-40:]))
    _require_no_jax(proc.stderr, "the soak's subprocess")
    return summary, len(lines) - len(summary), seconds


def spans_main() -> int:
    """Phase 8 in a fresh interpreter, whose first profiler sessions these
    are (:func:`run_spans`): :func:`span_split` of 4 x 64 camera and 16
    random 2048x2048 frames, batch 16, on cuda:0 and on a 2x2 mesh laid
    over the visible cards; its lines, then ``SPANS OK``."""
    device = torch.device("cuda", 0)
    camera = make_content(2048, 2048, 64)
    frames = np.concatenate([camera] * 4 + [make_content(2048, 2048, 16, kind="random")])
    mesh = make_mesh(2, 2, devices=mesh_slots(4, visible_devices("cuda")))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spans.dbde")
        write_video(path, frames, frame_hz=1000.0, device=device, batch_size=16)
        digest = _digest(path)
    slots = ",".join(str(d.index) for d in mesh.devices.flat)
    for part, rows in span_split(device, frames, 16, mesh, digest).items():
        where = "cuda:0" if part.startswith("stream") else f"2x2 mesh on cuda:{slots}"
        for row in rows:
            print(f"spans, {part}, {where}, ms a batch: {row}")
    print("SPANS OK")
    return 0


def run_spans() -> tuple[list[str], float]:
    """Phase 8: :func:`spans_main` in a fresh interpreter, because the
    profiler's device records thin out in a process that has profiled for
    minutes (phase 6).  Returns its lines before ``SPANS OK`` and the
    seconds it took."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           "sys.exit(chip_smoke.spans_main())"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    _require(proc.returncode == 0 and lines and lines[-1] == "SPANS OK",
             f"phase 8: exit {proc.returncode}\n" + "\n".join(lines[-20:])
             + proc.stderr[-4000:])
    return lines[:-1], time.perf_counter() - t0


def runtime_devices(cards) -> dict[str, int]:
    """Phase 1: the current device of the kernel library's own (static) CUDA
    runtime while torch has each card current, asked before any kernel is
    launched on cards other than cuda:0.  The launchers rely on it
    following torch's: they launch on that device's stream, and K2, K3 and
    K6 raise their shared-memory limit on it (``ops/launch.py``)."""
    lib = build_load()
    seen = {}
    for c in cards:
        with torch.cuda.device(c):
            seen[str(c)] = lib.dbde_current_device()
    return seen


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU and none is visible")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"phase 0 device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print(card, flush=True)
    cards = visible_devices("cuda")
    names = {c.index: card_name(c.index) for c in cards}
    print("phase 0 cards: " + "; ".join(f"cuda:{i} {name}" for i, name in names.items()))
    if len(cards) > 1:
        peers = {f"cuda:{i}->cuda:{j}": torch.cuda.can_device_access_peer(i, j)
                 for i in names for j in names if i != j}
        print(f"phase 0 peer access (torch.cuda.can_device_access_peer): {json.dumps(peers)}",
              flush=True)

    t0 = time.perf_counter()
    path, log = build(ptxas_verbose=True)
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    band.encode_depths(torch.zeros((1, 8, 8), dtype=torch.uint8, device=device))  # loads the library
    _sync(device)
    seen = runtime_devices(cards)
    print(f"phase 1 the kernel library's own CUDA runtime, current device under "
          f"torch.cuda.device(i), before any launch on card i > 0: {seen}", flush=True)
    _require(seen == {str(c): c.index for c in cards},
             "the kernel library's runtime does not follow torch's current device")
    # the stream layer's host record engine (g++, first use) is set-up too:
    # build it here so that phase 3 times the streaming path alone
    t0 = time.perf_counter()
    native = native_binding.native_available()
    print(f"phase 1 native IO library: {'built' if native else 'unavailable (numpy path)'} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    camera16 = make_content(2048, 2048, 16)
    geometries = [
        ("camera 16x2048x2048", camera16),
        ("adversarial 4x2048x2048 maxd 8", make_adversarial(2048, 2048, 4, maxd=8, seed=1)),
        ("random 4x2048x2536", make_content(2536, 2048, 4, kind="random")),
        ("camera 8x2048x320", make_content(320, 2048, 8)),
        ("camera 4x1081x1920", make_content(1920, 1081, 4)),
        ("camera 2x1081x1927", make_content(1927, 1081, 2)),
        ("depth runs 3x16x40000 across block seams", make_depth_runs(40000, 16, 3, seed=2)),
        ("adversarial 2x8x8200, T mod 1024 = 1", make_adversarial(8200, 8, 2, seed=3)),
        ("adversarial 2x8x16376, T mod 1024 = 1023", make_adversarial(16376, 8, 2, seed=4)),
        ("golden 1x8x16", GOLDEN_8x16_IMAGE[None]),
        ("readme 1x10x10", README_10x10_IMAGE[None]),
    ]
    errs = check_kernels(device, geometries)
    print(f"phase 2 kernels equal to plain at every geometry: {errs}", flush=True)
    # every further card: a 2048^2, a narrow and two block-seam geometries,
    # each through K1-K7 (K2, K3 and K6 with their 64 KB stages)
    per_card = {"cuda:0": errs}
    for other in cards[1:]:
        per_card[str(other)] = check_kernels(other, [geometries[i] for i in (0, 3, 6, 7)])
        errs = {k: max(v, per_card[str(other)][k]) for k, v in errs.items()}
    print(f"phase 2 max |kernel - plain| on each card: {json.dumps(per_card)}", flush=True)
    random16 = make_content(2048, 2048, 16, kind="random")
    check_k6_repeats(device, [("camera 16x2048x2048", camera16),
                              ("random 16x2048x2048", random16)])

    stream_frames = np.concatenate([make_content(2048, 2048, 64), random16])
    launches, (t_write, t_read), digest, pinned = check_main_path(device, stream_frames,
                                                                   batch=16)
    n = len(stream_frames)
    print(f"phase 3 main path: 64 camera + 16 random 2048x2048 frames bit-exact; "
          f"write_video {t_write:.4f} s "
          f"({n / t_write:.1f} frames/s), read_video {t_read:.4f} s ({n / t_read:.1f} frames/s) "
          f"(host clock, file IO included, batch 16); launches {launches}; torch's pinned-memory "
          f"cache in bytes {json.dumps(pinned)}, beside {stream_frames.nbytes} bytes of frames",
          flush=True)
    for depth, runs in time_pipelines(device, stream_frames, 16, digest).items():
        legs = "; ".join(f"write {w:.4f} s ({n / w:.1f} frames/s), read {r:.4f} s "
                         f"({n / r:.1f} frames/s)" for w, r in runs)
        print(f"phase 3 pipeline={depth}, same frames, files equal, reads bit-exact: {legs} "
              f"on {card}", flush=True)
    print(f"phase 3 end: torch's pinned-memory cache holds {pinned_cache_bytes(device)} bytes; "
          f"the frames materialize handed back were pageable", flush=True)

    tiles_launches, t_tiles = check_tiles_path(device, [camera16, random16])
    print(f"phase 3b tiles backend: 16 camera + 16 random 2048x2048 frames bit-exact, records "
          f"equal to the band backend's and the numpy oracle's; {t_tiles:.4f} s (host clock, "
          f"record bytes and parse included); launches {tiles_launches}", flush=True)
    launches.update(encode_tiles=tiles_launches["encode_tiles"],
                    decode_tiles=tiles_launches["decode_tiles"])

    summary = check_async(device, camera16, random16)
    print(f"phase 3c sync check: encode of camera, all-depth-8 and mixed batches, decode_dispatch "
          f"from the reader's pinned slots and two DbdeWriter.write at pipeline 2 under "
          f"set_sync_debug_mode('error') raised nothing and returned with the device still "
          f"asleep; {json.dumps(summary)}", flush=True)

    times, bounds = {}, {}
    for content, frames in (("camera", camera16), ("random", random16)):
        times[content] = time_paths(device, frames)
        n64_total = _n64_total(frames, device)
        pix = frames.size
        for name, (k_ms, p_ms) in times[content].items():
            bound = ""
            if name in band.LAUNCHES:
                b_ms, by, nbytes, ops = bounds[content, name] = kernel_bound(name, frames, n64_total)
                bound = (f"; bound {b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
                         f"{ops / 1e6:.0f} M int ops), {b_ms / k_ms:.1%} of it")
            print(f"phase 4 {name} 16x2048x2048 {content}: kernel {k_ms:.4f} ms "
                  f"({pix / k_ms / 1e6:.2f} Gpix/s), plain {p_ms:.4f} ms "
                  f"({pix / p_ms / 1e6:.2f} Gpix/s){bound} on {card}", flush=True)
    k2, k4 = times["random"]["encode_payload"][0], times["random"]["encode_payload_u8"][0]
    for content in times:
        gated, general = times[content]["encode path"][0], times[content]["encode path general"][0]
        print(f"phase 4 band encode path 16x2048x2048 {content}: DbdeCodec.encode (K1 with its "
              f"flag, K2 and K4 gated, no read-back) {gated:.4f} ms beside K1 + K2 alone "
              f"{general:.4f} ms, {gated / general:.3f}x on {card}", flush=True)
    print(f"phase 4 K2 on all-depth-8 content (16x2048x2048 random): {k2:.4f} ms beside "
          f"K4 {k4:.4f} ms for the same bytes, K2/K4 {k2 / k4:.3f} on {card}", flush=True)
    sizes = [("16x2048x2536 camera", make_content(2536, 2048, 16)),
             ("2x4096x4096 camera", make_content(4096, 4096, 2))]
    size_times = time_band_sizes(device, sizes)
    for label, frames in sizes:
        ms, n64_total = size_times[label], _n64_total(frames, device)
        for key, name in (("encode_payload", "K2"), ("decode", "K3")):
            b_ms, by, nbytes, _ = kernel_bound(key, frames, n64_total)
            print(f"phase 4 {name} {label}: {ms[key]:.4f} ms "
                  f"({frames.size / ms[key] / 1e6:.2f} Gpix/s); bound {b_ms:.4f} ms by {by} "
                  f"({nbytes / 1e6:.1f} MB), {b_ms / ms[key]:.1%} of it; the blocks' sums "
                  f"of earlier depths read {prefix_bytes(frames) / 1e6:.1f} MB from L2 "
                  f"on {card}", flush=True)
    for W, paths in time_widths(device, (320, 256, 192, 128)).items():
        for path_name, (b_ms, t_ms) in paths.items():
            pix = 8 * 2048 * W
            print(f"phase 4 narrow 8x2048x{W} camera {path_name} path: band {b_ms:.4f} ms "
                  f"({pix / b_ms / 1e6:.2f} Gpix/s), tiles {t_ms:.4f} ms "
                  f"({pix / t_ms / 1e6:.2f} Gpix/s), tiles/band {t_ms / b_ms:.3f} on {card}",
                  flush=True)

    t5 = time.perf_counter()
    sharded_frames = np.concatenate([stream_frames[:32], random16, stream_frames[:1]])
    ragged = make_content(1920, 1081, 4)
    shard_launches, secs = check_sharded_path(device, sharded_frames, 16, ragged)
    n = len(sharded_frames)
    slots = ",".join(str(d.index) for d in mesh_slots(4, cards))
    print(f"phase 5 sharded, mesh slots on cuda:{slots}: 2x2 mesh file of 32 camera + 16 random "
          f"+ 1 camera 2048x2048 frames equal to write_video's byte for byte and read back "
          f"exactly; 1x4 mesh encode of 4x1081x1920 camera equal to ref_numpy.pack_image, "
          f"decode exact; sharded_roundtrip_step exact with the single-device n64; "
          f"graft_entry.dryrun_multichip(8) over {len(cards)} card(s) and entry() passed",
          flush=True)
    legs = ", ".join(f"{leg} {s:.4f} s ({n / s:.1f} frames/s)" for leg, s in secs.items())
    print(f"phase 5 host clock, {n} 2048x2048 frames, batch 16, file IO included: {legs} "
          f"on {card}", flush=True)
    checked_ms, unchecked_ms = time_shard_encodes(device, camera16)
    print(f"phase 5 shard encodes, 2x2 mesh, 16x2048x2048 camera: {checked_ms:.4f} ms through "
          f"DbdeCodec.encode (K2 and K4 gated, no read-back), {unchecked_ms:.4f} ms as K1 + K2 "
          f"alone (CUDA events) on {card}", flush=True)
    if len(cards) > 1:
        for name, runs in time_distinct_meshes(sharded_frames, 16).items():
            legs = "; ".join(f"write {w:.4f} s ({n / w:.1f} frames/s), read {r:.4f} s "
                             f"({n / r:.1f} frames/s)" for w, r in runs)
            print(f"phase 5 distinct cards, {name}, {n} 2048x2048 frames, batch 16, host clock, "
                  f"file IO included, files equal, reads exact: {legs}", flush=True)
        print("phase 5 distinct cards on " + "; ".join(f"cuda:{i} {v}" for i, v in names.items()))
    else:
        print("phase 5 distinct cards: one card visible; meshes of distinct cards need two")
    print(f"phase 5 took {time.perf_counter() - t5:.1f} s", flush=True)

    # the profiler's first start is set-up too, which the first bench would
    # pay.  It comes here, not in phase 1: on an H100 (torch 2.11) the
    # device records a session delivers thinned out as the process aged
    # after its first session, to none within a few minutes
    x = torch.zeros((1, 8, 8), dtype=torch.uint8, device=device)
    starts = []
    for _ in range(2):
        t0 = time.perf_counter()
        measure_device_seconds(lambda: band.encode_depths(x), reps=1)
        starts.append(time.perf_counter() - t0)
    print(f"phase 6 torch.profiler: first measure_device_seconds {starts[0]:.2f} s, "
          f"second {starts[1]:.2f} s", flush=True)

    t6 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sub_file = os.path.join(tmp, "sub.dbde")
        with open(sub_file, "wb") as f:
            f.write(GOLDEN_8x16_FILE)
        with start_cli_subprocess(sub_file) as sub:  # on another core meanwhile
            cli_launches = check_cli(tmp, QUICKCHECK, pgm_geometry=2)
            finish_cli_subprocess(sub)
    print("phase 6 CLI: golden, info --scan and decode equal to GOLDEN_8x16_IMAGE, and "
          "python -m dbde_tpu_torch.cli info in a subprocess that imports no jax; "
          + ", ".join(f"{W}x{H} {c}" for W, H, c in QUICKCHECK)
          + ": encode equal to the numpy oracle's file, decode equal to the input, "
          "roundtrip OK, launches as the content predicts; decode --pgm-dir and preview "
          f"on 3072x64 ({time.perf_counter() - t6:.1f} s)", flush=True)
    bench_launches = run_cli_benches(card)
    port_launches = run_port_bench(card)
    bench_launches = {k: v + port_launches[k] for k, v in bench_launches.items()}
    print("phase 6 launches: " + json.dumps({"cli files": cli_launches, "bench": bench_launches}))
    print(f"phase 6 took {time.perf_counter() - t6:.1f} s", flush=True)

    torch.cuda.empty_cache()  # the soak's process gets the card's memory
    summary, n_cases, seconds = run_soak()
    for line in summary:
        print(f"phase 7 soak: {line}")
    print(f"phase 7 soak: python {' '.join(SOAK)} ran {n_cases} cases, every check exact, in a "
          f"subprocess that imported no jax ({seconds:.1f} s)", flush=True)

    lines, seconds = run_spans()
    for line in lines:
        print(f"phase 8 {line} on {card}")
    print(f"phase 8 spans: the pipelined write and read under torch.profiler, in a subprocess "
          f"({seconds:.1f} s)", flush=True)

    _require("jax" not in sys.modules, "jax was imported")
    _require(not any(m == "dbde_tpu" or m.startswith("dbde_tpu.") for m in sys.modules),
             "the JAX package was imported")
    rows = []
    for name, key, source, replaces, content in KERNELS:
        b_ms, by, _, _ = bounds[content, key]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[key], "max_abs_err": errs[key],
                     "ms": times[content][key][0], "plain_ms": times[content][key][1],
                     "bound_ms": b_ms, "bound_by": by,
                     # no single PyTorch call computes a DBDE tile pack or unpack
                     "library_ms": None})
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s on {len(cards)} card(s)")
    print("phase 5 launches: " + json.dumps(shard_launches))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
