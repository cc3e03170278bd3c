#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs CUDA and nvcc

Phases, one line each, in order:
  0  device: the card's name and power limit (nvidia-smi), torch and CUDA
  1  build: the CUDA kernels, compiled with nvcc from dbde_tpu_torch/csrc,
     and the stream layer's native IO library (g++)
  2  each kernel (K1 encode_depths, K2 encode_payload, K3 decode, and the
     uniform depth-8 pair K4 encode_payload_u8, K5 decode_u8) against its
     plain PyTorch version on the same CUDA tensors, exact equality, at the
     flagship and ragged geometries; K2 and K4 must leave every word past
     their own untouched, K3 and K5 must decode from payloads with garbage
     after each frame's stream, and where every tile is depth 8 K4's
     payload must equal K2's
  3  the main path: write_video then read_video of 64 2048² camera frames
     and 16 2048² random frames (every tile depth 8) in batches of 16,
     bit-exact, first records byte-equal to the numpy oracle, each camera
     batch through K1/K2/K3 and the random batch through K1/K4/K5
  4  timing with CUDA events: each kernel and the encode/decode paths
     against their plain versions at 16×2048² camera and random content

Any failure raises, so the script exits non-zero without the final line.
The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dbde_tpu import ref_numpy
from dbde_tpu.bench_core import make_adversarial, make_content
from dbde_tpu.format import VIDEO_HEADER_BYTES
from dbde_tpu.golden_vectors import GOLDEN_8x16_IMAGE, README_10x10_IMAGE
from dbde_tpu.native import binding as native_binding
from dbde_tpu_torch import read_video, write_video
from dbde_tpu_torch.codec import DbdeCodec, EncodedBatch, all_depth8, pack_frames_bytes
from dbde_tpu_torch.ops import band
from dbde_tpu_torch.ops.build import build
from dbde_tpu_torch.ops.payload import word_offsets

SOURCE = "dbde_tpu_torch/csrc/dbde_kernels.cu"
# (kernel, LAUNCHES key, the TPU kernel it replaces, phase-4 content)
KERNELS = (
    ("dbde_encode_depths", "encode_depths", "dbde_tpu/ops/pallas_band.py:370", "camera"),
    ("dbde_encode_payload", "encode_payload", "dbde_tpu/ops/pallas_band.py:419", "camera"),
    ("dbde_decode", "decode", "dbde_tpu/ops/pallas_band.py:1308", "camera"),
    ("dbde_encode_payload_u8", "encode_payload_u8", "dbde_tpu/ops/pallas_band.py:1017", "random"),
    ("dbde_decode_u8", "decode_u8", "dbde_tpu/ops/pallas_band.py:1182", "random"),
)
SENTINEL = 0xDEADBEEF
TOLERANCE = 0  # the codec is integer-valued: kernels and plain versions agree exactly


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


def check_kernels(device: torch.device, geometries, seed: int = 0) -> dict[str, int]:
    """Phase 2: every kernel against its plain version on ``device``.

    ``geometries`` is a list of (label, (B, H, W) u8 numpy frames).  Returns
    the largest |kernel - plain| per kernel over all of them; raises unless
    each is within TOLERANCE and the frames round-trip exactly.
    """
    rng = np.random.default_rng(seed)
    errs = dict.fromkeys(band.LAUNCHES, 0)
    for label, frames in geometries:
        B, H, W = frames.shape
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        d, m = band.encode_depths(x)
        dp, mp = band.encode_depths_plain(x)
        _sync(device)
        e1 = max(_max_err(d, dp), _max_err(m, mp))

        offsets, total = word_offsets(d)
        n64 = (total // 2).cpu().numpy()
        T = d.shape[1]
        fill = np.full((B, 16 * T), SENTINEL, np.uint32)
        pk = band.encode_payload(x, d, m, offsets, out=torch.from_numpy(fill.copy()).to(device))
        pp = band.encode_payload_plain(x, d, m, offsets, out=torch.from_numpy(fill).to(device))
        _sync(device)
        e2 = _max_err(pk, pp)
        pk_host = pk.cpu().numpy()
        for b in range(B):
            _require((pk_host[b, 2 * int(n64[b]):] == SENTINEL).all(),
                     f"{label}: encode_payload wrote past 2*n64 in frame {b}")
        rec = pack_frames_bytes(EncodedBatch(d, m, pk, total // 2))[0]
        _require(rec[20:] == ref_numpy.pack_image(frames[0]),
                 f"{label}: frame 0 differs from the numpy oracle's bytes")

        out_k = band.decode_frames(d, m, offsets, pk, H, W)
        out_p = band.decode_frames_plain(d, m, offsets, pk, H, W)
        _sync(device)
        e3 = _max_err(out_k, out_p)
        _require(torch.equal(out_k, x), f"{label}: decode did not return the frames")

        # the reader's stride: live words rounded up to 65536, garbage after them
        S = -(-2 * int(n64.max()) // 65536) * 65536 or 2
        short = rng.integers(0, 1 << 32, (B, S), dtype=np.uint32)
        for b in range(B):
            short[b, : 2 * int(n64[b])] = pk_host[b, : 2 * int(n64[b])]
        sp = torch.from_numpy(short).to(device)
        out_k = band.decode_frames(d, m, offsets, sp, H, W)
        out_p = band.decode_frames_plain(d, m, offsets, sp, H, W)
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
        fill = np.full((B, full + 3), SENTINEL, np.uint32)
        pk4s = band.encode_payload_u8(x, m, out=torch.from_numpy(fill.copy()).to(device))
        pp4s = band.encode_payload_u8_plain(x, m, out=torch.from_numpy(fill).to(device))
        _sync(device)
        e4 = max(_max_err(pk4, pp4), _max_err(pk4s, pp4s))
        _require(torch.equal(pk4s[:, :full], pk4), f"{label}: encode_payload_u8 paths differ")
        _require(bool((pk4s[:, full:].cpu().numpy() == SENTINEL).all()),
                 f"{label}: encode_payload_u8 wrote past 16*T")
        uniform = all_depth8(d)
        if uniform:
            _require(bool((n64 == 8 * T).all()) and torch.equal(pk4.cpu(), pk.cpu()),
                     f"{label}: every tile is depth 8 but K4's payload is not K2's")
        e5 = 0
        for src in (pk4, pk4s):
            out_k = band.decode_frames_u8(m, src, H, W)
            out_p = band.decode_frames_u8_plain(m, src, H, W)
            _sync(device)
            e5 = max(e5, _max_err(out_k, out_p))
            _require(torch.equal(out_k, x), f"{label}: decode_u8 did not return the frames")

        for name, e in zip(errs, (e1, e2, e3, e4, e5)):
            errs[name] = max(errs[name], e)
        print(f"phase 2 {label}: max |kernel - plain| K1 {e1} K2 {e2} K3 {e3} K4 {e4} K5 {e5}; "
              f"n64 max {int(n64.max())}, stride {S}, all depth 8: {uniform}", flush=True)
    _require(max(errs.values()) <= TOLERANCE, f"kernels disagree with plain: {errs}")
    return errs


def expected_launches(frames: np.ndarray, batch: int) -> dict[str, int]:
    """Kernel launches of a write_video + read_video of ``frames`` on a GPU:
    each batch runs K1, then K4 and K5 if every tile of it is depth 8 (by
    the numpy oracle's depth map), else K2 and K3."""
    n = dict.fromkeys(band.LAUNCHES, 0)
    for i in range(0, len(frames), batch):
        uniform = all(int(ref_numpy.tile_depths_mins(ref_numpy.tile_image(f))[0].min()) == 8
                      for f in frames[i : i + batch])
        n["encode_depths"] += 1
        n["encode_payload_u8" if uniform else "encode_payload"] += 1
        n["decode_u8" if uniform else "decode"] += 1
    return n


def check_main_path(device: torch.device, frames: np.ndarray, batch: int):
    """Phase 3: write_video → read_video through the port.  Returns
    (launches per kernel during the run, (write seconds, read seconds)),
    both on the host clock and including the file IO."""
    N, H, W = frames.shape
    # plain versions on the CPU launch nothing
    expected = expected_launches(frames, batch) if device.type == "cuda" \
        else dict.fromkeys(band.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.dbde")
        band.reset_launches()
        t0 = time.perf_counter()
        write_video(path, frames, frame_hz=1000.0, device=device, batch_size=batch)
        t1 = time.perf_counter()
        vh, headers, out = read_video(path, device=device, batch_size=batch)
        seconds = (t1 - t0, time.perf_counter() - t1)
        launches = dict(band.LAUNCHES)
        want = b"".join(ref_numpy.pack_frame(i, frames[i]) for i in range(min(2, N)))
        with open(path, "rb") as f:
            f.seek(VIDEO_HEADER_BYTES)
            got = f.read(len(want))
    _require((vh.height, vh.width) == (H, W), "video header geometry")
    _require([h.index for h in headers] == list(range(N)), "frame indices")
    _require(np.array_equal(out, frames), "read_video did not return the written frames")
    _require(got == want, "first records differ from ref_numpy.pack_frame")
    _require(launches == expected, f"launches {launches}, expected {expected}")
    return launches, seconds


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_paths(device: torch.device, frames: np.ndarray, iters: int = 20) -> dict:
    """Phase 4: ms per call of kernel and plain version, measured in turns
    (plain, kernel, kernel, plain) and averaged per version.

    The encode path is ``DbdeCodec.encode`` (K1, the depth-8 check, then
    scan + K2 or K4) against the same steps in plain versions; "encode
    path general" is K1 + scan + K2 with no check, which prices the check
    and, on all-depth-8 content, what K4 saves.  The decode
    path is scan + K3, or K5 when every tile is depth 8; that choice is made
    once on the host, as the reader makes it from host depths."""
    B, H, W = frames.shape
    x = torch.from_numpy(frames).to(device)
    codec = DbdeCodec(H, W, device=device)
    d, m = band.encode_depths(x)
    off, _ = word_offsets(d)
    p = band.encode_payload(x, d, m, off)
    buf = torch.empty_like(p)
    uniform = all_depth8(d)

    def encode_plain():
        dd, mm = band.encode_depths_plain(x)
        if all_depth8(dd):
            return band.encode_payload_u8_plain(x, mm)
        oo, _ = word_offsets(dd)
        return band.encode_payload_plain(x, dd, mm, oo)

    def encode_general(depths_fn, payload_fn):
        dd, mm = depths_fn(x)
        oo, _ = word_offsets(dd)
        return payload_fn(x, dd, mm, oo)

    def decode(general, u8):
        if uniform:
            return u8(m, p, H, W)
        oo, _ = word_offsets(d)
        return general(d, m, oo, p, H, W)

    cases = {
        "encode_depths": (lambda: band.encode_depths(x), lambda: band.encode_depths_plain(x)),
        "encode_payload": (lambda: band.encode_payload(x, d, m, off, out=buf),
                           lambda: band.encode_payload_plain(x, d, m, off, out=buf)),
        "decode": (lambda: band.decode_frames(d, m, off, p, H, W),
                   lambda: band.decode_frames_plain(d, m, off, p, H, W)),
    }
    if uniform:
        cases.update({
            "encode_payload_u8": (lambda: band.encode_payload_u8(x, m, out=buf),
                                  lambda: band.encode_payload_u8_plain(x, m, out=buf)),
            "decode_u8": (lambda: band.decode_frames_u8(m, p, H, W),
                          lambda: band.decode_frames_u8_plain(m, p, H, W)),
        })
    cases.update({
        "encode path": (lambda: codec.encode(x), encode_plain),
        "encode path general": (lambda: encode_general(band.encode_depths, band.encode_payload),
                                lambda: encode_general(band.encode_depths_plain,
                                                       band.encode_payload_plain)),
        "decode path": (lambda: decode(band.decode_frames, band.decode_frames_u8),
                        lambda: decode(band.decode_frames_plain, band.decode_frames_u8_plain)),
    })
    times = {}
    for name, (kernel, plain) in cases.items():
        p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kernel, kernel, plain))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU and none is visible")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"phase 0 device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    path, log = build(ptxas_verbose=True)
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    band.encode_depths(torch.zeros((1, 8, 8), dtype=torch.uint8, device=device))  # loads the library
    _sync(device)
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
        ("camera 4x1081x1920", make_content(1920, 1081, 4)),
        ("camera 2x1081x1927", make_content(1927, 1081, 2)),
        ("golden 1x8x16", GOLDEN_8x16_IMAGE[None]),
        ("readme 1x10x10", README_10x10_IMAGE[None]),
    ]
    errs = check_kernels(device, geometries)
    print(f"phase 2 kernels equal to plain at every geometry: {errs}", flush=True)

    random16 = make_content(2048, 2048, 16, kind="random")
    stream_frames = np.concatenate([make_content(2048, 2048, 64), random16])
    launches, (t_write, t_read) = check_main_path(device, stream_frames, batch=16)
    n = len(stream_frames)
    print(f"phase 3 main path: 64 camera + 16 random 2048x2048 frames bit-exact; "
          f"write_video {t_write:.4f} s "
          f"({n / t_write:.1f} frames/s), read_video {t_read:.4f} s ({n / t_read:.1f} frames/s) "
          f"(host clock, file IO included, batch 16); launches {launches}", flush=True)

    times = {}
    for content, frames in (("camera", camera16), ("random", random16)):
        times[content] = time_paths(device, frames)
        pix = frames.size
        for name, (k_ms, p_ms) in times[content].items():
            print(f"phase 4 {name} 16x2048x2048 {content}: kernel {k_ms:.4f} ms "
                  f"({pix / k_ms / 1e6:.2f} Gpix/s), plain {p_ms:.4f} ms "
                  f"({pix / p_ms / 1e6:.2f} Gpix/s) on {card}", flush=True)

    _require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[key], "max_abs_err": errs[key],
         "ms": times[content][key][0], "plain_ms": times[content][key][1]}
        for name, key, replaces, content in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
