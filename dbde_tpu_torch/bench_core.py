"""Codec benchmarks on a GPU, and the synthetic frame content they run on.

Counterpart of :mod:`dbde_tpu.bench_core` (the reference's rdtsc harness,
dbde_util_test.cpp:303-364, re-done as measured device time).  Content:
the port's own copies of ``make_content``, ``make_adversarial`` and
``make_uniform8``, the same frames from the same seeds, and
``make_depth_runs``, content for the seams between the tiles backend's
blocks of 1024 tiles.  Runners, with the JAX runners' parameters, defaults
and result keys:

  * :func:`run_bench` — ``DbdeCodec`` encode and decode Gpix/s;
  * :func:`run_latency_bench` — the same at batch 1;
  * :func:`run_stream_bench` — ``DbdeWriter``/``DbdeReader`` over a file,
    host clock;
  * :func:`run_composed_stream_bench` — each streaming leg alone, composed
    under the pipeline's overlap;
  * :func:`run_host_stream_bench` — the record walker alone.

Each runner that touches the codec takes ``device`` (``"cuda"`` by
default) and times its device legs with CUDA events, with the device's busy
time from the profiler as an extra ``device_busy_ms`` field; without a GPU
the timers raise.  A kernel that fails to build or launch raises; nothing
retries on another backend or device.  Every runner checks its decoded
frames before it reports.
"""

from __future__ import annotations

import collections
import os
import tempfile
import time

import numpy as np
import torch

from . import ref_numpy
from .codec import DbdeCodec, one_band, record_iovecs
from .format import FrameHeader, VideoHeader
from .stream import DbdeReader, DbdeWriter, _GatedPool, _writev_all
from .utils.profiling import card_name, cuda_event_seconds, measure_device_seconds

# The reference's single-core throughput (library -O3, driver -O0, under
# its harness's 3.33 GHz convention), as the JAX package's bench takes it
# (BASELINE.md "Reference baseline provenance")
REFERENCE_DECODE_GPIX_S = 2.9
REFERENCE_ENCODE_GPIX_S = 2.8


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


def make_uniform8(width: int, height: int, frames: int, seed: int = 0
                  ) -> np.ndarray:
    """Frames whose EVERY 8x8 tile (including cropped edge tiles) realizes
    depth exactly 8: random bytes with per-tile extremes pinned (rows ≡0
    (mod 8) carry 0 on cols ≡0 (mod 4), rows ≡1 carry 255 on cols ≡1 (mod
    4)), so any tile with ≥2 real rows and ≥2 real cols spans [0, 255].
    Geometries with H%8==1 or W%8==1 have single-pixel edge tiles that
    cannot reach depth 8 → ValueError."""
    if height % 8 == 1 or width % 8 == 1:
        raise ValueError("H%8==1 or W%8==1 leaves single-pixel edge tiles "
                         "that cannot realize depth 8")
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (frames, height, width)).astype(np.uint8)
    img[:, 0::8, 0::4] = 0
    img[:, 1::8, 1::4] = 255
    return img


def _measure(fn, device: torch.device, reps: int = 4) -> tuple[float, float]:
    """(seconds per call of ``fn()`` from CUDA events, device busy seconds
    per call from the profiler), each over ``reps`` calls on the card
    ``device``."""
    cards = [device.index]
    return (cuda_event_seconds(fn, reps, cards=cards),
            measure_device_seconds(fn, reps=reps, cards=cards))


def _busy_ms(**busy) -> dict:
    """{leg: device busy ms} from {leg: seconds}."""
    return {k: round(v * 1e3, 4) for k, v in busy.items()}


def _check_frames(out: np.ndarray, want: np.ndarray, what: str) -> None:
    if not np.array_equal(out, want):  # never report perf on wrong results
        raise AssertionError(f"{what} did not return the source frames")


def run_bench(width: int = 2048, height: int = 2048, frames: int = 8,
              iters: int = 4, content: str = "camera", device="cuda") -> dict:
    """Encode and decode Gpix/s of ``DbdeCodec`` (the band backend) on ``device``.

    Encode is ``codec.encode`` of a batch already on the device (K1, then
    K2 and K4 gated on the device by K1's flag); decode is
    ``codec.decode_dispatch`` with host depths, as the reader passes them,
    and minima and payload on the device.  The decoded frames must equal
    the source before anything is reported."""
    codec = DbdeCodec(height=height, width=width, device=device)
    images_np = make_content(width, height, frames, content)
    x = torch.from_numpy(images_np).to(codec.device)
    npix = frames * height * width

    enc = codec.encode(x)
    depths = enc.depths.cpu().numpy()
    t_enc, busy_enc = _measure(lambda: codec.encode(x), codec.device, iters)
    t_dec, busy_dec = _measure(lambda: codec.decode_dispatch(depths, enc.mins, enc.payload),
                               codec.device, iters)
    _check_frames(codec.decode(depths, enc.mins, enc.payload), images_np, "run_bench's decode")

    n64 = int(enc.n64.to(torch.int64).sum())
    encoded_bytes = 12 * frames + 2 * codec.tiles * frames + 8 * n64
    dec_gpix = npix / t_dec / 1e9
    enc_gpix = npix / t_enc / 1e9
    return {
        "metric": "decode_gpix_per_s",
        "value": round(dec_gpix, 3),
        "unit": "Gpix/s",
        "vs_baseline": round(dec_gpix / REFERENCE_DECODE_GPIX_S, 2),
        "encode_gpix_per_s": round(enc_gpix, 3),
        "encode_vs_baseline": round(enc_gpix / REFERENCE_ENCODE_GPIX_S, 2),
        "geometry": f"{frames}x{height}x{width}",
        "content": content,
        "backend": codec.backend,
        "compression_ratio": round(encoded_bytes / npix, 4),
        "device": card_name(codec.device.index),
        "device_busy_ms": _busy_ms(encode=busy_enc, decode=busy_dec),
    }


def run_stream_bench(width: int = 2048, height: int = 2048, frames: int = 64,
                     batch_size: int = 16, content: str = "camera",
                     path: str | None = None, repeats: int = 2, device="cuda") -> dict:
    """End-to-end sustained streaming (BASELINE configs[2]/[4]): host clock
    around a whole file written with ``DbdeWriter`` and read back with
    ``DbdeReader`` on ``device``, record assembly and parse, host↔device
    copies, codec and file IO included; the read checks every frame
    against its source frame, by the headers' indices.  The best of
    ``repeats`` is reported."""
    npix = frames * height * width
    src = make_content(width, height, min(frames, 64), content)
    own = path is None
    if own:
        fd, path = tempfile.mkstemp(suffix=".dbde")
        os.close(fd)
    try:
        t_write = []
        t_read = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            with DbdeWriter(path, height=height, width=width, frame_hz=1000.0,
                            device=device) as wr:
                done = 0
                while done < frames:
                    # cycle through the source stack so file frame i always
                    # holds src[i % len(src)]: the read's check relies on it
                    base = done % src.shape[0]
                    n = min(batch_size, frames - done, src.shape[0] - base)
                    wr.write(src[base : base + n], indices=range(done, done + n))
                    done += n
            t_write.append(time.perf_counter() - t0)

            t0 = time.perf_counter()
            got = 0
            with DbdeReader(path, batch_size=batch_size, device=device) as rd:
                for headers, out in rd:
                    # file frame i holds src[i % len(src)], wrapped or not
                    index = np.array([h.index for h in headers]) % src.shape[0]
                    _check_frames(out, src[index], "run_stream_bench's read")
                    got += len(headers)
            t_read.append(time.perf_counter() - t0)
            if got != frames:
                raise AssertionError(f"read {got} frames of {frames}")
        enc_bytes = os.path.getsize(path)
        tw, tr = min(t_write), min(t_read)
        return {
            "metric": "stream_decode_gpix_per_s",
            "value": round(npix / tr / 1e9, 3),
            "unit": "Gpix/s",
            "stream_encode_gpix_per_s": round(npix / tw / 1e9, 3),
            "frames": frames,
            "geometry": f"{height}x{width}",
            "batch_size": batch_size,
            "content": content,
            "file_bytes": enc_bytes,
            "frame_hz_equiv_decode": round(frames / tr, 1),
            "frame_hz_equiv_encode": round(frames / tw, 1),
            "note": "wall clock end-to-end incl. host parse/assembly and transfer",
        }
    finally:
        if own:
            os.unlink(path)


def run_composed_stream_bench(width: int = 2048, height: int = 2048,
                              frames: int = 64, batch_size: int = 16,
                              content: str = "camera", device="cuda") -> dict:
    """Sustained streaming as the slowest of its legs, each measured alone.

    The writer and reader keep ``pipeline`` batches in flight, so their legs
    run concurrently and the sustained rate is that of the slowest.  Each
    leg is measured where it runs: the device legs on ``device`` (CUDA
    events), the host legs on the host clock over ``/dev/shm``.  The
    host↔device copies are not a leg: the result gives the link bandwidth
    the composed rate needs in each direction, to set against the host's
    PCIe (a local link here, measured by none of the legs).

      * device encode: ``codec.encode`` of a batch already on the device;
      * device decode: ``codec.decode_dispatch`` of the file-shaped inputs
        the reader dispatches, a flat (B, stride) payload at the reader's
        64Ki-word stride rounding on the device, with host depths;
      * host write: ``record_iovecs`` + ``writev`` of each batch, the path
        ``DbdeWriter`` takes to a file;
      * host parse: the reader's release-gated parse
        (``_read_batch_arrays`` with a ``_GatedPool``), with releases
        sequenced as its ``__iter__`` sequences them.
    """
    codec = DbdeCodec(height=height, width=width, device=device)
    B = batch_size
    src = make_content(width, height, B, content)
    npix_b = B * height * width
    x = torch.from_numpy(src).to(codec.device)

    # --- device legs ---
    t_enc_dev, busy_enc = _measure(lambda: codec.encode(x), codec.device)
    enc = codec.encode(x)
    depths, mins, n64 = enc.depths.cpu().numpy(), enc.mins.cpu().numpy(), enc.n64.cpu().numpy()
    payload = enc.payload_host(2 * int(n64.max()))

    stride = min(16 * codec.tiles, -(-2 * int(n64.max()) // 65536) * 65536 or 2)
    pay_flat = np.zeros((B, stride), np.uint32)
    live = payload[:, :stride]
    pay_flat[:, : live.shape[1]] = live
    pay_dev = torch.from_numpy(pay_flat).to(codec.device)
    t_dec_dev, busy_dec = _measure(lambda: codec.decode_dispatch(depths, enc.mins, pay_dev),
                                   codec.device)
    _check_frames(codec.decode(depths, enc.mins, pay_dev), src, "the composed bench's decode")

    # --- host legs over /dev/shm (no device, no transfer) ---
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    fd, path = tempfile.mkstemp(suffix=".dbde", dir=shm)
    os.close(fd)
    try:
        nbatches = max(1, frames // B)
        # each pass writes a fresh file (sustained writes always hit fresh
        # pages); the median rides out the host's occasional reclaim stalls
        t_write = []
        for _ in range(3):
            with open(path, "wb") as f:
                f.write(VideoHeader(height=height, width=width, frame_hz=1000.0).pack())
                f.flush()
                for i in range(nbatches):
                    t0 = time.perf_counter()
                    _writev_all(f.fileno(), record_iovecs(
                        *one_band(depths, mins, payload, n64), n64,
                        indices=range(i * B, i * B + B)))
                    t_write.append(time.perf_counter() - t0)
            enc_bytes = os.path.getsize(path)
        t_asm = float(np.median(t_write))

        # a batch's slot frees `pipeline` batches later, when its decode
        # would materialize; the median skips the pool's warm-up batches
        t_parse = []
        for _ in range(3):
            got = 0
            with DbdeReader(path, batch_size=B, device=codec.device) as rd:
                pool = _GatedPool()
                inflight = collections.deque()
                while True:
                    t0 = time.perf_counter()
                    batch = rd._read_batch_arrays(pool=pool)
                    if batch is None:
                        break
                    t_parse.append(time.perf_counter() - t0)
                    got += len(batch[0])
                    inflight.append(batch[2])
                    if len(inflight) > rd.pipeline:
                        inflight.popleft()()  # release as materialize would
            if got != nbatches * B:
                raise AssertionError(f"parsed {got} frames of {nbatches * B}")
        t_par = float(np.median(t_parse))
    finally:
        os.unlink(path)

    enc_leg = max(t_enc_dev, t_asm)
    dec_leg = max(t_dec_dev, t_par)
    enc_gpix = npix_b / enc_leg / 1e9
    dec_gpix = npix_b / dec_leg / 1e9
    enc_bytes_b = enc_bytes / nbatches
    return {
        "metric": "composed_stream_decode_gpix_per_s",
        "value": round(dec_gpix, 3),
        "unit": "Gpix/s",
        "composed_stream_encode_gpix_per_s": round(enc_gpix, 3),
        "frame_hz_equiv_decode": round(dec_gpix * 1e9 / (height * width), 1),
        "frame_hz_equiv_encode": round(enc_gpix * 1e9 / (height * width), 1),
        "legs_ms_per_batch": {
            "device_encode": round(t_enc_dev * 1e3, 3),
            "host_assemble_write": round(t_asm * 1e3, 3),
            "host_walk_parse": round(t_par * 1e3, 3),
            "device_decode": round(t_dec_dev * 1e3, 3),
        },
        "required_link_gb_per_s": {
            "encode_h2d_raw": round(npix_b / enc_leg / 1e9, 2),
            "encode_d2h_packed": round(enc_bytes_b / enc_leg / 1e9, 2),
            "decode_h2d_packed": round(enc_bytes_b / dec_leg / 1e9, 2),
            "decode_d2h_raw": round(npix_b / dec_leg / 1e9, 2),
        },
        "geometry": f"{height}x{width}",
        "batch_size": B,
        "content": content,
        "backend": codec.backend,
        "host_assembler": "writev",
        "note": "per-leg measurement composed under the 2-deep pipeline "
                "overlap; transfer reported as required link bandwidth "
                "(set it against the host's PCIe)",
        "device_busy_ms": _busy_ms(encode=busy_enc, decode=busy_dec),
    }


def run_latency_bench(width: int = 2048, height: int = 2048,
                      content: str = "camera", device="cuda") -> dict:
    """Single-frame (batch=1) codec latency, the reference driver's
    per-frame timing analogue (dbde_util_test.cpp:234-299): a camera
    pipeline at batch 1 pays a whole call's host dispatch per frame."""
    codec = DbdeCodec(height=height, width=width, device=device)
    img = make_content(width, height, 1, content)
    x = torch.from_numpy(img).to(codec.device)
    enc = codec.encode(x)
    depths = enc.depths.cpu().numpy()
    t_enc, busy_enc = _measure(lambda: codec.encode(x), codec.device, 8)
    t_dec, busy_dec = _measure(lambda: codec.decode_dispatch(depths, enc.mins, enc.payload),
                               codec.device, 8)
    _check_frames(codec.decode(depths, enc.mins, enc.payload), img, "run_latency_bench's decode")
    npix = height * width
    return {
        "metric": "decode_latency_ms_per_frame",
        "value": round(t_dec * 1e3, 4),
        "unit": "ms",
        "encode_latency_ms_per_frame": round(t_enc * 1e3, 4),
        "decode_hz_equiv": round(1.0 / t_dec, 1),
        "encode_hz_equiv": round(1.0 / t_enc, 1),
        "decode_gpix_per_s": round(npix / t_dec / 1e9, 3),
        "encode_gpix_per_s": round(npix / t_enc / 1e9, 3),
        "geometry": f"1x{height}x{width}",
        "content": content,
        "backend": codec.backend,
        "device": card_name(codec.device.index),
        "note": "batch=1 time a call, host dispatch included (CUDA events)",
        "device_busy_ms": _busy_ms(encode=busy_enc, decode=busy_dec),
    }


def run_host_stream_bench(width: int = 2048, height: int = 2048, frames: int = 256,
                          batch_size: int = 16, content: str = "camera",
                          repeats: int = 3) -> dict:
    """Host-only walker benchmark: sustained record scan/parse rate.

    Isolates the streaming layer (the reference walker's role,
    dbde_util.cpp:362-426) from codec and host↔device copies: the file
    holds ONE frame encoded by the numpy oracle, repeated under per-frame
    headers, and :meth:`DbdeReader.iter_raw` walks it without decoding, so
    the reader's codec stays on the CPU and no device is touched.  This
    bounds the host cost a camera pipeline pays per frame on top of the
    codec, the number that must exceed the camera rate (1 kHz for
    BASELINE configs[4]).
    """
    img = make_content(width, height, 1, content)[0]
    data = ref_numpy.pack_image(img)
    fd, path = tempfile.mkstemp(suffix=".dbde")
    os.close(fd)
    try:
        with open(path, "wb") as f:
            f.write(VideoHeader(height=height, width=width, frame_hz=1000.0).pack())
            for i in range(frames):
                f.write(FrameHeader(index=i).pack())
                f.write(data)
        file_bytes = os.path.getsize(path)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = 0
            with DbdeReader(path, batch_size=batch_size, device="cpu") as rd:
                for headers, _ in rd.iter_raw():
                    got += len(headers)
            times.append(time.perf_counter() - t0)
            if got != frames:
                raise AssertionError(f"walked {got} frames of {frames}")
        t = min(times)
        npix = frames * height * width
        return {
            "metric": "host_walk_gpix_per_s",
            "value": round(npix / t / 1e9, 3),
            "unit": "Gpix/s",
            "frames": frames,
            "geometry": f"{height}x{width}",
            "batch_size": batch_size,
            "content": content,
            "file_bytes": file_bytes,
            "file_gb_per_s": round(file_bytes / t / 1e9, 3),
            "frame_hz_equiv": round(frames / t, 1),
            "note": "host-only record scan/parse (iter_raw), no codec/transfer",
        }
    finally:
        os.unlink(path)
