"""Command-line interface: encode/decode/inspect/preview DBDE videos on a GPU.

The port's counterpart of :mod:`dbde_tpu.cli`, with its subcommands,
arguments and defaults: the runtime replacement for the reference's
compile-time ``#ifdef`` test-driver flags (``DBDE_WRITE_MINIMAL``,
``DBDE_READ_FILE_TEST``, ``DBDE_WRITE_A_FRAME``; dbde_util_test.cpp:204-211,
368-398).

  python -m dbde_tpu_torch.cli info    video.dbde [--scan]
  python -m dbde_tpu_torch.cli encode  frames.raw --width 640 --height 480 -o out.dbde
  python -m dbde_tpu_torch.cli decode  video.dbde -o frames.raw [--pgm-dir d/]
  python -m dbde_tpu_torch.cli preview video.dbde [--frame N]
  python -m dbde_tpu_torch.cli roundtrip video.dbde   # integrity check
  python -m dbde_tpu_torch.cli golden  -o minimal.dbde [--frames N]
  python -m dbde_tpu_torch.cli bench   [--width W --height H --frames N]
                                       [--stream | --host-stream | --composed | --latency]

``encode``, ``decode``, ``roundtrip``, ``preview`` and ``bench`` run the
CUDA kernels and raise without a GPU; ``--no-device`` (all but ``bench``)
runs the plain PyTorch versions on the CPU instead.  ``preview`` walks the
records without decoding them up to its frame, then decodes that one.
``info`` is host-only, as in the JAX package: ``info --scan`` walks the
records and decodes nothing.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np

from . import bench_core
from .codec import DbdeCodec
from .format import VIDEO_HEADER_BYTES, unpack_video_header
from .golden_vectors import GOLDEN_8x16_FILE
from .stream import DbdeReader, DbdeWriter, read_video, write_video
from .utils.visualize import ascii_preview, write_pgm


def _device(args) -> str:
    return "cpu" if args.no_device else "cuda"


def _cmd_info(args) -> int:
    with open(args.file, "rb") as f:
        head = f.read(VIDEO_HEADER_BYTES)
        size = os.fstat(f.fileno()).st_size
    vh, _ = unpack_video_header(head)
    if not vh.ok:
        print("not a DBDE file (bad video header)", file=sys.stderr)
        return 1
    print(f"geometry:  {vh.width} x {vh.height}")
    print(f"frame_hz:  {vh.frame_hz}")
    print(f"file size: {size} bytes")
    if args.scan:
        with DbdeReader(args.file, device="cpu") as r:
            n = 0
            first = last = None
            for headers, _ in r.iter_raw():
                for fh in headers:
                    if first is None:
                        first = fh
                    last = fh
                    n += 1
            print(f"frames:    {n}")
            if first is not None:
                print(f"indices:   {first.index} .. {last.index}")
                npix = n * vh.width * vh.height
                print(f"ratio:     {size / npix:.4f} bytes/pixel")
    return 0


def _cmd_encode(args) -> int:
    W, H = args.width, args.height
    raw = np.fromfile(args.input, dtype=np.uint8)
    if raw.size % (W * H) != 0:
        print(f"input size {raw.size} not a multiple of {W}x{H}", file=sys.stderr)
        return 1
    frames = raw.reshape(-1, H, W)
    t0 = time.perf_counter()
    write_video(args.output, frames, frame_hz=args.hz, device=_device(args),
                batch_size=args.batch)
    dt = time.perf_counter() - t0
    out_size = os.path.getsize(args.output)
    print(f"encoded {frames.shape[0]} frames ({raw.size} px) in {dt:.3f}s "
          f"({raw.size / dt / 1e9:.2f} Gpix/s end-to-end), "
          f"{out_size} bytes (ratio {out_size / raw.size:.3f})")
    return 0


def _cmd_decode(args) -> int:
    t0 = time.perf_counter()
    vh, headers, frames = read_video(args.file, device=_device(args), batch_size=args.batch)
    dt = time.perf_counter() - t0
    npix = frames.size
    if args.output:
        frames.tofile(args.output)
    if args.pgm_dir:
        os.makedirs(args.pgm_dir, exist_ok=True)
        for fh, img in zip(headers, frames):
            write_pgm(os.path.join(args.pgm_dir, f"frame_{fh.index:06d}.pgm"), img)
    print(f"decoded {len(headers)} frames ({npix} px) in {dt:.3f}s "
          f"({npix / dt / 1e9:.2f} Gpix/s end-to-end)")
    return 0


def _cmd_preview(args) -> int:
    seen = 0
    with DbdeReader(args.file, batch_size=1, device=_device(args)) as r:
        for headers, (depths, mins, payload, _) in r.iter_raw():
            if seen == args.frame:
                codec = DbdeCodec(r.height, r.width, device=_device(args))
                img = codec.decode(depths, mins, payload)[0]
                print(f"frame {headers[0].index} ({r.width}x{r.height}):")
                print(ascii_preview(img, size=args.size))
                return 0
            seen += 1
    print(f"frame {args.frame} not found ({seen} frames in file)", file=sys.stderr)
    return 1


def _cmd_roundtrip(args) -> int:
    """Decode + re-encode the file; verify bit-exact equality."""
    vh, headers, frames = read_video(args.file, device=_device(args))
    buf = io.BytesIO()
    with DbdeWriter(buf, height=vh.height, width=vh.width, frame_hz=vh.frame_hz,
                    device=_device(args)) as wr:
        wr.write(frames, indices=[h.index for h in headers],
                 elapsed_ns=[h.elapsed_ns for h in headers])
    ours = buf.getvalue()
    with open(args.file, "rb") as f:
        theirs = f.read()
    if ours == theirs:
        print(f"OK: {len(headers)} frames, {len(ours)} bytes, bit-exact re-encode")
        return 0
    print(f"MISMATCH: re-encode differs ({len(ours)} vs {len(theirs)} bytes)", file=sys.stderr)
    return 1


def _cmd_golden(args) -> int:
    """Write the format-conformance golden file (the reference's
    DBDE_WRITE_MINIMAL / DBDE_MULTIPLE_MINIMAL_FRAMES fixture generator,
    dbde_util_test.cpp:204-211, as a runtime command)."""
    data = GOLDEN_8x16_FILE
    if args.frames > 1:
        data = data + GOLDEN_8x16_FILE[VIDEO_HEADER_BYTES:] * (args.frames - 1)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes ({args.frames} frame(s)) to {args.output}")
    return 0


def _cmd_bench(args) -> int:
    size = dict(width=args.width, height=args.height)
    if args.composed:
        result = bench_core.run_composed_stream_bench(**size, frames=args.frames,
                                                      batch_size=args.batch,
                                                      content=args.content, device="cuda")
    elif args.latency:
        result = bench_core.run_latency_bench(**size, content=args.content, device="cuda")
    elif args.host_stream:
        result = bench_core.run_host_stream_bench(**size, frames=args.frames,
                                                  batch_size=args.batch, content=args.content,
                                                  repeats=args.repeats)
    elif args.stream:
        result = bench_core.run_stream_bench(**size, frames=args.frames, batch_size=args.batch,
                                             content=args.content, repeats=args.repeats,
                                             device="cuda")
    else:
        result = bench_core.run_bench(**size, frames=args.frames, iters=args.iters,
                                      content=args.content, device="cuda")
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dbde_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("info", help="print video header / stats")
    s.add_argument("file")
    s.add_argument("--scan", action="store_true", help="walk all frames for counts")
    s.set_defaults(fn=_cmd_info)

    s = sub.add_parser("encode", help="raw u8 frames -> .dbde")
    s.add_argument("input", help="raw u8 file, N*H*W bytes")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--width", type=int, required=True)
    s.add_argument("--height", type=int, required=True)
    s.add_argument("--hz", type=float, default=1.0)
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--no-device", action="store_true",
                   help="the plain PyTorch versions on the CPU")
    s.set_defaults(fn=_cmd_encode)

    s = sub.add_parser("decode", help=".dbde -> raw u8 frames / PGMs")
    s.add_argument("file")
    s.add_argument("-o", "--output")
    s.add_argument("--pgm-dir")
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--no-device", action="store_true")
    s.set_defaults(fn=_cmd_decode)

    s = sub.add_parser("preview", help="ASCII-art preview of one frame")
    s.add_argument("file")
    s.add_argument("--frame", type=int, default=0)
    s.add_argument("--size", type=int, default=32)
    s.add_argument("--no-device", action="store_true")
    s.set_defaults(fn=_cmd_preview)

    s = sub.add_parser("roundtrip", help="verify decode+re-encode is bit-exact")
    s.add_argument("file")
    s.add_argument("--no-device", action="store_true")
    s.set_defaults(fn=_cmd_roundtrip)

    s = sub.add_parser("golden", help="write the 8x16 conformance fixture file")
    s.add_argument("-o", "--output", default="minimal.dbde")
    s.add_argument("--frames", type=int, default=1, help="repeat the frame N times")
    s.set_defaults(fn=_cmd_golden)

    s = sub.add_parser("bench", help="codec throughput benchmark on the GPU")
    s.add_argument("--width", type=int, default=2048)
    s.add_argument("--height", type=int, default=2048)
    s.add_argument("--frames", type=int, default=8)
    s.add_argument("--iters", type=int, default=20)
    s.add_argument("--content", default="camera", choices=["camera", "random", "flat"])
    s.add_argument("--stream", action="store_true",
                   help="end-to-end wall-clock file streaming benchmark (write+read a whole .dbde)")
    s.add_argument("--host-stream", action="store_true",
                   help="host-only walker benchmark: record scan/parse rate, no codec/transfer")
    s.add_argument("--composed", action="store_true",
                   help="sustained-streaming model: each leg measured alone (device legs "
                        "with CUDA events, host legs over /dev/shm), composed under the "
                        "2-deep pipeline; reports the link bandwidth it needs")
    s.add_argument("--latency", action="store_true",
                   help="single-frame (batch=1) codec latency")
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--repeats", type=int, default=2,
                   help="--stream/--host-stream repetitions (best-of is reported)")
    s.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
