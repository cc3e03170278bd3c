"""Device time by kernel on the codec's encode and decode paths.

    python3 -m dbde_tpu_torch.profile_paths [--iters 20] [--batch 16]
        [--height 2048] [--width 2048] [--backend band|tiles]

Needs a CUDA GPU.  For camera content (band backend, mixed depths: K1,
K2 / K3) and random content (every tile depth 8: K1, K4 /
K5; the tiles backend runs its layout transform and K6 / K7 on both),
runs ``DbdeCodec.encode`` and ``DbdeCodec.decode_dispatch`` ``iters``
times each under ``torch.profiler`` and prints, per path, every device
activity (kernels and copies) with its time per iteration, then each
card's idle share: 1 - (time covered by its activity) / (its first start
to its last end).
Decode is given host depths, as the reader gives them (the uniform check
runs on the host; the general path copies them to the device), with mins
and payload already on the device.  The profiler
adds host work between launches, so the idle share here is an upper
bound on the unprofiled path's.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .bench_core import make_content
from .codec import DbdeCodec
from .utils.profiling import card_name, card_shares, device_intervals, idle_share, sync_cards  # noqa: F401


def profile_path(label: str, fn, iters: int, cards) -> dict:
    """Profile ``iters`` calls of ``fn`` (after a warm-up), each card of
    ``cards`` (indices, the cards ``fn`` uses) synchronized before and
    after, and print the table: device time by activity, then each card's
    busy time and idle share and the span of every card's activity on the
    profiler's shared clock."""
    for _ in range(3):
        fn()
    sync_cards(cards)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync_cards(cards)
    intervals = device_intervals(prof)
    if not intervals:
        raise RuntimeError(f"{label}: the profiler saw no device activity")
    per_name = defaultdict(float)
    for _, name, s, e in intervals:
        per_name[name] += e - s
    shares, span = card_shares(intervals)
    total = sum(e - s for _, _, s, e in intervals)
    print(f"== {label}, {iters} iterations: device time per iteration")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1]):
        print(f"  {us / iters:10.3f} us  {us / total:6.1%}  {name[:100]}")
    for card, (busy, card_span, idle) in shares.items():
        print(f"  cuda:{card} busy {busy:.1f} us over span {card_span:.1f} us -> idle share "
              f"{idle:.3f}", flush=True)
    if len(shares) > 1:
        print(f"  every card's activity spans {span:.1f} us on the profiler's clock", flush=True)
    return {"per_iter_us": {k: v / iters for k, v in per_name.items()},
            "idle_share": {card: idle for card, (_, _, idle) in shares.items()},
            "span_us": span}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=2048)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--backend", default="band", choices=("band", "tiles"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_paths needs a CUDA GPU and none is visible")
    print(f"{card_name(0)}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    H, W = args.height, args.width
    codec = DbdeCodec(H, W, device="cuda", backend=args.backend)
    for content in ("camera", "random"):
        frames = make_content(W, H, args.batch, kind=content)
        x = torch.from_numpy(frames).to(codec.device)
        enc = codec.encode(x)
        depths = enc.depths.cpu().numpy()
        if not np.array_equal(codec.decode(depths, enc.mins, enc.payload), frames):
            raise AssertionError(f"{content}: decode did not return the frames")
        shape = f"{args.batch}x{H}x{W} {content}, backend {args.backend}"
        cards = [codec.device.index]
        profile_path(f"encode path, {shape}", lambda: codec.encode(x), args.iters, cards)
        profile_path(f"decode path, {shape}",
                     lambda: codec.decode_dispatch(depths, enc.mins, enc.payload), args.iters,
                     cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
