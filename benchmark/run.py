"""Run one cell of ``BENCHMARK.json`` and print its result as one JSON line.

    python3 benchmark/run.py --workload cam2048.stream --seed 7 --seconds 24 --trace 0

from the root of a checkout (``python3 -m benchmark.run`` works too).
The cell's deployment, traffic and metrics are files found by name
(:mod:`benchmark.spec`).  A run:

  1. set-up, timed from the process's start: imports, the CUDA context on
     each card the cell drives, the kernel and native libraries (built
     into ``dbde_tpu_torch/build/`` on a checkout's first run, loaded
     after), the source frames made on the card from ``--seed``, and one
     small file written and read through the cell's entry (warm-up);
  2. the window (:mod:`benchmark.window`): ``--seconds / 2`` of writing
     files, then as long reading the newest one back; with ``--trace 1``
     under ``torch.profiler``, the per-layer metrics' callables wrapped;
  3. the device's peak memory, then the plain reference on the same card
     and the comparison (:mod:`benchmark.checks`).

Standard output: information lines (sink, set-up split, cards, each
half's rates by file or pass, every rate of the run whether a metric of
the cell or not, the check), then the result line last.  Standard error
ends with each number compared beside its limit.  Without a CUDA card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result.  ``--rehearse`` (never used by a check) runs the plain PyTorch
versions on the CPU at frames 32 times smaller: the rehearsal of the
control flow.  ``--control`` puts the reference, cut to 7 bits a pixel,
in the writer's place: the control, whose run must come out not correct.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from
    ``/proc/self/stat``, 10 ms resolution; now, where that is unreadable)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rpartition(")")[2].split()[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = ROOT  # run as a script: import from the checkout's root
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(ROOT, ".cache", "bench", _sub)

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
from dataclasses import dataclass  # noqa: E402


def since_start() -> float:
    return time.perf_counter() - START


@dataclass
class Run:
    """What the entries and the window share."""

    params: dict
    device: object
    rows: int
    cols: int
    src: object
    files: object
    spans: object
    sample: object
    control: bool
    mesh: object = None


class Trace:
    """The traced run, as the readers see it: each half's host time per
    wrapped callable (``spans``: target → (seconds, calls)), batches,
    bytes and window on the profiler's clock (``t0``, ``t1`` µs), the
    device intervals, the cards and the card's peaks."""

    def __init__(self, halves: dict, intervals: list, cards: list, peak: dict):
        self.halves, self.intervals, self.cards, self.peak = halves, intervals, cards, peak

    def in_half(self, half: str) -> list:
        from benchmark.intervals import clip

        h = self.halves[half]
        return clip(self.intervals, h["t0"], h["t1"])


def geometry(config: dict, params: dict, rehearse: bool) -> dict:
    """The frames' region of the sensor; ``rehearse`` shrinks every size
    32 times (rows to at least 16) for the rehearsal on the CPU."""
    H, W = config["sensor_height"], config["sensor_width"]
    roi = {"row0": 0, "rows": H, "col0": 0, "cols": W, **(params.get("roi") or {})}
    geo = {"sensor_height": H, "sensor_width": W, **roi}
    if rehearse:
        geo = {k: v // 32 for k, v in geo.items()}
        geo["rows"] = max(16, geo["rows"] - geo["rows"] % 16)
    return geo


def _bytes_per_frame(ref_data, rows: int, cols: int):
    """Bytes a frame's encode or decode needs at least: the frame, its
    depths and minima, its n64 and its live payload words."""
    import numpy as np

    h, w = (rows + 7) // 8, (cols + 7) // 8
    n64 = np.array([n for _, n in ref_data], np.int64)
    return rows * cols + 2 * h * w + 4 + 8 * n64


def reduce_trace(device: list, host: list, halves_run: dict, cards: list, per_frame,
                 frames_per_file: list, peak: dict) -> tuple:
    """Device intervals and host spans of the traced window → (Trace,
    busy_s, window_s, breakdown): the busy seconds and the window summed
    over the halves, each card's busy time averaged over the cards; the
    device operations that took most time, and the idle time under each
    host span (the innermost open), summed and averaged the same way."""
    import numpy as np

    from benchmark import intervals as iv

    marks = {name[len("half:"):]: (s, e) for name, s, e in host if name.startswith("half:")}
    n_src = len(per_frame)
    frames_by_half = {
        "write": np.concatenate([np.arange(k) % n_src for k in frames_per_file]
                                or [np.zeros(0, np.int64)]),
        "read": np.concatenate([np.asarray(indices, np.int64) % n_src
                                for indices, _ in halves_run["read"].passes]
                               or [np.zeros(0, np.int64)]),
    }
    halves = {}
    for name, half in halves_run.items():
        t0, t1 = marks[name]
        halves[name] = {"t0": t0, "t1": t1, "wall_s": half.wall_s, "batches": half.batches,
                        "bytes": int(per_frame[frames_by_half[name]].sum()),
                        "spans": dict(half.spans)}
    trace = Trace(halves, device, cards, peak)
    pieces = iv.innermost([(n, s, e) for n, s, e in host if not n.startswith("half:")])
    busy_us, window_us, ops, idle = 0.0, 0.0, {}, {}
    for name, h in halves.items():
        ivs = trace.in_half(name)
        window_us += h["t1"] - h["t0"]
        for card in cards:
            mine = [x for x in ivs if x[0] == card]
            busy_us += iv.busy(mine) / len(cards)
            for host_name, us in iv.gaps_by_host(iv.gaps(mine, h["t0"], h["t1"]), pieces).items():
                key = f"{name}/{host_name}"
                idle[key] = idle.get(key, 0.0) + us / len(cards)
        for _, op, s, e in ivs:
            op = iv.short_name(op)
            ops[op] = ops.get(op, 0.0) + (e - s)

    def top(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return trace, busy_us * 1e-6, window_us * 1e-6, {"device_ops": top(ops), "idle_gaps": top(idle)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    split = {}
    t = since_start()
    import numpy as np
    import torch

    from benchmark import checks, content, intervals, reference, sink, spec, tracing, window

    cell = spec.load_cell(args.workload)
    if not args.rehearse:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA card(s); {found} visible",
                  file=sys.stderr)
            return 2
    from dbde_tpu_torch.native import binding
    from dbde_tpu_torch.ops import build

    entry = importlib.import_module(f"benchmark.entries.{cell.params['entry']}")
    split["imports"] = since_start() - t

    t = since_start()
    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    p = cell.params
    geo = geometry(cell.config, p, args.rehearse)
    spans = tracing.Spans([m["target"] for m in cell.per_layer if "target" in m], bool(args.trace))
    run = Run(params=p, device=device, rows=geo["rows"], cols=geo["cols"], src=None,
              files=sink.Files(args.seed), spans=spans,
              sample=window.Sample(p["sample_batches"], args.seed), control=args.control)
    entry.prepare(run)
    cards = entry.cards(run)
    for card in cards:
        torch.empty(1, device=torch.device("cuda", card))
        torch.cuda.synchronize(card)
    split["cuda_init"] = since_start() - t

    t = since_start()
    if cards:
        build.load()
    binding.native_available()
    split["libraries"] = since_start() - t

    t = since_start()
    run.src = content.frames(p["source_frames"], geo, p["content"], args.seed, device)
    if p["file_frames"] % run.src.shape[0] or run.src.shape[0] % p["batch"]:
        raise ValueError("file_frames must be whole source stacks, and these whole batches")
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    split["content"] = since_start() - t

    t = since_start()
    entry.warm(run)
    for card in cards:
        torch.cuda.synchronize(card)
    split["warm"] = since_start() - t

    print(f"sink: memfd (shmem, as tmpfs); files of {p['file_frames']} frames of "
          f"{run.rows}x{run.cols}, batch {p['batch']}, pipeline {p['pipeline']}")
    print("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
        prof = profile(activities=acts)
        prof.start()
    spans.install()
    setup_s = since_start()
    half_s = args.seconds / 2
    try:
        with spans.in_half("write"):
            write = entry.write_half(run, time.perf_counter() + half_s)
        run.files.settle()
        with spans.in_half("read"):
            read = entry.read_half(run, time.perf_counter() + half_s)
    finally:
        spans.uninstall()
    for card in cards:
        torch.cuda.synchronize(card)
    if prof is not None:
        prof.stop()
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)
    newest = run.files.read_target()
    if cards:  # after the window: nvidia-smi is the harness's, not the set-up's
        print(f"cards: {len(cards)}: " + "; ".join(f"cuda:{c} {intervals.card_name(c)}"
                                                   for c in cards))
    print(f"window: wrote {write.frames} frames in {len(run.files.frames_per_file)} files "
          f"({newest.size()} bytes the newest) in {write.wall_s:.3f} s; read {read.frames} "
          f"frames in {len(read.passes)} passes in {read.wall_s:.3f} s", flush=True)
    for name, half in (("write", write), ("read", read)):
        fps = [n / s for n, s in half.pieces] or [0.0]
        print(f"{name} frames/s by {'file' if name == 'write' else 'pass'}: quartiles "
              + " ".join(f"{q:.1f}" for q in np.percentile(fps, [0, 25, 50, 75, 100]))
              + " first " + " ".join(f"{x:.1f}" for x in fps[:3])
              + " last " + " ".join(f"{x:.1f}" for x in fps[-3:]))

    t = time.perf_counter()
    if cards:
        torch.cuda.empty_cache()
    ref_data = reference.encode_source(run.src, device)
    numbers = dict.fromkeys(checks.LIMITS, 0)
    compared = 0
    for f in run.files.kept():
        n, wrong, lost = checks.check_file(f.fd, f.frames, ref_data, run.rows, run.cols,
                                           p["frame_hz"])
        compared += n
        numbers["records_wrong"] += wrong
        numbers["records_lost"] += lost
    handed, numbers["frames_lost"] = checks.check_passes(read.passes, newest.frames)
    sampled, numbers["frames_wrong"] = checks.check_sample(run.sample.items, run.src)
    print(f"compared: {compared} records of {len(run.files.kept())} files, {sampled} of "
          f"{handed} frames read, in {time.perf_counter() - t:.3f} s", flush=True)

    def p95_ms(latencies):
        return 1e3 * float(np.percentile(latencies, 95)) if latencies else float("nan")

    values = {"write_fps": write.frames / write.wall_s, "read_fps": read.frames / read.wall_s,
              "write_p95_ms": p95_ms(write.latencies), "read_p95_ms": p95_ms(read.latencies),
              "setup_s": setup_s}
    print(("traced " if args.trace else "") + "rates: "
          + ", ".join(f"{k} {v}" for k, v in values.items()), flush=True)
    metrics = {}
    result_device = {"platform": "gpu" if cards else "cpu",
                     "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
                     "count": max(1, len(cards)), "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        t = time.perf_counter()
        events = prof.events()
        device_ivs = intervals.device_intervals(events, tracing.PREFIX)
        if cards and not device_ivs:
            raise RuntimeError("the profiler delivered no device record in the traced window")
        print(f"trace: {len(events)} events, {len(device_ivs)} device records, read in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        kind = result_device["kind"]
        peaks = spec.load_json(os.path.join(spec.HERE, "peaks.json"))
        if cards and kind not in peaks:
            raise RuntimeError(f"peaks.json has no entry for {kind!r}")
        for name, half in (("write", write), ("read", read)):
            half.spans = {k: tuple(v) for k, v in spans.totals.get(name, {}).items()}
        trace, busy_s, window_s, breakdown = reduce_trace(
            device_ivs, intervals.host_spans(events, tracing.PREFIX),
            {"write": write, "read": read}, cards,
            _bytes_per_frame(ref_data, run.rows, run.cols), run.files.frames_per_file,
            peaks.get(kind, {}))
        if cards:
            result_device.update(busy_s=busy_s, window_s=window_s)
        else:
            breakdown = None  # no device: nothing a device metric may be read from
        for m in cell.per_layer:
            if m["source"] == "device_trace" and not cards:
                continue
            value = importlib.import_module(f"benchmark.readers.{m['reader']}").read(trace, m)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    run.files.close()

    result = {"correct": not any(numbers.values()), "attempted": write.frames + read.frames,
              "failed": sum(numbers.values()), "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]} for k, v in numbers.items()}
    sys.stdout.flush()
    for k, v in numbers.items():
        print(f"check {k} {v} limit {checks.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
