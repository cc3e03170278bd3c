"""The benchmark's rehearsal on the CPU, before any run on a card.

    python3 benchmark/rehearse.py

  * ``BENCHMARK.json`` against the files it names: each configuration's
    file and its ``reduced`` keys, each cell's traffic file and entry,
    each per-layer metric's file (layer, unit, moves, cells and source as
    ``BENCHMARK.json`` has them) and its reader;
  * every cell's run at tiny frames on the plain PyTorch versions
    (``--rehearse``), untraced and traced: ``correct``, the
    cell's end-to-end metrics, and its host-span metrics;
  * every cell's control (``--control``): ``correct`` must be false;
  * the device readers (roofline, idle share) and the trace's reduction
    on intervals made up here, whose answers are known.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import sys

if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import run, spec  # noqa: E402


def run_cell(*argv) -> dict:
    """``run.main`` in this process → its result line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"run {argv} exited with {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def check_files(root: str = spec.ROOT) -> list[str]:
    """``BENCHMARK.json`` against the files it names → the faults found."""
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    faults = []
    for c in bench["configs"]:
        config = spec.load_json(os.path.join(root, c["file"]))
        faults += [f"{c['name']}: reduced key {k} not in its file"
                   for k in c["reduced"] if k not in config]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], root)
        importlib.import_module(f"benchmark.entries.{cell.params['entry']}")
    for m in bench["per_layer"]:
        f = spec.load_json(os.path.join(spec.HERE, "metrics", f"{m['name']}.json"))
        faults += [f"{m['name']}: {k} is {f.get(k)!r} in its file, {m[k]!r} in BENCHMARK.json"
                   for k in ("layer", "unit", "moves", "workloads", "source") if f.get(k) != m[k]]
        importlib.import_module(f"benchmark.readers.{f['reader']}")
    return faults


def check_readers() -> list[str]:
    """The device readers and :func:`run.reduce_trace` on made-up
    intervals → the faults found."""
    import numpy as np

    from benchmark.window import Half

    write, read = Half(frames=4, batches=2, wall_s=1.0), Half(frames=4, batches=2, wall_s=1.0)
    read.passes = [([0, 1, 2, 3], True)]
    write.spans = {"m:f": (0.5, 2)}
    read.spans = {}
    per_frame = np.array([1000, 3000], np.int64)  # bytes a frame, by source frame
    host = [("half:write", 0.0, 100.0), ("half:read", 200.0, 300.0), ("f", 10.0, 60.0)]
    device = [(0, "kernel_a", 10.0, 30.0), (0, "Memcpy HtoD", 30.0, 50.0),
              (0, "kernel_b", 210.0, 220.0), (1, "kernel_a", 40.0, 50.0)]
    peak = {"hbm_bytes_per_s": 1e12}
    trace, busy_s, window_s, breakdown = run.reduce_trace(
        device, host, {"write": write, "read": read}, [0, 1], per_frame, [4], peak)
    want = {
        # write: frames 0,1,0,1 → 8000 bytes at 1e12 B/s is 8 ns, over 30 µs of kernels
        ("roofline", "write"): 100 * 8e-9 / 30e-6,
        # read: 8000 bytes over 10 µs of kernels
        ("roofline", "read"): 100 * 8e-9 / 10e-6,
        # card 0 busy 40 of 100 µs, card 1 busy 10
        ("idle", "write"): 100 * (0.6 + 0.9) / 2,
        ("idle", "read"): 100 * (0.9 + 1.0) / 2,
        ("host_span", "write"): 1e3 * 0.5 / 2,
    }
    faults = []
    for (reader, half), expected in want.items():
        got = importlib.import_module(f"benchmark.readers.{reader}").read(
            trace, {"half": half, "target": "m:f"})
        if got is None or abs(got - expected) > 1e-9 * max(1.0, abs(expected)):
            faults.append(f"reader {reader} on the {half} half: {got}, expected {expected}")
    if importlib.import_module("benchmark.readers.host_span").read(
            trace, {"half": "read", "target": "m:f"}) is not None:
        faults.append("host_span read a span that never ran")
    if abs(busy_s - 1e-6 * ((40 + 10) / 2 + (10 + 0) / 2)) > 1e-12 or abs(window_s - 200e-6) > 1e-12:
        faults.append(f"busy_s {busy_s}, window_s {window_s}")
    idle = dict(breakdown["idle_gaps"])
    # card 0 idles 0-10 (none), 50-60 (under f), 60-100 (none); card 1 idles 0-40, 50-100
    if abs(idle["write/f"] - 1e-6 * (10 + 40) / 2) > 1e-12:
        faults.append(f"idle under f: {idle}")
    return faults


def main() -> int:
    faults = check_files()
    faults += check_readers()
    for name in spec.cell_names():
        for trace in ("0", "1"):
            result = run_cell("--workload", name, "--seed", "2147483659", "--seconds", "1",
                              "--trace", trace, "--rehearse")
            cell = spec.load_cell(name)
            if trace == "0":
                want = {m["name"] for m in cell.end_to_end}
            else:
                want = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
            if not result["correct"] or set(result["metrics"]) != want:
                faults.append(f"{name} --trace {trace}: correct {result['correct']}, "
                              f"metrics {sorted(result['metrics'])}, expected {sorted(want)}")
        control = run_cell("--workload", name, "--seed", "3", "--seconds", "1", "--rehearse",
                           "--control")
        if control["correct"]:
            faults.append(f"{name}: the control came out correct")
        print(f"{name}: ok, control {control['checks']}", flush=True)
    for fault in faults:
        print("FAULT", fault)
    print("rehearsal:", "failed" if faults else "passed")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
