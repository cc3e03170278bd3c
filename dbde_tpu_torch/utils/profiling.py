"""Device time on a CUDA GPU: CUDA events and the PyTorch profiler.

Counterpart of :mod:`dbde_tpu.utils.profiling`, which parses the JAX
profiler's XPlane traces.  On a GPU the call's time comes from CUDA events
around many calls (:func:`cuda_event_seconds`, the metric ``PERF.md`` §2
defines), and the device's busy time from ``torch.profiler``'s CUDA
activities (:func:`measure_device_seconds`).

Every function that measures or reads a trace raises when no CUDA device is
visible; none returns None for a caller to fall back on.  The interval
arithmetic (:func:`idle_share`) works on any intervals.
"""

from __future__ import annotations

import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: device timing needs a GPU")


def card_name(index: int = 0) -> str:
    """CUDA device ``index``'s name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them.  The
    card is found by its UUID: nvidia-smi numbers cards in PCI order and
    ignores ``CUDA_VISIBLE_DEVICES``, so a torch ordinal can name another
    card there."""
    _require_cuda()
    uuid = str(torch.cuda.get_device_properties(index).uuid).removeprefix("GPU-")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.splitlines():
        card_uuid, _, name_and_limit = line.partition(",")
        if card_uuid.strip().removeprefix("GPU-") == uuid:
            return name_and_limit.strip()
    raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid}")


def cuda_event_seconds(fn, reps: int, warmup: int = 3) -> float:
    """Seconds per call of ``fn()``: ``warmup`` calls, then a CUDA event
    before and after ``reps`` calls on the current stream, synchronized."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / 1e3


def device_intervals(prof) -> list[tuple[str, float, float]]:
    """(name, start µs, end µs) of every device activity ``prof`` (a
    finished ``torch.profiler.profile``) saw."""
    _require_cuda()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def idle_share(intervals) -> tuple[float, float, float]:
    """→ (busy µs, span µs, idle share) of the union of the (name, start,
    end) intervals."""
    spans = sorted((s, e) for _, s, e in intervals)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    return busy, span, 1.0 - busy / span


PROFILE_SESSIONS = 3  # profiler sessions a measurement may take


def measure_device_seconds(fn, reps: int = 4) -> float:
    """Device busy seconds per call of ``fn()``: one warm-up call, then
    ``reps`` calls under ``torch.profiler``; the union of the device
    activities' intervals over ``reps``.  A session that delivers no device
    activity is run again, up to :data:`PROFILE_SESSIONS` in all (on an
    H100, torch 2.11, about one process in four had a session whose device
    records never arrived); raises when none delivers any."""
    _require_cuda()
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_SESSIONS):
        # the host activity stays on although only device events are read:
        # on an H100 (torch 2.11), a device-only session in a process that
        # had already profiled both recorded no device activity at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        intervals = device_intervals(prof)
        if intervals:
            busy, _, _ = idle_share(intervals)
            return busy / reps / 1e6
    raise RuntimeError(f"the profiler saw no device activity in {PROFILE_SESSIONS} sessions")
