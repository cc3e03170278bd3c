"""Device time on a CUDA GPU: CUDA events and the PyTorch profiler.

Counterpart of :mod:`dbde_tpu.utils.profiling`, which parses the JAX
profiler's XPlane traces.  On a GPU the call's time comes from CUDA events
around many calls (:func:`cuda_event_seconds`, the metric ``PERF.md`` §2
defines), and the device's busy time from ``torch.profiler``'s CUDA
activities (:func:`measure_device_seconds`; each card's, and their span on
the profiler's shared clock, from :func:`measure_device_cards`).  A
measurement is given the cards its call uses, since a mesh's call runs on
several: it synchronizes each of them, and its events cover each.

Every function that measures or reads a trace raises when no CUDA device is
visible; none returns None for a caller to fall back on.  The interval
arithmetic (:func:`idle_share`, :func:`card_shares`) works on any intervals,
and :func:`idle_by_span` on any events.
"""

from __future__ import annotations

import bisect
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..trace import PREFIX


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


def sync_cards(cards) -> None:
    """Wait for the work on each card of ``cards`` (indices)."""
    for index in cards:
        torch.cuda.synchronize(index)


def cuda_event_seconds(fn, reps: int, warmup: int = 3, cards=None) -> float:
    """Seconds per call of ``fn()`` on ``cards`` (indices; default the
    current card): ``warmup`` calls, then a CUDA event on the first card's
    current stream before ``reps`` calls and one after them, recorded once
    that stream has waited for each other card's current stream, so the
    time covers the work of every card the calls used.  On one card this
    is an event before and after on its stream."""
    _require_cuda()
    cards = [torch.cuda.current_device()] if cards is None else list(cards)
    for _ in range(warmup):
        fn()
    sync_cards(cards)
    stream = torch.cuda.current_stream(cards[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(reps):
        fn()
    for index in cards[1:]:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(index))
        stream.wait_event(done)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / reps / 1e3


def _activities(events) -> list[tuple[int, str, float, float]]:
    """(card index, name, start µs, end µs) of the device activities among
    profiler events.  The profiler mirrors each host ``record_function``
    span, the program's own (:mod:`..trace`) among them, onto the device's
    timeline as a user annotation: those are no activity, and go."""
    return [(e.device_index, e.name, e.time_range.start, e.time_range.end)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith(PREFIX)]


def device_intervals(prof) -> list[tuple[int, str, float, float]]:
    """(card index, name, start µs, end µs) of every device activity
    ``prof`` (a finished ``torch.profiler.profile``) saw: kernels, copies
    and memsets.  The profiler puts every card's activity on one clock."""
    _require_cuda()
    return _activities(prof.events())


def idle_share(intervals) -> tuple[float, float, float]:
    """→ (busy µs, span µs, idle share) of the union of the intervals, each
    a tuple that ends with its start and end: (name, start, end) or (card,
    name, start, end).  Every interval counts as on one device: give it one
    card's intervals (:func:`card_shares`)."""
    spans = sorted((iv[-2], iv[-1]) for iv in intervals)
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


def card_shares(intervals) -> tuple[dict[int, tuple[float, float, float]], float]:
    """(card, name, start, end) intervals → ({card: (busy µs, span µs, idle
    share)} of each card's own intervals, the span in µs of them all on the
    profiler's shared clock, first start to last end).  One card gives
    :func:`idle_share`'s result and its span."""
    by_card: dict[int, list] = {}
    for iv in intervals:
        by_card.setdefault(iv[0], []).append(iv)
    span = max(iv[3] for iv in intervals) - min(iv[2] for iv in intervals)
    return {card: idle_share(ivs) for card, ivs in sorted(by_card.items())}, span


def _innermost(spans) -> list[tuple[float, float, tuple[str, str]]]:
    """Nested host spans (name, start, end) → (start, end, (root, name))
    pieces of the timeline in order: ``name`` the innermost span open over
    the piece, ``root`` the outermost."""
    # at one instant opens come before closes, so a span of no length
    # opens before it closes, and the longer of two spans that open
    # together comes first: it holds the other
    bounds = sorted([(s, 0, s - e, i) for i, (_, s, e) in enumerate(spans)]
                    + [(e, 1, 0, i) for i, (_, _, e) in enumerate(spans)])
    out, stack, cur = [], [], None
    for t, closing, _, i in bounds:
        if stack and t > cur:
            out.append((cur, t, (spans[stack[0]][0], spans[stack[-1]][0])))
        if closing:
            stack.remove(i)
        else:
            stack.append(i)
        cur = t
    return out


def idle_by_span(events, cards) -> dict[tuple, float]:
    """µs in which the cards ran no kernel and no copy, each stretch put
    under the innermost program span (``dbde:<name>``, :mod:`..trace`)
    open on the host over it: ``{(root, name): µs}``, keyed as
    :func:`..trace.totals` is, ``(None, None)`` where no span was open.
    The mean over ``cards`` (indices) of each card's idle time from the
    first program span's start to the last one's end, from ``events``, a
    finished profile's ``events()``."""
    spans = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
    if not spans or not cards:
        return {}
    t0 = min(s for _, s, _ in spans)
    t1 = max(e for _, _, e in spans)
    pieces = _innermost(spans)
    ends = [e for _, e, _ in pieces]
    activities = _activities(events)
    out: dict[str, float] = {}
    for card in cards:
        busy = sorted((max(s, t0), min(e, t1)) for c, _, s, e in activities
                      if c == card and e > t0 and s < t1)
        gaps, cur = [], t0
        for s, e in busy + [(t1, t1)]:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        for g0, g1 in gaps:
            covered = 0.0
            j = bisect.bisect_right(ends, g0)
            while j < len(pieces) and pieces[j][0] < g1:
                s, e, name = pieces[j]
                overlap = min(e, g1) - max(s, g0)
                if overlap > 0:
                    out[name] = out.get(name, 0.0) + overlap / len(cards)
                    covered += overlap
                j += 1
            if g1 - g0 > covered:
                out[None, None] = out.get((None, None), 0.0) + (g1 - g0 - covered) / len(cards)
    return out


PROFILE_SESSIONS = 3  # profiler sessions a measurement may take


def _profiled_intervals(fn, reps: int, sync, want) -> list:
    """The device intervals (:func:`device_intervals`) of ``reps`` calls of
    ``fn()`` under ``torch.profiler``, after one warm-up call, with the
    cards of ``sync`` synchronized before and after.  A session in which no
    card, or a card of ``want``, delivers device activity is run again, up
    to :data:`PROFILE_SESSIONS` in all (on an H100, torch 2.11, about one
    process in four had a session whose device records never arrived);
    raises when none delivers them."""
    _require_cuda()
    fn()
    sync_cards(sync)
    for _ in range(PROFILE_SESSIONS):
        # the host activity stays on although only device events are read:
        # on an H100 (torch 2.11), a device-only session in a process that
        # had already profiled both recorded no device activity at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync_cards(sync)
        intervals = device_intervals(prof)
        if intervals and set(want) <= {iv[0] for iv in intervals}:
            return intervals
    on = f" on card(s) {sorted(want)}" if want else ""
    raise RuntimeError(f"the profiler saw no device activity in {PROFILE_SESSIONS} sessions{on}")


def measure_device_cards(fn, want, reps: int = 4) -> tuple[dict[int, float], float]:
    """Device time of ``fn()`` on each card of ``want`` (card indices), the
    cards synchronized before and after (:func:`_profiled_intervals`).
    Returns ({card: busy seconds per call, the union of that card's device
    activities}, the span in seconds per call of those cards' activity on
    the profiler's shared clock)."""
    intervals = [iv for iv in _profiled_intervals(fn, reps, want, want) if iv[0] in want]
    shares, span = card_shares(intervals)
    return {card: shares[card][0] / reps / 1e6 for card in want}, span / reps / 1e6


def measure_device_seconds(fn, reps: int = 4, cards=None) -> float:
    """Device busy seconds per call of ``fn()``: the union of the device
    activities' intervals over ``reps`` calls (:func:`_profiled_intervals`).
    With ``cards`` (indices), the union of those cards' activities, each of
    which must deliver some, the cards synchronized; without, every card's
    activity as one union, the current card synchronized."""
    _require_cuda()
    sync = [torch.cuda.current_device()] if cards is None else list(cards)
    intervals = _profiled_intervals(fn, reps, sync, cards or [])
    if cards is not None:
        intervals = [iv for iv in intervals if iv[0] in cards]
    return idle_share(intervals)[0] / reps / 1e6
