"""The profiler's intervals and what the benchmark reduces them to.

The benchmark's own copy of the port's interval arithmetic
(``utils/profiling``: ``card_name``, ``device_intervals``,
``idle_share``), with what the traced run adds: clipping to a half of the
window, the idle gaps, and the host span under way in each gap.
Intervals are ``(card, name, start µs, end µs)`` on the profiler's clock,
which the host's ``record_function`` spans share.
"""

from __future__ import annotations

import bisect
import subprocess

COPY_PREFIXES = ("Memcpy", "Memset")


def card_name(index: int = 0) -> str:
    """CUDA device ``index``'s name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, the
    card found by its UUID (nvidia-smi ignores ``CUDA_VISIBLE_DEVICES``)."""
    import torch

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


def device_intervals(events, prefix: str) -> list[tuple[int, str, float, float]]:
    """(card, name, start µs, end µs) of every device activity among a
    finished profile's ``events()``: kernels, copies and memsets.  The
    profiler mirrors each host ``record_function`` span onto the device's
    timeline as a user annotation; those are no activity, and go (by the
    event's flag, and by ``prefix`` for the benchmark's own spans)."""
    from torch.autograd import DeviceType

    return [(e.device_index, e.name, e.time_range.start, e.time_range.end)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith(prefix)]


def host_spans(events, prefix: str) -> list[tuple[str, float, float]]:
    """(name, start µs, end µs) of the host ``record_function`` spans whose
    names start with ``prefix``, the prefix cut off."""
    from torch.autograd import DeviceType

    return [(e.name[len(prefix):], e.time_range.start, e.time_range.end)
            for e in events if e.device_type == DeviceType.CPU and e.name.startswith(prefix)]


def short_name(name: str, limit: int = 96) -> str:
    """A device operation's name without its argument list, namespaces of
    no meaning and ``void``, at most ``limit`` characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0][:limit] if not name.startswith("Mem") else name[:limit]


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def clip(intervals, t0: float, t1: float) -> list:
    """The intervals that start in [t0, t1), cut to end by t1."""
    return [(*iv[:-2], iv[-2], min(iv[-1], t1)) for iv in intervals if t0 <= iv[-2] < t1]


def union(spans) -> list[tuple[float, float]]:
    """The union of (start, end) pairs as sorted disjoint pairs."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals) -> float:
    """µs covered by the union of the intervals."""
    return sum(e - s for s, e in union((iv[-2], iv[-1]) for iv in intervals))


def gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for s, e in union((max(iv[-2], t0), min(iv[-1], t1)) for iv in intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return out


def innermost(spans) -> list[tuple[float, float, str]]:
    """Nested host spans (name, start, end) → (start, end, name) pieces of
    the timeline, each named by the innermost span open over it."""
    bounds = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    out, stack, cur = [], [], None
    for t, opening, i in bounds:
        if stack and cur is not None and t > cur:
            out.append((cur, t, spans[stack[-1]][0]))
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        cur = t
    return out


def gaps_by_host(gap_list, pieces) -> dict[str, float]:
    """µs of the gaps under each innermost host span ("(none)" where no
    span was open).  Both lists are sorted and disjoint within each."""
    ends = [e for _, e, _ in pieces]
    out: dict[str, float] = {}
    for g0, g1 in gap_list:
        covered = 0.0
        j = bisect.bisect_right(ends, g0)
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, name = pieces[j]
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
                covered += overlap
            j += 1
        if g1 - g0 > covered:
            out["(none)"] = out.get("(none)", 0.0) + (g1 - g0 - covered)
    return out
