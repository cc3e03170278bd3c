"""Program spans and counters, recorded only while ``torch.profiler`` records.

The stream, codec and parallel layers mark their work with :func:`span`
and :func:`count`.  Both do nothing beyond one check of torch's
process-wide flag (``torch.autograd.profiler._is_profiler_enabled``,
which its profiler sets when a session starts and clears when it stops),
unless a profiler session is recording: no ``record_function``, no clock
read, no table write.  While one is recording, on every thread of the
process,

  * ``span(name)`` opens ``record_function("dbde:" + name)``, so the span
    lies on the profiler's clock beside the device's intervals, and adds
    its host time to an in-memory table: total seconds, self seconds (the
    total less the time its child spans cover on the same thread) and
    calls;
  * ``count(name, value)`` adds ``value`` to the table;
  * ``off_cpu(name)`` counts, in µs, the wall time of its block less the
    CPU time its thread spent in it: the time the thread waited for the
    interpreter's lock, a core, the card or another thread.

The table is keyed ``(root, name)``, where ``root`` is the outermost
program span open on the thread (the span itself, or the counter's name,
where none is).  Work under the write roots (``writer.write``,
``writer.close``, ``sharded.write``) is thereby told from work under the
read roots (``reader.dispatch``, ``reader.materialize``,
``sharded.dispatch``, ``sharded.materialize``) without a clock, and the
work of several threads that write or read at once adds up under the
same roots.  ``DbdeWriter``'s sink thread opens a root of its own
(``writer.sink``, outside the write roots: that time is off the writing
thread's path); ``write_video_sharded``'s opens ``sharded.write``, so its
writes lie under the root of the call they belong to.  The table empties
itself when a span or counter, on any thread, finds a session recording
after some thread last found none, so a session that follows work done
unprofiled starts from nothing, and a thread that starts recording late
empties nothing.  Two sessions back to back, with no span between them,
add into one table: call :func:`reset` before the second.
:func:`totals` reads the table.  No span stays open across a ``yield``.
Kernel launches are counted in :data:`.ops.launch.LAUNCHES`, not here.

torch's profiler puts ``record_function`` ranges into its trace from the
thread that started the session alone, so the ``dbde:*`` ranges of other
threads are in the table and not in the trace.
"""

from __future__ import annotations

import contextlib
import threading
from time import perf_counter as _clock
from time import perf_counter_ns, thread_time_ns

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

PREFIX = "dbde:"
WRITE_ROOTS = ("writer.write", "writer.close", "sharded.write")
READ_ROOTS = ("reader.dispatch", "reader.materialize", "sharded.dispatch", "sharded.materialize")
SINK_ROOT = "writer.sink"  # DbdeWriter's sink thread (see the module docstring)

_table: dict = {}  # (root, name) → [total s, self s, calls] or [value, calls]
_lock = threading.Lock()
_open = threading.local()  # .stack: the spans open on this thread, outermost first
_saw_off = False  # a thread found no session recording since the table last emptied
_OFF = contextlib.nullcontext()  # what span() returns while nothing records: no allocation


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def enabled() -> bool:
    """Whether spans and counters record now, emptying the table where
    some thread found nothing recording at its last look: for a caller
    that has to measure something before it can :func:`count` it."""
    global _saw_off
    if not _profiler._is_profiler_enabled:
        if not _saw_off:
            with _lock:  # seen off under the lock, so no session's entries precede it
                _saw_off = not _profiler._is_profiler_enabled
        return False
    if _saw_off:
        with _lock:
            if _saw_off:
                _saw_off = False
                _table.clear()
    return True


class _Span:
    __slots__ = ("name", "root", "child", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the span's own record_function counts into it, so a parent's
        # self time holds none of its children's cost of being traced
        self.t0 = _clock()
        stack = _stack()
        self.root = stack[0].name if stack else self.name
        self.child = 0.0
        self.rf = record_function(PREFIX + self.name)
        self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = _stack()
        stack.pop()
        self.rf.__exit__(*exc)
        seconds = _clock() - self.t0
        if stack:
            stack[-1].child += seconds
        with _lock:
            acc = _table.setdefault((self.root, self.name), [0.0, 0.0, 0])
            acc[0] += seconds
            acc[1] += seconds - self.child
            acc[2] += 1
        return False


def span(name: str):
    """A context manager that records ``name`` while a profiler session
    records (see the module docstring)."""
    return _Span(name) if enabled() else _OFF


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` under the open root, while a
    profiler session records."""
    if not enabled():
        return
    stack = _stack()
    key = (stack[0].name if stack else name, name)
    with _lock:
        acc = _table.setdefault(key, [0, 0])
        acc[0] += value
        acc[1] += 1


class _OffCpu:
    __slots__ = ("name", "t0", "cpu0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0, self.cpu0 = perf_counter_ns(), thread_time_ns()
        return self

    def __exit__(self, *exc):
        wall, cpu = perf_counter_ns() - self.t0, thread_time_ns() - self.cpu0
        count(self.name, (wall - cpu) / 1e3)
        return False


def off_cpu(name: str):
    """A context manager that counts ``name``, in µs, as its block's wall
    time less its thread's CPU time, while a profiler session records."""
    return _OffCpu(name) if enabled() else _OFF


def totals() -> dict:
    """The table: ``{(root, name): {"total_s", "self_s", "calls"}}`` for a
    span, ``{(root, name): {"value", "calls"}}`` for a counter."""
    with _lock:
        return {key: ({"total_s": v[0], "self_s": v[1], "calls": v[2]} if len(v) == 3
                      else {"value": v[0], "calls": v[1]})
                for key, v in _table.items()}


def reset() -> None:
    """Empty the table."""
    with _lock:
        _table.clear()
