"""Program spans and counters, recorded only under ``torch.profiler``.

The stream, codec and parallel layers mark their work with :func:`span`
and :func:`count`.  Both do nothing beyond one check,
``torch.autograd._profiler_enabled()``, unless a profiler session is
recording: no ``record_function``, no clock read, no table write.  While
one is recording,

  * ``span(name)`` opens ``record_function("dbde:" + name)``, so the span
    lies on the profiler's clock beside the device's intervals, and adds
    its host time to an in-memory table: total seconds, self seconds (the
    total less the time its child spans cover on the same thread) and
    calls;
  * ``count(name, value)`` adds ``value`` to the table.

The table is keyed ``(root, name)``, where ``root`` is the outermost
program span open on the thread (the span itself, or the counter's name,
where none is).  Work under the write roots (``writer.write``,
``writer.close``, ``sharded.write``) is thereby told from work under the
read roots (``reader.dispatch``, ``reader.materialize``,
``sharded.dispatch``, ``sharded.materialize``) without a clock.  The
table empties itself when a span or counter finds recording on after it
last found it off on the same thread, so a session that follows work done
unprofiled starts from nothing.  Two sessions back to back, with no span
between them, add into one table: call :func:`reset` before the second.
:func:`totals` reads the table.  No span stays open across a ``yield``.
Kernel launches are counted in :data:`.ops.launch.LAUNCHES`, not here.

torch's profiler records on the thread that started the session: on any
other thread spans record nothing and their finding recording off empties
nothing.  Work timed on such a thread, as ``DbdeWriter``'s sink thread
times its ``writev`` calls, is added to the table afterwards from the
recording thread with :func:`interval` and :func:`count`'s ``root``,
under a root of its own (``writer.sink``, outside the write roots: that
time is off the writing thread's path).
"""

from __future__ import annotations

import contextlib
import threading
from time import perf_counter as _clock

from torch.autograd import _profiler_enabled as _recording
from torch.profiler import record_function

PREFIX = "dbde:"
WRITE_ROOTS = ("writer.write", "writer.close", "sharded.write")
READ_ROOTS = ("reader.dispatch", "reader.materialize", "sharded.dispatch", "sharded.materialize")
SINK_ROOT = "writer.sink"  # DbdeWriter's sink thread (see the module docstring)

_table: dict = {}  # (root, name) → [total s, self s, calls] or [value, calls]
_lock = threading.Lock()
_open = threading.local()  # .stack: the spans open on this thread, outermost first;
# .saw_off: recording was off at this thread's last span or counter
_OFF = contextlib.nullcontext()  # what span() returns while nothing records: no allocation


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def enabled() -> bool:
    """Whether spans and counters record now, emptying the table where
    nothing recorded at the last look: for a caller that has to measure
    something before it can :func:`count` it."""
    if not _recording():
        _open.saw_off = True
        return False
    if getattr(_open, "saw_off", False):
        _open.saw_off = False
        reset()
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


def count(name: str, value, root: str | None = None) -> None:
    """Add ``value`` to counter ``name`` under ``root`` (default: the open
    root), while a profiler session records."""
    if not enabled():
        return
    if root is None:
        stack = _stack()
        root = stack[0].name if stack else name
    key = (root, name)
    with _lock:
        acc = _table.setdefault(key, [0, 0])
        acc[0] += value
        acc[1] += 1


def interval(root: str, name: str, seconds: float) -> None:
    """Add a finished span ``name`` of ``seconds`` under ``root``, while a
    profiler session records: for work timed with this module's clock
    (``time.perf_counter``) on a thread where the profiler does not record.
    Its self time is its total."""
    if not enabled():
        return
    with _lock:
        acc = _table.setdefault((root, name), [0.0, 0.0, 0])
        acc[0] += seconds
        acc[1] += seconds
        acc[2] += 1


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
