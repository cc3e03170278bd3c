"""Host spans around the program's callables, for the traced run only.

A target is ``module:attribute`` (``dbde_tpu_torch.codec:DbdeCodec.stage``).
:class:`Spans` replaces each target, for the window, by a wrapper that
adds the call's host time to the half under way, and opens a
``record_function`` span of the same name, so that the profiler's trace
says what the host was doing in each of the device's idle gaps.  The
harness's own steps (a ``write`` call, the wait for the next batch) are
spans too, through :meth:`Spans.step`.  With ``enabled`` false nothing is
wrapped and every span is free: the untraced run measures the program as
it is.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

PREFIX = "bench:"


def resolve(target: str):
    """``module:A.b`` → (the object that holds ``b``, ``"b"``)."""
    module, _, path = target.partition(":")
    obj = importlib.import_module(module)
    *owners, attr = path.split(".")
    for name in owners:
        obj = getattr(obj, name)
    return obj, attr


class Spans:
    def __init__(self, targets, enabled: bool):
        self.enabled = enabled
        self.targets = sorted(set(targets)) if enabled else []
        self.half = None
        self.totals: dict[str, dict[str, list]] = {}  # half → target → [seconds, calls]
        self._saved = []

    def _wrap(self, target: str, fn):
        from torch.profiler import record_function

        label = PREFIX + target.partition(":")[2]

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with record_function(label):
                    return fn(*args, **kwargs)
            finally:
                if self.half is not None:
                    acc = self.totals[self.half].setdefault(target, [0.0, 0])
                    acc[0] += time.perf_counter() - t0
                    acc[1] += 1

        return timed

    def install(self) -> None:
        for target in self.targets:
            owner, attr = resolve(target)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(target, fn))

    def uninstall(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    @contextlib.contextmanager
    def in_half(self, half: str):
        """The window's ``half`` ("write" or "read"), marked in the trace."""
        self.half = half
        self.totals[half] = {}
        with self.step("half:" + half):
            yield
        self.half = None

    def step(self, name: str):
        """A span of the harness's own (``bench:<name>`` in the trace)."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)
