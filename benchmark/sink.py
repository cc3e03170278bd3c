"""Where the window's files go: anonymous shared-memory files (memfd).

A file is a ``memfd_create`` file, reached by the path
``/proc/self/fd/<fd>``: the same shmem pages as a tmpfs such as
``/dev/shm``, but in no directory, of no mount's size, and gone when the
process ends.  So the window writes nothing to disk, and reads come from
the page cache.

:class:`Files` keeps few files alive: the one being written, the newest
complete one (the read half's), the last partial one, and one complete
file drawn from the seed (a reservoir of one over the complete files), so
that the check after the window covers a file from anywhere in the write
half.  Any other file is deleted as soon as the next one is complete, on
a thread of its own: freeing a file's pages takes the host about 0.1 s a
GB, which a deployment's writer does not wait for either.
"""

from __future__ import annotations

import os
import queue
import random
import threading


class MemFile:
    def __init__(self, number: int):
        self.number = number
        self.fd = os.memfd_create(f"bench{number}")
        self.path = f"/proc/self/fd/{self.fd}"
        self.frames = 0  # records written to it, in order from index 0

    def size(self) -> int:
        return os.fstat(self.fd).st_size


class Files:
    """The window's files (see the module docstring)."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self._count = 0
        self.complete = 0
        self.newest = None  # the newest complete file
        self.pick = None  # a complete file drawn from the seed
        self.partial = None
        self.frames_per_file: list[int] = []  # every file's records, in order
        self._trash: queue.Queue = queue.Queue()
        self._deleter = threading.Thread(target=self._delete_loop, daemon=True)
        self._deleter.start()

    def _delete_loop(self) -> None:
        while True:
            fd = self._trash.get()
            if fd is None:
                return
            os.close(fd)
            self._trash.task_done()

    def start(self) -> MemFile:
        self._count += 1
        return MemFile(self._count)

    def finish(self, f: MemFile, complete: bool) -> None:
        self.frames_per_file.append(f.frames)
        if not complete:
            if self.partial is not None:
                self._drop(self.partial)
            self.partial = f
            return
        self.complete += 1
        old = {g.number: g for g in (self.newest, self.pick) if g is not None}
        self.newest = f
        if self._rng.random() * self.complete < 1.0:
            self.pick = f
        for g in old.values():
            if g not in (self.newest, self.pick):
                self._drop(g)

    def _drop(self, f: MemFile) -> None:
        self._trash.put(f.fd)

    def settle(self) -> None:
        """Wait until every dropped file is deleted."""
        self._trash.join()

    def kept(self) -> list[MemFile]:
        """The files alive, oldest first."""
        alive = {f.number: f for f in (self.pick, self.newest, self.partial) if f is not None}
        return [alive[k] for k in sorted(alive)]

    def read_target(self) -> MemFile:
        """The read half's file: the newest complete one, else the partial."""
        return self.newest if self.newest is not None else self.partial

    def close(self) -> None:
        for f in self.kept():
            self._drop(f)
        self.newest = self.pick = self.partial = None
        self._trash.put(None)
        self._deleter.join()
