"""The port's native IO library (dbde_tpu_torch/native): it builds
correctly when several builders start at once."""

import ctypes
import threading

from dbde_tpu_torch.native import binding


def test_concurrent_first_builds_all_get_the_library(tmp_path, monkeypatch):
    """Four threads build into an empty build directory at once: each gets
    a library that loads, and no partial or temporary file is left."""
    monkeypatch.setattr(binding, "_build_dir", lambda: str(tmp_path))
    start, paths = threading.Barrier(4), [None] * 4

    def build(i):
        start.wait()
        paths[i] = binding._compile()

    threads = [threading.Thread(target=build, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0] is not None
    for path in paths:
        assert ctypes.CDLL(path).dbde_record_size is not None
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].rsplit("/", 1)[-1]]
