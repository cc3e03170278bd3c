"""The port's program spans and counters (``dbde_tpu_torch.trace``) on the
CPU: nothing recorded and nothing entered without a profiler; under
``torch.profiler``, each span's calls a batch under its root for the
writer, the reader and the sharded path on CPU mesh slots, ``dbde:``
events nested in their roots, self time within total, the byte counters,
the table's reset between sessions, and the benchmark's reader of the
table (``benchmark/readers/program.py``)."""

import contextlib
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import dbde_tpu_torch
from benchmark.readers import program as program_reader
from dbde_tpu_torch import DbdeReader, DbdeWriter, trace
from dbde_tpu_torch import codec as program_codec
from dbde_tpu_torch.bench_core import make_content
from dbde_tpu_torch.format import VIDEO_HEADER_BYTES
from dbde_tpu_torch.ops import launch
from dbde_tpu_torch.parallel import iter_video_sharded, make_mesh, sharding, write_video_sharded
from dbde_tpu_torch.utils.profiling import idle_by_span

N, H, W, B = 6, 32, 40, 2  # three batches of 2; 4 tile rows, so 2 bands
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frames():
    return make_content(W, H, N)


def _pipeline(frames, tmp):
    """The traced calls: a DbdeWriter on a file descriptor and a DbdeReader
    at pipeline 2, then write_video_sharded (batches of 4 and 2) and
    iter_video_sharded (batch 4) on a 2x2 mesh of CPU slots.  Returns the
    file paths."""
    path = os.path.join(tmp, "w.dbde")
    with open(path, "wb") as f:
        with DbdeWriter(f, H, W, frame_hz=100.0, device=CPU, pipeline=2) as wr:
            for i in range(0, N, B):
                wr.write(frames[i:i + B])
    with DbdeReader(path, batch_size=B, device=CPU, pipeline=2) as rd:
        np.testing.assert_array_equal(rd.read_all()[1], frames)
    mesh = make_mesh(2, 2, devices=[CPU] * 4)
    sharded = os.path.join(tmp, "s.dbde")
    write_video_sharded(sharded, frames, mesh, frame_hz=100.0, batch_size=4)
    got = np.concatenate([f for _, f in iter_video_sharded(sharded, mesh, batch_size=4)])
    np.testing.assert_array_equal(got, frames)
    return path, sharded


@pytest.fixture(scope="module")
def traced(frames, tmp_path_factory):
    """(table, events, paths) of one profiled run of :func:`_pipeline`."""
    tmp = str(tmp_path_factory.mktemp("traced"))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        paths = _pipeline(frames, tmp)
    return trace.totals(), prof.events(), paths


class _NoWrites(dict):
    def setdefault(self, *args):
        raise AssertionError("the table was written with the profiler off")


def test_off_records_nothing_and_enters_nothing(frames, tmp_path, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("entered with the profiler off")

    trace.reset()
    monkeypatch.setattr(trace, "record_function", forbidden)
    monkeypatch.setattr(trace, "_clock", forbidden)
    monkeypatch.setattr(trace, "_table", _NoWrites())
    _pipeline(frames, str(tmp_path))
    assert trace.totals() == {}
    assert trace.span("a") is trace.span("b")  # one shared no-op: nothing allocated
    assert not trace.enabled()


WRITER = {  # (root, name): calls over the three batches; the writev runs on the sink thread
    ("writer.write", "writer.write"): 3, ("writer.write", "codec.stage"): 3,
    ("writer.write", "codec.encode"): 3, ("writer.write", "codec.put"): 3,
    ("writer.write", "writer.drain"): 1, ("writer.write", "codec.records"): 1,
    ("writer.write", "writer.sink_wait"): 1, ("writer.close", "writer.close"): 1,
    ("writer.close", "writer.drain"): 2, ("writer.close", "codec.records"): 2,
    ("writer.close", "writer.sink_wait"): 3,  # two hand-offs and the join
    ("writer.sink", "stream.writev"): 3,
}
READER = {  # two dispatches fill the pipeline; the last two find the end
    ("reader.dispatch", "reader.dispatch"): 5, ("reader.dispatch", "reader.parse"): 5,
    ("reader.dispatch", "codec.decode_dispatch"): 3, ("reader.dispatch", "codec.put"): 3,
    ("reader.materialize", "reader.materialize"): 3,
}
SHARDED = {  # two batches of four shards each way; the writev runs on the call's sink thread
    ("sharded.write", "sharded.write"): 3,  # the call and the sink thread's span a batch
    ("sharded.write", "sharded.encode"): 2,
    ("sharded.write", "codec.stage"): 8, ("sharded.write", "codec.encode"): 8,
    ("sharded.write", "sharded.totals"): 2,
    ("sharded.write", "sharded.fields"): 2, ("sharded.write", "sharded.assemble"): 2,
    ("sharded.write", "stream.writev"): 2,
    ("sharded.write", "writer.sink_wait"): 3,  # two hand-offs and the join
    ("sharded.dispatch", "sharded.dispatch"): 4, ("sharded.dispatch", "reader.parse"): 3,
    ("sharded.dispatch", "sharded.split"): 2, ("sharded.dispatch", "codec.decode_dispatch"): 8,
    ("sharded.materialize", "sharded.materialize"): 2,
}


@pytest.mark.parametrize("calls", [WRITER, READER, SHARDED], ids=["writer", "reader", "sharded"])
def test_span_calls_under_their_roots(traced, calls):
    table = traced[0]
    assert {key: table[key]["calls"] for key in calls if "total_s" in table.get(key, {})} == calls
    # a CPU codec copies nothing back and pins nothing
    assert not any(name in ("copy.wait", "copy.keep", "pinned.allocs") for _, name in table)


def test_counters_under_their_roots(traced, frames):
    table = traced[0]
    # one codec a shard a call: the write builds its grid under its root,
    # the walk before its first dispatch, outside any root, beside the
    # writer's, the reader's and the walker's reader's own codecs
    assert table["sharded.write", "codec.instances"] == {"value": 4, "calls": 4}
    assert ("sharded.dispatch", "codec.instances") not in table
    assert table["codec.instances", "codec.instances"] == {"value": 3 + 4, "calls": 3 + 4}
    # a CPU codec stages nothing
    assert not any(name == "codec.staged_bytes" for _, name in table)


def test_writev_bytes_is_the_file_less_its_header(traced):
    table, _, (path, sharded) = traced
    assert table["writer.sink", "stream.writev_bytes"] == {
        "value": os.path.getsize(path) - VIDEO_HEADER_BYTES, "calls": 3}
    assert not [root for root, name in table
                if name.startswith("stream.writev") and root in ("writer.write", "writer.close")]
    assert table["sharded.write", "stream.writev_bytes"]["value"] == \
        os.path.getsize(sharded) - VIDEO_HEADER_BYTES


def test_inplace_bytes_is_the_writev_less_headers_and_lengths(traced):
    """The sharded writer hands writev every depths, minima and payload
    byte straight from the shards' copies: all it writes but each
    record's 20-byte header and three length words."""
    table = traced[0]
    assert ("sharded.write", "codec.records") not in table
    assert table["sharded.write", "sharded.inplace_bytes"] == {
        "value": table["sharded.write", "stream.writev_bytes"]["value"] - N * (20 + 3 * 4),
        "calls": 2}


def test_sharded_write_records_nothing_under_writer_sink(frames, tmp_path):
    """The sharded write's sink thread records under ``sharded.write``, the
    root its metrics read, and nothing under ``DbdeWriter``'s sink root."""
    mesh = make_mesh(2, 2, devices=[CPU] * 4)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        write_video_sharded(str(tmp_path / "s.dbde"), frames, mesh, frame_hz=100.0,
                            batch_size=4)
    table = trace.totals()
    assert {root for root, _ in table} == {"sharded.write"}
    assert table["sharded.write", "stream.writev_bytes"] == {
        "value": os.path.getsize(tmp_path / "s.dbde") - VIDEO_HEADER_BYTES, "calls": 2}


def test_inplace_bytes_leaves_out_a_copy(frames, tmp_path, monkeypatch):
    """Bands copied on the way to writev are not written in place: the
    counter reads 0 while the file is still exact."""
    record_iovecs = sharding.record_iovecs

    def copied(depths, mins, payload, *args, **kwargs):
        return record_iovecs(*([[a.copy() for a in bands] for bands in field]
                               for field in (depths, mins, payload)), *args, **kwargs)

    monkeypatch.setattr(sharding, "record_iovecs", copied)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _pipeline(frames, str(tmp_path))
    assert trace.totals()["sharded.write", "sharded.inplace_bytes"] == {"value": 0, "calls": 2}


def test_self_time_within_total(traced):
    for key, v in traced[0].items():
        if "total_s" in v:
            assert 0 <= v["self_s"] <= v["total_s"], key


def test_spans_are_dbde_events_nested_in_their_roots(traced):
    events = [e for e in traced[1] if e.name.startswith(trace.PREFIX)]
    names = {e.name[len(trace.PREFIX):] for e in events}
    # the profiler's trace holds its own thread's ranges: not the sink
    # threads' (DbdeWriter's root writer.sink; the sharded write's writev)
    on_sinks = {("sharded.write", "stream.writev")}
    assert {name for (root, name), v in traced[0].items()
            if "total_s" in v and root != trace.SINK_ROOT and (root, name) not in on_sinks} <= names
    is_root = {e.name: e.name[len(trace.PREFIX):] in trace.WRITE_ROOTS + trace.READ_ROOTS
               for e in events}
    roots = [e.time_range for e in events if is_root[e.name]]
    for e in events:
        if not is_root[e.name]:
            assert any(r.start <= e.time_range.start and e.time_range.end <= r.end
                       for r in roots), e.name


def test_table_resets_between_sessions(frames, tmp_path):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _pipeline(frames, str(tmp_path))
    first = trace.totals()
    _pipeline(frames, str(tmp_path))  # the spans find recording off
    with profile(activities=[ProfilerActivity.CPU]):
        _pipeline(frames, str(tmp_path))
    assert {k: v["calls"] for k, v in trace.totals().items()} == \
        {k: v["calls"] for k, v in first.items()}
    trace.reset()
    assert trace.totals() == {}


def test_sessions_back_to_back_add_unless_reset(frames, tmp_path):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _pipeline(frames, str(tmp_path))
    once = {k: v["calls"] for k, v in trace.totals().items()}
    with profile(activities=[ProfilerActivity.CPU]):  # no span between the sessions
        _pipeline(frames, str(tmp_path))
    assert {k: v["calls"] for k, v in trace.totals().items()} == {k: 2 * n for k, n in once.items()}
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _pipeline(frames, str(tmp_path))
    assert {k: v["calls"] for k, v in trace.totals().items()} == once


def test_a_span_or_counter_outside_any_root_is_its_own_root():
    codec = program_codec.DbdeCodec(16, 16, device=CPU)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        codec.stage(np.zeros((1, 16, 16), np.uint8))
        trace.count("x.bytes", 5)
        with trace.span("outer"):
            trace.count("x.bytes", 2)
    table = trace.totals()
    assert table["codec.stage", "codec.stage"]["calls"] == 1
    assert table["x.bytes", "x.bytes"] == {"value": 5, "calls": 1}
    assert table["outer", "x.bytes"] == {"value": 2, "calls": 1}


def test_a_root_is_its_own_threads():
    """A span on another thread (where torch's profiler puts nothing into
    its trace) never lands under the root open on this one."""
    def work():
        with trace.span("worker.span"):
            pass

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("main.root"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=10)
    assert not worker.is_alive()
    assert [key for key in trace.totals() if key[1] == "worker.span"] == [
        ("worker.span", "worker.span")]
    assert trace.totals()["main.root", "main.root"]["calls"] == 1


def test_work_timed_on_another_thread_lands_under_its_root():
    """Work on another thread while a session records lands under that
    thread's own root, as the sink thread's writes do under
    ``writer.sink``, apart from the spans open on the recording thread."""
    def work():
        with trace.span(trace.SINK_ROOT):
            with trace.span("stream.writev"):
                time.sleep(0.01)
            trace.count("stream.writev_bytes", 7)

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("writer.write"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=10)
            with trace.span("writer.sink_wait"):
                pass
    assert not worker.is_alive()
    table = trace.totals()
    writev = table["writer.sink", "stream.writev"]
    assert writev["calls"] == 1 and writev["total_s"] >= 0.01
    assert table["writer.sink", "writer.sink"]["total_s"] >= writev["total_s"]
    assert table["writer.sink", "stream.writev_bytes"] == {"value": 7, "calls": 1}
    assert table["writer.write", "writer.write"]["calls"] == 1
    assert table["writer.write", "writer.sink_wait"]["calls"] == 1
    assert not [name for root, name in table if root == "writer.write" and "writev" in name]
    assert trace.SINK_ROOT not in trace.WRITE_ROOTS


def _writers_on_threads(frames, tmp, cameras: int) -> None:
    """``cameras`` DbdeWriters at once, each on a thread of its own and
    into a file of its own (the sink thread's path), three batches each."""
    errors = []

    def camera(c):
        try:
            with DbdeWriter(os.path.join(tmp, f"cam{c}.dbde"), H, W, device=CPU) as wr:
                for i in range(0, N, B):
                    wr.write(frames[i:i + B])
        except BaseException as e:  # re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=camera, args=(c,)) for c in range(cameras)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not [t for t in threads if t.is_alive()]
    if errors:
        raise errors[0]


def test_every_writer_thread_records(frames, tmp_path):
    """Four writer threads under a session started on this one: every
    ``writer.write`` call, its stage and the sink thread's writes are in
    the table, four times one writer's; the table names no thread."""
    calls = {("writer.write", "writer.write"): 3, ("writer.write", "codec.stage"): 3,
             ("writer.write", "writer.offcpu_us"): 3, ("writer.close", "writer.close"): 1,
             ("writer.close", "writer.sink_wait"): 3, ("writer.sink", "writer.sink"): 3,
             ("writer.sink", "stream.writev"): 3, ("writer.sink", "stream.writev_bytes"): 3}
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _writers_on_threads(frames, str(tmp_path), 4)
    table = trace.totals()
    assert {key: table[key]["calls"] for key in calls} == {k: 4 * n for k, n in calls.items()}
    size = os.path.getsize(tmp_path / "cam0.dbde") - VIDEO_HEADER_BYTES
    assert table["writer.sink", "stream.writev_bytes"]["value"] == 4 * size


def test_offcpu_is_the_write_less_its_cpu_time(frames, tmp_path, monkeypatch):
    """``writer.offcpu_us`` counts each ``write``'s wall time less its
    thread's CPU time: a stage that sleeps 30 ms shows as 30 ms off the CPU."""
    stage = program_codec.DbdeCodec.stage

    def sleepy(self, *args, **kwargs):
        time.sleep(0.03)
        return stage(self, *args, **kwargs)

    monkeypatch.setattr(program_codec.DbdeCodec, "stage", sleepy)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with DbdeWriter(str(tmp_path / "w.dbde"), H, W, device=CPU) as wr:
            for i in range(0, N, B):
                wr.write(frames[i:i + B])
    table = trace.totals()
    off = table["writer.write", "writer.offcpu_us"]
    assert off["calls"] == 3
    assert 3 * 30e3 <= off["value"] <= 1e6 * table["writer.write", "writer.write"]["total_s"]


def test_a_thread_that_starts_late_empties_nothing():
    """A thread that last looked before the session, or looks after it,
    empties nothing that the session recorded."""
    looked, go = threading.Event(), threading.Event()

    def late():
        with trace.span("late.before"):  # the session has not started
            looked.set()
        go.wait(timeout=10)
        with trace.span("late.root"):
            pass

    trace.reset()
    worker = threading.Thread(target=late)
    worker.start()
    assert looked.wait(timeout=10)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("main.root"):
            pass
        go.set()
        worker.join(timeout=10)
        with trace.span("main.again"):
            pass
    assert not worker.is_alive()
    with trace.span("after.session"):  # finds nothing recording
        pass
    assert {key: v["calls"] for key, v in trace.totals().items()} == {
        ("main.root", "main.root"): 1, ("late.root", "late.root"): 1,
        ("main.again", "main.again"): 1}


@pytest.mark.parametrize("stats, want", [
    ([{"num_host_alloc": 1, "host_alloc_time.total": 10},
      {"num_host_alloc": 3, "host_alloc_time.total": 25}], (2, 15)),
    ([{}, {}], (0, 0)),  # a torch that does not say: zero, recorded
])
def test_pinned_allocations_are_counted(monkeypatch, stats, want):
    empty = torch.empty
    monkeypatch.setattr(program_codec.torch.cuda, "host_memory_stats", lambda: stats.pop(0))
    monkeypatch.setattr(program_codec.torch, "empty",
                        lambda *a, pin_memory=False, **k: empty(*a, **k))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("writer.write"):
            program_codec._pinned((4,), torch.uint8)
    table = trace.totals()
    assert (table["writer.write", "pinned.allocs"]["value"],
            table["writer.write", "pinned.alloc_us"]["value"]) == want


class _ProcessStats:
    """A pinned cache's process-wide statistics, whose every allocation
    takes 2 ms, one block and 10 µs: a measurement that lets another
    thread's allocation into its window counts it twice."""

    def __init__(self, empty):
        self._empty, self.blocks, self.us = empty, 0, 0

    def stats(self):
        return {"num_host_alloc": self.blocks, "host_alloc_time.total": self.us}

    def alloc(self, *args, pin_memory=False, **kwargs):
        self.blocks += 1
        time.sleep(0.002)
        self.us += 10
        return self._empty(*args, **kwargs)


def _on_threads(n: int, fn) -> None:
    threads = [threading.Thread(target=fn) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in threads if t.is_alive()]


def _pinned_totals(monkeypatch, threads: int) -> tuple:
    cache = _ProcessStats(torch.empty)
    monkeypatch.setattr(program_codec.torch.cuda, "host_memory_stats", cache.stats)
    monkeypatch.setattr(program_codec.torch, "empty", cache.alloc)

    def write():
        with trace.span("writer.write"):
            for _ in range(5):
                program_codec._pinned((4,), torch.uint8)

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _on_threads(threads, write)
    monkeypatch.undo()
    table = trace.totals()
    return (table["writer.write", "pinned.allocs"]["value"],
            table["writer.write", "pinned.alloc_us"]["value"])


def test_pinned_counters_add_up_over_threads(monkeypatch):
    assert _pinned_totals(monkeypatch, 1) == (5, 50)
    assert _pinned_totals(monkeypatch, 4) == (20, 200)


@pytest.mark.parametrize("threads", [4, 2 * (os.cpu_count() or 4)], ids=["four", "over-cores"])
def test_launch_counts_add_up_over_threads(monkeypatch, threads):
    """``LAUNCHES`` from threads that launch at once: n threads count n
    times one thread's launches (a fake launcher; no card needed)."""
    monkeypatch.setattr(launch.torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(launch.torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    per_thread = 4000

    def launches():
        for _ in range(per_thread):
            launch.launch("decode", lambda *args: 0, CPU)

    launch.reset_launches()
    try:
        _on_threads(1, launches)
        assert launch.LAUNCHES["decode"] == per_thread
        launch.reset_launches()
        _on_threads(threads, launches)
        assert launch.LAUNCHES["decode"] == threads * per_thread
    finally:
        launch.reset_launches()


def _made_up(table):
    return lambda: table


@pytest.mark.parametrize("table, spec, want", [
    ({("writer.write", "copy.wait"): {"total_s": 0.5, "self_s": 0.5, "calls": 3},
      ("writer.close", "copy.wait"): {"total_s": 0.1, "self_s": 0.1, "calls": 1},
      ("reader.dispatch", "copy.wait"): {"total_s": 9.0, "self_s": 9.0, "calls": 1}},
     {"names": ["copy.wait"], "kind": "span", "scale": 1e3}, 1e3 * 0.6 / 4),
    ({("sharded.write", "pinned.alloc_us"): {"value": 800, "calls": 4}},
     {"names": ["pinned.alloc_us"], "kind": "counter", "scale": 1e-3}, 1e-3 * 800 / 4),
    ({("writer.write", "writer.write"): {"total_s": 1.0, "self_s": 0.1, "calls": 4}},
     {"names": ["copy.wait"], "kind": "span", "scale": 1e3}, 0.0),
    ({("sharded.write", "sharded.assemble"): {"total_s": 1.0, "self_s": 1.0, "calls": 4}},
     {"names": ["sharded.assemble"], "roots": ["writer.write"], "kind": "span", "scale": 1e3},
     None),
    ({}, {"names": ["copy.wait"], "kind": "span", "scale": 1e3}, None),
], ids=["span", "counter", "root-but-no-name", "other-roots", "nothing"])
def test_program_reader(monkeypatch, table, spec, want):
    monkeypatch.setattr(trace, "totals", _made_up(table))
    got = program_reader.read(SimpleNamespace(halves={"write": {"batches": 4}}),
                              {**spec, "half": "write"})
    assert got == pytest.approx(want) if want is not None else got is None


def test_program_reader_on_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(dbde_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "dbde_tpu_torch.trace", None)  # the import fails
    assert program_reader.read(SimpleNamespace(halves={"write": {"batches": 4}}),
                               {"names": ["copy.wait"], "kind": "span", "scale": 1e3,
                                "half": "write"}) is None


def _event(name, start, end, cuda=False, card=0, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           device_index=card, is_user_annotation=annotation)


def test_idle_by_span_on_made_up_events():
    """Card 0 busy 10-30 and 60-70, card 1 busy 0-100; host: writer.write
    0-50 holding codec.stage 5-40 and a codec.put of no length at 32, then
    nothing, then writer.close 55-90 holding writer.drain 55-60, which
    opens with it and is listed first; the program's annotation mirrored
    on the device and any user annotation are no activity."""
    events = [_event("dbde:writer.write", 0, 50), _event("dbde:codec.stage", 5, 40),
              _event("dbde:codec.put", 32, 32), _event("dbde:writer.drain", 55, 60),
              _event("dbde:writer.close", 55, 90), _event("bench:write", 0, 95),
              _event("kernel", 10, 30, cuda=True), _event("Memcpy HtoD", 60, 70, cuda=True),
              _event("kernel", 0, 100, cuda=True, card=1),
              _event("dbde:codec.stage", 5, 40, cuda=True),
              _event("gpu_user_annotation", 0, 90, cuda=True, annotation=True)]
    # the program spans' 0-90: card 0 idles 0-10 (writer.write 0-5,
    # codec.stage 5-10), 30-60 (codec.stage 30-40, writer.write 40-50, none
    # 50-55, writer.drain 55-60), 70-90 (writer.close); card 1 never
    card0 = {("writer.write", "writer.write"): 15, ("writer.write", "codec.stage"): 15,
             (None, None): 5, ("writer.close", "writer.drain"): 5,
             ("writer.close", "writer.close"): 20}
    assert idle_by_span(events, [0]) == pytest.approx(card0)
    assert idle_by_span(events, [0, 1]) == pytest.approx({k: v / 2 for k, v in card0.items()})
    assert idle_by_span([e for e in events if e.device_type == DeviceType.CUDA], [0]) == {}
