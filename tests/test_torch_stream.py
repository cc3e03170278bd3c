"""The port's streaming writer/reader (device="cpu") against the JAX
package's and the numpy oracle's files, the no-jax import rule, and a
rehearsal of chip_smoke.py at a tiny size on the CPU."""

import importlib.util
import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dbde_tpu import ref_numpy as ref
from dbde_tpu import stream as jax_stream
from dbde_tpu.bench_core import make_adversarial, make_content
from dbde_tpu_torch.bench_core import make_depth_runs
from dbde_tpu.golden_vectors import GOLDEN_8x16_FILE, GOLDEN_8x16_IMAGE, README_10x10_IMAGE
from dbde_tpu_torch import DbdeReader, DbdeWriter, read_video, write_video
from dbde_tpu_torch.codec import unpack_frames_bytes
from dbde_tpu_torch.format import VIDEO_HEADER_BYTES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 5, 20, 28  # batch 2 leaves a ragged tail batch of 1


@pytest.fixture(scope="module")
def frames():
    return make_adversarial(W, H, N, maxd=8, seed=12)


@pytest.fixture(scope="module")
def jax_file(frames, tmp_path_factory):
    """A file written by the JAX package's writer on its XLA codec."""
    path = tmp_path_factory.mktemp("jax") / "jax.dbde"
    jax_stream.write_video(str(path), frames, frame_hz=250.0, device=True)
    return path.read_bytes()


def _write_port(frames, target: str, batch: int = 2) -> bytes:
    """Port writer output into a BytesIO, a sink with no file descriptor
    (one write of the joined records), with ``use_native`` on and off: the
    option, kept for the JAX writer's signature, changes nothing."""
    f = io.BytesIO()
    with DbdeWriter(f, H, W, frame_hz=250.0, device="cpu",
                    use_native=(target != "bytesio-numpy")) as wr:
        for i in range(0, len(frames), batch):
            wr.write(frames[i : i + batch])
    return f.getvalue()


@pytest.mark.parametrize("target", ["file", "bytesio-native", "bytesio-numpy"])
def test_write_video_bytes_match_jax_and_oracle(frames, jax_file, target, tmp_path):
    if target == "file":
        path = tmp_path / "port.dbde"
        write_video(str(path), frames, frame_hz=250.0, device="cpu", batch_size=2)
        got = path.read_bytes()
    else:
        got = _write_port(frames, target)
    assert got == jax_file
    assert got == ref.encode_video(list(frames), frame_hz=250.0)


def test_uniform_depth8_video_bytes(tmp_path):
    """Random frames (every tile depth 8, the uniform pair's case) in a
    ragged geometry: the port's file is the oracle's, and both packages
    read it back."""
    frames = make_content(37, 19, 3, kind="random")
    path = tmp_path / "random.dbde"
    write_video(str(path), frames, frame_hz=250.0, device="cpu", batch_size=2)
    assert path.read_bytes() == ref.encode_video(list(frames), frame_hz=250.0)
    np.testing.assert_array_equal(read_video(str(path), device="cpu", batch_size=2)[2], frames)
    np.testing.assert_array_equal(jax_stream.read_video(str(path), device=False)[2], frames)


def test_writer_golden_file():
    f = io.BytesIO()
    with DbdeWriter(f, 8, 16, frame_hz=1.0, device="cpu") as wr:
        wr.write(GOLDEN_8x16_IMAGE, indices=[1])
    assert f.getvalue() == GOLDEN_8x16_FILE


@pytest.mark.parametrize("source, use_native", [("file", True), ("file", False),
                                                ("bytesio", True), ("bytesio", False)])
def test_read_video_reads_jax_file(frames, jax_file, tmp_path, source, use_native):
    """mmap'd file or buffered stream, native or numpy parse: every path of
    the port's _read_batch_arrays."""
    if source == "file":
        path = tmp_path / "jax.dbde"
        path.write_bytes(jax_file)
        src = str(path)
    else:
        src = io.BytesIO(jax_file)
    with DbdeReader(src, batch_size=2, device="cpu", use_native=use_native) as r:
        headers, out = r.read_all()
        assert r.header.frame_hz == 250.0 and r.frames_read == N
    np.testing.assert_array_equal(out, frames)
    assert [h.index for h in headers] == list(range(N))


def test_read_video_function(frames, jax_file, tmp_path):
    path = tmp_path / "jax.dbde"
    path.write_bytes(jax_file)
    vh, headers, out = read_video(str(path), device="cpu", batch_size=3)
    assert (vh.height, vh.width) == (H, W) and len(headers) == N
    np.testing.assert_array_equal(out, frames)


def test_iter_raw_fields(frames, jax_file):
    """The undecoded walk: the fields at the reader's short payload stride."""
    with DbdeReader(io.BytesIO(jax_file), batch_size=N, device="cpu") as r:
        (headers, (depths, mins, payload, n64)), = list(r.iter_raw())
    assert payload.shape[1] == min(16 * depths.shape[1], 65536)
    for b in range(N):
        rec = ref.pack_frame(b, frames[b])[20:]
        assert bytes(depths[b]) == rec[4 : 4 + depths.shape[1]]
        assert payload[b, : 2 * n64[b]].tobytes() == rec[12 + 2 * depths.shape[1]:]


def test_jax_reader_reads_port_file(frames, tmp_path):
    path = tmp_path / "port.dbde"
    write_video(str(path), frames, device="cpu", batch_size=4)
    _, _, out = jax_stream.read_video(str(path), device=False)
    np.testing.assert_array_equal(out, frames)


def test_reader_rejects_cuda_without_gpu(jax_file):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DbdeReader(io.BytesIO(jax_file))


def test_unpack_frames_bytes_default_stride(frames, jax_file):
    T = 3 * 4
    off = 28 + 20
    depths, mins, payload, n64 = unpack_frames_bytes(jax_file, W, H, [off])
    assert payload.shape == (1, 16 * T)
    np.testing.assert_array_equal(depths[0], ref.tile_depths_mins(ref.tile_image(frames[0]))[0])


NO_JAX = """
import importlib, importlib.util, os, pkgutil, sys, tempfile
import numpy as np
import dbde_tpu_torch
for mod in pkgutil.walk_packages(dbde_tpu_torch.__path__, "dbde_tpu_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from dbde_tpu_torch import cli, read_video, write_video
frames = np.random.default_rng(0).integers(0, 256, (3, 12, 20)).astype(np.uint8)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "v.dbde")
    write_video(path, frames, device="cpu", batch_size=2)
    _, _, out = read_video(path, device="cpu", batch_size=2)
    golden = os.path.join(d, "g.dbde")
    assert cli.main(["golden", "-o", golden, "--frames", "2"]) == 0
    assert cli.main(["info", golden, "--scan"]) == 0
from dbde_tpu_torch import trace
assert trace.totals() == {}
assert (out == frames).all()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "dbde_tpu"))
assert not leaked, leaked
print("no-jax ok", len([m for m in sys.modules if m.startswith("dbde_tpu_torch")]))
"""


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has jax from conftest), importing
    every module of the port, loading chip_smoke.py, a full write and read
    on the CPU and the CLI's golden and info leave jax and the JAX package
    out of sys.modules."""
    proc = subprocess.run([sys.executable, "-c", NO_JAX], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax ok" in proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rehearsal_on_cpu():
    """Phases 2, 3 and 3b of chip_smoke.py at a tiny size, plain versions only."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    errs = smoke.check_kernels(cpu, [
        ("golden", GOLDEN_8x16_IMAGE[None]),
        ("readme", README_10x10_IMAGE[None]),
        ("adversarial", make_adversarial(43, 21, 2, maxd=8, seed=1)),
        ("camera", make_content(40, 24, 2)),
        ("depth runs across block seams", make_depth_runs(20000, 8, 2, seed=2)),
    ])
    assert errs == dict.fromkeys(("encode_depths", "encode_payload", "decode",
                                  "encode_payload_u8", "decode_u8",
                                  "encode_tiles", "decode_tiles"), 0)
    frames = np.concatenate([make_content(40, 24, 3), make_content(40, 24, 2, kind="random")])
    launches, _, digest, pinned = smoke.check_main_path(cpu, frames, batch=2)
    # a CPU codec pins nothing
    assert pinned == {"cached after read_video": 0, "added by read_video": 0}
    assert set(launches.values()) == {0}
    times = smoke.time_pipelines(cpu, frames, 2, digest, depths=(2, 1))
    assert {k: len(v) for k, v in times.items()} == {2: 1, 1: 1}
    parts = smoke.span_split(cpu, frames, 2, smoke.make_mesh(2, 1, devices=[cpu] * 2), digest)
    assert list(parts) == ["stream write", "stream read", "mesh write", "mesh read"]
    names = {part: {row.split(":")[0] for row in rows} for part, rows in parts.items()}
    assert {"writer.write/codec.encode", "writer.write/writer.sink_wait",
            "writer.close/writer.sink_wait", "writer.sink/stream.writev",
            "writer.sink/stream.writev_bytes"} <= names["stream write"]
    assert {"reader.dispatch/reader.parse", "reader.materialize/reader.materialize"} \
        <= names["stream read"]
    assert {"sharded.write/sharded.encode", "sharded.write/codec.instances"} <= names["mesh write"]
    assert {"sharded.dispatch/sharded.split", "sharded.materialize/sharded.materialize"} \
        <= names["mesh read"]
    assert all(row.endswith("idle -") for rows in parts.values() for row in rows
               if "calls" in row)  # no card: no idle time
    # what phase 3 requires on the GPU: every encode launches K2 and K4
    # (gated on the device); from the reader's host depths the mixed batch
    # [camera, random] decodes with K3, the all-random batch with K5
    assert smoke.expected_launches(frames, batch=2) == {
        "encode_depths": 3, "encode_payload": 3, "decode": 2,
        "encode_payload_u8": 3, "decode_u8": 1, "encode_tiles": 0, "decode_tiles": 0}
    launches, _ = smoke.check_tiles_path(cpu, [make_content(40, 24, 2),
                                               make_content(40, 24, 2, kind="random")])
    assert set(launches.values()) == {0}


def test_chip_smoke_sharded_rehearsal_on_cpu(monkeypatch):
    """Phase 5 of chip_smoke.py at a tiny size on a mesh of CPU slots (plain
    versions only), and the launches it would require on a GPU mesh."""
    smoke = _chip_smoke()
    entry, dryruns = smoke.graft_entry.entry, []

    def small_entry(device):  # entry()'s step on a corner of its example
        fn, (example,) = entry(device)
        return fn, (np.ascontiguousarray(example[:, :16, :40]),)

    # the dry run itself is tests/test_torch_parallel.py's
    monkeypatch.setattr(smoke.graft_entry, "entry", small_entry)
    monkeypatch.setattr(smoke.graft_entry, "dryrun_multichip",
                        lambda n, device: dryruns.append((n, device)))
    cpu = torch.device("cpu")
    camera = make_content(24, 16, 4)
    frames = np.concatenate([camera, make_content(24, 16, 2, kind="random"), camera[:1]])
    launches, seconds = smoke.check_sharded_path(cpu, frames, 2, make_content(20, 27, 2))
    assert dryruns == [(8, "cpu")]
    assert set(launches) == {"a", "b", "c", "d"}
    assert all(set(n.values()) == {0} for n in launches.values())
    assert set(seconds) == {"write_video", "write_video_sharded", "iter_video_sharded",
                            "read_video"}
    # on a 2x2 GPU mesh: 4 batches of 4 shards, each encode launching K2
    # and K4 (gated on the device); the random batch's bands decode with
    # K5, and the tail's zero record makes its read shard general
    assert smoke.expected_sharded_launches(frames, 2, 2, 2) == {
        "encode_depths": 16, "encode_payload": 16, "decode": 12,
        "encode_payload_u8": 16, "decode_u8": 4, "encode_tiles": 0, "decode_tiles": 0}
    monkeypatch.setattr(smoke, "_time_ms", lambda fn, iters: (fn(), 1.0)[1])
    assert smoke.time_shard_encodes(cpu, camera) == (1.0, 1.0)


def test_chip_smoke_stream_switch_on_cpu():
    """Phase 3c's stream switch at a tiny size on the CPU (no streams there:
    the plain versions, the reader and the sharded walker on 2x2 CPU slots)."""
    cpu = torch.device("cpu")
    said = _chip_smoke().check_stream_switch(cpu, make_content(40, 32, 2),
                                             make_content(40, 32, 2, kind="random"))
    assert "2x2 mesh on cpu,cpu,cpu,cpu" in said and said.endswith("exact")


def test_chip_smoke_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        _chip_smoke().main()


def test_chip_smoke_timing_cases_on_cpu(monkeypatch):
    """Phase 4's cases run (each once, untimed) on the plain versions: the
    uniform pair is timed only on all-depth-8 content; every kernel timed
    has a bound."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "_time_ms", lambda fn, iters: (fn(), 1.0)[1])
    cpu = torch.device("cpu")
    common = {"encode_depths", "encode_payload", "decode", "encode_tiles", "decode_tiles",
              "encode path", "encode path general", "decode path", "tiles encode path",
              "tiles decode path"}
    camera, random = make_content(24, 16, 2), make_content(24, 16, 2, kind="random")
    assert set(smoke.time_paths(cpu, camera)) == common
    assert set(smoke.time_paths(cpu, random)) == common | {"encode_payload_u8", "decode_u8"}
    widths = smoke.time_widths(cpu, (24, 16), H=16, B=2)
    assert {W: set(paths) for W, paths in widths.items()} == {24: {"encode", "decode"},
                                                              16: {"encode", "decode"}}
    for key in smoke.band.LAUNCHES:
        ms, by, nbytes, ops = smoke.kernel_bound(key, random, smoke._n64_total(random, cpu))
        assert ms > 0 and by in ("bytes", "operations") and nbytes > random.size and ops > 0


def test_kernel_bound_counts_the_bytes():
    """16x2048x2048 camera content: the bytes the kernels must move, as
    PERF.md works them out (K1 69.2 MB, about 20.7 us at 3.35 TB/s)."""
    smoke = _chip_smoke()
    frames = np.zeros((16, 2048, 2048), np.uint8)
    ms, by, nbytes, _ = smoke.kernel_bound("encode_depths", frames, 0)
    assert (by, nbytes) == ("bytes", 16 * 2048 * 2048 + 2 * 16 * 65536)
    assert abs(ms - nbytes / 3.35e9) < 1e-9
    _, _, nbytes6, _ = smoke.kernel_bound("encode_tiles", frames, 1000)
    assert nbytes6 == 66 * 16 * 65536 + 8 * 1000 + 4 * 16
    # K2 and K3 take no offsets: frames, depths and minima, the live
    # payload, and K2's n64
    _, _, nbytes2, _ = smoke.kernel_bound("encode_payload", frames, 1000)
    _, _, nbytes3, _ = smoke.kernel_bound("decode", frames, 1000)
    assert nbytes2 == 16 * 2048 * 2048 + 2 * 16 * 65536 + 8 * 1000 + 4 * 16
    assert nbytes3 == 16 * 2048 * 2048 + 2 * 16 * 65536 + 8 * 1000


def test_chip_smoke_band_sizes_on_cpu(monkeypatch):
    """Phase 4's K2 and K3 at other frame sizes run (once, untimed) on the
    plain versions, after their round-trip check; the depth bytes their
    blocks read for the sums of the earlier depths: chunk g reads g*1024."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "_time_ms", lambda fn, iters: (fn(), 1.0)[1])
    runs = make_depth_runs(20000, 8, 2, seed=3)  # T 2500: chunks 0, 1 and 2
    sizes = [("camera", make_content(40, 24, 2)), ("runs", runs)]
    assert smoke.time_band_sizes(torch.device("cpu"), sizes) == dict.fromkeys(
        ("camera", "runs"), {"encode_payload": 1.0, "decode": 1.0})
    assert smoke.prefix_bytes(runs) == 2 * (1024 + 2048)
    assert smoke.prefix_bytes(np.zeros((2, 4096, 4096), np.uint8)) == 2 * 1024 * 256 * 255 // 2


# -- the pipelined writer and reader (pipeline depths 1 to 3) -----------------

PH, PW = 19, 37  # ragged on both edges: 3 x 5 tiles


@pytest.fixture(scope="module")
def pipeline_frames():
    """Three batches of two: every tile depth 8; mixed depths; mixed with
    one frame whose tiles are all depth 8 (the batch flag must still say
    mixed)."""
    random = make_content(PW, PH, 3, kind="random")
    mixed = make_adversarial(PW, PH, 3, maxd=7, seed=21)
    return np.concatenate([random[:2], mixed[:2], mixed[2:], random[2:]])


@pytest.fixture(scope="module")
def pipeline_jax_file(pipeline_frames, tmp_path_factory):
    """The JAX package's writer on its host path (no compile)."""
    path = tmp_path_factory.mktemp("jaxp") / "p.dbde"
    jax_stream.write_video(str(path), pipeline_frames, frame_hz=250.0, device=False,
                           batch_size=2)
    return path.read_bytes()


def _within(fn, seconds: float = 20.0):
    """``fn()`` on a thread of its own, joined with a timeout, so that a
    hung sink thread fails the test instead of hanging the suite; returns
    what it returned, raises what it raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=seconds)
    assert not worker.is_alive(), "the writer hung"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.mark.parametrize("sink", ["file", "fileobj", "bytesio"])
@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_writer_pipeline_bytes_match_jax(pipeline_frames, pipeline_jax_file, tmp_path,
                                         pipeline, sink):
    """A path and a caller's open file (file descriptors: the sink thread
    writes) and a BytesIO (assembled on the caller's thread) give the JAX
    package's file; the caller's file stays open."""
    path = tmp_path / "p.dbde"
    owned = open(path, "wb") if sink == "fileobj" else None
    target = {"file": str(path), "fileobj": owned, "bytesio": io.BytesIO()}[sink]

    def write():
        with DbdeWriter(target, PH, PW, frame_hz=250.0, device="cpu", pipeline=pipeline) as wr:
            for i in range(0, len(pipeline_frames), 2):
                wr.write(pipeline_frames[i : i + 2])

    _within(write)
    if owned is not None:
        assert not owned.closed
        owned.close()
    got = target.getvalue() if sink == "bytesio" else path.read_bytes()
    assert got == pipeline_jax_file


@pytest.mark.parametrize("sink", ["file", "bytesio"])
@pytest.mark.parametrize("pipeline", [1, 2])
def test_writer_caller_may_overwrite_its_frames(pipeline_frames, pipeline_jax_file, tmp_path,
                                                pipeline, sink):
    """The caller reuses one buffer for every batch, overwriting it as soon
    as write() returns: the file is unchanged."""
    path = tmp_path / "p.dbde"
    f = io.BytesIO() if sink == "bytesio" else open(path, "wb")
    buf = np.empty((2, PH, PW), np.uint8)

    def write():
        with DbdeWriter(f, PH, PW, frame_hz=250.0, device="cpu", pipeline=pipeline) as wr:
            for i in range(0, len(pipeline_frames), 2):
                buf[:] = pipeline_frames[i : i + 2]
                wr.write(buf)
                buf[:] = 0xFF

    _within(write)
    if sink == "bytesio":
        assert f.getvalue() == pipeline_jax_file
    else:
        f.close()
        assert path.read_bytes() == pipeline_jax_file


def test_sink_keeps_records_in_order(tmp_path, monkeypatch):
    """Many one-frame batches through a sink that is slower than the
    writer on every other write, so the hand-off queue fills, with the
    interpreter switching threads as often as it can: every record in
    order, no hole, the file the oracle's, and at most two batches' arrays
    held whenever a batch is staged."""
    from dbde_tpu_torch import stream
    from dbde_tpu_torch.codec import DbdeCodec

    frames = make_content(16, 8, 48, kind="random")
    frames[::3] = make_content(16, 8, 16)  # mixed depths, so records differ in size
    writev = stream._writev_all
    calls = []

    def slow(fd, iov):
        calls.append(len(iov))
        if len(calls) % 2:
            time.sleep(0.002)
        return writev(fd, iov)

    held, writers = [], []
    stage = DbdeCodec.stage

    def spy_stage(self, batch):
        held.append(len(writers[0]._sink._held))
        return stage(self, batch)

    monkeypatch.setattr(stream, "_writev_all", slow)
    monkeypatch.setattr(DbdeCodec, "stage", spy_stage)
    path = tmp_path / "order.dbde"

    def write():
        with DbdeWriter(str(path), 8, 16, frame_hz=250.0, device="cpu", pipeline=1) as wr:
            writers.append(wr)
            for frame in frames:
                wr.write(frame)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _within(write)
    finally:
        sys.setswitchinterval(interval)
    assert calls == [7] * len(frames)  # one hand-off a batch, 7 buffers a record
    assert max(held) == 2  # two batches at most: written, being written or queued
    assert path.read_bytes() == ref.encode_video(list(frames), frame_hz=250.0)
    assert not [t for t in threading.enumerate() if t.name == "dbde-sink"]


@pytest.mark.parametrize("pipeline", [1, 2])
def test_sink_failure_is_raised_and_nothing_later_is_written(pipeline_frames, pipeline_jax_file,
                                                             tmp_path, monkeypatch, pipeline):
    """The second writev raises on the sink thread: write() or close()
    raises it, the file holds the header and the first batch's records
    alone, and the sink thread has ended."""
    from dbde_tpu_torch import stream

    writev = stream._writev_all
    calls = []

    def failing(fd, iov):
        calls.append(len(iov))
        if len(calls) == 2:
            raise OSError(28, "No space left on device")
        return writev(fd, iov)

    monkeypatch.setattr(stream, "_writev_all", failing)
    path = tmp_path / "fail.dbde"
    wr = DbdeWriter(str(path), PH, PW, frame_hz=250.0, device="cpu", pipeline=pipeline)
    thread = wr._sink._thread

    def write():
        for _ in range(4):  # the first batches again: later writes find the failure
            for i in range(0, len(pipeline_frames), 2):
                wr.write(pipeline_frames[i : i + 2])

    with pytest.raises(OSError, match="No space left"):
        _within(write)
    _within(wr.close)  # raised once already: close closes quietly
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert calls == [14, 14]  # nothing handed to writev after the failure
    assert path.read_bytes() == ref.encode_video(list(pipeline_frames[:2]), frame_hz=250.0)


def test_sink_failure_in_close_is_raised_by_close(pipeline_frames, pipeline_jax_file, tmp_path,
                                                  monkeypatch):
    """A failure no write() saw is raised by close(), which still ends the
    sink thread and closes the file."""
    from dbde_tpu_torch import stream

    def failing(fd, iov):
        raise OSError(5, "Input/output error")

    monkeypatch.setattr(stream, "_writev_all", failing)
    path = tmp_path / "fail.dbde"
    wr = DbdeWriter(str(path), PH, PW, frame_hz=250.0, device="cpu", pipeline=2)
    thread = wr._sink._thread
    _within(lambda: wr.write(pipeline_frames[:2]))  # nothing drained yet
    with pytest.raises(OSError, match="Input/output"):
        _within(wr.close)
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert wr._f is None
    assert path.read_bytes() == pipeline_jax_file[:VIDEO_HEADER_BYTES]


def test_sink_calls_the_writev_set_after_the_writer_opened(pipeline_frames, pipeline_jax_file,
                                                          tmp_path, monkeypatch):
    """A wrapper set on ``stream._writev_all`` after the writer opened (as
    the benchmark's traced run times it) is what the sink thread calls, on
    the sink thread, once a batch."""
    from dbde_tpu_torch import stream

    path = tmp_path / "wrapped.dbde"
    wr = DbdeWriter(str(path), PH, PW, frame_hz=250.0, device="cpu", pipeline=2)
    writev = stream._writev_all
    threads = []

    def wrapped(fd, iov):
        threads.append(threading.current_thread().name)
        return writev(fd, iov)

    monkeypatch.setattr(stream, "_writev_all", wrapped)

    def write():
        with wr:
            for i in range(0, len(pipeline_frames), 2):
                wr.write(pipeline_frames[i : i + 2])

    _within(write)
    assert threads == ["dbde-sink"] * 3
    assert path.read_bytes() == pipeline_jax_file


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_reader_yielded_arrays_are_the_callers(pipeline_frames, pipeline_jax_file, tmp_path,
                                               pipeline):
    """Every yielded array, all kept until the end, still holds its frames:
    none aliases a pooled slot or buffer that a later batch overwrites."""
    path = tmp_path / "p.dbde"
    path.write_bytes(pipeline_jax_file)
    with DbdeReader(str(path), batch_size=2, device="cpu", pipeline=pipeline) as rd:
        kept = [out for _, out in rd]
    assert len(kept) == 3
    np.testing.assert_array_equal(np.concatenate(kept), pipeline_frames)


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_pool_slot_released_only_after_its_materialize(pipeline_frames, pipeline_jax_file,
                                                       tmp_path, monkeypatch, pipeline):
    """The release gate: a pooled parse slot goes back to the pool only
    after the batch decoded from it is materialized, and is never handed
    out again before; ``pipeline`` batches are dispatched ahead."""
    from dbde_tpu_torch import stream
    from dbde_tpu_torch.codec import DbdeCodec

    events, slot_of = [], {}
    dispatch, materialize = DbdeCodec.decode_dispatch, DbdeCodec.materialize
    acquire, release = stream._GatedPool.acquire, stream._GatedPool.release

    def spy_dispatch(self, depths, mins, payload):
        pending = dispatch(self, depths, mins, payload)
        slot_of[id(pending)] = id(depths)
        events.append(("dispatch", id(depths)))
        return pending

    def spy_materialize(self, pending, after=None):
        events.append(("materialize", slot_of[id(pending)]))
        return materialize(self, pending, after=after)

    def spy_acquire(self, key):
        slot = acquire(self, key)
        if slot is not None:
            events.append(("reuse", id(slot[0])))
        return slot

    def spy_release(self, key, slot):
        events.append(("release", id(slot[0])))
        release(self, key, slot)

    monkeypatch.setattr(DbdeCodec, "decode_dispatch", spy_dispatch)
    monkeypatch.setattr(DbdeCodec, "materialize", spy_materialize)
    monkeypatch.setattr(stream._GatedPool, "acquire", spy_acquire)
    monkeypatch.setattr(stream._GatedPool, "release", spy_release)
    path = tmp_path / "p.dbde"  # the records three times: nine batches, so slots are reused
    path.write_bytes(pipeline_jax_file + pipeline_jax_file[VIDEO_HEADER_BYTES:] * 2)
    frames = np.concatenate([pipeline_frames] * 3)
    with DbdeReader(str(path), batch_size=2, device="cpu", pipeline=pipeline) as rd:
        _, out = rd.read_all()
    np.testing.assert_array_equal(out, frames)
    in_use, done, ahead = set(), set(), 0
    for kind, slot in events:
        if kind == "dispatch":
            assert slot not in in_use
            in_use.add(slot)
            ahead = max(ahead, len(in_use))
        elif kind == "materialize":
            done.add(slot)
        elif kind == "release":
            assert slot in done, "a slot was released before its batch was materialized"
            in_use.discard(slot)
            done.discard(slot)
        else:  # reuse
            assert slot not in in_use, "a slot in flight was handed out again"
    assert [k for k, _ in events].count("reuse") > 0
    assert ahead == pipeline + 1  # the batch being materialized and `pipeline` ahead


class EventLog:
    """Stand-ins for ``codec.record_event`` and ``codec.HostCopy`` that log,
    in one list, each event recorded (a token, on the CPU too) and each
    copy back with the event it was told to wait for, and return what the
    real ones return on the CPU."""

    def __init__(self):
        self.log = []
        log = self.log

        class Copy:
            def __init__(self, tensors, stream=None, after=None):
                self.tensors = list(tensors)
                log.append(("copy", id(self.tensors[0]), after))

            def wait(self):
                log.append(("waited", id(self.tensors[0])))
                return [t.numpy() for t in self.tensors]

            keep = wait

        self.Copy = Copy

    def record_event(self, device):
        token = ("event", sum(1 for entry in self.log if entry[0] == "record"))
        self.log.append(("record", token))
        return token


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_reader_copy_waits_for_its_own_dispatch_event(pipeline_frames, pipeline_jax_file,
                                                     tmp_path, monkeypatch, pipeline):
    """Each batch's copy back waits for the event recorded right after its
    own dispatch (so it is right on whatever stream the caller has current
    at that ``next()``), and its slot is released only after that copy is
    waited for."""
    from dbde_tpu_torch import codec, stream

    events = EventLog()
    dispatch, release = codec.DbdeCodec.decode_dispatch, stream._GatedPool.release

    def spy_dispatch(self, depths, mins, payload):
        pending = dispatch(self, depths, mins, payload)
        events.log.append(("dispatch", id(pending), id(depths)))
        spy_dispatch.kept.append(pending)  # ids stay unique while the test runs
        return pending

    def spy_release(self, key, slot):
        events.log.append(("release", id(slot[0])))
        release(self, key, slot)

    spy_dispatch.kept = []
    monkeypatch.setattr(stream, "record_event", events.record_event)
    monkeypatch.setattr(codec, "HostCopy", events.Copy)
    monkeypatch.setattr(codec.DbdeCodec, "decode_dispatch", spy_dispatch)
    monkeypatch.setattr(stream._GatedPool, "release", spy_release)
    path = tmp_path / "p.dbde"
    path.write_bytes(pipeline_jax_file + pipeline_jax_file[VIDEO_HEADER_BYTES:])
    with DbdeReader(str(path), batch_size=2, device="cpu", pipeline=pipeline) as rd:
        _, out = rd.read_all()
    np.testing.assert_array_equal(out, np.concatenate([pipeline_frames] * 2))
    log = events.log
    event_of, slot_of, waited = {}, {}, set()
    for i, entry in enumerate(log):
        if entry[0] == "dispatch":
            assert log[i + 1][0] == "record", "no event recorded right after a dispatch"
            event_of[entry[1]], slot_of[entry[1]] = log[i + 1][1], entry[2]
        elif entry[0] == "copy":
            assert entry[2] == event_of[entry[1]], "a copy back waits for another batch's event"
        elif entry[0] == "waited":
            waited.add(slot_of[entry[1]])
        elif entry[0] == "release":
            assert entry[1] in waited, "a slot was released before its copy back was waited for"
    copies = [entry for entry in log if entry[0] == "copy"]
    assert len(copies) == len(event_of) == 6
