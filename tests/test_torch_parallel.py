"""The port's sharded path on meshes of CPU devices (the plain versions run
in every shard), against the numpy oracle, the port's single-device
writer and the JAX package's sharded arrays; tolerance 0 throughout (the
codec is integer-valued).  The cases mirror tests/test_parallel.py."""

import struct
import threading
import time

import numpy as np
import pytest
import torch

from dbde_tpu import ref_numpy as ref
from dbde_tpu.parallel import encode_sharded as jax_encode_sharded
from dbde_tpu.parallel import make_mesh as jax_make_mesh
from dbde_tpu.parallel import sharding as jax_sharding
from dbde_tpu_torch import stream, write_video
from dbde_tpu_torch.bench_core import make_content
from dbde_tpu_torch.format import VIDEO_HEADER_BYTES
from dbde_tpu_torch.graft_entry import dryrun_multichip
from dbde_tpu_torch.ops import band
from dbde_tpu_torch.parallel import sharding
from dbde_tpu_torch.parallel import (
    assemble_payload_host,
    assemble_payload_padded,
    decode_sharded,
    encode_sharded,
    iter_video_sharded,
    make_mesh,
    mesh_slots,
    read_video_sharded,
    segment_slot_words,
    sharded_roundtrip_step,
    split_payload_host,
    visible_devices,
    write_video_sharded,
)

CPU8 = [torch.device("cpu")] * 8


def _mesh(n_data, n_tiles):
    return make_mesh(n_data=n_data, n_tiles=n_tiles, devices=CPU8)


def _frames(B=4, H=48, W=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, size=(B, H, W)) + 50).astype(np.uint8)


def _oracle_n64(frame) -> int:
    T = int(np.prod([-(-n // 8) for n in frame.shape]))
    return struct.unpack_from("<i", ref.pack_image(frame), 8 + 2 * T)[0]


def test_mesh_construction():
    mesh = _mesh(4, 2)
    assert mesh.shape == {"data": 4, "tiles": 2}
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)  # one device, 8 slots
    mesh = make_mesh(n_tiles=2, devices=CPU8)
    assert mesh.shape["data"] == 4 and mesh.shape["tiles"] == 2
    with pytest.raises(ValueError):
        make_mesh(n_data=5, n_tiles=2, devices=CPU8)


def test_make_mesh_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visible_devices()


CARDS = [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("n, devices, want", [
    (4, CARDS, CARDS),  # one slot a card
    (8, CARDS, CARDS * 2),  # repeats, in turn
    (6, CARDS, CARDS + CARDS[:2]),
    (2, CARDS, CARDS[:2]),  # fewer slots than cards: the first cards
    (3, CARDS[:2], [CARDS[0], CARDS[1], CARDS[0]]),
    (1, CARDS[:1], CARDS[:1]),
], ids=["4 over 4", "8 over 4", "6 over 4", "2 over 4", "3 over 2", "1 over 1"])
def test_mesh_slots_lay_slots_over_the_cards_in_turn(n, devices, want):
    assert mesh_slots(n, devices) == want


@pytest.mark.parametrize("device", [torch.device("cpu"), torch.device("cuda", 0),
                                    torch.device("cuda", 3)])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_mesh_slots_one_device_fills_every_slot(device, n):
    """One visible device gives exactly ``[device] * n``: the meshes every
    run on one card has used."""
    assert mesh_slots(n, [device]) == [device] * n


def test_visible_devices_are_the_cpu_or_every_card(monkeypatch):
    """The CPU's mesh is laid over the CPU alone; a CUDA one over every
    visible card, in order, whichever card is current."""
    assert visible_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert visible_devices() == visible_devices("cuda:3") == CARDS


@pytest.mark.parametrize("n_data,n_tiles", [(2, 1), (1, 2), (4, 2), (2, 3)])
def test_sharded_encode_matches_oracle(n_data, n_tiles):
    frames = _frames(B=n_data * 2, H=8 * 6, W=21)  # h=6 divides 1, 2, 3
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, _mesh(n_data, n_tiles))
    assert Hp == 48 and payload.shape == (frames.shape[0], n_tiles * segment_slot_words(21, 48, n_tiles))
    payloads = assemble_payload_host(payload, totals)
    T = 6 * 3
    for b in range(frames.shape[0]):
        expected = ref.pack_image(frames[b])
        np.testing.assert_array_equal(depth[b], np.frombuffer(expected, np.uint8, T, 4))
        np.testing.assert_array_equal(mn[b], np.frombuffer(expected, np.uint8, T, 8 + T))
        np.testing.assert_array_equal(payloads[b], np.frombuffer(expected, np.uint32, offset=12 + 2 * T))


def test_sharded_encode_rejects_uneven_bands_and_other_backends():
    mesh = _mesh(2, 4)
    with pytest.raises(ValueError, match="divide evenly"):
        encode_sharded(_frames(B=2, H=8 * 6, W=16), mesh)  # 6 tile rows % 4 != 0
    frames = _frames(B=2, H=32, W=16)
    with pytest.raises(ValueError, match="CPU devices"):
        encode_sharded(frames, mesh, backend="xla")
    with pytest.raises(ValueError, match="unknown"):
        encode_sharded(frames, mesh, backend="tiles")
    with pytest.raises(ValueError, match="data shards"):
        encode_sharded(frames[:1], mesh)


@pytest.mark.parametrize("n_data,n_tiles", [(2, 2), (1, 4)])
def test_sharded_decode_roundtrip(n_data, n_tiles):
    mesh = _mesh(n_data, n_tiles)
    frames = _frames(B=n_data * 3, H=8 * 4, W=30, seed=3)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    np.testing.assert_array_equal(decode_sharded(depth, mn, payload, mesh, H=32, W=30, Hp=Hp),
                                  frames)


def test_sharded_roundtrip_step_ragged():
    """Ragged H is edge-padded to whole bands (37 → 48 rows, 3 tile rows a
    band); n64 is the global sum over the padded frames."""
    frames = _frames(B=4, H=37, W=29, seed=9)
    out, n64 = sharded_roundtrip_step(frames, _mesh(2, 2))
    np.testing.assert_array_equal(out, frames)
    padded = np.concatenate([frames, np.repeat(frames[:, -1:], 11, axis=1)], axis=1)
    assert n64 == sum(_oracle_n64(f) for f in padded) > 0


def test_sharded_totals_and_bases():
    frames = _frames(B=2, H=32, W=32, seed=4)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, _mesh(1, 2))
    assert totals.dtype == bases.dtype == np.int32 and totals.shape == (2, 2)
    for b in range(2):
        assert int(totals[:, b].sum()) == 2 * _oracle_n64(frames[b])
        np.testing.assert_array_equal(bases[:, b], [0, totals[0, b]])  # exclusive scan


def test_split_payload_inverse_of_assemble():
    mesh = _mesh(2, 2)
    frames = _frames(B=4, H=32, W=30, seed=7)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    pays = assemble_payload_host(payload, totals)
    flat = np.zeros((4, max(p.size for p in pays)), np.uint32)
    for b, p in enumerate(pays):
        flat[b, : p.size] = p
    segs = split_payload_host(flat, depth, 32, 30, 2)
    assert segs.shape == payload.shape
    again = split_payload_host(flat, depth, 32, 30, 2, out=segs)  # a reused buffer
    assert again is segs
    dev, sp = payload.reshape(4, 2, -1), segs.reshape(4, 2, -1)
    for b in range(4):
        for s in range(2):
            np.testing.assert_array_equal(sp[b, s, : totals[s, b]], dev[b, s, : totals[s, b]])
    np.testing.assert_array_equal(decode_sharded(depth, mn, segs, mesh, H=32, W=30, Hp=Hp), frames)


def test_assemble_payload_padded_matches_ragged():
    frames = _frames(B=4, H=32, W=30, seed=5)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, _mesh(2, 2))
    segments = payload.reshape(4, 2, -1)
    buf = np.full((6, 16 * 4 * 4), 7, np.uint32)  # wider and taller than needed
    for out in (None, buf):
        pay, n64 = assemble_payload_padded(payload, totals, out=out)
        assert out is None or np.shares_memory(pay, buf)
        for b in range(4):
            expected = np.concatenate([segments[b, s, : totals[s, b]] for s in range(2)])
            assert 2 * int(n64[b]) == expected.size
            np.testing.assert_array_equal(pay[b, : expected.size], expected)


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_glue_legs_match_jax_package(n_tiles):
    """Each shard's live words from split_payload_host, and the assembled
    streams, equal the JAX package's (tolerance 0; numpy functions, no
    compile) on depths with camera statistics and a random payload, as
    tools/probe_sharded_io.py makes them, 4 tile rows of 5 tiles."""
    W, H, B = 40, 32, 4
    rng = np.random.default_rng(0)
    depths = np.minimum(rng.poisson(2.2, (B, 4 * 5)), 5).astype(np.uint8)
    words = 2 * depths.astype(np.int64).sum(1)
    payload = rng.integers(0, 1 << 32, (B, int(words.max())), dtype=np.uint32)
    counts = 2 * depths.reshape(B, n_tiles, -1).astype(np.int64).sum(-1)
    ours = split_payload_host(payload, depths, H, W, n_tiles)
    theirs = jax_sharding.split_payload_host(payload, depths, H, W, n_tiles, backend="band")
    o, t = ours.reshape(B, n_tiles, -1), theirs.reshape(B, n_tiles, -1)
    for b in range(B):
        for s in range(n_tiles):
            np.testing.assert_array_equal(o[b, s, :counts[b, s]], t[b, s, :counts[b, s]])
    pay, n64 = assemble_payload_padded(ours, counts.T)
    jpay, jn64 = jax_sharding.assemble_payload_padded(theirs, counts.T)
    np.testing.assert_array_equal(n64, jn64)
    for b in range(B):
        np.testing.assert_array_equal(pay[b, : 2 * n64[b]], jpay[b, : 2 * jn64[b]])
        np.testing.assert_array_equal(pay[b, : 2 * n64[b]], payload[b, : 2 * n64[b]])


def test_decode_tolerates_garbage_segment_tails():
    """Slot words past each shard's live count never reach the output, at
    the encoder's stride and at a wider one."""
    mesh = _mesh(2, 2)
    frames = _frames(B=4, H=32, W=30, seed=13)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    S = payload.shape[1] // 2
    for stride in (S, S + 5):
        segs = np.full((4, 2, stride), 0xDEADBEEF, np.uint32)
        for b in range(4):
            for s in range(2):
                segs[b, s, : totals[s, b]] = payload[b, s * S : s * S + totals[s, b]]
        out = decode_sharded(depth, mn, segs.reshape(4, -1), mesh, H=32, W=30, Hp=Hp)
        np.testing.assert_array_equal(out, frames)


def test_depth8_band_beside_camera_band(monkeypatch):
    """A frame whose top band is random (every tile depth 8) and bottom band
    depth-5 content: one shard takes the uniform pair, the other the general
    pair, and the stream is still the oracle's."""
    calls = []  # the wrapper calls that do the work: a gated call whose flag
    # selects the other kernel of its pair writes nothing
    for name in ("encode_payload", "encode_payload_u8", "decode_frames", "decode_frames_u8"):
        fn = getattr(band, name)
        general = name in ("encode_payload", "decode_frames")

        def counted(*a, _fn=fn, _n=name, _general=general, **k):
            if band._runs(k.get("mixed"), _general):
                calls.append(_n)
            return _fn(*a, **k)

        monkeypatch.setattr(band, name, counted)
    frames = np.concatenate([make_content(40, 16, 2, kind="random"), _frames(2, 16, 40)], axis=1)
    mesh = _mesh(1, 2)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    assert sorted(calls) == ["encode_payload", "encode_payload_u8"]
    for b in range(2):
        expected = ref.pack_image(frames[b])
        assert (depth[b, :10] == 8).all() and (depth[b, 10:] < 8).all()
        assert assemble_payload_host(payload, totals)[b].tobytes() == expected[12 + 2 * 20:]
    calls.clear()
    np.testing.assert_array_equal(decode_sharded(depth, mn, payload, mesh, H=32, W=40, Hp=Hp), frames)
    assert sorted(calls) == ["decode_frames", "decode_frames_u8"]


def test_iter_video_sharded_bounded_walker(tmp_path):
    """Batch-sized chunks (4 + 3: the tail fills the data axis with a zero
    record), equal to read_video_sharded's frames."""
    mesh = _mesh(2, 2)
    frames = _frames(B=7, H=32, W=24, seed=23)
    p = tmp_path / "w.dbde"
    write_video_sharded(p, frames, mesh, frame_hz=2.0, batch_size=4)
    sizes, seen = [], []
    for headers, chunk in iter_video_sharded(p, mesh, batch_size=4):
        assert chunk.shape[0] == len(headers)
        sizes.append(chunk.shape[0])
        seen.append(chunk)
    assert sizes == [4, 3]
    np.testing.assert_array_equal(np.concatenate(seen), frames)
    vh, headers, out = read_video_sharded(p, mesh, batch_size=4)
    np.testing.assert_array_equal(out, frames)
    assert [h.index for h in headers] == list(range(7))


def test_sharded_write_and_walk_each_build_one_codec_grid(tmp_path, monkeypatch):
    """Three batches each way on a 2x2 mesh: the writer and the walker each
    build one codec a shard, once a call, not once a batch."""
    built = []

    class Counted(sharding.DbdeCodec):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(sharding, "DbdeCodec", Counted)
    mesh = _mesh(2, 2)
    frames = _frames(B=12, H=32, W=24, seed=29)
    p = tmp_path / "w.dbde"
    write_video_sharded(p, frames, mesh, batch_size=4)
    assert p.read_bytes() == ref.encode_video(list(frames), frame_hz=1.0)
    assert [(c.height, c.width) for c in built] == [(16, 24)] * 4
    built.clear()
    chunks = [chunk for _, chunk in iter_video_sharded(p, mesh, batch_size=4)]
    assert len(chunks) == 3 and len(built) == 4
    np.testing.assert_array_equal(np.concatenate(chunks), frames)


def test_read_video_sharded_opens_the_file_once(tmp_path, monkeypatch):
    """read_video_sharded takes the video header from its walk's reader."""
    mesh = _mesh(2, 1)
    frames = _frames(B=3, H=16, W=24, seed=37)
    p = tmp_path / "w.dbde"
    write_video(p, frames, frame_hz=3.0, device="cpu", batch_size=2)
    opened = []
    init = sharding.DbdeReader.__init__

    def counted(self, *args, **kwargs):
        opened.append(args[0])
        init(self, *args, **kwargs)

    monkeypatch.setattr(sharding.DbdeReader, "__init__", counted)
    vh, headers, out = read_video_sharded(p, mesh, batch_size=2)
    assert opened == [p]
    assert (vh.height, vh.width, vh.frame_hz, len(headers)) == (16, 24, 3.0, 3)
    np.testing.assert_array_equal(out, frames)


@pytest.mark.parametrize("n_data,n_tiles,H,W,kind", [
    pytest.param(2, 2, 32, 24, "camera", id="2-2"),
    pytest.param(3, 1, 32, 24, "camera", id="3-1"),
    pytest.param(1, 1, 32, 24, "camera", id="1-1"),
    pytest.param(1, 4, 27, 21, "camera", id="1-4-ragged"),  # H padded, W off the 8-grid
    pytest.param(4, 2, 30, 21, "camera", id="4-2-ragged"),
    pytest.param(2, 2, 32, 24, "random", id="2-2-depth8"),  # every tile depth 8: K4
])
def test_sharded_file_write_and_read(tmp_path, n_data, n_tiles, H, W, kind):
    """A tail batch that does not fill the data axis: the file is the
    oracle's and the port's single-device writer's, byte for byte."""
    mesh = _mesh(n_data, n_tiles)
    frames = _frames(B=5, H=H, W=W, seed=21) if kind == "camera" else make_content(W, H, 5, kind)
    p, single = tmp_path / "s.dbde", tmp_path / "single.dbde"
    write_video_sharded(p, frames, mesh, frame_hz=7.0, batch_size=4)
    write_video(single, frames, frame_hz=7.0, device="cpu", batch_size=4)
    assert p.read_bytes() == ref.encode_video(list(frames), frame_hz=7.0) == single.read_bytes()
    vh, headers, out = read_video_sharded(p, mesh, batch_size=4)
    assert vh.frame_hz == 7.0
    assert [h.index for h in headers] == list(range(5))
    np.testing.assert_array_equal(out, frames)


def test_sharded_records_are_written_from_the_shards_copies(tmp_path, monkeypatch):
    """write_video_sharded hands writev each frame's depths, minima and
    payload pieces straight from the shards' copies back (_copy_fields),
    7 + 3*(n_tiles - 1) buffers a frame, and assembles no payload; the
    file is still the oracle's."""
    mesh = _mesh(2, 2)
    frames = _frames(B=5, H=32, W=24, seed=43)
    copied, written = [], []
    copy_fields, writev_all = sharding._copy_fields, stream._writev_all

    def spy_copy_fields(*args):
        shards = copy_fields(*args)
        copied.extend(a for row in shards for shard in row for a in shard)
        return shards

    def spy_writev_all(fd, iov):
        written.append(list(iov))
        return writev_all(fd, iov)

    def no_assembly(*args, **kwargs):
        raise AssertionError("the writer assembled a payload matrix")

    monkeypatch.setattr(sharding, "_copy_fields", spy_copy_fields)
    monkeypatch.setattr(stream, "_writev_all", spy_writev_all)  # called by the sink thread
    monkeypatch.setattr(sharding, "assemble_payload_padded", no_assembly)
    p = tmp_path / "s.dbde"
    write_video_sharded(p, frames, mesh, frame_hz=7.0, batch_size=4)
    assert p.read_bytes() == ref.encode_video(list(frames), frame_hz=7.0)
    assert [len(iov) for iov in written] == [4 * 10, 1 * 10]  # the tail's padded frame is dropped
    for iov in written:
        for k, piece in enumerate(iov):
            if k % 10 in (0, 1, 4, 7):  # the header and the three length words
                assert isinstance(piece, bytes)
            else:
                assert any(np.shares_memory(np.asarray(piece), a) for a in copied), k


def _sink_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "dbde-sink" and t.is_alive()]


def _on_a_thread(fn, seconds: float = 60.0):
    """``fn()`` on a thread of its own, joined with a timeout, so that a
    hung sink thread fails the test instead of hanging the suite; raises
    what it raised."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=seconds)
    assert not worker.is_alive(), "write_video_sharded did not return"
    if "error" in out:
        raise out["error"]


def test_sharded_write_overlaps_a_slow_sink(tmp_path, monkeypatch):
    """A sink slower than the caller: batches queue behind the write, the
    next batch is encoded while one is being written, at most two batches
    are held, every write runs on the sink thread, and the file is still
    write_video's byte for byte."""
    mesh = _mesh(2, 2)
    frames = _frames(B=20, H=32, W=24, seed=47)  # five batches of 4
    writev, encode_shards, sink_class = stream._writev_all, sharding._encode_shards, sharding._Sink
    writing, threads, overlapped, held, sinks = [], [], [], [], []

    def slow(fd, iov):
        threads.append(threading.current_thread().name)
        writing.append(True)
        time.sleep(0.05)  # before the write: the caller runs ahead
        try:
            return writev(fd, iov)
        finally:
            writing.pop()

    def spy_encode(*args):
        overlapped.append(bool(writing))
        held.extend(len(sink._held) for sink in sinks)
        return encode_shards(*args)

    class Sink(sink_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            sinks.append(self)

    p, single = tmp_path / "s.dbde", tmp_path / "single.dbde"
    write_video(single, frames, frame_hz=7.0, device="cpu", batch_size=4)
    monkeypatch.setattr(stream, "_writev_all", slow)
    monkeypatch.setattr(sharding, "_encode_shards", spy_encode)
    monkeypatch.setattr(sharding, "_Sink", Sink)
    _on_a_thread(lambda: write_video_sharded(p, frames, mesh, frame_hz=7.0, batch_size=4))
    assert p.read_bytes() == single.read_bytes() == ref.encode_video(list(frames), frame_hz=7.0)
    assert threads == ["dbde-sink"] * 5
    assert any(overlapped)  # a batch encoded while an earlier one was being written
    assert max(held) == 2  # two batches at most: being written and queued
    assert not _sink_threads()


def test_sharded_write_raises_a_failed_writev(tmp_path, monkeypatch):
    """The second batch's writev raises on the sink thread: the call raises
    it, nothing later is written, the file holds the header and the first
    batch's records, and the sink thread has ended."""
    mesh = _mesh(2, 2)
    frames = _frames(B=16, H=32, W=24, seed=53)  # four batches of 4
    writev = stream._writev_all
    calls = []

    def failing(fd, iov):
        calls.append(len(iov))
        if len(calls) == 2:
            raise OSError(28, "No space left on device")
        return writev(fd, iov)

    monkeypatch.setattr(stream, "_writev_all", failing)
    p = tmp_path / "s.dbde"
    with pytest.raises(OSError, match="No space left"):
        _on_a_thread(lambda: write_video_sharded(p, frames, mesh, frame_hz=7.0, batch_size=4))
    assert calls == [40, 40]  # nothing handed to writev after the failure
    assert p.read_bytes() == ref.encode_video(list(frames[:4]), frame_hz=7.0)
    assert not _sink_threads()


@pytest.mark.parametrize("sink", ["writing", "failed"])
def test_sharded_write_raises_the_callers_error(tmp_path, monkeypatch, sink):
    """The second batch's encode raises while the first batch is with the
    sink, which is still writing it or whose write failed: the call raises
    the encode's error, not the sink's, once the sink thread has ended; a
    sink still writing finishes the first batch."""
    mesh = _mesh(2, 2)
    frames = _frames(B=12, H=32, W=24, seed=59)  # three batches of 4
    writev, encode_shards = stream._writev_all, sharding._encode_shards
    encodes = []

    def slow_or_failing(fd, iov):
        time.sleep(0.05)
        if sink == "failed":
            raise OSError(5, "Input/output error")
        return writev(fd, iov)

    def failing_encode(*args):
        encodes.append(1)
        if len(encodes) == 2:
            raise RuntimeError("encode failed")
        return encode_shards(*args)

    monkeypatch.setattr(stream, "_writev_all", slow_or_failing)
    monkeypatch.setattr(sharding, "_encode_shards", failing_encode)
    p = tmp_path / "s.dbde"
    with pytest.raises(RuntimeError, match="encode failed"):
        _on_a_thread(lambda: write_video_sharded(p, frames, mesh, frame_hz=7.0, batch_size=4))
    assert not _sink_threads()
    file = ref.encode_video(list(frames[:4]), frame_hz=7.0)
    assert p.read_bytes() == (file if sink == "writing" else file[:VIDEO_HEADER_BYTES])


def test_dryrun_multichip_on_cpu(capsys):
    dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip ok: mesh=(2x2)" in capsys.readouterr().out


def test_sharded_arrays_match_jax_package():
    """On a 2x2 mesh at 4x32x30, and on the JAX package's multichip mesh,
    4x2 at 8x32x1024 (MULTICHIP_r05.json's), the port's sharded arrays
    equal the JAX package's backend="xla" ones on the virtual CPU mesh, and
    the JAX segments, at their own stride, decode exactly in the port."""
    import jax

    for (n_data, n_tiles), (B, H, W) in (((2, 2), (4, 32, 30)), ((4, 2), (8, 32, 1024))):
        frames = _frames(B=B, H=H, W=W, seed=31)
        jmesh = jax_make_mesh(n_data=n_data, n_tiles=n_tiles,
                              devices=jax.devices("cpu")[: n_data * n_tiles])
        jd, jm, jp, jt, jb, jHp = (np.asarray(a) for a in
                                   jax_encode_sharded(frames, jmesh, backend="xla"))
        mesh = _mesh(n_data, n_tiles)
        depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
        assert Hp == int(jHp)
        for ours, theirs in ((depth, jd), (mn, jm), (totals, jt), (bases, jb)):
            np.testing.assert_array_equal(ours, theirs)
        for ours, theirs in zip(assemble_payload_host(payload, totals),
                                assemble_payload_host(jp, jt)):
            np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(
            decode_sharded(jd, jm, jp, mesh, H=H, W=W, Hp=Hp), frames)


class RecordingCopy:
    """A stand-in for codec.HostCopy that logs when each copy is enqueued
    and when it is waited for, and returns what HostCopy returns."""

    log: list = []

    def __init__(self, tensors, stream=None, after=None):
        self.tensors = list(tensors)
        self.index = sum(1 for event, _ in self.log if event == "enqueue")
        self.log.append(("enqueue", self.index))

    def wait(self):
        self.log.append(("wait", self.index))
        return [t.numpy() for t in self.tensors]


@pytest.mark.parametrize("n_data,n_tiles", [(1, 1), (2, 2), (4, 2), (1, 4)])
def test_encode_sharded_enqueues_every_copy_before_the_first_wait(monkeypatch, n_data, n_tiles):
    """Two rounds: every data row's totals and bases, then every shard's
    depths, minima and live payload; in each round every copy is enqueued
    before the first is waited for.  The arrays are those with HostCopy."""
    frames = _frames(B=2 * n_data, H=32, W=40, seed=41)
    mesh = _mesh(n_data, n_tiles)
    want = encode_sharded(frames, mesh)
    monkeypatch.setattr(RecordingCopy, "log", [])
    monkeypatch.setattr(sharding, "HostCopy", RecordingCopy)
    got = encode_sharded(frames, mesh)
    rows, shards = n_data, n_data * n_tiles
    assert [event for event, _ in RecordingCopy.log] == (
        ["enqueue"] * rows + ["wait"] * rows + ["enqueue"] * shards + ["wait"] * shards)
    assert [i for _, i in RecordingCopy.log] == (
        [*range(rows)] * 2 + [*range(rows, rows + shards)] * 2)
    (depth, mn, payload, totals, bases, Hp), (wd, wm, wp, wt, wb, wHp) = got, want
    for ours, theirs in ((depth, wd), (mn, wm), (totals, wt), (bases, wb)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    assert payload.shape == wp.shape and Hp == wHp
    # slot words past each frame's own total are unspecified
    for ours, theirs in zip(assemble_payload_host(payload, totals), assemble_payload_host(wp, wt)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n_data,n_tiles,pipeline", [(2, 2, 1), (2, 2, 2), (1, 4, 3)])
def test_sharded_copies_wait_for_each_shards_dispatch_event(tmp_path, monkeypatch, n_data,
                                                            n_tiles, pipeline):
    """iter_video_sharded: each shard's copy back waits for the event
    recorded right after its own dispatch, on its own card, and a batch's
    segment buffer is handed out again only after every copy of that batch
    was waited for.  The frames are those without the stand-ins."""
    from dbde_tpu_torch.codec import DbdeCodec

    mesh = _mesh(n_data, n_tiles)
    frames = _frames(B=20, H=32, W=24, seed=29)  # five batches: buffers are reused
    path = tmp_path / "w.dbde"
    write_video_sharded(path, frames, mesh, batch_size=4)
    log, kept = [], []

    class Copy:
        def __init__(self, tensors, stream=None, after=None):
            self.tensor = tensors[0]
            log.append(("copy", id(self.tensor), after))

        def wait(self):
            log.append(("waited", id(self.tensor)))
            return [self.tensor.numpy()]

    def record_event(device):
        token = ("event", len(log), device)
        log.append(("record", token))
        return token

    dispatch, split = DbdeCodec.decode_dispatch, sharding.split_payload_host

    def spy_dispatch(self, depths, mins, payload):
        pending = dispatch(self, depths, mins, payload)
        kept.append(pending)  # ids stay unique while the test runs
        log.append(("dispatch", id(pending), self.device))
        return pending

    def spy_split(*args, out=None, **kwargs):
        segments = split(*args, out=out, **kwargs)
        log.append(("split", id(segments), out is not None))
        kept.append(segments)
        return segments

    monkeypatch.setattr(sharding, "record_event", record_event)
    monkeypatch.setattr(sharding, "HostCopy", Copy)
    monkeypatch.setattr(DbdeCodec, "decode_dispatch", spy_dispatch)
    monkeypatch.setattr(sharding, "split_payload_host", spy_split)
    got = np.concatenate([c for _, c in iter_video_sharded(path, mesh, batch_size=4,
                                                           pipeline=pipeline)])
    np.testing.assert_array_equal(got, frames)
    event_of, batch_of, buffer_of, batches = {}, {}, {}, []
    for i, entry in enumerate(log):
        if entry[0] == "split":
            batches.append(set())
            buffer_of[len(batches) - 1] = entry[1]
            if entry[2]:  # a pooled buffer: every copy of its last batch was waited for
                last = max(b for b, buf in buffer_of.items() if buf == entry[1]
                           and b < len(batches) - 1)
                assert not batches[last], "a segment buffer went back before its copies"
        elif entry[0] == "dispatch":
            token = log[i + 1][1]
            assert log[i + 1][0] == "record" and token[2] == entry[2], \
                "no event recorded on the shard's card right after its dispatch"
            event_of[entry[1]] = token
            batch_of[entry[1]] = len(batches) - 1
            batches[-1].add(entry[1])
        elif entry[0] == "copy":
            assert entry[2] == event_of[entry[1]], "a copy back waits for another shard's event"
        elif entry[0] == "waited":
            batches[batch_of[entry[1]]].discard(entry[1])
    assert len(batches) == 5 and len(event_of) == 5 * n_data * n_tiles
    assert any(entry[0] == "split" and entry[2] for entry in log)  # buffers were reused
