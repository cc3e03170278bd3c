"""The port's utils and bench runners against the JAX package's, on the CPU.

Visualization: the same strings, PGM bytes and arrays as
``dbde_tpu.utils.visualize``.  Runners: ``device="cpu"`` at tiny sizes,
with the JAX runners' result keys; the device timers, which need a GPU,
are replaced by one call of the timed function and fixed times.  Only
``run_host_stream_bench`` runs on both sides, as the JAX one is host-only
(no JAX compile here).  Tolerance
0 throughout: everything compared is integer-valued or text.
"""

import types

import numpy as np
import pytest
import torch

from dbde_tpu import bench_core as jax_bench
from dbde_tpu.utils import visualize as jax_visualize
from dbde_tpu_torch import bench_core, ref_numpy
from dbde_tpu_torch.codec import frame_data_size
from dbde_tpu_torch.utils import profiling
from dbde_tpu_torch.utils import visualize

BOTH = pytest.mark.parametrize("vis", [jax_visualize, visualize], ids=["jax", "port"])


# -- the five cases of tests/test_visualize.py, over both packages ----------


@BOTH
def test_pgm_p2_roundtrip(vis, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23)).astype(np.uint8)
    p = tmp_path / "f.pgm"
    vis.write_pgm(p, img)
    np.testing.assert_array_equal(vis.read_pgm(p), img)


@BOTH
def test_pgm_p5_8bit(vis, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    img[0, 0] = 0x20  # raster starts with a whitespace byte: must not be eaten
    p = tmp_path / "f.pgm"
    p.write_bytes(b"P5\n7 5\n255\n" + img.tobytes())
    np.testing.assert_array_equal(vis.read_pgm(p), img)


@BOTH
def test_pgm_p5_maxval_scaling(vis, tmp_path):
    img = np.array([[0, 7, 15]], np.uint8)
    p = tmp_path / "f.pgm"
    p.write_bytes(b"P5 3 1 15 " + img.tobytes())
    np.testing.assert_array_equal(vis.read_pgm(p), (img.astype(np.int64) * 255 // 15))


@BOTH
def test_pgm_p5_16bit(vis, tmp_path):
    vals = np.array([[0, 1234, 65535]], ">u2")
    p = tmp_path / "f.pgm"
    p.write_bytes(b"P5\n3 1\n65535\n" + vals.tobytes())
    expect = (vals.astype(np.int64) * 255 // 65535).astype(np.uint8)
    np.testing.assert_array_equal(vis.read_pgm(p), expect)


@BOTH
def test_ascii_preview_flat(vis):
    out = vis.ascii_preview(np.full((64, 64), 9, np.uint8))
    assert out and set(out.replace("\n", "")) == {" "}


# -- the port against the JAX package ---------------------------------------


PREVIEWS = [  # (image shape, seed, size, x0, y0)
    ((64, 64), 0, 32, 0, 0),
    ((24, 40), 1, 8, 0, 0),
    ((19, 27), 2, 4, 3, 5),
    ((100, 37), 3, 16, 10, 2),
    ((5, 7), 4, 32, 0, 0),      # smaller than size: one pixel a cell
    ((9, 9), 5, 4, 9, 0),       # empty region
]


@pytest.mark.parametrize("shape, seed, size, x0, y0", PREVIEWS)
def test_ascii_preview_matches_jax(shape, seed, size, x0, y0):
    img = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    assert visualize.ascii_preview(img, size, x0, y0) == \
        jax_visualize.ascii_preview(img, size, x0, y0)


@pytest.mark.parametrize("shape, seed", [((17, 23), 0), ((1, 1), 1), ((8, 300), 2)])
def test_pgm_bytes_and_arrays_match_jax(shape, seed, tmp_path):
    img = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    ours, theirs = tmp_path / "port.pgm", tmp_path / "jax.pgm"
    visualize.write_pgm(ours, img)
    jax_visualize.write_pgm(theirs, img)
    assert ours.read_bytes() == theirs.read_bytes()
    p5 = tmp_path / "f5.pgm"
    p5.write_bytes(f"P5 {shape[1]}\n{shape[0]} 200\n".encode() + img.tobytes())
    for path in (ours, p5):
        np.testing.assert_array_equal(visualize.read_pgm(path), jax_visualize.read_pgm(path))


def test_read_pgm_rejects_what_jax_rejects(tmp_path):
    for data in (b"P6\n1 1\n255\n\x00", b"P5 x"):
        p = tmp_path / "bad.pgm"
        p.write_bytes(data)
        for vis in (visualize, jax_visualize):
            with pytest.raises(ValueError):
                vis.read_pgm(p)


# -- content and sizes -------------------------------------------------------


@pytest.mark.parametrize("W, H, frames, seed", [(40, 24, 3, 0), (27, 18, 2, 1), (64, 64, 1, 7)])
def test_make_uniform8_matches_jax(W, H, frames, seed):
    got = bench_core.make_uniform8(W, H, frames, seed)
    np.testing.assert_array_equal(got, jax_bench.make_uniform8(W, H, frames, seed))
    depths = ref_numpy.tile_depths_mins(ref_numpy.tile_image(got[0]))[0]
    assert (depths == 8).all()


def test_make_uniform8_rejects_single_pixel_edges():
    with pytest.raises(ValueError):
        bench_core.make_uniform8(17, 24, 1)


def test_frame_data_size_is_pack_image_length():
    img = bench_core.make_content(27, 19, 1)[0]
    depths = ref_numpy.tile_depths_mins(ref_numpy.tile_image(img))[0]
    assert frame_data_size(depths, 27, 19) == len(ref_numpy.pack_image(img))


# -- the runners on the CPU --------------------------------------------------

# the JAX runners' literal result keys (dbde_tpu/bench_core.py:202-214,
# 352-379, 401-415, 462-474, 513-525)
JAX_KEYS = {
    "run_bench": {"metric", "value", "unit", "vs_baseline", "encode_gpix_per_s",
                  "encode_vs_baseline", "geometry", "content", "backend",
                  "compression_ratio", "device"},
    "run_stream_bench": {"metric", "value", "unit", "stream_encode_gpix_per_s", "frames",
                         "geometry", "batch_size", "content", "file_bytes",
                         "frame_hz_equiv_decode", "frame_hz_equiv_encode", "note"},
    "run_composed_stream_bench": {"metric", "value", "unit",
                                  "composed_stream_encode_gpix_per_s", "frame_hz_equiv_decode",
                                  "frame_hz_equiv_encode", "legs_ms_per_batch",
                                  "required_link_gb_per_s", "geometry", "batch_size",
                                  "content", "backend", "host_assembler", "note"},
    "run_latency_bench": {"metric", "value", "unit", "encode_latency_ms_per_frame",
                          "decode_hz_equiv", "encode_hz_equiv", "decode_gpix_per_s",
                          "encode_gpix_per_s", "geometry", "content", "backend", "device",
                          "note"},
    "run_host_stream_bench": {"metric", "value", "unit", "frames", "geometry", "batch_size",
                              "content", "file_bytes", "file_gb_per_s", "frame_hz_equiv",
                              "note"},
}

W, H = 40, 24


def _ratio(frames: np.ndarray) -> float:
    return round(sum(len(ref_numpy.pack_image(f)) for f in frames) / frames.size, 4)


@pytest.fixture
def stub_timers(monkeypatch):
    """``_measure`` calls the timed function once and returns 2 ms a call,
    1 ms of it busy; ``card_name`` names a stub card."""
    def measure(fn, device, reps=4):
        fn()
        return 2e-3, 1e-3

    monkeypatch.setattr(bench_core, "_measure", measure)
    monkeypatch.setattr(bench_core, "card_name", lambda index: "stub card, 1.00 W")


@pytest.mark.parametrize("content", ["camera", "random", "flat"])
def test_run_bench_on_cpu(content, stub_timers):
    r = bench_core.run_bench(W, H, frames=3, iters=1, content=content, device="cpu")
    assert set(r) == JAX_KEYS["run_bench"] | {"device_busy_ms"}
    assert r["device"] == "stub card, 1.00 W" and r["backend"] == "band"
    assert r["compression_ratio"] == _ratio(bench_core.make_content(W, H, 3, content))
    assert r["geometry"] == f"3x{H}x{W}"
    assert r["value"] == round(3 * H * W / 2e-3 / 1e9, 3)
    assert r["device_busy_ms"] == {"encode": 1.0, "decode": 1.0}


def test_run_latency_bench_on_cpu(stub_timers):
    r = bench_core.run_latency_bench(W, H, content="random", device="cpu")
    assert set(r) == JAX_KEYS["run_latency_bench"] | {"device_busy_ms"}
    assert r["value"] == 2.0 and r["geometry"] == f"1x{H}x{W}"


def test_run_stream_bench_on_cpu():
    r = bench_core.run_stream_bench(W, H, frames=5, batch_size=2, repeats=1, device="cpu")
    assert set(r) == JAX_KEYS["run_stream_bench"]
    frames = bench_core.make_content(W, H, 5)
    assert r["file_bytes"] == len(ref_numpy.encode_video(frames, frame_hz=1000.0))


def test_run_composed_stream_bench_on_cpu(stub_timers):
    r = bench_core.run_composed_stream_bench(W, H, frames=6, batch_size=2, device="cpu")
    assert set(r) == JAX_KEYS["run_composed_stream_bench"] | {"device_busy_ms"}
    assert set(r["legs_ms_per_batch"]) == {"device_encode", "host_assemble_write",
                                           "host_walk_parse", "device_decode"}
    assert all(v > 0 for v in r["legs_ms_per_batch"].values())


def test_run_host_stream_bench_matches_jax():
    kw = dict(width=W, height=H, frames=7, batch_size=3, repeats=1)
    r = bench_core.run_host_stream_bench(**kw)
    assert set(r) == JAX_KEYS["run_host_stream_bench"]
    assert r["file_bytes"] == jax_bench.run_host_stream_bench(**kw)["file_bytes"]


# -- no GPU: nothing measures --------------------------------------------------


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the errors without one")


@pytest.mark.parametrize("call", [
    lambda: bench_core.run_bench(W, H, frames=1, iters=1),
    lambda: bench_core.run_bench(W, H, frames=1, iters=1, device="cpu"),
    lambda: bench_core.run_latency_bench(W, H),
    lambda: profiling.cuda_event_seconds(lambda: None, reps=1),
    lambda: profiling.measure_device_seconds(lambda: None, reps=1),
    lambda: profiling.card_name(0),
], ids=["run_bench", "run_bench on the CPU", "run_latency_bench", "cuda_event_seconds",
        "measure_device_seconds", "card_name"])
def test_gpu_measures_raise_without_cuda(no_gpu, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("intervals, busy, span", [
    ([("k", 0.0, 10.0)], 10.0, 10.0),
    ([("a", 0.0, 10.0), ("b", 10.0, 12.0)], 12.0, 12.0),  # touching
    ([("a", 0.0, 4.0), ("b", 6.0, 8.0), ("c", 1.0, 7.0)], 8.0, 8.0),  # a bridge
    ([("a", 5.0, 6.0), ("b", 0.0, 1.0), ("c", 9.0, 10.0)], 3.0, 10.0),  # three gaps
])
def test_idle_share_on_synthetic_intervals(intervals, busy, span):
    assert profiling.idle_share(intervals) == (busy, span, 1.0 - busy / span)


@pytest.mark.parametrize("intervals, busy, span", [
    ([("k", 0.0, 10.0)], 10.0, 10.0),
    ([("a", 0.0, 10.0), ("b", 10.0, 12.0)], 12.0, 12.0),
    ([("a", 0.0, 4.0), ("b", 6.0, 8.0), ("c", 1.0, 7.0)], 8.0, 8.0),
    ([("a", 5.0, 6.0), ("b", 0.0, 1.0), ("c", 9.0, 10.0)], 3.0, 10.0),
])
@pytest.mark.parametrize("card", [0, 3])
def test_card_shares_on_one_card_is_idle_share(intervals, busy, span, card):
    """One card's (card, name, start, end) intervals give idle_share's
    (busy, span, idle share) of the same intervals, and its span."""
    tagged = [(card, *iv) for iv in intervals]
    shares, whole = profiling.card_shares(tagged)
    assert shares == {card: profiling.idle_share(intervals)} == {card: profiling.idle_share(tagged)}
    assert whole == span


def test_card_shares_keeps_each_cards_own_time():
    """Four cards, each busy in its own window: each card's busy time,
    span and idle share are its own (the union of all four would merge
    them), and the span on the shared clock runs from the first start to
    the last end."""
    intervals = [
        (0, "K1", 0.0, 4.0), (0, "K2", 3.0, 6.0), (0, "copy", 8.0, 10.0),  # 8 busy of 10
        (1, "K1", 1.0, 3.0), (1, "K2", 5.0, 7.0),  # 4 busy of 6
        (2, "K1", 2.0, 12.0),  # busy throughout
        (3, "copy", 20.0, 21.0), (3, "K3", 20.5, 25.0),  # 5 of 5, last
    ]
    shares, span = profiling.card_shares(intervals)
    assert shares == {0: (8.0, 10.0, 1 - 8 / 10), 1: (4.0, 6.0, 1 - 4 / 6), 2: (10.0, 10.0, 0.0),
                      3: (5.0, 5.0, 0.0)}
    assert span == 25.0
    assert profiling.idle_share(intervals)[0] == 17.0  # what the union of all would report


def test_sync_cards_synchronizes_the_given_cards(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda index: synced.append(index))
    profiling.sync_cards([3, 1])
    assert synced == [3, 1]


class _Stream:
    def __init__(self, card, log):
        self.card, self.log = card, log

    def wait_event(self, event):
        self.log.append(("wait", self.card, event.stream.card))


class _Event:
    def __init__(self, log, enable_timing=False):
        self.log, self.stream = log, None

    def record(self, stream=None):
        self.stream = stream
        self.log.append(("record", None if stream is None else stream.card))

    def synchronize(self):
        self.log.append(("synchronize", self.stream.card))

    def elapsed_time(self, end):
        return 8.0  # ms


@pytest.mark.parametrize("cards, current, home, others", [
    (None, 2, 2, []),  # the current card alone
    ([1], 0, 1, []),  # a card that is not the current one
    ([0, 1, 2, 3], 0, 0, [1, 2, 3]),  # a mesh's cards
])
def test_cuda_event_seconds_times_the_calls_cards(monkeypatch, cards, current, home, others):
    """The events go on the first card's current stream, which waits for
    each other card of the call before the end event; only the call's cards
    are synchronized.  (Events and streams stubbed: they need a GPU.)"""
    log = []
    monkeypatch.setattr(profiling, "_require_cuda", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda card: _Stream(card, log))
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event(log, **kw))
    monkeypatch.setattr(profiling, "sync_cards", lambda cs: log.append(("sync", list(cs))))
    calls = []
    assert profiling.cuda_event_seconds(lambda: calls.append(1), reps=4, warmup=2,
                                        cards=cards) == 2e-3
    assert len(calls) == 6
    assert log == [("sync", cards or [current]), ("record", home),
                   *[x for card in others for x in (("record", card), ("wait", home, card))],
                   ("record", home), ("synchronize", home)]


@pytest.mark.parametrize("sessions_short, want", [(0, True), (2, True), (3, False)])
def test_measure_device_cards_needs_every_card(monkeypatch, sessions_short, want):
    """A session in which a card of the call delivers no device activity
    is run again, up to PROFILE_SESSIONS; each card's busy time and the
    span on the shared clock are per call."""
    import contextlib

    sessions, synced = [], []
    full = [(0, "K1", 0.0, 8.0), (1, "K1", 2.0, 6.0), (1, "K3", 10.0, 14.0)]

    def intervals(prof):
        sessions.append(prof)
        return full[:1] if len(sessions) <= sessions_short else full

    monkeypatch.setattr(profiling, "_require_cuda", lambda: None)
    monkeypatch.setattr(profiling, "sync_cards",
                        lambda cards: synced.append((cards, len(sessions))))
    monkeypatch.setattr(profiling, "profile", lambda activities: contextlib.nullcontext("prof"))
    monkeypatch.setattr(profiling, "device_intervals", intervals)
    calls = []
    if want:
        busy, span = profiling.measure_device_cards(lambda: calls.append(1), [0, 1], reps=2)
        assert busy == {0: 4e-6, 1: 4e-6} and span == 7e-6
    else:
        with pytest.raises(RuntimeError, match=r"no device activity in 3 sessions on card\(s\) "
                                               r"\[0, 1\]"):
            profiling.measure_device_cards(lambda: calls.append(1), [0, 1], reps=2)
    n = min(sessions_short + 1, profiling.PROFILE_SESSIONS)
    assert len(sessions) == n
    assert len(calls) == 1 + 2 * n  # one warm-up call, then reps a session
    # the call's cards, after the warm-up and in each session after its calls
    assert synced == [([0, 1], i) for i in (0, *range(n))]


def test_card_name_finds_the_card_by_uuid(monkeypatch):
    """nvidia-smi lists cards in PCI order; the torch ordinal's card is the
    one with its UUID."""
    uuids = {0: "1111aaaa-0000-0000-0000-000000000001", 1: "2222bbbb-0000-0000-0000-000000000002"}
    listing = (f"GPU-{uuids[1]}, NVIDIA H100 80GB HBM3, 500.00 W\n"
               f"GPU-{uuids[0]}, NVIDIA H100 80GB HBM3, 700.00 W\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=uuids[i]))
    monkeypatch.setattr(profiling.subprocess, "run", lambda argv, **kw: types.SimpleNamespace(
        returncode=0, stdout=listing, stderr=""))
    assert profiling.card_name(0) == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert profiling.card_name(1) == "NVIDIA H100 80GB HBM3, 500.00 W"
    uuids[0] = "3333cccc-0000-0000-0000-000000000003"
    with pytest.raises(RuntimeError, match="no card with UUID"):
        profiling.card_name(0)


@pytest.mark.parametrize("empty, want", [(0, 2e-6), (2, 2e-6), (3, None)])
def test_measure_device_seconds_profiles_again_when_no_device_record_arrives(
        monkeypatch, empty, want):
    """A profiler session that delivers no device activity is run again, up
    to PROFILE_SESSIONS in all; with none delivering any, the measure
    raises.  (Timers stubbed: the sessions themselves need a GPU.)"""
    import contextlib

    sessions = []

    def intervals(prof):
        sessions.append(prof)
        return [] if len(sessions) <= empty else [(0, "k", 0.0, 8.0)]

    monkeypatch.setattr(profiling, "_require_cuda", lambda: None)
    monkeypatch.setattr(profiling, "sync_cards", lambda cards: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(profiling, "profile", lambda activities: contextlib.nullcontext("prof"))
    monkeypatch.setattr(profiling, "device_intervals", intervals)
    if want is None:
        with pytest.raises(RuntimeError, match="no device activity in 3 sessions"):
            profiling.measure_device_seconds(lambda: None, reps=4)
    else:
        assert profiling.measure_device_seconds(lambda: None, reps=4) == want
    assert len(sessions) == min(empty + 1, profiling.PROFILE_SESSIONS)



@pytest.mark.parametrize("cards, busy, synced", [
    (None, 4.0, [0]),  # every card's activity as one union, the current card synced
    ([1], 8.0, [1]),  # a card that is not the current one: its activity alone
    ([0, 1], 10.0, [0, 1]),  # the union over both cards
])
def test_measure_device_seconds_on_the_calls_cards(monkeypatch, cards, busy, synced):
    """With cards named, the busy time is the union of those cards'
    activity, and those cards are synchronized; a session in which a named
    card delivers nothing runs again.  With none named, the union of every
    card's activity in the first session that has any, the current card
    synchronized (the first session here has card 0's alone)."""
    import contextlib

    full = [(0, "K1", 0.0, 4.0), (1, "K1", 2.0, 6.0), (1, "K3", 8.0, 12.0)]
    sessions, syncs = [], []

    def intervals(prof):
        sessions.append(prof)
        return full[:1] if len(sessions) == 1 else full  # card 1 late the first time

    monkeypatch.setattr(profiling, "_require_cuda", lambda: None)
    monkeypatch.setattr(profiling, "sync_cards", lambda cs: syncs.append(list(cs)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(profiling, "profile", lambda activities: contextlib.nullcontext("prof"))
    monkeypatch.setattr(profiling, "device_intervals", intervals)
    assert profiling.measure_device_seconds(lambda: None, reps=2, cards=cards) == busy / 2 / 1e6
    assert len(sessions) == (2 if cards and 1 in cards else 1)
    assert all(s == synced for s in syncs)

# -- python -m dbde_tpu_torch.bench, the counterpart of bench.py ---------------


def _bench_script():
    """The repository's bench.py (the JAX package's bench) as a module, not run."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("jax_bench_script", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_bench_line_has_bench_py_keys(stub_timers):
    """At a tiny geometry on the CPU: the camera config's run_bench result
    at the top level and a ``configs`` object with bench.py's three names,
    each record with the keys of bench.py's own ``_sub``."""
    from dbde_tpu_torch import bench as port_bench

    tiny = tuple((key, dict(kw, width=W, height=H, frames=2, iters=1))
                 for key, kw in port_bench.CONFIGS)
    line = port_bench.run(tiny, device="cpu")
    assert set(line) == JAX_KEYS["run_bench"] | {"device_busy_ms", "configs"}
    assert [key for key, _ in port_bench.CONFIGS] == ["camera_2048", "random_2048",
                                                      "random_2536x2048"]
    assert set(line["configs"]) == {key for key, _ in port_bench.CONFIGS}
    keys = set(_bench_script()._sub(line))
    assert all(set(record) == keys for record in line["configs"].values())
    assert line["content"] == "camera" and line["configs"]["random_2048"]["content"] == "random"
    assert line["configs"]["camera_2048"]["decode_gpix_per_s"] == line["value"]
    assert {kw["width"] for _, kw in port_bench.CONFIGS} == {2048, 2536}


def test_port_bench_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    from dbde_tpu_torch import bench as port_bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.main()


def test_bench_raises_when_the_profiler_delivers_nothing(monkeypatch):
    """A profiler that delivers no device records in any session fails the
    bench leg: no line is printed with a device metric missing."""
    def no_records(fn, reps, cards):
        fn()
        raise RuntimeError("the profiler saw no device activity in 3 sessions")

    monkeypatch.setattr(bench_core, "cuda_event_seconds", lambda fn, reps, cards: (fn(), 2e-3)[1])
    monkeypatch.setattr(bench_core, "measure_device_seconds", no_records)
    with pytest.raises(RuntimeError, match="no device activity"):
        bench_core._measure(lambda: None, torch.device("cuda", 1))
    assert bench_core._busy_ms(encode=1e-3, decode=2.5e-4) == {"encode": 1.0, "decode": 0.25}


def test_run_stream_bench_checks_every_frame(monkeypatch):
    """At a batch size that does not divide the 64 source frames (12 over
    70 frames: a batch wraps past the source stack), the read checks every
    frame, each against src[index % 64]."""
    src = bench_core.make_content(W, H, 64)
    wanted, check = [], bench_core._check_frames

    def spy(out, want, what):
        wanted.append(want)
        check(out, want, what)

    monkeypatch.setattr(bench_core, "_check_frames", spy)
    bench_core.run_stream_bench(W, H, frames=70, batch_size=12, repeats=1, device="cpu")
    assert len(wanted) == 6
    np.testing.assert_array_equal(np.concatenate(wanted), src[np.arange(70) % 64])
