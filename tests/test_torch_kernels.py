"""The CUDA kernels against their plain PyTorch versions on the card, at
small sizes.  Tolerance 0: the codec is integer-valued.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  On the GPU machine, run
this file without the suite's conftest (it pins jax to a CPU mesh for the
JAX tests, which this file does not need):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from dbde_tpu_torch.bench_core import make_adversarial, make_content, make_depth_runs
from dbde_tpu_torch.golden_vectors import GOLDEN_8x16_IMAGE, README_10x10_IMAGE
from dbde_tpu_torch import DbdeReader, DbdeWriter, read_video, write_video
from dbde_tpu_torch.stream import _GatedPool
from dbde_tpu_torch.codec import DbdeCodec, EncodedBatch, pack_frames_bytes
from dbde_tpu_torch.ops import band, tile_layout, word_offsets
from dbde_tpu_torch.parallel import visible_devices
from dbde_tpu_torch.soak import callers_streams, next_switching_streams
from torch.profiler import ProfilerActivity, profile

pytestmark = pytest.mark.requires_cuda

SENTINEL = 0xDEADBEEF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the GPU machine)")
    return torch.device("cuda", 0)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


GEOMETRIES = {
    "golden": lambda: GOLDEN_8x16_IMAGE[None],
    "readme": lambda: README_10x10_IMAGE[None],
    "one pixel": lambda: np.full((2, 1, 1), 9, np.uint8),
    "adversarial ragged": lambda: make_adversarial(43, 21, 2, maxd=8, seed=1),
    "adversarial maxd 5": lambda: make_adversarial(64, 40, 3, maxd=5, seed=2),
    "camera": lambda: make_content(256, 64, 2),
    "random ragged": lambda: make_content(317, 45, 2, kind="random"),
    "depth runs across block seams": lambda: make_depth_runs(40000, 16, 2, seed=3),
    "T mod 1024 = 1": lambda: make_adversarial(8200, 8, 2, seed=4),
    "T mod 1024 = 1023": lambda: make_adversarial(16376, 8, 2, seed=5),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernels_match_plain(cuda, name):
    frames = GEOMETRIES[name]()
    B, H, W = frames.shape
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(cuda)
    d, m = band.encode_depths(x)
    dp, mp = band.encode_depths_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(m, mp)

    _, total = word_offsets(d)
    T = d.shape[1]
    for S in (16 * T + 1, 16 * T):  # rows off and on the 16-byte grid
        fill = np.full((B, S), SENTINEL, np.uint32)
        pk, nk = band.encode_payload(x, d, m, out=torch.from_numpy(fill.copy()).to(cuda))
        pp, np_ = band.encode_payload_plain(x, d, m, out=torch.from_numpy(fill).to(cuda))
        torch.cuda.synchronize()
        got, want = _u32(pk), _u32(pp)
        np.testing.assert_array_equal(got, want)
        assert torch.equal(nk, np_) and torch.equal(nk, total // 2)
        n64 = nk.cpu().numpy()
        for b in range(B):
            assert (got[b, 2 * n64[b]:] == SENTINEL).all()

        out = band.decode_frames(d, m, pk, H, W)
        torch.cuda.synchronize()
        assert torch.equal(out, band.decode_frames_plain(d, m, pk, H, W))
        np.testing.assert_array_equal(out.cpu().numpy(), frames)

    # shortest legal stride, random garbage after each frame's stream
    S = max(2 * int(n64.max()), 1)
    short = np.random.default_rng(0).integers(0, 1 << 32, (B, S), dtype=np.uint32)
    for b in range(B):
        short[b, : 2 * n64[b]] = got[b, : 2 * n64[b]]
    sp = torch.from_numpy(short).to(cuda)
    out = band.decode_frames(d, m, sp, H, W)
    torch.cuda.synchronize()
    assert torch.equal(out, band.decode_frames_plain(d, m, sp, H, W))
    np.testing.assert_array_equal(out.cpu().numpy(), frames)

    # the uniform pair, at any content: 16-byte path (default buffer) and
    # word path (stride 16*T+3, sentinels after each frame's words)
    full = 16 * d.shape[1]
    p4 = band.encode_payload_u8(x, m)
    fill = np.full((B, full + 3), SENTINEL, np.uint32)
    p4s = band.encode_payload_u8(x, m, out=torch.from_numpy(fill.copy()).to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_u32(p4), _u32(band.encode_payload_u8_plain(x, m)))
    got4 = _u32(p4s)
    np.testing.assert_array_equal(
        got4, _u32(band.encode_payload_u8_plain(x, m, out=torch.from_numpy(fill).to(cuda))))
    assert (got4[:, full:] == SENTINEL).all()
    if bool((d == 8).all()):
        np.testing.assert_array_equal(_u32(p4), got)
    for src in (p4, p4s):
        out = band.decode_frames_u8(m, src, H, W)
        torch.cuda.synchronize()
        assert torch.equal(out, band.decode_frames_u8_plain(m, src, H, W))
        np.testing.assert_array_equal(out.cpu().numpy(), frames)


def test_unaligned_frames_take_the_byte_path(cuda):
    """W % 8 == 0 but a base address off the 8-byte grid: no u64 row loads."""
    frames = make_content(64, 16, 2)
    buf = torch.empty(1 + frames.size, dtype=torch.uint8, device=cuda)
    x = buf[1:].view(frames.shape)
    x.copy_(torch.from_numpy(frames))
    d, m = band.encode_depths(x)
    p, _ = band.encode_payload(x, d, m)
    torch.cuda.synchronize()
    assert torch.equal(d, band.encode_depths_plain(x)[0])
    assert torch.equal(band.decode_frames(d, m, p, 16, 64).cpu(), x.cpu())


def test_main_path_launches_every_kernel(cuda, tmp_path):
    """Batches [camera, camera], [camera, random], [random, random]: every
    encode launches K1, K2 and K4 (gated on the card); from the reader's
    host depths the first two decode through K3, the all-depth-8 one
    through K5."""
    frames = np.concatenate([make_content(72, 40, 3), make_content(72, 40, 3, kind="random")])
    band.reset_launches()
    write_video(str(tmp_path / "v.dbde"), frames, device=cuda, batch_size=2)
    _, _, out = read_video(str(tmp_path / "v.dbde"), device=cuda, batch_size=2)
    np.testing.assert_array_equal(out, frames)
    assert band.LAUNCHES == {"encode_depths": 3, "encode_payload": 3, "decode": 2,
                             "encode_payload_u8": 3, "decode_u8": 1,
                             "encode_tiles": 0, "decode_tiles": 0}


def test_band_path_launches_no_cumsum(cuda):
    """The band encode and decode of a mixed batch run K1, K2 and K3 (and K4
    and K5, gated off by the batch flag) and no scan: the profiler (host and
    device activities) sees no cumsum."""
    frames = make_content(72, 40, 3)
    codec = DbdeCodec(40, 72, device=cuda)
    enc = codec.encode(frames)  # warm-up: the library is loaded
    torch.cuda.synchronize()
    band.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        enc = codec.encode(frames)
        out = codec.decode(enc.depths, enc.mins, enc.payload)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(out, frames)
    assert {k: v for k, v in band.LAUNCHES.items() if v} == {
        "encode_depths": 1, "encode_payload": 1, "decode": 1, "encode_payload_u8": 1,
        "decode_u8": 1}
    names = [e.key for e in prof.key_averages()]
    assert any("encode_payload_kernel" in n for n in names), names
    assert not any("cumsum" in n.lower() for n in names), names


def test_launch_leaves_the_current_device(cuda):
    """A launch on the last card selects it only for the launch."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    before = torch.cuda.current_device()
    x = torch.from_numpy(make_content(64, 16, 1, kind="random")).to(last)
    d, m = band.encode_depths(x)
    p = band.encode_payload_u8(x, m)
    assert torch.equal(band.decode_frames_u8(m, p, 16, 64), x)
    assert torch.cuda.current_device() == before


def test_profile_paths_sees_the_kernels(cuda, capsys):
    from dbde_tpu_torch import profile_paths

    assert profile_paths.main(["--iters", "2", "--batch", "2", "--height", "64",
                               "--width", "64"]) == 0
    text = capsys.readouterr().out
    for kernel in ("encode_depths_kernel", "encode_payload_kernel", "decode_kernel",
                   "encode_payload_u8_kernel", "decode_u8_kernel"):
        assert kernel in text
    assert text.count("idle share") == 4
    assert profile_paths.main(["--iters", "2", "--batch", "2", "--height", "16",
                               "--width", "320", "--backend", "tiles"]) == 0
    text = capsys.readouterr().out
    assert "encode_tiles_kernel" in text and "decode_tiles_kernel" in text
    assert text.count("idle share") == 4


def test_wrappers_reject_bad_tensors(cuda):
    x = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        band.encode_depths(x)
    d = torch.zeros((1, 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        band.decode_frames(d, d, torch.zeros((1, 16), dtype=torch.int64, device=cuda), 8, 8)


# and K6's full 64 KB stage: every tile depth 8, 1023 real tiles in the last block
TILES_GEOMETRIES = {**GEOMETRIES, "all depth 8, T mod 1024 = 1023":
                    lambda: make_content(16376, 8, 2, kind="random")}


@pytest.mark.parametrize("name", list(TILES_GEOMETRIES))
def test_tiles_kernels_match_plain(cuda, name):
    """K6 and K7: equal to their plain versions, K6's buffer equal to K2's
    (stream and untouched sentinels), its depths and minima K1's, and K7
    decodes the shortest stride with garbage after each frame's stream."""
    frames = TILES_GEOMETRIES[name]()
    B, H, W = frames.shape
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(cuda)
    d, m = band.encode_depths(x)
    T = d.shape[1]
    _, total = word_offsets(d)
    fill = np.full((B, 16 * T), SENTINEL, np.uint32)
    p2, _ = band.encode_payload(x, d, m, out=torch.from_numpy(fill.copy()).to(cuda))
    tw = tile_layout.image_to_tiles_w(x)
    got = tile_layout.encode_tiles(tw, T, out=torch.from_numpy(fill.copy()).to(cuda))
    want = tile_layout.encode_tiles_plain(tw, T, out=torch.from_numpy(fill).to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    d6, m6, p6, n6 = got
    np.testing.assert_array_equal(_u32(p6), _u32(p2))
    assert torch.equal(d6[:, :T], d) and torch.equal(m6[:, :T], m)
    assert torch.equal(n6, total // 2)

    n64 = n6.cpu().numpy()
    S = max(2 * int(n64.max()), 1)
    short = np.random.default_rng(1).integers(0, 1 << 32, (B, S), dtype=np.uint32)
    for b in range(B):
        short[b, : 2 * n64[b]] = _u32(p6)[b, : 2 * n64[b]]
    for src in (p6, torch.from_numpy(short).to(cuda)):
        out = tile_layout.decode_tiles(d6, m6, src)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(out), _u32(tile_layout.decode_tiles_plain(d6, m6, src)))
        np.testing.assert_array_equal(tile_layout.tiles_w_to_image(out, H, W).cpu().numpy(), frames)


def test_encode_tiles_from_unaligned_tiles_w(cuda):
    """A tiles_W 4 bytes off the 8-byte grid takes K6's word loads and gives
    the same results as an aligned one."""
    frames = make_adversarial(8200, 8, 2, seed=7)
    tw = tile_layout.image_to_tiles_w(torch.from_numpy(frames).to(cuda))
    T = 1025
    off = torch.empty(tw.numel() + 1, dtype=torch.uint32, device=cuda)[1:].view(tw.shape)
    off.copy_(tw)
    assert off.data_ptr() % 8 == 4
    fill = torch.from_numpy(np.full((2, 16 * T), SENTINEL, np.uint32)).to(cuda)
    want = tile_layout.encode_tiles_plain(tw, T, out=fill.clone())
    got = tile_layout.encode_tiles(off, T, out=fill.clone())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_tiles_backend_launches_one_k6_and_one_k7(cuda):
    frames = make_depth_runs(8000, 24, 3, seed=6)
    codec = DbdeCodec(24, 8000, device=cuda, backend="tiles")
    band.reset_launches()
    enc = codec.encode(frames)
    out = codec.decode(enc.depths.cpu().numpy(), enc.mins, enc.payload)
    assert {k: v for k, v in band.LAUNCHES.items() if v} == {"encode_tiles": 1, "decode_tiles": 1}
    np.testing.assert_array_equal(out, frames)
    assert pack_frames_bytes(enc) == pack_frames_bytes(DbdeCodec(24, 8000, device="cpu").encode(frames))


def test_tiles_wrappers_reject_bad_tensors(cuda):
    tw = torch.zeros((1, 16, 1000), dtype=torch.uint32, device=cuda)
    with pytest.raises(ValueError):
        tile_layout.encode_tiles(tw, 10)  # Tp not a multiple of 1024
    d = torch.zeros((1, 1024), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tile_layout.decode_tiles(d, d, torch.zeros((1, 16), dtype=torch.int32, device=cuda))


def test_sharded_shards_run_their_kernels(cuda):
    """A 2x2 mesh of one card: every shard's encode launches K2 and K4 (the
    flag picks K4 for the random top band's shards, K2 for the low-depth
    bottom band's); from host depths the top shards decode with K5, the
    bottom ones with K3; the arrays equal a CPU mesh's; and
    K3 and K5 decode segments whose slots hold 0xDEADBEEF past each
    shard's live words."""
    from dbde_tpu_torch.parallel import decode_sharded, encode_sharded, make_mesh

    rng = np.random.default_rng(7)
    low = (rng.integers(0, 32, size=(4, 16, 40)) + 50).astype(np.uint8)
    frames = np.concatenate([make_content(40, 16, 4, kind="random"), low], axis=1)
    mesh = make_mesh(2, 2, devices=[cuda] * 4)
    band.reset_launches()
    got = encode_sharded(frames, mesh)
    assert {k: v for k, v in band.LAUNCHES.items() if v} == {
        "encode_depths": 4, "encode_payload": 4, "encode_payload_u8": 4}
    want = encode_sharded(frames, make_mesh(2, 2, devices=[torch.device("cpu")] * 4))
    depth, mins, payload, totals, _, Hp = got
    for g, w in zip(got[:5], want[:5]):
        if g is payload:  # slot words past the live ones are unspecified
            continue
        np.testing.assert_array_equal(g, w)
    S = payload.shape[1] // 2
    segs = np.full((4, 2, S), SENTINEL, np.uint32)
    for b in range(4):
        for s in range(2):
            segs[b, s, : totals[s, b]] = payload[b, s * S : s * S + totals[s, b]]
            assert totals[s, b] == want[3][s, b]
            np.testing.assert_array_equal(segs[b, s, : totals[s, b]],
                                          want[2][b, s * S : s * S + totals[s, b]])
    band.reset_launches()
    out = decode_sharded(depth, mins, segs.reshape(4, -1), mesh, H=32, W=40, Hp=Hp)
    assert {k: v for k, v in band.LAUNCHES.items() if v} == {"decode": 2, "decode_u8": 2}
    np.testing.assert_array_equal(out, frames)


def test_cli_on_the_card_matches_no_device(cuda, tmp_path, capsys):
    """CLI encode and decode on the card: the file equals --no-device's byte
    for byte, the frames come back, and K1–K3 launched; preview decodes its
    one frame with K3 and prints what --no-device prints."""
    from dbde_tpu_torch import cli

    frames = make_content(72, 40, 3)
    raw = tmp_path / "in.raw"
    frames.tofile(raw)
    size = ["--width", "72", "--height", "40", "--batch", "2"]
    band.reset_launches()
    assert cli.main(["encode", str(raw), "-o", str(tmp_path / "gpu.dbde"), *size]) == 0
    assert cli.main(["decode", str(tmp_path / "gpu.dbde"), "-o", str(tmp_path / "out.raw"),
                     "--batch", "2"]) == 0
    assert band.LAUNCHES["encode_depths"] == 2 and band.LAUNCHES["encode_payload"] == 2
    assert band.LAUNCHES["decode"] == 2
    assert cli.main(["encode", str(raw), "-o", str(tmp_path / "cpu.dbde"), *size,
                     "--no-device"]) == 0
    assert (tmp_path / "gpu.dbde").read_bytes() == (tmp_path / "cpu.dbde").read_bytes()
    assert (tmp_path / "out.raw").read_bytes() == raw.read_bytes()
    assert cli.main(["roundtrip", str(tmp_path / "gpu.dbde")]) == 0
    capsys.readouterr()
    band.reset_launches()
    assert cli.main(["preview", str(tmp_path / "gpu.dbde"), "--frame", "2"]) == 0
    on_card = capsys.readouterr().out
    assert band.LAUNCHES["decode"] == 1 and band.LAUNCHES["encode_depths"] == 0
    assert cli.main(["preview", str(tmp_path / "gpu.dbde"), "--frame", "2", "--no-device"]) == 0
    assert capsys.readouterr().out == on_card


def test_run_bench_on_the_card(cuda):
    from dbde_tpu_torch.bench_core import run_bench

    r = run_bench(256, 256, frames=2, iters=3, device=cuda)
    assert r["value"] > 0 and r["encode_gpix_per_s"] > 0
    assert r["device_busy_ms"]["encode"] > 0 and r["device_busy_ms"]["decode"] > 0
    assert torch.cuda.get_device_name(cuda).split()[-1] in r["device"]


@pytest.mark.parametrize("name", ["camera", "random ragged", "depth runs across block seams"])
def test_gated_kernels_write_only_when_selected(cuda, name):
    """Each gated kernel launched alone with the batch flag set against it
    writes nothing (sentinels stay, n64 stays); with the flag set for it,
    it equals its plain version; K1's flag is its plain version's."""
    frames = GEOMETRIES[name]()
    B, H, W = frames.shape
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(cuda)
    flag = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    d, m = band.encode_depths(x, flag)
    assert int(flag) == int(bool((band.encode_depths_plain(x)[0] != 8).any()))
    T = d.shape[1]
    on, off = (torch.full((1,), v, dtype=torch.int32, device=cuda) for v in (1, 0))
    fill = np.full((B, 16 * T), SENTINEL, np.uint32)
    keep = torch.full((B,), -7, dtype=torch.int32, device=cuda)
    for fn, against in ((band.encode_payload, off), (band.encode_payload_u8, on)):
        out, n64 = torch.from_numpy(fill.copy()).to(cuda), keep.clone()
        if fn is band.encode_payload:
            fn(x, d, m, out=out, n64=n64, mixed=against)
        else:
            fn(x, m, out=out, n64=n64, mixed=against)
        torch.cuda.synchronize()
        assert (_u32(out) == SENTINEL).all() and torch.equal(n64, keep)
    p2, n2 = band.encode_payload(x, d, m, mixed=on)
    q2, r2 = band.encode_payload_plain(x, d, m, mixed=on)
    n4 = keep.clone()
    p4 = band.encode_payload_u8(x, m, n64=n4, mixed=off)
    torch.cuda.synchronize()
    assert torch.equal(n2, r2) and n4.tolist() == [8 * T] * B
    for b in range(B):
        np.testing.assert_array_equal(_u32(p2)[b, : 2 * int(n2[b])], _u32(q2)[b, : 2 * int(n2[b])])
    np.testing.assert_array_equal(_u32(p4), _u32(band.encode_payload_u8_plain(x, m)))
    blank = torch.full((B, H, W), 0xA5, dtype=torch.uint8, device=cuda)
    for out in (band.decode_frames(d, m, p2, H, W, out=blank.clone(), mixed=off),
                band.decode_frames_u8(m, p4, H, W, out=blank.clone(), mixed=on)):
        assert torch.equal(out, blank)
    assert torch.equal(band.decode_frames(d, m, p2, H, W, mixed=on), x)
    assert torch.equal(band.decode_frames_u8(m, p4, H, W, mixed=off), x)


def test_codec_encode_reads_nothing_back(cuda):
    """Under torch.cuda.set_sync_debug_mode("error") the codec's encode and
    its decode from host depths raise nothing; the bytes are K2's."""
    frames = np.concatenate([make_content(72, 40, 2), make_content(72, 40, 1, kind="random")])
    codec = DbdeCodec(40, 72, device=cuda)
    enc = codec.encode(frames)  # warm-up
    depths = enc.depths.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        enc = codec.encode(frames)
        pending = codec.decode_dispatch(depths, enc.mins, enc.payload)
        with pytest.raises(RuntimeError):
            torch.from_numpy(np.zeros(64, np.uint8)).to(cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(codec.materialize(pending), frames)
    x = torch.from_numpy(frames).to(cuda)
    d, m = band.encode_depths(x)
    assert pack_frames_bytes(enc) == pack_frames_bytes(EncodedBatch(d, m, *band.encode_payload(x, d, m)))


def test_writer_copies_the_callers_frames(cuda, tmp_path):
    """The caller overwrites its one buffer as soon as write() returns, at
    pipeline 2: the file is the CPU writer's, byte for byte."""
    frames = np.concatenate([make_content(72, 40, 4), make_content(72, 40, 2, kind="random")])
    buf = np.empty((2, 40, 72), np.uint8)
    with DbdeWriter(str(tmp_path / "gpu.dbde"), 40, 72, device=cuda, pipeline=2) as wr:
        for i in range(0, 6, 2):
            buf[:] = frames[i : i + 2]
            wr.write(buf)
            buf[:] = 0
    write_video(str(tmp_path / "cpu.dbde"), frames, device="cpu", batch_size=2)
    assert (tmp_path / "gpu.dbde").read_bytes() == (tmp_path / "cpu.dbde").read_bytes()


def test_host_buffers_are_pinned(cuda, tmp_path):
    """The reader's pool slots and the codec's staged input are pinned;
    arrays handed back are the caller's to keep, in pageable memory, so
    that keeping them holds no pinned memory."""
    frames = make_content(72, 40, 4)
    write_video(str(tmp_path / "v.dbde"), frames, device=cuda, batch_size=2)
    with DbdeReader(str(tmp_path / "v.dbde"), batch_size=2, device=cuda) as rd:
        headers, arrays, release = rd._read_batch_arrays(pool=_GatedPool())
        assert all(torch.from_numpy(a).is_pinned() for a in arrays)
        kept = [out for _, out in rd]
    np.testing.assert_array_equal(np.concatenate(kept), frames[2:])
    codec = DbdeCodec(40, 72, device=cuda)
    assert codec.stage(frames).is_pinned()
    assert not torch.from_numpy(codec.materialize(torch.from_numpy(frames).to(cuda))).is_pinned()
    assert not torch.from_numpy(codec.encode(frames).payload_host()).is_pinned()
    assert not any(torch.from_numpy(out).is_pinned() for out in kept)


def test_codec_keeps_the_callers_stream(cuda):
    """Under a stream of the caller's, the codec's kernels and copies run on
    it, and the caller's current stream is the same after each call; the
    frames come back."""
    frames = np.concatenate([make_content(72, 40, 2), make_content(72, 40, 1, kind="random")])
    codec = DbdeCodec(40, 72, device=cuda)
    mine = torch.cuda.Stream(cuda)
    with torch.cuda.stream(mine):
        enc = codec.encode(frames)
        assert torch.cuda.current_stream(cuda) == mine
        pending = codec.decode_dispatch(enc.depths.cpu().numpy(), enc.mins, enc.payload)
        assert torch.cuda.current_stream(cuda) == mine
        out = codec.materialize(pending)
        assert torch.cuda.current_stream(cuda) == mine
    np.testing.assert_array_equal(out, frames)


SLEEP_CYCLES = 200_000_000  # about 0.1 s of an H100's clock


def test_encode_reads_back_on_another_stream(cuda):
    """An encode under a caller's stream, behind a device sleep, read back on
    the default stream: to_numpy, payload_host and the records equal the
    CPU codec's (the copies wait for the encode's event)."""
    frames = np.concatenate([make_content(72, 40, 3), make_content(72, 40, 1, kind="random")])
    B, H, W = frames.shape
    want = DbdeCodec(H, W, device="cpu").encode(frames)
    d, m, p, n = want.to_numpy()
    codec = DbdeCodec(H, W, device=cuda)
    for read_back in ("to_numpy", "payload_host", "records"):
        with callers_streams([cuda], SLEEP_CYCLES):
            enc = codec.encode(frames)
        if read_back == "to_numpy":
            gd, gm, gp, gn = enc.to_numpy()
            np.testing.assert_array_equal(gd, d)
            np.testing.assert_array_equal(gm, m)
            np.testing.assert_array_equal(gn, n)
        elif read_back == "payload_host":
            gp = enc.payload_host()
        else:
            assert pack_frames_bytes(enc) == pack_frames_bytes(want)
            continue
        for b in range(B):
            np.testing.assert_array_equal(gp[b, : 2 * n[b]], p[b, : 2 * n[b]])


def test_reader_and_sharded_walker_on_switching_streams(cuda, tmp_path):
    """DbdeReader and iter_video_sharded with each next() in turn under a
    caller's stream behind a device sleep and under the default stream,
    at pipelines 1 and 2: the frames are exact."""
    from dbde_tpu_torch.parallel import iter_video_sharded, make_mesh

    frames = np.concatenate([make_content(72, 40, 5), make_content(72, 40, 3, kind="random")])
    path = tmp_path / "s.dbde"
    write_video(path, frames, device=cuda, batch_size=2)
    mesh = make_mesh(2, 1, devices=[cuda] * 2)
    for pipeline in (1, 2):
        with DbdeReader(path, batch_size=2, device=cuda, pipeline=pipeline) as rd:
            got = next_switching_streams(rd, [cuda], SLEEP_CYCLES)
        np.testing.assert_array_equal(np.concatenate([b for _, b in got]), frames)
        got = next_switching_streams(
            iter_video_sharded(path, mesh, batch_size=4, pipeline=pipeline), [cuda], SLEEP_CYCLES)
        np.testing.assert_array_equal(np.concatenate([b for _, b in got]), frames)


def test_materialize_after_the_dispatch_event(cuda):
    """decode_dispatch under a caller's stream behind a device sleep,
    materialized on the default stream after the event recorded at the
    dispatch: the frames are exact."""
    from dbde_tpu_torch.codec import record_event

    frames = np.concatenate([make_content(72, 40, 3), make_content(72, 40, 1, kind="random")])
    codec = DbdeCodec(40, 72, device=cuda)
    enc = codec.encode(frames)
    depths = enc.depths.cpu().numpy()
    torch.cuda.synchronize(cuda)  # the caller's stream reads the encode's outputs
    for d in (depths, enc.depths):  # host depths (K3), depths on the card (K3 and K5 gated)
        with callers_streams([cuda], SLEEP_CYCLES):
            pending = codec.decode_dispatch(d, enc.mins, enc.payload)
            done = record_event(cuda)
        np.testing.assert_array_equal(codec.materialize(pending, after=done), frames)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs (runs on a multi-GPU machine)")
    return visible_devices("cuda")


@pytest.mark.parametrize("name", ["camera", "depth runs across block seams", "T mod 1024 = 1"])
def test_every_kernel_on_every_card(cards, name):
    """K1–K7 on each card, with torch's current device another card: each
    equals its plain version on that card (K2, K3 and K6 take 64 KB of
    dynamic shared memory, whose limit is raised once a card)."""
    frames = GEOMETRIES[name]()
    B, H, W = frames.shape
    for card in cards:
        other = cards[(card.index + 1) % len(cards)]
        with torch.cuda.device(other):
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(card)
            d, m = band.encode_depths(x)
            p, n = band.encode_payload(x, d, m)
            p4 = band.encode_payload_u8(x, m)
            out = band.decode_frames(d, m, p, H, W)
            out5 = band.decode_frames_u8(m, p4, H, W)
            k6 = tile_layout.encode_tiles(tile_layout.image_to_tiles_w(x), d.shape[1])
            k7 = tile_layout.decode_tiles(*k6[:3])
            torch.cuda.synchronize(card)
            assert torch.equal(out, x) and torch.equal(out5, x), card
            assert torch.equal(tile_layout.tiles_w_to_image(k7, H, W), x), card
            pp, np_ = band.encode_payload_plain(x, d, m)
            assert torch.equal(n, np_) and torch.equal(k6[3], n), card
            for b, words in enumerate((2 * n).tolist()):  # past them: unspecified
                assert torch.equal(p[b, :words].view(torch.int32),
                                   pp[b, :words].view(torch.int32)), (card, b)


def test_sharded_path_on_distinct_cards(cards, tmp_path):
    """A mesh with one slot a card (2x2 over four, 2x1 over two or three):
    the sharded arrays equal a CPU mesh's, the round-trip step returns the
    frames with their n64, and the sharded file is write_video's."""
    from dbde_tpu_torch.parallel import (encode_sharded, make_mesh, mesh_slots,
                                         sharded_roundtrip_step, write_video_sharded)
    from dbde_tpu_torch.soak import distinct_mesh_shape

    shape = distinct_mesh_shape(len(cards))
    mesh = make_mesh(*shape, devices=mesh_slots(shape[0] * shape[1], cards))
    assert len(set(mesh.devices.flat)) == shape[0] * shape[1]
    frames = np.concatenate([make_content(40, 16, 4, kind="random"), make_content(40, 16, 4)],
                            axis=1)
    depth, mins, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    want = encode_sharded(frames, make_mesh(*shape, devices=[torch.device("cpu")] * 4))
    for g, w in zip((depth, mins, totals, bases), (want[0], want[1], want[3], want[4])):
        np.testing.assert_array_equal(g, w)
    out, n64 = sharded_roundtrip_step(frames, mesh)
    np.testing.assert_array_equal(out, frames)
    assert n64 == int(depth.astype(np.int64).sum())
    single, sharded = tmp_path / "single.dbde", tmp_path / "sharded.dbde"
    write_video(single, frames, device=cards[0], batch_size=4)
    write_video_sharded(sharded, frames, mesh, batch_size=4)
    assert single.read_bytes() == sharded.read_bytes()
