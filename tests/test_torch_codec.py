"""The port's codec (device="cpu") against the JAX package's XLA codec and
the numpy oracle, byte for byte (tolerance 0: the codec is integer-valued).

Inputs come from numpy seeds.  Encoded batches cross between the packages
as numpy arrays (``EncodedBatch.from_numpy`` / ``to_numpy``).
"""

import numpy as np
import pytest
import torch

from dbde_tpu import ref_numpy as ref
from dbde_tpu.bench_core import make_adversarial
from dbde_tpu.codec import DbdeCodec as JaxCodec
from dbde_tpu.codec import pack_frames_bytes as jax_pack_frames_bytes
from dbde_tpu.codec import unpack_frames_bytes as jax_unpack_frames_bytes
from dbde_tpu.golden_vectors import (
    GOLDEN_8x16_IMAGE,
    README_10x10_DEPTHS,
    README_10x10_IMAGE,
    README_10x10_MINS,
    README_10x10_U64S,
)
from dbde_tpu_torch import soak, stream
from dbde_tpu_torch.codec import (
    DbdeCodec,
    EncodedBatch,
    one_band,
    pack_frames_bytes,
    record_iovecs,
    unpack_frames_bytes,
)
from dbde_tpu_torch.format import VIDEO_HEADER_BYTES
from dbde_tpu_torch.parallel import sharding


def _encode(frames: np.ndarray) -> EncodedBatch:
    return DbdeCodec(frames.shape[1], frames.shape[2], device="cpu").encode(frames)


def _check_against_oracle(frames: np.ndarray) -> EncodedBatch:
    """Port records equal ref_numpy's, and the port decodes them back."""
    enc = _encode(frames)
    recs = pack_frames_bytes(enc, indices=range(3, 3 + len(frames)))
    for b, rec in enumerate(recs):
        assert rec == ref.pack_frame(3 + b, frames[b]), f"frame {b}"
    codec = DbdeCodec(frames.shape[1], frames.shape[2], device="cpu")
    np.testing.assert_array_equal(codec.decode(enc.depths, enc.mins, enc.payload), frames)
    return enc


def _uniform_depth_frame(depth: int, H: int = 24, W: int = 24) -> np.ndarray:
    """The content of tests/test_jax_codec.py's uniform-depth case."""
    rng = np.random.default_rng(depth)
    span = (1 << depth) - 1 if depth else 0
    img = (100 + rng.integers(0, span + 1, size=(H, W))).astype(np.uint8)
    if depth == 8:
        img = rng.integers(0, 256, size=(H, W)).astype(np.uint8)
    return img


def test_golden_image_bytes():
    enc = _check_against_oracle(GOLDEN_8x16_IMAGE[None])
    assert enc.depths.dtype == enc.mins.dtype == torch.uint8
    assert enc.payload.dtype == torch.uint32 and enc.n64.dtype == torch.int32
    assert enc.depth_bound is None and enc.depth_exact is None


def test_readme_image_bytes():
    enc = _check_against_oracle(README_10x10_IMAGE[None])
    depths, mins, payload, n64 = enc.to_numpy()
    np.testing.assert_array_equal(depths[0], README_10x10_DEPTHS)
    np.testing.assert_array_equal(mins[0], README_10x10_MINS)
    assert int(n64[0]) == len(README_10x10_U64S)
    assert payload[0, : 2 * int(n64[0])].view(np.uint64).tolist() == README_10x10_U64S


@pytest.mark.parametrize(
    "shape", [(8, 8), (16, 8), (10, 10), (1, 1), (7, 3), (9, 9), (17, 33), (40, 56), (31, 130)]
)
def test_random_bytes_parity(shape):
    """The shape list of tests/test_jax_codec.py, with the same content."""
    rng = np.random.default_rng(hash(shape) % 2**32)
    img = (rng.integers(0, 256, size=shape) & rng.integers(0, 256, size=shape)).astype(np.uint8)
    _check_against_oracle(img[None])


@pytest.mark.parametrize("depth", range(9))
def test_uniform_depth_bytes_parity(depth):
    img = _uniform_depth_frame(depth)
    enc = _check_against_oracle(img[None])
    assert set(enc.depths.unique().tolist()) == {depth}


def test_flat_frame_has_empty_payload():
    frames = np.full((2, 17, 23), 201, np.uint8)
    enc = _check_against_oracle(frames)
    assert enc.n64.tolist() == [0, 0]


def test_partial_group_depth8_tail():
    """The pattern of tests/test_band_codec.py's round-3 regression: leading
    flat tiles, then a depth-8 last tile of the row, so a store past a
    tile's own words would land on the next row's stream head."""
    rng = np.random.default_rng(3)
    H, W = 32, 1024
    base = rng.integers(0, 256, (1, H, W)).astype(np.uint8)
    frames = []
    for F in (1, 80, 127):
        img = base.copy()
        img[0, 8:16, : 8 * F] = 77
        frames.append(img[0])
    _check_against_oracle(np.stack(frames))


def test_adversarial_content():
    _check_against_oracle(make_adversarial(56, 40, 3, maxd=8, seed=2))


@pytest.mark.parametrize("slack", [0, 5])
def test_decode_short_stride_with_garbage(slack):
    """Any payload stride S >= 2*max(n64), below the worst case 16*T, with
    random garbage after each frame's 2*n64 words."""
    frames = make_adversarial(44, 30, 3, maxd=6, seed=4)
    depths, mins, payload, n64 = _encode(frames).to_numpy()
    S = 2 * int(n64.max()) + slack
    assert S < 16 * depths.shape[1]
    rng = np.random.default_rng(slack)
    short = rng.integers(0, 1 << 32, (3, S), dtype=np.uint32)
    for b in range(3):
        short[b, : 2 * n64[b]] = payload[b, : 2 * n64[b]]
    codec = DbdeCodec(30, 44, device="cpu")
    np.testing.assert_array_equal(codec.decode(depths, mins, short), frames)


def test_payload_host_slices_the_prefix():
    enc = _encode(make_adversarial(24, 16, 2, seed=1))
    full = enc.payload_host()
    assert full.shape == (2, 16 * 6) and full.dtype == np.uint32
    np.testing.assert_array_equal(enc.payload_host(7), full[:, :7])


def test_roundtrip_single_frame():
    img = _uniform_depth_frame(5, 13, 21)
    out, n64 = DbdeCodec(13, 21, device="cpu").roundtrip(img)
    np.testing.assert_array_equal(out, img)
    assert int(n64) == int(ref.tile_depths_mins(ref.tile_image(img))[0].astype(int).sum())


def test_rejects_wrong_geometry():
    with pytest.raises(ValueError):
        DbdeCodec(8, 16, device="cpu").encode(np.zeros((1, 8, 8), np.uint8))


def test_cuda_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DbdeCodec(8, 8)


# -- against the JAX package's XLA codec, in both directions ------------------

H, W = 30, 44  # ragged on both edges


@pytest.fixture(scope="module")
def jax_case():
    """Uniform depths 0..8, a flat frame and two adversarial frames, encoded
    and decoded by the JAX package (one compile each)."""
    frames = np.stack([_uniform_depth_frame(d, H, W) for d in range(9)]
                      + [np.full((H, W), 3, np.uint8)]
                      + list(make_adversarial(W, H, 2, maxd=8, seed=6)))
    jc = JaxCodec(H, W, backend="xla")
    enc = jc.encode(frames)
    np.testing.assert_array_equal(jc.decode(enc.depths, enc.mins, enc.payload), frames)
    return frames, jc, enc


def test_encode_matches_jax_xla(jax_case):
    frames, _, jenc = jax_case
    enc = _encode(frames)
    depths, mins, payload, n64 = enc.to_numpy()
    np.testing.assert_array_equal(depths, np.asarray(jenc.depths))
    np.testing.assert_array_equal(mins, np.asarray(jenc.mins))
    np.testing.assert_array_equal(n64, np.asarray(jenc.n64))
    jpay = jenc.payload_host()
    for b in range(len(frames)):
        np.testing.assert_array_equal(payload[b, : 2 * n64[b]], jpay[b, : 2 * n64[b]])
    assert pack_frames_bytes(enc) == jax_pack_frames_bytes(jenc)


def test_port_decodes_jax_batch(jax_case):
    frames, _, jenc = jax_case
    enc = EncodedBatch.from_numpy(np.asarray(jenc.depths), np.asarray(jenc.mins),
                                  jenc.payload_host(), np.asarray(jenc.n64), "cpu")
    codec = DbdeCodec(H, W, device="cpu")
    np.testing.assert_array_equal(codec.decode(enc.depths, enc.mins, enc.payload), frames)


def test_jax_decodes_port_batch(jax_case):
    frames, jc, _ = jax_case
    depths, mins, payload, _ = _encode(frames).to_numpy()
    np.testing.assert_array_equal(jc.decode(depths, mins, payload), frames)


# -- host byte glue ------------------------------------------------------------


def _records(frames):
    recs = pack_frames_bytes(_encode(frames))
    buf = b"".join(r[20:] for r in recs)
    offsets = list(np.cumsum([0] + [len(r) - 20 for r in recs[:-1]]))
    return buf, [int(o) for o in offsets]


def test_unpack_frames_bytes_matches_jax():
    frames = make_adversarial(20, 12, 3, seed=3)
    buf, offsets = _records(frames)
    got = unpack_frames_bytes(buf, 20, 12, offsets)
    want = jax_unpack_frames_bytes(buf, 20, 12, offsets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    out = DbdeCodec(12, 20, device="cpu").decode(*got[:3])
    np.testing.assert_array_equal(out, frames)


@pytest.mark.parametrize("field, match", [("depths", "depth count"), ("mins", "min count"),
                                          ("n64", "n64")])
def test_unpack_frames_bytes_count_mismatch(field, match):
    """A corrupt count field raises, as the JAX package's glue and the
    reference decoder do."""
    frames = make_adversarial(20, 12, 2, seed=8)
    buf, offsets = _records(frames)
    T = 3 * 2
    pos = offsets[1] + {"depths": 0, "mins": 4 + T, "n64": 8 + 2 * T}[field]
    bad = bytearray(buf)
    bad[pos] ^= 1
    for unpack in (unpack_frames_bytes, jax_unpack_frames_bytes):
        with pytest.raises(ValueError, match=match):
            unpack(bytes(bad), 20, 12, offsets)


@pytest.mark.parametrize("bands", [1, 2, 3])
def test_record_iovecs_bands_give_the_one_band_bytes(bands):
    """A batch's depths, minima and payload cut into 1, 2 and 3 bands a
    frame: 7 + 3*(bands - 1) buffers a frame, whose bytes are the one-band
    layout's and soak.records', the struct-built oracle's."""
    frames = make_adversarial(36, 28, 3, maxd=8, seed=6)
    depths, mins, payload, n64 = _encode(frames).to_numpy()
    T = depths.shape[1]
    cuts = np.linspace(0, T, bands + 1).astype(int)[1:-1]  # tile bands, a ragged one too
    pieces = [np.split(payload[b, : 2 * int(n)], [int(n) * k // bands for k in range(1, bands)])
              for b, n in enumerate(n64)]
    iov = record_iovecs([np.split(d, cuts) for d in depths], [np.split(m, cuts) for m in mins],
                        pieces, n64)
    assert len(iov) == 3 * (7 + 3 * (bands - 1))
    one = record_iovecs(*one_band(depths, mins, payload, n64), n64)
    assert b"".join(iov) == b"".join(one) == b"".join(soak.records(depths, mins, payload, n64))


@pytest.mark.parametrize("patched", ["stream", "sharding"])
def test_record_iovecs_patch_reaches_its_own_writer_alone(patched, tmp_path, monkeypatch):
    """The two writers call the one layout through their own module's name:
    a wrapper set on one name (the benchmark's write_half_batch fault)
    halves that writer's batches and leaves the other's file exact."""
    assert stream.record_iovecs is sharding.record_iovecs is record_iovecs
    frames = make_adversarial(24, 16, 4, maxd=8, seed=9)

    def half(depths, mins, payload, n64, indices=None, elapsed_ns=None):
        k = len(n64) // 2
        return record_iovecs(depths[:k], mins[:k], payload[:k], n64[:k],
                             list(indices)[:k], None if elapsed_ns is None else elapsed_ns[:k])

    monkeypatch.setattr({"stream": stream, "sharding": sharding}[patched], "record_iovecs", half)
    single, sharded = tmp_path / "single.dbde", tmp_path / "sharded.dbde"
    stream.write_video(str(single), frames, device="cpu", batch_size=4)
    sharding.write_video_sharded(str(sharded), frames,
                                 sharding.make_mesh(2, 2, devices=[torch.device("cpu")] * 4),
                                 batch_size=4)
    want = ref.encode_video(list(frames), frame_hz=1.0)
    half_file = VIDEO_HEADER_BYTES + sum(len(r) for r in pack_frames_bytes(_encode(frames[:2])))
    written = {"stream": single.read_bytes(), "sharding": sharded.read_bytes()}
    assert written.pop(patched) == want[:half_file]
    assert written.popitem()[1] == want


# -- the uniform depth-8 pair and its dispatch ---------------------------------


@pytest.fixture
def calls(monkeypatch):
    """Count the codec's calls of each band wrapper that do the work (the
    plain versions run on the CPU, so LAUNCHES stays at zero here): a call
    whose batch flag selects the other kernel of its pair writes nothing
    and is not counted."""
    from dbde_tpu_torch.ops import band

    n = {}
    for name in ("encode_payload", "encode_payload_u8", "decode_frames", "decode_frames_u8"):
        fn = getattr(band, name)

        def counted(*a, _fn=fn, _name=name, **k):
            if band._runs(k.get("mixed"), general=_name in ("encode_payload", "decode_frames")):
                n[_name] = n.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(band, name, counted)
    return n


def test_uniform_batch_takes_the_u8_pair(calls):
    """Every tile depth 8 → K4/K5 (bytes and frames as the oracle's); one
    tile below 8 anywhere in the batch → K2/K3."""
    frames = np.stack([_uniform_depth_frame(8, 26, 34), _uniform_depth_frame(8, 26, 34)[::-1]])
    enc = _check_against_oracle(frames)
    assert enc.n64.tolist() == [8 * 4 * 5] * 2
    assert calls == {"encode_payload_u8": 1, "decode_frames_u8": 1}
    codec = DbdeCodec(26, 34, device="cpu")
    depths, mins, payload, _ = enc.to_numpy()
    np.testing.assert_array_equal(codec.decode(depths, mins, payload), frames)  # host depths
    assert calls["decode_frames_u8"] == 2

    frames[1, 8:16, 8:16] = 7  # one flat tile
    calls.clear()
    _check_against_oracle(frames)
    assert calls == {"encode_payload": 1, "decode_frames": 1}


def test_uniform_pair_matches_general_pair():
    """On all-depth-8 content the uniform pair's payload is the general
    pair's word for word, and each pair decodes the other's."""
    from dbde_tpu_torch.ops import band

    x = torch.from_numpy(np.stack([_uniform_depth_frame(8, 21, 43)] * 3))
    d, m = band.encode_depths(x)
    general, n64 = band.encode_payload(x, d, m)
    uniform = band.encode_payload_u8(x, m)
    assert n64.tolist() == [8 * d.shape[1]] * 3
    assert torch.equal(general.view(torch.int32), uniform.view(torch.int32))
    assert torch.equal(band.decode_frames_u8(m, general, 21, 43), x)
    assert torch.equal(band.decode_frames(d, m, uniform, 21, 43), x)


def test_band_codec_scans_only_in_the_plain_versions(monkeypatch):
    """On the CPU the band codec and graft_entry's step reach word_offsets
    (the scan the kernels do without) only through the plain versions of
    K2 and K3; codec.py and graft_entry.py do not name it."""
    import inspect

    from dbde_tpu_torch import codec as codec_module
    from dbde_tpu_torch import graft_entry
    from dbde_tpu_torch.ops import band

    callers, scan = [], band.word_offsets

    def spy(depths):
        callers.append(inspect.stack()[1].function)
        return scan(depths)

    monkeypatch.setattr(band, "word_offsets", spy)
    _check_against_oracle(make_adversarial(43, 21, 2, maxd=8, seed=3))
    assert callers == ["encode_payload_plain", "decode_frames_plain"]
    fn, (example,) = graft_entry.entry("cpu")
    frames, n64 = fn(example[:, :16, :40])
    assert torch.equal(frames, torch.from_numpy(example[:, :16, :40]))
    assert n64.tolist() == [int(ref.tile_depths_mins(ref.tile_image(f))[0].astype(np.int64).sum())
                            for f in example[:, :16, :40]]
    assert callers[2:] == ["encode_payload_plain", "decode_frames_plain"]
    for module in (codec_module, graft_entry):
        assert "word_offsets" not in inspect.getsource(module)


def test_uniform_decode_garbage_after_the_stream():
    """K5's plain version reads words [0, 16*T) only: a longer stride with
    garbage after them decodes the same frames."""
    frames = np.stack([_uniform_depth_frame(8, 16, 24)] * 2)
    depths, mins, payload, _ = _encode(frames).to_numpy()
    rng = np.random.default_rng(5)
    padded = rng.integers(0, 1 << 32, (2, payload.shape[1] + 7), dtype=np.uint32)
    padded[:, : payload.shape[1]] = payload
    np.testing.assert_array_equal(DbdeCodec(16, 24, device="cpu").decode(depths, mins, padded),
                                  frames)


def test_uniform_batch_crosses_packages():
    """A uniform depth-8 batch: JAX XLA encode → port decode and the reverse,
    and equal records."""
    frames = np.stack([_uniform_depth_frame(8, H, W), _uniform_depth_frame(8, H, W)[:, ::-1]])
    jc = JaxCodec(H, W, backend="xla")
    jenc = jc.encode(frames)
    enc = _encode(frames)
    assert pack_frames_bytes(enc) == jax_pack_frames_bytes(jenc)
    codec = DbdeCodec(H, W, device="cpu")
    np.testing.assert_array_equal(
        codec.decode(np.asarray(jenc.depths), np.asarray(jenc.mins), jenc.payload_host()), frames)
    depths, mins, payload, _ = enc.to_numpy()
    np.testing.assert_array_equal(jc.decode(depths, mins, payload), frames)


# -- the batch flag and the gated pairs ----------------------------------------

# rows of jax_case's batch: uniform depths 0..8 (row 8 every tile depth 8),
# a flat frame, two adversarial frames
FLAG_CASES = {"every tile depth 8": [8, 8], "mixed": [0, 3, 5, 9, 10, 11],
              "mixed, one frame all depth 8": [10, 8]}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_flag_selected_plain_versions_match_jax(jax_case, case):
    """K1's flag, then K2 and K4 both called into one payload and n64 and
    K3 and K5 into one output, each gated by the flag as the codec calls
    the kernels: the plain versions give the JAX codec's n64 and stream
    bytes, and the frames back."""
    from dbde_tpu_torch.ops import band

    frames, _, jenc = jax_case
    rows = FLAG_CASES[case]
    x = torch.from_numpy(frames[rows])
    mixed = torch.full((1,), -1, dtype=torch.int32)
    d, m = band.encode_depths(x, mixed)
    assert int(mixed) == (case != "every tile depth 8")
    payload, n64 = band.encode_payload(x, d, m, mixed=mixed)
    assert band.encode_payload_u8(x, m, out=payload, n64=n64, mixed=mixed) is payload
    jn64, jpay = np.asarray(jenc.n64)[rows], jenc.payload_host()[rows]
    np.testing.assert_array_equal(n64.numpy(), jn64)
    for b in range(len(rows)):
        np.testing.assert_array_equal(payload.numpy()[b, : 2 * jn64[b]], jpay[b, : 2 * jn64[b]])
    out = band.decode_frames(d, m, payload, H, W, mixed=mixed)
    assert band.decode_frames_u8(m, payload, H, W, out=out, mixed=mixed) is out
    np.testing.assert_array_equal(out.numpy(), frames[rows])
    assert torch.equal(band.mixed_flag(d), mixed)
