"""The port's randomized soak (dbde_tpu_torch.soak) on the CPU: the plan,
small drawn cases through ``main`` with the plain versions, the checker
against injected faults, its oracle against the JAX package's, and the
errors without a GPU.  Tolerance 0 throughout (the codec is
integer-valued)."""

import numpy as np
import pytest
import torch

from dbde_tpu import ref_numpy as jax_ref
from dbde_tpu_torch import soak
from dbde_tpu_torch.codec import DbdeCodec, pack_frames_bytes
from dbde_tpu_torch.format import tile_grid
from dbde_tpu_torch.ops import band

CPU = torch.device("cpu")


def _tiles(c: soak.Case) -> int:
    h, w = tile_grid(c.W, c.H)
    return c.B * h * w


def _small(n: int = 12) -> list[int]:
    """``n`` cases of seed 0's plan with at most 20000 tiles, cheap on the
    CPU: the smallest such case of each regime that has one, then the
    smallest others."""
    cases = sorted((c for c in soak.plan(0, 60)
                    if c.regime != soak.PAST_2_31 and _tiles(c) <= 20_000),
                   key=lambda c: (_tiles(c), c.index))
    firsts = {c.regime: c.index for c in reversed(cases)}
    rest = [c.index for c in cases if c.index not in firsts.values()]
    return list(firsts.values()) + rest[: n - len(firsts)]


SMALL = sorted(_small())
# a narrow ragged batch for the injected faults: frame 1 has live words
FAULT_CASE = soak.Case(0, "narrow", 3, 21, 43, "adversarial 8", 8, seed=7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_is_deterministic_and_its_first_cases_cover_every_regime(seed):
    cases = soak.plan(seed, 30)
    assert cases == soak.plan(seed, 30) and cases[:7] == soak.plan(seed, 7)
    assert cases != soak.plan(seed + 10, 30)
    first = cases[: len(soak.REGIMES)]
    assert [c.regime for c in first] == list(soak.REGIMES)
    assert [c.content for c in first[: len(soak.CONTENTS)]] == list(soak.CONTENTS)
    assert first[0].W < 8 and first[0].H < 8
    for c in first:
        h, w = tile_grid(c.W, c.H)
        if c.regime.startswith("seam"):
            assert (h * w) % 1024 == int(c.regime.split()[1]) and h * w > 1024
        assert (c.B * c.H * c.W > 2**31) == (c.regime == soak.PAST_2_31)
        assert c.B <= 16 or c.regime == soak.PAST_2_31
        if c.content in soak.UNIFORM:
            assert c.H % 8 != 1 and c.W % 8 != 1
    streams = [c.stream for c in first if c.stream]
    assert {s[2] for s in streams} == {s[4] for s in streams} == {1, 2, 3}
    assert all(n % wb for n, wb, *_ in streams if wb > 1)  # a ragged last batch
    meshes = [c for c in first if c.mesh]
    assert any(c.mesh[0] > 1 for c in meshes) and any(c.mesh[1] > 1 for c in meshes)
    for c in (c for c in cases if c.mesh):
        n_data, n_tiles = c.mesh
        assert c.B % n_data or n_data == 1
        assert c.H % (8 * n_tiles) and tile_grid(c.W, c.H)[0] % n_tiles == 0
    assert {c.W % 8 for c in cases[:20]} == set(range(8))


def test_small_cases_cover_stream_and_mesh():
    cases = soak.plan(0, 60)
    picked = [cases[i] for i in SMALL]
    assert len(picked) == 12
    assert any(c.stream for c in picked) and any(c.mesh for c in picked)
    assert {"one column", "narrow", "medium", "wide"} < {c.regime for c in picked}
    assert any(c.regime.startswith("seam") for c in picked)


@pytest.mark.parametrize("index", SMALL)
def test_small_case_passes_on_the_cpu(index, capsys):
    assert soak.main(["--device", "cpu", "--seed", "0", "--case", str(index)]) == 0
    out = capsys.readouterr().out
    assert f"ok case {index}:" in out and "band: host depths" in out
    assert "tiles: rows off the 16-byte grid" in out
    assert out.rstrip().endswith("SOAK OK (1 cases, seed 0)")


def test_past_2_31_regime_on_a_small_batch():
    """The checks of the batch past 2**31 bytes, on 33 frames of 16×24:
    three sub-batches of 16, both kinds of content from the generator."""
    case = soak.Case(9, soak.PAST_2_31, 33, 16, 24, soak.DEVICE_CONTENT, 8, seed=3)
    tally = soak.Tally()
    soak.run_case(case, CPU, tally)
    assert tally.counts["regime"] == {soak.PAST_2_31: 1}
    assert tally.counts["route"]["band: encode 33 frames, all depth 8"] == 1
    assert tally.counts["backend"] == {"band": 1, "tiles": 1, "K1-K7": 1}


@pytest.mark.parametrize("uniform", [False, True])
def test_device_frames(uniform):
    case = soak.Case(9, soak.PAST_2_31, 3, 20, 24, soak.DEVICE_CONTENT, 8, seed=5)
    x = soak.device_frames(case, CPU, uniform)
    assert torch.equal(x, soak.device_frames(case, CPU, uniform))
    depths = np.stack([jax_ref.tile_depths_mins(jax_ref.tile_image(f))[0] for f in x.numpy()])
    assert (depths == 8).all() == uniform


def _flip_output(monkeypatch, name, flip):
    """Wrap ``band.<name>`` so that ``flip`` changes its result."""
    real = getattr(band, name)

    def faulty(*args, **kwargs):
        return flip(real(*args, **kwargs))

    monkeypatch.setattr(band, name, faulty)


def _flip_word(out):
    payload, n64 = out
    payload.view(torch.int32)[1, 5] ^= 1 << 7
    return payload, n64


def _bump_n64(out):
    payload, n64 = out
    n64[1] += 1
    return payload, n64


def _flip_depth(out):
    d, m = out
    d[1, 6] ^= 1
    return d, m


def _flip_min(out):
    d, m = out
    m[1, 7] ^= 1
    return d, m


def _flip_pixel(out):
    out[1, 4, 9] ^= 1
    return out


FAULTS = {
    "a payload word": ("encode_payload", _flip_word, "K2 payload", "frame 1, word 5"),
    "a depth": ("encode_depths", _flip_depth, "K1 depths", "frame 1, tile 6"),
    "a minimum": ("encode_depths", _flip_min, "K1 minima", "frame 1, tile 7"),
    "n64": ("encode_payload", _bump_n64, "K2 n64", "frame 1"),
    "a decoded pixel": ("decode_frames", _flip_pixel, "K3 frames", "frame 1, pixel (4, 9)"),
}


@pytest.mark.parametrize("fault", list(FAULTS) + ["a record byte"])
def test_checker_names_an_injected_fault(fault, monkeypatch):
    if fault == "a record byte":
        real = soak.pack_frames_bytes

        def faulty(enc):
            recs = real(enc)
            rec = bytearray(recs[1])
            rec[40] ^= 0x10
            return recs[:1] + [bytes(rec)] + recs[2:]

        monkeypatch.setattr(soak, "pack_frames_bytes", faulty)
        what, where = "band record bytes of frame 1", "byte 40"
    else:
        name, flip, what, where = FAULTS[fault]
        _flip_output(monkeypatch, name, flip)
    with pytest.raises(soak.SoakFailure) as err:
        soak.run_case(FAULT_CASE, CPU, soak.Tally())
    assert err.value.what.startswith(what)
    assert err.value.where == where
    assert err.value.got != err.value.want
    assert f"first difference at {where}" in str(err.value)


def test_main_reports_a_failure(monkeypatch, capsys):
    """A fault in K5 fails the case: main prints the case, the seed, the
    geometry, the content, the backend and route and the first differing
    pixel, and returns 1."""
    _flip_output(monkeypatch, "decode_frames_u8", _flip_pixel)
    cases = soak.plan(0, 60)
    index = next(i for i in SMALL if cases[i].B > 1 and cases[i].H > 4 and cases[i].W > 9)
    case = cases[index]
    assert soak.main(["--device", "cpu", "--case", str(index)]) == 1
    out = capsys.readouterr().out
    assert f"SOAK FAILED at case {index}, seed 0: {case.describe()}" in out
    assert "backend K1-K7, route each against its plain version" in out
    assert "K5 frames from stride" in out and "first difference at frame 1, pixel (4, 9)" in out
    assert f"--seed 0 --case {index} --device cpu" in out


ORACLE_CASES = [soak.plan(0, 60)[i] for i in SMALL[:3]] + [
    soak.Case(3, "wide", 1, 520, 2100, "adversarial 8", 8, seed=11)]  # over 1 MB: 64 tile rows


@pytest.mark.parametrize("case", ORACLE_CASES, ids=lambda c: f"{c.B}x{c.H}x{c.W}")
def test_oracle_bytes_equal_the_jax_packages(case):
    """The soak's oracle for drawn frames equals dbde_tpu.ref_numpy's bytes
    (the whole frame, or its first 64 tile rows over 1 MB), and a record
    from the codec passes the oracle check."""
    frame = soak.make_frames(case)[-1]
    blob, whole = soak.oracle_bytes(frame)
    assert whole == (frame.size <= soak.ORACLE_BYTES)
    assert blob == jax_ref.pack_image(frame if whole else frame[: 8 * soak.ORACLE_TILE_ROWS])
    (record,) = pack_frames_bytes(DbdeCodec(case.H, case.W, device="cpu").encode(frame[None]))
    soak.check_oracle("record", frame, record)


def test_main_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--case", str(SMALL[0])])


@pytest.mark.parametrize("device, error", [("cuda", RuntimeError), ("cpu", ValueError)])
def test_step_time_check_needs_cuda(device, error):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(error):
        soak.check_sharded_step_time(device)


@pytest.mark.requires_cuda
def test_soak_on_the_card():
    """The first three cases of seed 0 on the card, then the step check (c)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the GPU machine)")
    assert soak.main(["--seed", "0", "--cases", "3"]) == 0


@pytest.mark.parametrize("count, shape", [(0, None), (1, None), (2, (2, 1)), (3, (2, 1)),
                                          (4, (2, 2)), (8, (2, 2))])
def test_distinct_card_check_mesh(count, shape):
    """Check (d)'s mesh has one slot a card: 2x2 over four cards, 2x1 over
    two or three, and none below two."""
    assert soak.distinct_mesh_shape(count) == shape


def test_distinct_card_check_needs_two_cards():
    """With fewer than two cards visible, check (d) has nothing to run on
    and returns None rather than a result."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        pytest.skip("two or more GPUs are visible; this checks the case without them")
    assert soak.check_distinct_cards() is None
