"""The port's probe of the sharded step's host legs
(``python -m dbde_tpu_torch.probe_sharded``) on the CPU: its glue legs
against the JAX package's ``split_payload_host`` and
``assemble_payload_padded`` at the probe's own inputs (tolerance 0; numpy
functions, no compile), and its write and read legs on meshes of CPU slots,
the plain versions in every shard."""

import numpy as np
import pytest
import torch

from dbde_tpu.parallel import sharding as jax_sharding
from dbde_tpu_torch import probe_sharded
from dbde_tpu_torch.bench_core import make_content
from dbde_tpu_torch.parallel import (
    assemble_payload_padded,
    make_mesh,
    split_payload_host,
    write_video_sharded,
)

W, H, B = 40, 32, 4  # 4 tile rows: 1, 2 or 4 bands
CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_glue_legs_match_jax_package(n_tiles):
    """Each shard's live words from split_payload_host, and the assembled
    streams, equal the JAX package's at the probe's inputs."""
    depths, payload = probe_sharded.glue_inputs(W, H, B)
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


def test_time_glue_rows():
    rows = probe_sharded.time_glue(W, H, B, (1, 2, 3))
    assert [r["n_tiles"] for r in rows] == [1, 2, 3] and "skipped" in rows[2]
    for r in rows[:2]:
        assert all(r[k] > 0 for k in ("split fresh", "split pooled", "assemble fresh",
                                      "assemble reused"))
    lines = probe_sharded.glue_lines(W, H, B, rows)
    assert lines[0].startswith(f"geom {B}x{H}x{W}: T=20 tiles")
    assert lines[1].startswith("n_tiles=1 (slot") and "skipped" in lines[3]


@pytest.fixture(scope="module")
def frames():
    return make_content(W, H, 9)  # batches of 4, 4 and 1


@pytest.mark.parametrize("n_data,n_tiles", [(1, 1), (2, 2)])
def test_legs_on_cpu_slots(frames, tmp_path, n_data, n_tiles):
    """Every write and read leg is timed in each batch and is ≥ 0; the
    instrumented file is write_video_sharded's byte for byte and its read
    returns the frames."""
    mesh = make_mesh(n_data, n_tiles, devices=CPU8)
    legs, batches = probe_sharded.write_legs(tmp_path / "legs.dbde", frames, mesh, 4)
    write_video_sharded(tmp_path / "real.dbde", frames, mesh, frame_hz=probe_sharded.FRAME_HZ,
                        batch_size=4)
    assert (tmp_path / "legs.dbde").read_bytes() == (tmp_path / "real.dbde").read_bytes()
    assert batches == 3 and tuple(legs.seconds) == probe_sharded.WRITE_LEGS
    assert all(v >= 0 for v in legs.seconds.values())
    shards = n_data * n_tiles  # the legs of each shard, in the step's order
    assert legs.calls == {leg: 3 * shards if leg in ("slice", "stage", "h2d", "kernels") else 3
                          for leg in probe_sharded.WRITE_LEGS}
    legs, batches, got = probe_sharded.read_legs(tmp_path / "legs.dbde", mesh, 4)
    np.testing.assert_array_equal(got, frames)
    assert batches == 3 and tuple(legs.seconds) == probe_sharded.READ_LEGS
    assert all(v >= 0 for v in legs.seconds.values())
    assert legs.calls == {leg: 3 * shards if leg in ("slice+stage", "h2d", "kernels")
                          else 4 if leg == "parse" else 3 for leg in probe_sharded.READ_LEGS}

    result = probe_sharded.probe_mesh(frames, mesh, 4)
    assert result["mesh"] == f"{n_data}x{n_tiles}" and result["frames"] == 9
    for leg in ("write", "read"):
        assert result[leg]["batches"] == 3 and len(result[leg]["spans"]) == 2
    write, read = probe_sharded.mesh_lines(result, "phase 5 ")
    assert write.startswith(f"phase 5 probe write, {n_data}x{n_tiles} mesh on cpu")
    assert all(f" {leg} " in write for leg in probe_sharded.WRITE_LEGS)
    assert all(f" {leg} " in read for leg in probe_sharded.READ_LEGS)
    assert "legs/span" in write and "iter_video_sharded(pipeline=1) span" in read


def test_probe_raises_when_the_instrumented_file_differs(frames, monkeypatch):
    mesh = make_mesh(2, 1, devices=CPU8)
    record_iovecs = probe_sharded.record_iovecs

    def shifted(*args, indices, **kwargs):  # frame indices off by one
        return record_iovecs(*args, indices=[i + 1 for i in indices], **kwargs)

    monkeypatch.setattr(probe_sharded, "record_iovecs", shifted)
    with pytest.raises(RuntimeError, match="differs from write_video_sharded's"):
        probe_sharded.probe_mesh(frames, mesh, 4)


def test_a_leg_not_timed_raises():
    legs = probe_sharded.Legs(("a", "b"), make_mesh(1, 1, devices=CPU8))
    legs("a", lambda: None)
    with pytest.raises(RuntimeError, match="leg 'b' was timed 0 times"):
        legs.check(1)


def test_main_on_cpu(capsys):
    assert probe_sharded.main([f"{W}x{H}", "2", "1", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"geom 2x{H}x{W}") and lines[1].startswith("n_tiles=1")
    meshes = [line.split(",")[1].strip() for line in lines[3:]]
    assert meshes == ["1x1 mesh on cpu"] * 2 + ["2x2 mesh on cpu"] * 2


def test_default_meshes(monkeypatch):
    """1x1 and 2x2 over the visible cards in turn, 4x1 too with four."""
    assert [m.devices.shape for m in probe_sharded.default_meshes([torch.device("cpu")])] == \
        [(1, 1), (2, 2)]
    monkeypatch.setattr(probe_sharded, "make_mesh", lambda nd, nt, devices: (nd, nt, devices))
    cards = [torch.device("cuda", i) for i in range(4)]
    assert probe_sharded.default_meshes(cards) == [(1, 1, cards[:1]), (2, 2, cards),
                                                  (4, 1, cards)]
    assert probe_sharded.default_meshes(cards[:1]) == [(1, 1, cards[:1]), (2, 2, cards[:1] * 4)]


def test_probe_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_sharded.main([f"{W}x{H}", "2", "1"])
