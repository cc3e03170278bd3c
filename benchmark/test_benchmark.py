"""Tests of the benchmark itself, on the CPU at tiny frames:

    python -m pytest benchmark/test_benchmark.py -q

  * the plain reference gives the port's numpy oracle's bytes;
  * the rehearsal (``rehearse.py``): the files agree, the readers give
    known answers, and every cell runs ``correct`` untraced and traced;
  * the control, the reference at 7 bits a pixel in the writer's place,
    comes out not correct in every cell;
  * the comparison catches each fault a cell can have, planted in the
    program underneath a whole run: a step that returns its state
    unchanged, half of a batch left out, the exchange between the mesh's
    shards left out (the sharded cell), and an answer altered where it is
    produced.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import reference, rehearse, spec  # noqa: E402
from dbde_tpu_torch import ref_numpy  # noqa: E402
from dbde_tpu_torch import codec as program_codec  # noqa: E402
from dbde_tpu_torch import stream as program_stream  # noqa: E402
from dbde_tpu_torch.parallel import sharding as program_sharding  # noqa: E402

CELLS = spec.cell_names()
SHARDED = [c for c in CELLS if spec.load_cell(c).params["entry"] == "sharded"]


def _run(cell: str, *extra) -> dict:
    return rehearse.run_cell("--workload", cell, "--seed", "4294967311", "--seconds", "4",
                             "--rehearse", *extra)


@pytest.mark.parametrize("shape", [(10, 10), (17, 29), (64, 80), (48, 79)])
def test_reference_is_the_oracle(shape):
    rng = np.random.default_rng(sum(shape))
    H, W = shape
    frames = [rng.integers(0, 256, (2, H, W), dtype=np.uint8),
              np.clip(96 + rng.normal(0, 3, (2, H, W)), 0, 255).astype(np.uint8),
              np.full((1, H, W), 7, np.uint8)]
    for stack in frames:
        got = reference.encode_source(stack, torch.device("cpu"))
        assert [d for d, _ in got] == [ref_numpy.pack_image(f) for f in stack]


def test_files_and_readers():
    assert rehearse.check_files() == []
    assert rehearse.check_readers() == []


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result = _run(cell, "--control")
    assert not result["correct"]
    assert result["checks"]["records_wrong"]["value"] > 0


def _stale(fn):
    """``fn`` that returns its first answer ever after."""
    first = []

    def stale(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]

    return stale


def _flip_payload(fn):
    """An encode whose first frame's first payload word has a bit flipped."""
    def altered(*args, **kwargs):
        enc = fn(*args, **kwargs)
        enc.payload.view(torch.int32)[0, 0] ^= 1
        return enc

    return altered


def _flip_pixel(fn):
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs)
        out[0, 0, 0] ^= 1
        return out

    return altered


def _half_records(fn):
    """``record_iovecs`` that leaves out the second half of each batch."""
    def half(depths, mins, payload, n64, indices=None, elapsed_ns=None):
        k = max(1, len(n64) // 2)
        return fn(depths[:k], mins[:k], payload[:k], n64[:k],
                  None if indices is None else list(indices)[:k],
                  None if elapsed_ns is None else list(elapsed_ns)[:k])

    return half


def _half_parse(fn):
    """A parse that hands on only the first half of each batch's records."""
    def half(self, *args, **kwargs):
        out = fn(self, *args, **kwargs)
        if out is None:
            return None
        headers, (d, m, p, n), *rest = out
        k = max(1, len(headers) // 2)
        return (headers[:k], (d[:k], m[:k], p[:k], n[:k]), *rest)

    return half


def _no_exchange(fn):
    """The word totals of every band but the first never reach the row's
    first card: the write's one exchange between shards, left out."""
    def local(row):
        totals, bases = fn(row)
        totals = totals.clone()
        totals[1:] = 0
        return totals, torch.zeros_like(bases)

    return local


FAULTS = {
    "encode_unchanged": [(program_codec.DbdeCodec, "encode", _stale)],
    "decode_unchanged": [(program_codec.DbdeCodec, "materialize", _stale),
                         (program_sharding, "decode_sharded_materialize", _stale)],
    "write_half_batch": [(program_stream, "record_iovecs", _half_records),
                         (program_sharding, "record_iovecs", _half_records)],
    "read_half_batch": [(program_stream.DbdeReader, "_read_batch_arrays", _half_parse)],
    "encode_altered": [(program_codec.DbdeCodec, "encode", _flip_payload)],
    "decode_altered": [(program_codec.DbdeCodec, "materialize", _flip_pixel),
                       (program_sharding, "_place", None)],
    "exchange_left_out": [(program_sharding, "_totals_bases", _no_exchange)],
}


def _place_altered(out, d, t, band):
    band = band.copy()
    band[0, 0, 0] ^= 1
    return ORIGINAL_PLACE(out, d, t, band)


ORIGINAL_PLACE = program_sharding._place


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in sorted(FAULTS)
                                        if f != "exchange_left_out" or c in SHARDED])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    for owner, attr, wrap in FAULTS[fault]:
        fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        monkeypatch.setattr(owner, attr, _place_altered if wrap is None else wrap(fn))
    result = _run(cell)
    assert not result["correct"], (result["checks"], result["attempted"])
