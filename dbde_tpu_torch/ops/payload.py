"""Ragged payload stream ↔ dense per-tile words, via scanned offsets.

Counterpart of :mod:`dbde_tpu.ops.payload`.  The reference advances a
cursor by ``8*depth`` bytes per tile (dbde_util.cpp:155,312); an exclusive
prefix sum over the per-tile word counts ``2*depth`` gives every tile's
offset up front.  The JAX version compacts with a searchsorted gather;
here compaction is a plain scatter of each tile's live words to its offset.

The payload is (B, S) ``torch.uint32``; it is viewed as int32 for indexing,
which uint32 lacks on the CPU.
"""

from __future__ import annotations

import torch

from .bitpack import MAX_WORDS_PER_TILE, U32_MASK


def word_offsets(depths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """depths (..., T) → (exclusive u32-word offsets (..., T) i32, total (...,) i32).

    ``offsets[t] = 2 * Σ_{s<t} depth[s]``; total = 2*n64.
    """
    counts = 2 * depths.to(torch.int32)
    incl = torch.cumsum(counts, dim=-1, dtype=torch.int32)
    return incl - counts, incl[..., -1]


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values → int32 with the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def compact_payload(words: torch.Tensor, depths: torch.Tensor, offsets: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (B, T, 16) words → flat (B, S) u32 payload.

    Stores each tile's ``2*depth`` words at ``out[b, offsets[b, t]:]`` and
    writes nothing else.  ``out`` defaults to a zeroed (B, 16*T) buffer.
    """
    B, T, _ = words.shape
    dev = words.device
    if out is None:
        out = torch.zeros((B, T * MAX_WORDS_PER_TILE), dtype=torch.uint32, device=dev)
    S = out.shape[1]
    j = torch.arange(MAX_WORDS_PER_TILE, device=dev)
    live = j < 2 * depths.to(torch.int64)[..., None]
    idx = (torch.arange(B, device=dev)[:, None, None] * S
           + offsets.to(torch.int64)[..., None] + j)
    out.view(torch.int32).view(-1)[idx[live]] = _as_int32_bits(words[live])
    return out


def gather_windows(payload: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Flat (B, S) u32 payload → dense (B, T, 16) int64 windows holding u32
    values.  Reads past the stride are clamped to word S-1; the unpack
    never selects those words."""
    B, T = offsets.shape
    S = payload.shape[-1]
    idx = offsets.to(torch.int64)[..., None] + torch.arange(MAX_WORDS_PER_TILE, device=payload.device)
    idx = idx.clamp_(max=S - 1).reshape(B, T * MAX_WORDS_PER_TILE)
    p = payload.view(torch.int32).to(torch.int64) & U32_MASK
    return torch.gather(p, -1, idx).reshape(B, T, MAX_WORDS_PER_TILE)
