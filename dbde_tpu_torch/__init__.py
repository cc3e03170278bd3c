"""dbde_tpu_torch — the DBDE codec in PyTorch, with CUDA kernels for Hopper.

A port of :mod:`dbde_tpu` (JAX/Pallas on a TPU) that writes and reads the
same bytes.  Layers:

  * :mod:`dbde_tpu_torch.ops`    — tile ops in PyTorch and the CUDA kernels
  * :mod:`dbde_tpu_torch.codec`  — public encode/decode API + host byte glue;
    ``DbdeCodec(..., backend="band")`` (the default, kernels K1–K5) or
    ``backend="tiles"`` (the tile-layout kernels K6/K7), same bytes
  * :mod:`dbde_tpu_torch.stream` — streaming file reader/writer
  * :mod:`dbde_tpu_torch.parallel` — the codec sharded over a mesh of
    devices by one process, and the sharded file layer;
    :mod:`dbde_tpu_torch.graft_entry` — the one-device compile check and
    the multi-device dry run
  * :mod:`dbde_tpu_torch.format`, :mod:`~dbde_tpu_torch.ref_numpy`,
    :mod:`~dbde_tpu_torch.golden_vectors`, :mod:`~dbde_tpu_torch.bench_core`,
    :mod:`dbde_tpu_torch.native` — host modules: container serde (its
    header names re-exported here), the numpy oracle, the golden vectors,
    synthetic content and the bench runners, native record IO
  * :mod:`dbde_tpu_torch.cli` — ``python -m dbde_tpu_torch.cli``;
    :mod:`dbde_tpu_torch.utils` — frame previews and PGM files, device
    timing

The port imports ``torch`` and never ``jax``, and nothing of ``dbde_tpu``:
it keeps its own copy of each host module it needs.
"""

from .format import (
    FRAME_HEADER_BYTES,
    VIDEO_HEADER_BYTES,
    FrameHeader,
    VideoHeader,
    unpack_frame_header,
    unpack_video_header,
)

__version__ = "0.1.0"

_LAZY = {
    "DbdeCodec": ("dbde_tpu_torch.codec", "DbdeCodec"),
    "EncodedBatch": ("dbde_tpu_torch.codec", "EncodedBatch"),
    "DbdeReader": ("dbde_tpu_torch.stream", "DbdeReader"),
    "DbdeWriter": ("dbde_tpu_torch.stream", "DbdeWriter"),
    "read_video": ("dbde_tpu_torch.stream", "read_video"),
    "write_video": ("dbde_tpu_torch.stream", "write_video"),
}


def __getattr__(name):
    """Lazy re-exports: ``import dbde_tpu_torch`` loads neither torch nor the kernels
    (the format names above are numpy-free struct code)."""
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'dbde_tpu_torch' has no attribute {name!r}")
