"""dbde_tpu_torch — the DBDE codec in PyTorch, with CUDA kernels for Hopper.

A port of :mod:`dbde_tpu` (JAX/Pallas on a TPU) that writes and reads the
same bytes.  Layers:

  * :mod:`dbde_tpu_torch.ops`    — tile ops in PyTorch and the CUDA kernels
  * :mod:`dbde_tpu_torch.codec`  — public encode/decode API + host byte glue
  * :mod:`dbde_tpu_torch.stream` — streaming file reader/writer

The port imports ``torch`` and never ``jax``.  It reuses the JAX package's
JAX-free host modules (:mod:`dbde_tpu.format`, :mod:`dbde_tpu.native`, the
classes of :mod:`dbde_tpu.stream`) rather than copying them.
"""

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
    """Lazy re-exports: ``import dbde_tpu_torch`` loads neither torch nor the kernels."""
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'dbde_tpu_torch' has no attribute {name!r}")
