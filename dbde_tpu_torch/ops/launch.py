"""What every kernel wrapper shares: the launch counts, the argument checks
and the launch itself.

:data:`LAUNCHES` is the one count of kernel launches that ``chip_smoke.py``
reads: a wrapper adds one to its key where it launches its kernel, and
nowhere else, under a lock, so that the counts of several threads that
launch at once add up.
"""

from __future__ import annotations

import threading

import torch

from . import build

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"encode_depths": 0, "encode_payload": 0, "decode": 0,
            "encode_payload_u8": 0, "decode_u8": 0,
            "encode_tiles": 0, "decode_tiles": 0}
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def cuda_batch(device: torch.device, B: int) -> None:
    """Raise unless ``device`` is a CUDA device and ``B`` fits the kernels' grids."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: use a CPU or CUDA tensor")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernels' grid limit of 65535 frames")


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call launcher ``fn`` with ``args`` and the current stream of
    ``device``; raise on a non-zero ``cudaGetLastError()``, else count it."""
    with torch.cuda.device(device):  # the launch's device; restored after
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = build.load().dbde_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
