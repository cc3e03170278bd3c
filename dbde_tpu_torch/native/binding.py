"""ctypes binding for the native IO library, compiled on demand.

The port's own copy of :mod:`dbde_tpu.native.binding`.  The shared object
is built from ``dbde_io.cpp`` with g++ -O3 on first use into the package's
gitignored ``build/`` directory, beside the CUDA kernels' library (falling
back to a temp dir if the package is not writable).  Everything degrades
gracefully: if no compiler is available the callers fall back to the
pure-numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False


def _clamp_threads(threads: int) -> int:
    """Cap the native helpers' thread fan-out at the cores actually
    available — oversubscribed std::threads on a 1-core host are pure
    scheduling overhead on the memcpy loops."""
    try:
        avail = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        avail = os.cpu_count() or 1
    return max(1, min(int(threads), avail))

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dbde_io.cpp")
_PKG = os.path.dirname(_HERE)


def _build_dir() -> str:
    d = os.path.join(_PKG, "build")
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return tempfile.gettempdir()
    return d if os.access(d, os.W_OK) else tempfile.gettempdir()


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_build_dir(), f"libdbde_io_{tag}.so")


def _compile() -> str | None:
    """Build the library unless it exists → its path, or None.  Each builder
    writes a file of its own and renames it into place, so processes and
    threads that build at once never see a partial file; one whose build
    fails still loads the library that another built."""
    so = _so_path()
    if os.path.exists(so):
        return so
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(so) + ".", dir=os.path.dirname(so))
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.chmod(tmp, 0o755)  # mkstemp made it 0600
        os.replace(tmp, so)
    except (subprocess.SubprocessError, OSError):
        pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so if os.path.exists(so) else None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _compile()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        L = ctypes.c_long
        P8 = ctypes.POINTER(ctypes.c_uint8)
        lib.dbde_record_size.restype = L
        lib.dbde_record_size.argtypes = [P8, L, L, L]
        lib.dbde_scan_records.restype = L
        lib.dbde_scan_records.argtypes = [
            P8, L, L, L, L,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.dbde_gather_fields.restype = L
        lib.dbde_gather_fields.argtypes = [
            P8, L, ctypes.POINTER(ctypes.c_long), L, L,
            P8, P8, ctypes.POINTER(ctypes.c_uint32), L,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _buf_ptr(buf):
    """Zero-copy (pointer, length) for bytes/bytearray/memoryview."""
    arr = np.frombuffer(buf, np.uint8)
    return _p(arr, ctypes.c_uint8), arr.size, arr  # keep arr alive


def record_size(buf, offset: int, tiles: int) -> int:
    """Size of the validated record at ``offset`` (0 = corrupt/truncated)."""
    lib = get_lib()
    ptr, n_buf, _keep = _buf_ptr(buf)
    return lib.dbde_record_size(ptr, n_buf, offset, tiles)


def scan_records(buf: bytes, start: int, tiles: int, max_records: int):
    """→ (offsets list, sizes list) of validated sequential records."""
    lib = get_lib()
    ptr, n_buf, _keep = _buf_ptr(buf)
    offs = np.zeros(max_records, np.int64)
    sizes = np.zeros(max_records, np.int64)
    n = lib.dbde_scan_records(
        ptr, n_buf, start, tiles, max_records,
        _p(offs, ctypes.c_long), _p(sizes, ctypes.c_long),
    )
    return offs[:n].tolist(), sizes[:n].tolist()


def gather_fields(buf: bytes, data_offsets, tiles: int, payload_stride_words: int,
                  threads: int = 4, scratch: dict | None = None, out=None):
    """Batched parse of frame-data records → fixed-stride arrays.

    Returns (depths (B,T) u8, mins (B,T) u8, payload (B,S) u32, n64 (B,) i32).
    Raises ValueError on the first corrupt record (error parity with
    dbde_util.cpp:295-303).

    Pass a ``scratch`` dict (optionally with ``nslots``, default 2) to
    rotate the output arrays through a reused pool: skips the fresh-page
    fault cost of per-batch ``np.empty`` (~60% of parse time at 16×2048² —
    ROUND3_NOTES).  Arrays from a pooled call are overwritten again after
    ``nslots`` further calls; consumers must finish with them by then.

    Alternatively pass ``out`` — an explicit (depths, mins, payload, n64)
    tuple of exactly-shaped contiguous arrays to fill.  This is the hook
    for release-gated pools (stream._GatedPool), where slot lifetime is
    controlled by the consumer rather than a fixed rotation depth.
    """
    lib = get_lib()
    B = len(data_offsets)
    ptr, n_buf, _keep = _buf_ptr(buf)
    offs = np.asarray(data_offsets, np.int64)
    if out is not None:
        depths, mins, payload, n64s = out
        assert depths.shape == (B, tiles) and payload.shape == (B, payload_stride_words)
    elif scratch is not None:
        key = (B, tiles, payload_stride_words)
        if scratch.get("key") != key:
            scratch["key"], scratch["slots"], scratch["i"] = key, [], 0
        slots, i = scratch["slots"], scratch["i"]
        if len(slots) <= i:
            slots.append((np.empty((B, tiles), np.uint8),
                          np.empty((B, tiles), np.uint8),
                          np.empty((B, payload_stride_words), np.uint32),
                          np.empty((B,), np.int32)))
        depths, mins, payload, n64s = slots[i]
        scratch["i"] = (i + 1) % max(1, int(scratch.get("nslots", 2)))
    else:
        depths = np.empty((B, tiles), np.uint8)
        mins = np.empty((B, tiles), np.uint8)
        payload = np.empty((B, payload_stride_words), np.uint32)
        n64s = np.empty((B,), np.int32)
    bad = lib.dbde_gather_fields(
        ptr, n_buf, _p(offs, ctypes.c_long), B, tiles,
        _p(depths, ctypes.c_uint8), _p(mins, ctypes.c_uint8),
        _p(payload, ctypes.c_uint32), payload_stride_words,
        _p(n64s, ctypes.c_int32), _clamp_threads(threads),
    )
    if bad:
        raise ValueError(f"frame {bad - 1}: corrupt record")
    return depths, mins, payload, n64s
