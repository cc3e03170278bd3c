"""Build the CUDA kernels with nvcc and load them with ctypes.

``csrc/dbde_kernels.cu`` (with ``csrc/dbde_tile.cuh``) compiles into
``dbde_tpu_torch/build/libdbde_tpu_torch_<sha12>.so``, where the tag hashes
the sources, so an edited kernel rebuilds and an unchanged one loads at
once.  The library has a plain C interface: no PyTorch headers, which keeps
the build to seconds.  Building needs the CUDA toolkit's ``nvcc`` (on
``PATH`` or under ``/usr/local/cuda/bin``) and happens at first use;
failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("dbde_kernels.cu", "dbde_tile.cuh")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdbde_tpu_torch_{h.hexdigest()[:12]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(ptxas_verbose: bool = False) -> tuple[str, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns (library path, compiler diagnostics; "" when nothing was
    built).  ``ptxas_verbose`` adds ``-Xptxas -v``: registers, shared
    memory and spills per kernel.
    """
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
           "-o", tmp, os.path.join(CSRC, "dbde_kernels.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    return path, proc.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            P, I = ctypes.c_void_p, ctypes.c_int
            signatures = {
                "dbde_encode_depths": [P, P, P, I, I, I, I, P],
                "dbde_encode_payload": [P, P, P, P, P, I, I, I, I, I, P],
                "dbde_decode": [P, P, P, P, P, I, I, I, I, I, P],
                "dbde_encode_payload_u8": [P, P, P, I, I, I, I, I, I, P],
                "dbde_decode_u8": [P, P, P, I, I, I, I, I, I, P],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, I
            lib.dbde_error_string.argtypes = [I]
            lib.dbde_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
