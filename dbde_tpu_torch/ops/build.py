"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` (with the headers ``csrc/*.cuh``) compiles into
``dbde_tpu_torch/build/libdbde_tpu_torch_<sha12>.so``, where the tag hashes
the sources, so an edited kernel rebuilds and an unchanged one loads at
once.  Each source compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects.  The library has a plain
C interface: no PyTorch headers, which keeps the build to seconds.
Building needs the CUDA toolkit's ``nvcc`` (on ``PATH`` or under
``/usr/local/cuda/bin``) and happens at first use; failure raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    """The kernel sources (``*.cu``), each compiled on its own."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
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
    nvcc = _nvcc()
    stem = f"{path}.{os.getpid()}"
    srcs, objects, procs = sources(), [], []
    for src in srcs:
        obj = f"{stem}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-c", "-o", obj, src]
        objects.append(obj)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    log, failed = [], []
    for src, proc in zip(srcs, procs):
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        log.append(err)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{stem}.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True, timeout=600)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    return path, "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            P, I = ctypes.c_void_p, ctypes.c_int
            signatures = {
                "dbde_encode_depths": [P, P, P, P, I, I, I, I, P],
                "dbde_encode_payload": [P, P, P, P, P, P, I, I, I, I, I, P],
                "dbde_decode": [P, P, P, P, P, I, I, I, I, I, P],
                "dbde_encode_payload_u8": [P, P, P, P, P, I, I, I, I, I, I, P],
                "dbde_decode_u8": [P, P, P, P, I, I, I, I, I, I, P],
                "dbde_encode_tiles": [P, P, P, P, P, P, I, I, I, I, P],
                "dbde_decode_tiles": [P, P, P, P, I, I, I, I, P],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, I
            lib.dbde_current_device.argtypes, lib.dbde_current_device.restype = [], I
            lib.dbde_error_string.argtypes = [I]
            lib.dbde_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
