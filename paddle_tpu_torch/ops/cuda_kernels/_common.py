"""Build, load and call the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` — one
process per ``.cu`` file, all started together — and linked into one
shared library under ``paddle_tpu_torch/_build/``.  The library's name
carries a hash of the sources and flags, so an edited source rebuilds.
The build runs at the first CUDA use (never at import), and a failed build
raises with nvcc's output.  The library exposes a plain C interface that
is called through ``ctypes``: every pointer and the stream travel as
``c_void_p``, and every entry point returns a ``cudaError_t``, which
``launch`` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types after the kernel's own, (dtype, stream)
# close every launch
_SIGNATURES = {
    "ptt_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "ptt_paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _I, _P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built from source at first use")
    return path


def sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libptt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile and link the kernels unless the library for these sources
    exists; returns its path.  nvcc's output (ptxas register and
    shared-memory reports included) is kept beside it as ``.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=_BUILD)
    try:
        cus = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(work, os.path.basename(s) + ".o") for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cus, objs)]
        logs = []
        failed = []
        for src, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode:
                failed.append(f"nvcc failed on {src}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_so = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", *objs, "-o", tmp_so],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        with open(so[:-3] + ".log", "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def launch(name: str, *args, device: torch.device):
    """Call C entry point `name` with `args` (tensors pass their data
    pointer), then PyTorch's current stream on `device`.  The device is
    current for the call only, so the caller's choice survives it.
    Raises if the launch was refused."""
    lib = load()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} failed: {lib.ptt_error_string(rc).decode()} ({rc})")
