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
# close every launch; ``ptt_{lstm,gru}_capacity``, ``_smem_bytes`` and
# ``_device_launches`` are queries (no stream, see ``query``)
_SIGNATURES = {
    "ptt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                _P],
    "ptt_flash_attention_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _I, _P],
    "ptt_flash_attention_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _F, _I, _P],
    "ptt_paged_attention_fwd": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    "ptt_paged_attention_mq_fwd": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
    "ptt_lstm_forward": [_P] * 12 + [_I] * 5 + [_P],
    "ptt_lstm_backward": [_P] * 15 + [_I] * 5 + [_P],
    "ptt_lstm_capacity": [_I] * 3 + [ctypes.POINTER(_I)],
    "ptt_lstm_smem_bytes": [_I] * 3 + [ctypes.POINTER(_I)],
    "ptt_lstm_device_launches": [_I, ctypes.POINTER(_I)],
    "ptt_gru_forward": [_P] * 12 + [_I] * 5 + [_P],
    "ptt_gru_backward": [_P] * 15 + [_I] * 5 + [_P],
    "ptt_gru_capacity": [_I] * 3 + [ctypes.POINTER(_I)],
    "ptt_gru_smem_bytes": [_I] * 3 + [ctypes.POINTER(_I)],
    "ptt_gru_device_launches": [_I, ctypes.POINTER(_I)],
    "ptt_bn_matmul_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "ptt_bn_matmul_bwd": [_P] * 12 + [_I] * 7 + [_P],
    "ptt_bn_conv3x3_fwd": [_P] * 6 + [_I] * 8 + [_P],
    "ptt_bn_conv3x3_fwd_v2": [_P] * 6 + [_I] * 9 + [_P],
    "ptt_bn_conv3x3_bwd": [_P] * 13 + [_I] * 10 + [_P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# devices whose tensors take a kernel's plain version: the CPU, and the
# meta device of the analysis tier's shape oracle (shapes only: nothing
# is computed there); a CUDA tensor launches the kernel or raises
PLAIN_DEVICES = ("cpu", "meta")

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


def dtype_code(t) -> int:
    """The C code of a tensor's dtype, or of a dtype."""
    dt = t.dtype if isinstance(t, torch.Tensor) else t
    if dt not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dt}")
    return _DTYPE_CODES[dt]


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


def query(name: str, *args, device: torch.device) -> int:
    """Call C query `name` with `args` and a pointer to one int on
    `device` (current for the call only); returns that int.  Raises as
    ``launch`` does."""
    lib = load()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(
            f"{name} failed: {lib.ptt_error_string(rc).decode()} ({rc})")
    return out.value
