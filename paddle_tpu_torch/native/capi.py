"""Build + ctypes binding for the C inference API (``capi.cc``), the port
of ``paddle_tpu/native/capi.py``.

Two consumption modes:
- in-process: load ``libpaddle_capi`` into this interpreter through ctypes;
  the embedded-Python calls resolve into the running interpreter;
- standalone: a C program links the library, calls ``paddle_capi_init()``
  and runs inference with no Python code of its own (the reference capi's
  deployment story, capi/examples/model_inference; ``capi_demo.c``,
  built by ``build_demo``).

The library builds with ``CXX`` at first use into
``paddle_tpu_torch/_build/libpaddle_capi_<hash>.so`` (the hash over
``capi.cc``, ``capi.h`` and the command; atomic publish), and a failed
build raises with the compiler's output; ``load`` raises where the JAX
package's returns None.  The library links libpython (a shared library
on the machines the port runs on, ``Py_ENABLE_SHARED``).  A standalone
program reaches this package and torch through ``PYTHONPATH``
(``embed_env``).  Its engines run on the card unless
``PADDLE_TPU_TORCH_CAPI_PLACE=cpu`` (``capi_runtime``)."""

from __future__ import annotations

import ctypes
import os
import sys
import sysconfig
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..capi_runtime import _DTYPE_CODES as DTYPE_CODES  # noqa: E402
from ..capi_runtime import _DTYPES as CODE_DTYPES  # noqa: E402
from . import _cxx

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "capi.cc")
_HDR = os.path.join(_HERE, "capi.h")
DEMO_SRC = os.path.join(_HERE, "capi_demo.c")
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_dll = None
_lock = threading.Lock()


def python_build_flags() -> Tuple[List[str], List[str]]:
    """(include_flags, link_flags) for embedding this interpreter."""
    inc = [f"-I{sysconfig.get_path('include')}"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    link = [f"-L{libdir}"] if libdir else []
    link.append(f"-lpython{ver}")
    return inc, link


def library_path() -> str:
    inc, link = python_build_flags()
    return _cxx.hashed_path(_cxx.BUILD, "libpaddle_capi",
                            [CXX, *CXX_FLAGS, *inc, *link], [_SRC, _HDR])


def build_lib() -> str:
    """Compile the library unless the one for this source and command
    exists; returns its path.  Raises with the compiler's output."""
    so = library_path()
    if not os.path.exists(so):
        inc, link = python_build_flags()
        _cxx.compile_to(
            "capi", CXX, _SRC, so,
            [*CXX_FLAGS, f"-Wl,-soname,{os.path.basename(so)}", *inc],
            link)
    return so


def build_demo(src: str = DEMO_SRC, out: Optional[str] = None) -> str:
    """A C program (``capi_demo.c`` by default) compiled against
    ``capi.h`` and linked to the library (rpath to ``_build/``); returns
    the executable's path.  Raises with the compiler's output."""
    lib = build_lib()
    flags = ["-O2", f"-I{_HERE}", f"-Wl,-rpath,{os.path.dirname(lib)}"]
    if out is None:
        out = _cxx.hashed_path(_cxx.BUILD, "capi_demo", [CXX, *flags, lib],
                               [src, _HDR], suffix="")
    if not os.path.exists(out):
        _cxx.compile_to("capi demo", CXX, src, out, flags, [lib])
    return out


def embed_env(env=None) -> dict:
    """`env` (os.environ by default) with PYTHONPATH set to this
    interpreter's sys.path, so an embedded interpreter finds this package
    and torch wherever they are installed."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    return env


def load() -> ctypes.CDLL:
    """The library, built and loaded on first call."""
    global _dll
    with _lock:
        if _dll is not None:
            return _dll
        dll = ctypes.CDLL(build_lib())
        i64, i32, vp, cp = (ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_char_p)
        dll.paddle_capi_init.restype = i32
        dll.paddle_capi_init.argtypes = [cp]
        dll.paddle_capi_shutdown.restype = i32
        dll.paddle_capi_shutdown.argtypes = []
        dll.paddle_capi_last_error.restype = cp
        dll.paddle_capi_last_error.argtypes = []
        dll.paddle_inference_create.restype = i32
        dll.paddle_inference_create.argtypes = [cp, ctypes.POINTER(i64)]
        dll.paddle_inference_set_input.restype = i32
        dll.paddle_inference_set_input.argtypes = [
            i64, cp, vp, ctypes.POINTER(i64), i32, i32]
        dll.paddle_inference_run.restype = i32
        dll.paddle_inference_run.argtypes = [i64, ctypes.POINTER(i32)]
        dll.paddle_inference_output_shape.restype = i32
        dll.paddle_inference_output_shape.argtypes = [
            i64, i32, ctypes.POINTER(i64), i32, ctypes.POINTER(i32)]
        dll.paddle_inference_output_dtype.restype = i32
        dll.paddle_inference_output_dtype.argtypes = [i64, i32,
                                                      ctypes.POINTER(i32)]
        dll.paddle_inference_output_data.restype = i64
        dll.paddle_inference_output_data.argtypes = [i64, i32, vp, i64]
        dll.paddle_inference_release.restype = i32
        dll.paddle_inference_release.argtypes = [i64]
        _dll = dll
        return dll


class InferenceEngine:
    """Pythonic shim over the C ABI (mirrors capi/examples usage).  Every
    failing call raises RuntimeError with the library's last error (the
    JAX shim reads an output whose dtype has no code as float32)."""

    def __init__(self, model_dir: str):
        self._dll = load()
        self._h = 0
        self._check(self._dll.paddle_capi_init(None))
        h = ctypes.c_int64()
        self._check(self._dll.paddle_inference_create(model_dir.encode(),
                                                      ctypes.byref(h)))
        self._h = h.value

    def _check(self, rc):
        if rc < 0:
            raise RuntimeError(self._dll.paddle_capi_last_error().decode())
        return rc

    def run(self, feeds: dict) -> List[np.ndarray]:
        dll = self._dll
        for name, arr in feeds.items():
            arr = np.ascontiguousarray(arr)
            code = DTYPE_CODES[arr.dtype]
            shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            self._check(dll.paddle_inference_set_input(
                self._h, name.encode(),
                arr.ctypes.data_as(ctypes.c_void_p), shape, arr.ndim, code))
        n = ctypes.c_int()
        self._check(dll.paddle_inference_run(self._h, ctypes.byref(n)))
        outs = []
        for i in range(n.value):
            shape = (ctypes.c_int64 * 16)()
            rank = ctypes.c_int()
            self._check(dll.paddle_inference_output_shape(
                self._h, i, shape, 16, ctypes.byref(rank)))
            dcode = ctypes.c_int()
            self._check(dll.paddle_inference_output_dtype(
                self._h, i, ctypes.byref(dcode)))
            buf = np.empty([shape[j] for j in range(rank.value)],
                           dtype=CODE_DTYPES[dcode.value])
            self._check(dll.paddle_inference_output_data(
                self._h, i, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes))
            outs.append(buf)
        return outs

    def close(self):
        if self._h:
            self._dll.paddle_inference_release(self._h)
            self._h = 0
