"""ctypes binding over the native Program IR library (``program_desc.cc``),
the port of ``paddle_tpu/native/program_desc.py``: validate, prune, stats
and a text dump of serialized ProgramDef bytes, with the same C ABI and
the same outputs as the JAX package's library (counterpart of the
reference's C++ desc + prune layer, paddle/framework/program_desc.cc,
prune.cc).

The JAX package's library is built from protoc's classes and links
libprotobuf, and falls back to Python when that toolchain is missing.
``program_desc.cc`` has its own proto2 codec and needs only ``CXX``
(g++): it builds at first use into
``paddle_tpu_torch/_build/libprogram_desc_<hash>.so``, the hash taken over
the source and the compile command, published by an atomic rename, and a
failed build raises with the compiler's output.  There is no fallback: a
call that cannot have the library raises, and bytes that do not parse
make ``prune``, ``stats`` and ``text_dump`` raise ``ValueError`` (the JAX
library's binding returns None there)."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

from . import _cxx

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "program_desc.cc")
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_dll = None
_lock = threading.Lock()


def library_path() -> str:
    return _cxx.hashed_path(_cxx.BUILD, "libprogram_desc",
                            [CXX, *CXX_FLAGS], [_SRC])


def build_lib() -> str:
    """Compile the library unless the one for this source and command
    exists; returns its path.  Raises with the compiler's output."""
    so = library_path()
    if not os.path.exists(so):
        _cxx.compile_to("program_desc", CXX, _SRC, so, CXX_FLAGS)
    return so


def _lib():
    """The library, built and loaded on first call."""
    global _dll
    with _lock:
        if _dll is not None:
            return _dll
        dll = ctypes.CDLL(build_lib())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        vpp = ctypes.POINTER(ctypes.c_void_p)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        dll.pt_desc_free.restype = None
        dll.pt_desc_free.argtypes = [ctypes.c_void_p]
        dll.pt_desc_validate.restype = ctypes.c_int
        dll.pt_desc_validate.argtypes = [u8p, ctypes.c_uint64, vpp]
        dll.pt_desc_prune.restype = ctypes.c_int
        dll.pt_desc_prune.argtypes = [u8p, ctypes.c_uint64, ctypes.c_char_p,
                                      vpp, u64p]
        dll.pt_desc_stats.restype = ctypes.c_int
        dll.pt_desc_stats.argtypes = [u8p, ctypes.c_uint64, vpp]
        dll.pt_desc_text.restype = ctypes.c_int
        dll.pt_desc_text.argtypes = [u8p, ctypes.c_uint64, vpp, u64p]
        _dll = dll
        return dll


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _as_u8(data: bytes):
    """(pointer, buffer): keep the buffer alive while the pointer is used."""
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), buf


def _take(dll, ptr: ctypes.c_void_p, length=None) -> bytes:
    if not ptr.value:
        return b""
    raw = ctypes.string_at(ptr.value, length) if length is not None \
        else ctypes.string_at(ptr.value)
    dll.pt_desc_free(ptr)
    return raw


def _bad_bytes(what: str):
    return ValueError(f"program_desc.{what}: bad ProgramDef bytes")


def validate(program_bytes: bytes) -> Tuple[bool, str]:
    """(ok, diagnostics): the structural check of a serialized program."""
    dll = _lib()
    p, keep = _as_u8(program_bytes)
    diag = ctypes.c_void_p()
    rc = dll.pt_desc_validate(p, len(program_bytes), ctypes.byref(diag))
    return rc == 0, _take(dll, diag).decode("utf-8", errors="replace")


def prune(program_bytes: bytes, targets: List[str]) -> bytes:
    """Backward-reachability prune to `targets`: the pruned program's
    bytes."""
    dll = _lib()
    p, keep = _as_u8(program_bytes)
    out = ctypes.c_void_p()
    out_len = ctypes.c_uint64()
    if dll.pt_desc_prune(p, len(program_bytes),
                         "\n".join(targets).encode(),
                         ctypes.byref(out), ctypes.byref(out_len)) != 0:
        raise _bad_bytes("prune")
    return _take(dll, out, out_len.value)


def stats(program_bytes: bytes) -> str:
    """One JSON line of program stats."""
    dll = _lib()
    p, keep = _as_u8(program_bytes)
    out = ctypes.c_void_p()
    if dll.pt_desc_stats(p, len(program_bytes), ctypes.byref(out)) != 0:
        raise _bad_bytes("stats")
    return _take(dll, out).decode("utf-8", errors="replace")


def text_dump(program_bytes: bytes) -> str:
    """The program as protobuf's C++ ``DebugString`` prints it."""
    dll = _lib()
    p, keep = _as_u8(program_bytes)
    out = ctypes.c_void_p()
    out_len = ctypes.c_uint64()
    if dll.pt_desc_text(p, len(program_bytes), ctypes.byref(out),
                        ctypes.byref(out_len)) != 0:
        raise _bad_bytes("text_dump")
    return _take(dll, out, out_len.value).decode("utf-8", errors="replace")
