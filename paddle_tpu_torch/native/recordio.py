"""RecordIO chunked record files, the port of ``paddle_tpu/native/recordio.py``:
a ctypes binding over ``recordio.cc`` and a pure-Python codec that writes
the same bytes, its plain version.

Used as the dataset chunk format for the elastic master
(``distributed/master.py``), ``reader.creator.recordio`` and
``dataset.common.convert`` — the counterpart of the reference's RecordIO
dataset chunks (go/master/service.go partition :106).

The library builds with ``CXX`` (g++) at first use into
``paddle_tpu_torch/_build/librecordio_<hash>.so``, the hash taken over the
source and the compile command, so an edited source or another compiler
builds anew; it never builds next to its source.  A build or load failure
raises with the compiler's message.  ``use_native`` True (or None, the
JAX package's default) takes the library and nothing else; the Python
codec runs only for ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Iterator, List, Optional

from . import _cxx

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "recordio.cc")
_BUILD = _cxx.BUILD
_MAGIC = 0x52433130
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-lz"]

_dll = None
_lock = threading.Lock()


def library_path() -> str:
    return _cxx.hashed_path(_BUILD, "librecordio",
                            [CXX, *CXX_FLAGS, *LIBS], [_SRC])


def build_lib() -> str:
    """Compile the library unless the one for this source and command
    exists; returns its path.  Raises with the compiler's output."""
    so = library_path()
    if not os.path.exists(so):
        _cxx.compile_to("recordio", CXX, _SRC, so, CXX_FLAGS, LIBS)
    return so


def _lib():
    """The library, built and loaded on first call."""
    global _dll
    with _lock:
        if _dll is not None:
            return _dll
        dll = ctypes.CDLL(build_lib())
        dll.rio_writer_open.restype = ctypes.c_void_p
        dll.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        dll.rio_write.restype = ctypes.c_int
        dll.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
        dll.rio_writer_close.restype = ctypes.c_int
        dll.rio_writer_close.argtypes = [ctypes.c_void_p]
        dll.rio_reader_open.restype = ctypes.c_void_p
        dll.rio_reader_open.argtypes = [ctypes.c_char_p]
        dll.rio_read_next.restype = ctypes.c_int64
        dll.rio_read_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64,
                                      ctypes.POINTER(ctypes.c_uint64)]
        dll.rio_reader_close.restype = ctypes.c_int
        dll.rio_reader_close.argtypes = [ctypes.c_void_p]
        _dll = dll
        return dll


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _native(use_native: Optional[bool]):
    """The library for `use_native` True or None (raising if it cannot be
    had), None for False."""
    return None if use_native is False else _lib()


# ---------------------------------------------------------------------------


class Writer:
    def __init__(self, path: str, chunk_bytes: int = 1 << 20,
                 use_native: Optional[bool] = None):
        self.path = path
        self.chunk_bytes = chunk_bytes
        self._native = _native(use_native)
        if self._native is not None:
            self._h = self._native.rio_writer_open(
                path.encode(), ctypes.c_uint64(chunk_bytes))
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._f = open(path, "wb")
            self._buf = bytearray()
            self._nrec = 0

    def write(self, record: bytes):
        if self._native is not None:
            rc = self._native.rio_write(self._h, record, len(record))
            if rc != 0:
                raise IOError("rio_write failed")
            return
        # varint length prefix
        v = len(record)
        while v >= 0x80:
            self._buf.append((v & 0x7F) | 0x80)
            v >>= 7
        self._buf.append(v)
        self._buf.extend(record)
        self._nrec += 1
        if len(self._buf) >= self.chunk_bytes:
            self._flush()

    def _flush(self):
        if not self._nrec:
            return
        crc = zlib.crc32(bytes(self._buf)) & 0xFFFFFFFF
        self._f.write(struct.pack("<IIII", _MAGIC, self._nrec,
                                  len(self._buf), crc))
        self._f.write(self._buf)
        self._buf = bytearray()
        self._nrec = 0

    def close(self):
        if self._native is not None:
            if self._native.rio_writer_close(self._h) != 0:
                raise IOError("rio_writer_close failed")
            self._h = None
        else:
            self._flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_records(path: str, use_native: Optional[bool] = None
                 ) -> Iterator[bytes]:
    dll = _native(use_native)
    if dll is not None:
        h = dll.rio_reader_open(path.encode())
        if not h:
            raise IOError(f"cannot open {path}")
        try:
            cap = 1 << 16
            buf = ctypes.create_string_buffer(cap)
            need = ctypes.c_uint64()
            while True:
                n = dll.rio_read_next(h, buf, cap, ctypes.byref(need))
                if n == -2:  # end of file
                    return
                if n == -1:
                    if need.value > cap:
                        cap = int(need.value) * 2
                        buf = ctypes.create_string_buffer(cap)
                        continue
                    raise IOError(f"corrupt recordio file {path}")
                yield ctypes.string_at(buf, n)
        finally:
            dll.rio_reader_close(h)
        return
    # the Python codec
    with open(path, "rb") as f:
        while True:
            head = f.read(16)
            if len(head) < 16:
                return
            magic, nrec, dlen, crc = struct.unpack("<IIII", head)
            if magic != _MAGIC:
                raise IOError(f"bad magic in {path}")
            payload = f.read(dlen)
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise IOError(f"crc mismatch in {path}")
            pos = 0
            for _ in range(nrec):
                ln = 0
                shift = 0
                while True:
                    b = payload[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    if not (b & 0x80):
                        break
                    shift += 7
                yield payload[pos: pos + ln]
                pos += ln


def write_shards(samples: List[bytes], prefix: str, num_shards: int,
                 **kw) -> List[str]:
    """Partition samples round-robin into shard files (master task units)."""
    paths = [f"{prefix}-{i:05d}-of-{num_shards:05d}" for i in range(num_shards)]
    writers = [Writer(p, **kw) for p in paths]
    try:
        for i, s in enumerate(samples):
            writers[i % num_shards].write(s)
    finally:
        for w in writers:
            w.close()
    return paths


def recordio_reader(path_or_paths, deserialize=None):
    """Reader-contract adapter over recordio files."""
    paths = ([path_or_paths] if isinstance(path_or_paths, str)
             else list(path_or_paths))

    def reader():
        for p in paths:
            for rec in read_records(p):
                yield deserialize(rec) if deserialize else rec

    return reader
