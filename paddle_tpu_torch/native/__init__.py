"""Native (C++) host-runtime components, the port's copy of
``paddle_tpu/native/``: ``recordio`` (chunked, CRC-checked record files).

The library builds with g++ at first use into ``paddle_tpu_torch/_build/``
and binds through ctypes.  A failed build raises with the compiler's
output; the pure-Python codec, which writes the same bytes, runs only when
the caller asks for it (``use_native=False``).  ``program_desc`` and
``capi`` are not ported (ROADMAP.md Queue A item 12)."""

from . import recordio  # noqa: F401
