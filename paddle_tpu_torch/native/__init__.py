"""Native (C++) host-runtime components, the port's copy of
``paddle_tpu/native/``: ``recordio`` (chunked, CRC-checked record files),
``program_desc`` (validate, prune, stats and the text dump of serialized
programs, with its own proto2 codec) and ``capi`` (the C inference API
over an embedded interpreter).

Each library builds with g++ at first use into ``paddle_tpu_torch/_build/``
and binds through ctypes.  A failed build raises with the compiler's
output.  Only RecordIO has a pure-Python codec, which writes the same
bytes and runs only when the caller asks for it (``use_native=False``)."""

from . import capi  # noqa: F401
from . import program_desc  # noqa: F401
from . import recordio  # noqa: F401
