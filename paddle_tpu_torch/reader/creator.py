"""Reader creators, the port's copy of ``paddle_tpu/reader/creator.py``
(reference python/paddle/v2/reader/creator.py): np_array, text_file and
recordio (over ``native/recordio.py``)."""

from __future__ import annotations


def np_array(x):
    """Creator over a numpy array's first axis (reference creator.py:24)."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Creator yielding stripped lines (reference creator.py:38)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.strip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Creator over RecordIO file(s) (reference creator.py:57) — the native
    chunked CRC format via paddle_tpu_torch.native.recordio.  Accepts a
    list, a comma-separated string, and glob patterns (shard sets); records
    stream through a background read-ahead buffer of `buf_size`."""
    import glob as _glob

    from ..native.recordio import recordio_reader
    from .decorator import buffered

    if isinstance(paths, str):
        paths = paths.split(",")
    expanded = []
    for p in paths:
        hits = sorted(_glob.glob(p))
        expanded.extend(hits if hits else [p])
    return buffered(recordio_reader(expanded), buf_size)
