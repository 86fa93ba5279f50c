"""Reader creators, the port's copy of ``paddle_tpu/reader/creator.py``
(reference python/paddle/v2/reader/creator.py): np_array and text_file.
``recordio`` needs the native RecordIO reader, which is not ported."""

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
    """Creator over RecordIO file(s) (reference creator.py:57): it reads
    through the JAX package's ``native/`` RecordIO reader, which the port
    does not have."""
    raise NotImplementedError(
        "reader.creator.recordio: the native RecordIO reader (native/) is "
        "not ported (ROADMAP.md Queue A item 12)")
