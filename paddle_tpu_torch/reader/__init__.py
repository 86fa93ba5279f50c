"""Reader composition library, the port's copy of ``paddle_tpu/reader``
(reference python/paddle/v2/reader/decorator.py:29-236: map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers).

A reader is a zero-arg callable returning an iterable of samples — the
reference's contract, so user data pipelines port unchanged."""

from .decorator import (  # noqa: F401
    batch,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    shuffle,
    xmap_readers,
)

from . import creator  # noqa: F401
