"""Unique name generator (fluid python/paddle/v2/fluid/unique_name semantics)."""

import collections
import contextlib

_counters = collections.defaultdict(int)


def generate(prefix: str) -> str:
    _counters[prefix] += 1
    return f"{prefix}_{_counters[prefix] - 1}"


def reset():
    _counters.clear()


@contextlib.contextmanager
def guard():
    global _counters
    saved = _counters
    _counters = collections.defaultdict(int)
    try:
        yield
    finally:
        _counters = saved
