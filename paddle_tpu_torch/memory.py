"""Memory accounting + host staging (reference paddle/memory/) — the port
of ``paddle_tpu/memory.py``.

- ``used/peak/total/available(place)`` — for a ``CUDAPlace``, the caching
  allocator's live and peak bytes (``torch.cuda.memory_allocated``,
  ``max_memory_allocated``) and the card's capacity and free bytes
  (``torch.cuda.mem_get_info``); for a ``CPUPlace``, a process-side
  ledger of the tensors handed out by :func:`alloc` (total 0: the host
  hides nothing the JAX package's CPU backend reports either).
- ``memory_stats(place)`` — the raw stats dict (``torch.cuda.memory_stats``
  on the card, {} on the CPU).
- ``Copy`` / :class:`HostStaging` — the memcpy.h equivalent: explicit
  cross-place copies and a reusable staging buffer pool for feeds.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

import numpy as np

from .framework.place import Place, default_place

_lock = threading.Lock()
# place-key → bytes handed out via alloc() (the CPU's accounting)
_ledger: Dict[str, int] = {}
_peak: Dict[str, int] = {}
# id(tensor) → weakref.finalize decrementing the ledger; fires on GC or
# on an explicit free(), whichever comes first
_finalizers: Dict[int, object] = {}


def _dec(key: str, nbytes: int, ident: int) -> None:
    with _lock:
        _ledger[key] = max(_ledger.get(key, 0) - nbytes, 0)
        _finalizers.pop(ident, None)


def _key(place: Place) -> str:
    return repr(place)


def _place(place: Optional[Place]) -> Place:
    return place if place is not None else default_place()


def _on_card(place: Place) -> bool:
    return place.device.type == "cuda"


def memory_stats(place: Optional[Place] = None) -> dict:
    """The caching allocator's stats for the place's card ({} on the
    CPU)."""
    place = _place(place)
    if not _on_card(place):
        return {}
    import torch

    return dict(torch.cuda.memory_stats(place.device))


def used(place: Optional[Place] = None) -> int:
    """Bytes currently in use on `place` (memory::Used equivalent)."""
    place = _place(place)
    if _on_card(place):
        import torch

        return int(torch.cuda.memory_allocated(place.device))
    with _lock:
        return _ledger.get(_key(place), 0)


def peak(place: Optional[Place] = None) -> int:
    place = _place(place)
    if _on_card(place):
        import torch

        return int(torch.cuda.max_memory_allocated(place.device))
    with _lock:
        return _peak.get(_key(place), 0)


def total(place: Optional[Place] = None) -> int:
    """Byte capacity of the place (the card's memory; 0 on the CPU)."""
    place = _place(place)
    if not _on_card(place):
        return 0
    import torch

    return int(torch.cuda.mem_get_info(place.device)[1])


def available(place: Optional[Place] = None) -> int:
    """Free bytes on the card (0 on the CPU)."""
    place = _place(place)
    if not _on_card(place):
        return 0
    import torch

    return int(torch.cuda.mem_get_info(place.device)[0])


def alloc(shape, dtype="float32", place: Optional[Place] = None):
    """Allocate a zeroed tensor on `place` and account for it
    (memory::Alloc); pair with :func:`free`."""
    import torch

    from .framework.core import torch_dtype

    place = _place(place)
    t = torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                    device=place.device)
    nbytes = int(t.numel() * t.element_size())
    with _lock:
        k = _key(place)
        _ledger[k] = _ledger.get(k, 0) + nbytes
        _peak[k] = max(_peak.get(k, 0), _ledger[k])
        _finalizers[id(t)] = weakref.finalize(t, _dec, k, nbytes, id(t))
    return t


def free(arr) -> None:
    """Release a tensor obtained from :func:`alloc` (memory::Free); one
    dropped without free() is reclaimed by its GC finalizer."""
    fin = _finalizers.get(id(arr))
    if fin is not None:
        fin()


def Copy(dst_place: Place, src, src_place: Optional[Place] = None):
    """Explicit cross-place copy (memcpy.h `Copy<Dst,Src>`): a tensor on
    `dst_place`."""
    import torch

    t = src if isinstance(src, torch.Tensor) else torch.as_tensor(
        np.asarray(src))
    return t.to(_place(dst_place).device, copy=True)


class HostStaging:
    """Reusable host staging buffers for feed paths (the pinned-memory
    CPUAllocator idea): one buffer per (slot, shape, dtype), reused across
    steps so feeding doesn't reallocate host memory every batch.  Keyed by
    the feed slot name — two same-shaped slots must never alias."""

    def __init__(self):
        self._buffers: Dict[tuple, np.ndarray] = {}

    def stage(self, name: str, value) -> np.ndarray:
        a = np.asarray(value)
        key = (name, a.shape, a.dtype.str)
        buf = self._buffers.get(key)
        if buf is None:
            buf = np.empty(a.shape, a.dtype)
            self._buffers[key] = buf
        np.copyto(buf, a)
        return buf

    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._buffers.values())

    def clear(self) -> None:
        self._buffers.clear()
