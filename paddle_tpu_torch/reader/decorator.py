"""Reader decorators, the port's copy of ``paddle_tpu/reader/decorator.py``
(reference v2/reader/decorator.py).

A reader is a zero-arg callable returning an iterable of samples.  Only
``prefetch`` differs from the JAX package: its ``to_device`` puts each
block on a torch device, the card unless the caller passes a CPU place,
copying from pinned host memory on a stream of its own
(``stage``/``handoff``, which ``data_feeder.DeviceFeeder`` shares)."""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading

import numpy as np
import torch


def map_readers(func, *readers):
    """Apply func to samples zipped from readers (decorator.py:29)."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size, seed=None):
    """Pool-shuffle with a bounded buffer (decorator.py:64)."""

    def reader_():
        rng = _random.Random(seed)
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return reader_


def chain(*readers):
    """Concatenate readers (decorator.py:94)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into tuple samples (decorator.py:124)."""

    def _flatten(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for items in zip(*rs):
                yield sum((_flatten(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*rs):
                yield sum((_flatten(i) for i in items if i is not None), ())

    return reader


def buffered(reader, size):
    """Producer-thread read-ahead (decorator.py:169).  An exception in the
    producer re-raises in the consumer (``produce``): a corrupt RecordIO
    shard behind ``creator.recordio`` fails the read instead of ending the
    stream early, as the JAX package's ``buffered`` does."""

    def reader_():
        return produce(reader, size, "buffered")

    return reader_


def produce(items, depth, name):
    """Iterate `items()` on a producer thread, at most `depth` ahead.

    The contract of ``prefetch`` and ``DeviceFeeder``: order is kept; an
    exception in the producer re-raises in the consumer where it
    occurred; abandoning the iterator (``close()``/GeneratorExit) stops
    the producer promptly even when it waits on a full queue."""
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(msg):
        # timeout-loop put: a producer stuck on a full queue still
        # notices the consumer left (stop set) and exits
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in items():
                if not _put(("block", item)):
                    return
            _put(("end", None))
        except BaseException as e:  # noqa: BLE001 — relayed whole
            _put(("error", e))

    t = threading.Thread(target=producer, daemon=True, name=name)
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                return
            if kind == "error":
                raise payload
            yield payload
    finally:
        stop.set()
        try:  # unblock a producer mid-put immediately
            q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5)


def _map(item, fn):
    if isinstance(item, dict):
        return {k: fn(v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(fn(v) for v in item)
    return fn(item)


def _tensors(item):
    if isinstance(item, dict):
        return list(item.values())
    if isinstance(item, (tuple, list)):
        return list(item)
    return [item]


def stage(item, device, stream=None):
    """`item` (a dict, tuple or list of arrays, or one array) as torch
    tensors on `device`; returns (item, event).  On the card each array is
    copied from pinned host memory with ``non_blocking=True`` on `stream`,
    and `event` is recorded after the copies; on the CPU it is None."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.ascontiguousarray(v))

    if device.type != "cuda":
        return _map(item, host), None
    with torch.cuda.stream(stream):
        out = _map(item, lambda v: host(v).pin_memory().to(
            device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def handoff(item, event, device):
    """Hand a staged item to the consumer: its current stream waits on the
    copies' `event`, and each tensor is recorded on that stream, so the
    allocator does not reuse its memory while the consumer's work is
    queued."""
    if event is None:
        return item
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    for t in _tensors(item):
        t.record_stream(cur)
    return item


def prefetch(reader, depth=2, steps=1, to_device=True, place=None):
    """Double-buffered input pipeline for the fused K-step dispatch
    (``Executor.run(steps_per_dispatch=K)``, framework/step_loop.py).

    A producer thread pulls per-step items from `reader` (feed dicts,
    tuples/lists of arrays, or bare arrays), stacks every `steps`
    consecutive items on a NEW leading axis (the loop's (K, ...) feed
    contract), and — with `to_device` — puts the block on the device of
    `place` (``default_place()``, the card, when None) from pinned memory
    on its own stream, so the copy of block N+1 overlaps the device
    running block N.  With ``steps=1`` items pass through unstacked.

    Arrays are transferred AS-IS — cast to the program's feed dtypes
    before this decorator (DataFeeder already does).

    Contract (``produce``): ordering preserved, exactly ceil(n/steps)
    blocks for n items; a ragged final block keeps its short leading dim
    m < steps — run it with ``steps_per_dispatch=m``; a reader exception
    re-raises in the consumer; abandoning the iterator stops the
    producer."""
    if depth < 1:
        raise ValueError(f"prefetch depth={depth} must be >= 1")
    if steps < 1:
        raise ValueError(f"prefetch steps={steps} must be >= 1")

    def _stack(vals):
        return np.stack([np.asarray(v) for v in vals])

    def _combine(block):
        first = block[0]
        if isinstance(first, dict):
            return {k: _stack([b[k] for b in block]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(_stack(col) for col in zip(*block))
        return _stack(block)

    def reader_():
        device = stream = None
        if to_device:
            from ..framework.place import default_place

            device = (place or default_place()).device
            if device.type == "cuda":
                stream = torch.cuda.Stream(device)

        def items():
            for block in batch(reader, steps)():
                item = _combine(block) if steps > 1 else block[0]
                yield stage(item, device, stream) if to_device \
                    else (item, None)

        for item, event in produce(items, depth, "paddle-tpu-prefetch"):
            yield handoff(item, event, device)

    return reader_


def firstn(reader, n):
    """Take first n samples (decorator.py:208)."""

    def reader_():
        return itertools.islice(reader(), n)

    return reader_


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads (decorator.py:236)."""

    end = object()

    def reader_():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feeder():
            for i, s in enumerate(reader()):
                in_q.put((i, s))
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, s = item
                out_q.put((i, mapper(s)))

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
                continue
            pending[item[0]] = item[1]
            while next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1
        if order:
            for i in sorted(pending):
                yield pending[i]

    return reader_


def cache(reader):
    """Materialize once, replay thereafter."""
    done = []
    loaded = [False]

    def reader_():
        if not loaded[0]:
            for s in reader():
                done.append(s)
                yield s
            loaded[0] = True
        else:
            yield from done

    return reader_


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists (v2/minibatch.py)."""

    def reader_():
        b = []
        for s in reader():
            b.append(s)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return reader_
