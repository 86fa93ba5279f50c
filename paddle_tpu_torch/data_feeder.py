"""DataFeeder: minibatch (list of sample tuples) → executor feed dict, the
port's copy of ``paddle_tpu/data_feeder.py``.

Reference: python/paddle/v2/fluid/data_feeder.py + py_paddle
dataprovider_converter — dense slots stack to arrays, lod_level>0 slots
become padded arrays plus their ``@LENGTH`` companion (``lod.py``).

``DeviceFeeder`` converts the next batch on a background thread and puts
it on the device while the current step runs: on the card, from pinned
host memory on a stream of its own, the consumer's stream waiting on an
event recorded after the copy (``reader.decorator.stage``/``handoff``)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .framework.core import np_dtype
from .lod import LENGTH_SUFFIX, LoDTensor
from .reader.decorator import batch, handoff, produce, stage


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        from .framework.core import default_main_program

        self.program = program or default_main_program()
        block = self.program.global_block()
        self.vars = [
            block.var(v if isinstance(v, str) else v.name) for v in feed_list
        ]
        self.place = place

    def feed(self, minibatch: List[tuple]) -> Dict[str, object]:
        """minibatch: list of per-sample tuples aligned with feed_list."""
        out = {}
        cols = list(zip(*minibatch))
        if len(cols) != len(self.vars):
            raise ValueError(f"sample arity {len(cols)} != feed_list "
                             f"{len(self.vars)}")
        for var, col in zip(self.vars, cols):
            if var.lod_level > 0:
                seqs = [np.asarray(s).reshape(len(np.atleast_1d(s)), -1)
                        for s in col]
                lt = LoDTensor.from_sequences(seqs)
                padded, lengths = lt.to_padded(bucket=True)
                out[var.name] = padded.astype(np_dtype(var.dtype), copy=False)
                out[var.name + LENGTH_SUFFIX] = lengths
            else:
                arr = np.asarray(col)
                if arr.ndim == 1:
                    arr = arr[:, None]
                out[var.name] = arr.astype(np_dtype(var.dtype), copy=False)
        return out

    def feed_stacked(self, minibatches: List[List[tuple]]
                     ) -> Dict[str, object]:
        """K minibatches → one leading-stacked (K, batch, ...) feed
        block, the input contract of the fused K-step dispatch
        (``Executor.run(steps_per_dispatch=K)``,
        framework/step_loop.py).  Every minibatch must convert to the
        same per-step shapes — bucketed LoD padding can differ across
        steps, so pad ragged sequence batches identically (or keep
        lod feeds on the K=1 path)."""
        if not minibatches:
            raise ValueError("feed_stacked needs at least one minibatch")
        feeds = [self.feed(mb) for mb in minibatches]
        out = {}
        for k in feeds[0]:
            cols = [np.asarray(f[k]) for f in feeds]
            shapes = {c.shape for c in cols}
            if len(shapes) > 1:
                raise ValueError(
                    f"feed {k!r} shapes differ across the {len(feeds)} "
                    f"stacked steps ({sorted(shapes)}) — a scanned loop "
                    f"needs one static per-step shape")
            out[k] = np.stack(cols)
        return out


class DeviceFeeder:
    """Wraps a batched reader: converts batches and puts them on the
    device ahead of use.  The device is `device`, else the feeder's
    place's, else ``default_place()``'s (the card).  With ``steps=K``
    each yielded item is a leading-stacked (K, batch, ...) block of
    tensors ready for ``Executor.run(steps_per_dispatch=K)`` — a ragged
    final block keeps its short leading dim (run it with
    steps_per_dispatch=m).  Producer exceptions re-raise in the consumer;
    abandoning the iterator stops the thread
    (``reader.decorator.produce``)."""

    def __init__(self, feeder: DataFeeder, reader, device=None,
                 depth: int = 2, steps: int = 1):
        if steps < 1:
            raise ValueError(f"steps={steps} must be >= 1")
        self.feeder = feeder
        self.reader = reader
        self.depth = depth
        self.device = device
        self.steps = int(steps)

    def __iter__(self):
        if self.device is not None:
            device = torch.device(self.device)
        else:
            from .framework.place import default_place

            device = (self.feeder.place or default_place()).device
        stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

        def items():
            for group in batch(self.reader, self.steps)():
                feed = (self.feeder.feed(group[0]) if self.steps == 1
                        else self.feeder.feed_stacked(group))
                yield stage(feed, device, stream)

        for feed, event in produce(items, self.depth,
                                   "paddle-tpu-device-feeder"):
            yield handoff(feed, event, device)
