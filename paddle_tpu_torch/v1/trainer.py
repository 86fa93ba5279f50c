"""v1 trainer loop: drive a v1 config + @provider data sources — the port
of ``paddle_tpu/v1/trainer.py``.

The reference's `paddle train --config=conf.py` flow (trainer/Trainer.cpp
over TrainerConfig): the config declares data sources
(define_py_data_sources2), topology (v1 layers ending in a cost), and
settings(); the trainer then runs `num_passes` over the provider.  Here the
config uses the same v1 functions, the executor runs the cost's Program op
by op, and this loop pulls batched feeds from the registered DataProvider.
It runs on the card (``default_place()``) unless the caller passes a
place."""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

import numpy as np

from .data_provider import get_data_source
from .optimizers import optimizer_from_settings, settings_dict


class V1Trainer:
    """Train a v1-config cost with the registered @provider data source.

    cost: the v1 cost LayerOutput (or fluid Variable).
    batch_size: overrides settings(batch_size=...) when given.
    place: where the executor runs; None is ``default_place()``, the card.
    feed_order: data_layer names per slot, required only when the provider
    declares list-style input_types (dict input_types feed by key)."""

    def __init__(self, cost, batch_size: Optional[int] = None, place=None,
                 feed_order=None):
        from .. import Executor, default_main_program, default_startup_program
        from ..framework.place import default_place

        self.cost_var = getattr(cost, "var", cost)
        self.feed_order = list(feed_order) if feed_order else None
        conf = settings_dict()
        self.batch_size = int(batch_size or conf.get("batch_size") or 32)
        # eval-mode clone BEFORE optimizer ops exist: test() must not touch
        # parameters
        self.test_program = default_main_program().clone(for_test=True)
        optimizer_from_settings().minimize(self.cost_var)
        # settings(average_window=...) parity (reference AverageOptimizer:
        # train accumulates window sums in-graph; test() evaluates on the
        # averaged parameters)
        self.model_average = None
        if conf.get("average_window"):
            from ..optimizer import ModelAverage

            self.model_average = ModelAverage(
                average_window_rate=float(conf["average_window"]),
                max_average_window=int(conf.get("max_average_window")
                                       or 10000))
        self.place = place if place is not None else default_place()
        self.exe = Executor(self.place)
        self.exe.run(default_startup_program())

    def _source(self, kind):
        prov, files = get_data_source(kind)
        if prov is None:
            raise RuntimeError(
                f"no {kind} data source — call define_py_data_sources2 in "
                f"the config first")
        return prov, files

    def train(self, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              start_pass: int = 0):
        """Run `num_passes` over the registered train source; returns the
        per-pass mean losses.  event_handler(pass_id, batch_id, loss) is
        called per batch.  start_pass offsets the pass ids (and therefore
        the provider shuffle seeds): a caller driving one pass at a time
        (the CLI's --save-dir loop) keeps the per-pass shuffling of a
        single num_passes=N call."""
        prov, files = self._source("train")
        pass_losses = []
        for pass_id in range(start_pass, start_pass + num_passes):
            losses = []
            for batch_id, feed in enumerate(
                    prov.batches(files, self.batch_size, seed=pass_id,
                                 data_layer_names=self.feed_order)):
                (loss,) = self.exe.run(feed=feed,
                                       fetch_list=[self.cost_var])
                val = float(np.asarray(loss).reshape(-1)[0])
                losses.append(val)
                if event_handler is not None:
                    event_handler(pass_id, batch_id, val)
            pass_losses.append(float(np.mean(losses)) if losses
                               else float("nan"))
        return pass_losses

    def time(self, num_batches: int = 5):
        """Reference `--job=time`: run the first batch untimed (it builds
        the kernels and warms the allocator), then time `num_batches`
        steps on the host clock.  Each step fetches the loss to the host,
        which waits for the card, so the clock reads finished steps.
        Returns (ms_per_batch, last_loss)."""
        prov, files = self._source("train")
        it = prov.batches(files, self.batch_size, seed=0,
                          data_layer_names=self.feed_order)
        feeds = [f for _, f in zip(range(max(1, num_batches) + 1), it)]
        if not feeds:
            raise RuntimeError("train data source yielded no batches")
        (loss,) = self.exe.run(feed=feeds[0], fetch_list=[self.cost_var])
        timed = feeds[1:] or feeds  # tiny dataset: re-time the only batch
        t0 = _time.perf_counter()
        for f in timed:
            (loss,) = self.exe.run(feed=f, fetch_list=[self.cost_var])
        dt = (_time.perf_counter() - t0) / len(timed)
        return dt * 1e3, float(np.asarray(loss).reshape(-1)[0])

    def test(self):
        """Mean cost over the registered test source: one pass of the
        eval-mode program (cloned before minimize — no parameter updates,
        BN/dropout in inference mode).  Under settings(average_window=),
        evaluation runs on the window-AVERAGED parameters and restores
        the raw ones afterward (reference AverageOptimizer apply/restore
        traversal)."""
        import contextlib

        prov, files = self._source("test")
        ctx = (self.model_average.apply(self.exe)
               if self.model_average is not None
               else contextlib.nullcontext())
        with ctx:
            losses = [
                float(np.asarray(
                    self.exe.run(self.test_program, feed=feed,
                                 fetch_list=[self.cost_var])[0]
                ).reshape(-1)[0])
                for feed in prov.batches(files, self.batch_size, seed=0,
                                         data_layer_names=self.feed_order)
            ]
        return float(np.mean(losses)) if losses else float("nan")
