"""v2 trainer, the port of ``paddle_tpu/v2/trainer.py``: the SGD.train event
loop (reference python/paddle/v2/trainer.py:137 — reader-driven passes
with BeginPass/EndIteration/... event callbacks, plus .test()).

The v2 stack drove a SWIG GradientMachine; here the same user-facing loop
drives the port's Executor over a fluid-style cost variable, on the card
unless the caller passes ``place=CPUPlace()``.  `feeding` maps sample
tuple positions to data-variable names, exactly like the reference's
feeding dict."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from .. import optimizer as optimizer_mod
from ..data_feeder import DataFeeder
from ..framework.core import default_startup_program
from ..framework.executor import Executor
from ..framework.place import default_place
from . import event as v2_event
from .parameters import Parameters


class SGD:
    """v2 trainer (reference trainer.py:44 class SGD). `update_equation` is
    an optimizer instance; `cost` the loss Variable; extra_layers fetch
    additional metrics each iteration.  `place` None is the card
    (``default_place()``)."""

    def __init__(self, cost, parameters: Optional[Parameters] = None,
                 update_equation=None, extra_layers: Sequence = (),
                 is_local=True, place=None):
        cost = getattr(cost, "var", cost)  # accept v2 LayerOutput
        self.cost = cost
        self.program = cost.block.program
        self.parameters = parameters or Parameters(self.program)
        self.extra_layers = list(extra_layers)
        # forward-only snapshot before optimizer mutation
        self.test_program = self.program.clone(for_test=True)
        opt = update_equation or optimizer_mod.SGD(learning_rate=0.01)
        opt.minimize(cost)
        self.exe = Executor(place or default_place())
        self._startup_done = False

    # ------------------------------------------------------------------
    def _ensure_startup(self):
        if not self._startup_done:
            self.exe.run(default_startup_program())
            self._startup_done = True

    def _feeder(self, feeding: Optional[Dict[str, int]]):
        if feeding is None:
            data_vars = [v.name for v in
                         self.program.global_block().vars.values()
                         if v.is_data and not v.name.endswith("@LENGTH")]
            return DataFeeder(feed_list=data_vars, program=self.program)
        # shared with v2.DataFeeder (data_feeder.py): non-contiguous /
        # subset feeding maps project the sample columns first
        from .data_feeder import ProjectingFeeder, pairs_from_feeding

        return ProjectingFeeder(pairs_from_feeding(feeding),
                                program=self.program)

    # ------------------------------------------------------------------
    def train(self, reader, num_passes=1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None):
        """reader yields minibatches (lists of sample tuples) — compose with
        paddle_tpu_torch.reader.batch, as in the reference."""
        event_handler = event_handler or (lambda e: None)
        self._ensure_startup()
        feeder = self._feeder(feeding)
        fetch = [self.cost] + self.extra_layers
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            for batch_id, minibatch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                outs = self.exe.run(self.program,
                                    feed=feeder.feed(minibatch),
                                    fetch_list=fetch)
                cost = float(np.asarray(outs[0]).item())
                metrics = {
                    getattr(l, "name", f"metric_{i}"): np.asarray(o)
                    for i, (l, o) in enumerate(zip(self.extra_layers,
                                                   outs[1:]))
                }
                event_handler(v2_event.EndIteration(pass_id, batch_id, cost,
                                                    metrics))
            event_handler(v2_event.EndPass(pass_id))

    def test(self, reader, feeding=None) -> "v2_event.TestResult":
        self._ensure_startup()
        feeder = self._feeder(feeding)
        costs = []
        for minibatch in reader():
            (c,) = self.exe.run(self.test_program,
                                feed=feeder.feed(minibatch),
                                fetch_list=[self.cost])
            costs.append(float(np.asarray(c).item()))
        return v2_event.TestResult(cost=float(np.mean(costs)))


def infer(output_layer, parameters: Parameters, input, feeding=None,
          field="value", place=None):
    """v2 inference.py equivalent: run the forward program on raw samples,
    on the card unless `place` says otherwise (``default_place()``)."""
    from .. import io as fio

    output_layer = getattr(output_layer, "var", output_layer)
    program = output_layer.block.program.clone(for_test=True)
    program = fio.prune(program, [output_layer.name])
    exe = Executor(place or default_place())
    used = set()
    for op in program.global_block().ops:
        used.update(op.input_names())
    data_vars = [v.name for v in program.global_block().vars.values()
                 if v.is_data and v.name in used
                 and not v.name.endswith("@LENGTH")]
    if feeding:
        # samples may carry columns for vars the pruned inference program
        # no longer uses (e.g. the label): select this program's columns
        order = [feeding[n] for n in data_vars]
        input = [tuple(sample[i] for i in order) for sample in input]
    feeder = DataFeeder(feed_list=data_vars, program=program)
    (out,) = exe.run(program, feed=feeder.feed(input),
                     fetch_list=[output_layer])
    return np.asarray(out)
