"""Evaluators that accumulate over minibatches, the port of
``paddle_tpu/evaluator.py``: ``Accuracy`` and ``ChunkEvaluator``.

Their state is int64 [1] persistable variables in the scope, zeroed by
the startup program and added to by ``sum`` ops inside the training
program, so counting costs the step nothing more on the card; ``eval``
reads the state on the host and ``reset`` zeroes it.  ``DetectionMAP``
waits for the detection ops."""

from __future__ import annotations

import torch

from .framework import unique_name
from .framework.core import torch_dtype
from .framework.initializer import ConstantInitializer
from .framework.layer_helper import LayerHelper
from .framework.scope import global_scope


class Evaluator:
    def __init__(self, name):
        self.helper = LayerHelper(name)
        self.states = []
        self.metrics = []

    def _create_state(self, suffix, shape, dtype="float32"):
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{self.helper.name}_{suffix}"),
            shape=shape, dtype=dtype)
        self.helper.set_initialized(var, ConstantInitializer(0.0))
        self.states.append(var)
        return var

    def reset(self, executor, reset_program=None):
        scope = global_scope()
        for s in self.states:
            scope.set(s.name, torch.zeros(s.shape, dtype=torch_dtype(s.dtype)))

    def eval(self, executor):
        raise NotImplementedError

    def _count(self, state, batch):
        """state += batch, as a ``sum`` op of the program."""
        self.helper.block.append_op("sum",
                                    inputs={"X": [state.name, batch.name]},
                                    outputs={"Out": [state.name]})

    @staticmethod
    def _read(var):
        return float(global_scope().find_np(var.name).item())


class Accuracy(Evaluator):
    """Top-k accuracy over every minibatch seen since the last reset."""

    def __init__(self, input, label, k=1):
        super().__init__("accuracy")
        from . import layers

        self.total = self._create_state("total", (1,), "int64")
        self.correct = self._create_state("correct", (1,), "int64")
        _, indices = layers.topk(input, k)
        acc = self.helper.create_tmp_variable("float32", shape=(1,),
                                              stop_gradient=True)
        correct_b = self.helper.create_tmp_variable("int64", shape=(1,),
                                                    stop_gradient=True)
        total_b = self.helper.create_tmp_variable("int64", shape=(1,),
                                                  stop_gradient=True)
        self.helper.block.append_op(
            "accuracy",
            inputs={"Indices": [indices.name], "Label": [label.name]},
            outputs={"Accuracy": [acc.name], "Correct": [correct_b.name],
                     "Total": [total_b.name]})
        self._count(self.total, total_b)
        self._count(self.correct, correct_b)
        self.batch_acc = acc

    def eval(self, executor=None):
        return self._read(self.correct) / max(self._read(self.total), 1.0)


class ChunkEvaluator(Evaluator):
    """Chunk precision, recall and F1 over every minibatch seen since the
    last reset, from ``chunk_eval``'s per-batch counts of inferred,
    labelled and correct chunks."""

    def __init__(self, num_infer_chunks, num_label_chunks,
                 num_correct_chunks):
        super().__init__("chunk_evaluator")
        self.num_infer = self._create_state("num_infer", (1,), "int64")
        self.num_label = self._create_state("num_label", (1,), "int64")
        self.num_correct = self._create_state("num_correct", (1,), "int64")
        for state, batch in ((self.num_infer, num_infer_chunks),
                             (self.num_label, num_label_chunks),
                             (self.num_correct, num_correct_chunks)):
            self._count(state, batch)

    def eval(self, executor=None):
        infer, label, correct = (self._read(v) for v in (
            self.num_infer, self.num_label, self.num_correct))
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1
